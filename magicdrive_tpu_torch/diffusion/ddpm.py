"""DDPM training-side ops: noise injection, prediction targets and the
random draws of a step (counterpart of ``diffusion/ddpm.py``).

Latents are NCHW with leading (B, N) axes here, (B, N, 4, h, w); timesteps
broadcast over the leading axes. The schedule's scales are taken in the
latents' dtype, as the JAX package takes them. Draws come from an explicit
``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .schedules import NoiseSchedule


def _scale(values, x0: torch.Tensor, timesteps: torch.Tensor
           ) -> torch.Tensor:
    a = torch.as_tensor(values, dtype=x0.dtype, device=x0.device)[timesteps]
    return a.reshape(*timesteps.shape, *(1,) * (x0.dim() - timesteps.dim()))


def add_noise(schedule: NoiseSchedule, x0: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """x_t = alpha_t * x0 + sigma_t * noise."""
    return _scale(schedule.alpha_t, x0, timesteps) * x0 + \
        _scale(schedule.sigma_t, x0, timesteps) * noise


def prediction_target(schedule: NoiseSchedule, x0: torch.Tensor,
                      noise: torch.Tensor, timesteps: torch.Tensor,
                      prediction_type: str = "epsilon") -> torch.Tensor:
    if prediction_type == "epsilon":
        return noise
    if prediction_type == "v_prediction":
        return _scale(schedule.alpha_t, x0, timesteps) * noise - \
            _scale(schedule.sigma_t, x0, timesteps) * x0
    raise ValueError(prediction_type)


def sample_timesteps(generator: torch.Generator, batch: int,
                     num_train_timesteps: int = 1000,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return torch.randint(0, num_train_timesteps, (batch,),
                         generator=generator, device=device)


def noise_with_offset(generator: torch.Generator, shape: Sequence[int],
                      noise_offset: float = 0.0,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """Gaussian noise (..., C, H, W) with an optional DC offset per
    (..., C), shared over the spatial axes."""
    noise = torch.randn(tuple(shape), generator=generator, device=device)
    if noise_offset > 0:
        off = torch.randn((*shape[:-2], 1, 1), generator=generator,
                          device=device)
        noise = noise + noise_offset * off
    return noise
