"""The noise schedule in float64 numpy (counterpart of
``diffusion/schedules.py``; that module's package imports jax, so the
builders are restated here).

SD-v1.5's scaled_linear betas 0.00085..0.012 over 1000 train steps by
default (diffusers' DDPM/UniPC settings), or diffusers' ``linear`` and
``squaredcos_cap_v2`` betas.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    betas: np.ndarray  # (T,) float64

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_start: float = 0.00085, beta_end: float = 0.012,
               beta_schedule: str = "scaled_linear") -> "NoiseSchedule":
        if beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float64)
        elif beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == "squaredcos_cap_v2":
            t = np.arange(num_train_timesteps, dtype=np.float64)

            def f(s):
                return np.cos((s + 0.008) / 1.008 * np.pi / 2) ** 2

            betas = np.minimum(1 - f((t + 1) / num_train_timesteps)
                               / f(t / num_train_timesteps), 0.999)
        else:
            raise ValueError(f"beta_schedule {beta_schedule!r}: linear, "
                             "scaled_linear or squaredcos_cap_v2")
        return cls(betas=betas)

    @property
    def num_train_timesteps(self) -> int:
        return len(self.betas)

    @property
    def alphas_cumprod(self) -> np.ndarray:
        return np.cumprod(1.0 - self.betas)

    @property
    def alpha_t(self) -> np.ndarray:
        """sqrt(alphas_cumprod): signal scale."""
        return np.sqrt(self.alphas_cumprod)

    @property
    def sigma_t(self) -> np.ndarray:
        """sqrt(1 - alphas_cumprod): noise scale."""
        return np.sqrt(1.0 - self.alphas_cumprod)

    @property
    def lambda_t(self) -> np.ndarray:
        """log-SNR / 2, the UniPC time variable."""
        return np.log(self.alpha_t) - np.log(self.sigma_t)

    def inference_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """Descending int timestep grid (diffusers UniPC spacing)."""
        t = np.linspace(0, self.num_train_timesteps - 1,
                        num_inference_steps + 1).round()[::-1][:-1]
        t = t.astype(np.int64)
        _, idx = np.unique(t, return_index=True)
        return t[np.sort(idx)]
