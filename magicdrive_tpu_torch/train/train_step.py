"""The diffusion train step (counterpart of ``train/train_step.py``).

VAE encode (frozen, no graph) -> noise and timesteps -> ControlNet with the
condition drop -> multiview UNet -> fp32 MSE on the prediction target ->
gradients of the trainable partition -> the optimizer on the fp32 masters.

Every random draw of a step is a field of ``StepDraws``: ``sample_draws``
makes them from a ``torch.Generator``, and a caller may pass its own (the
tests feed the JAX package's draws, since ``jax.random`` and
``torch.Generator`` never agree).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from magicdrive_tpu_torch.diffusion import NoiseSchedule, ddpm
from .state import TrainConfig, TrainState

_INT_KEYS = ("input_ids", "uncond_ids", "classes")


@dataclasses.dataclass
class StepDraws:
    vae_noise: torch.Tensor            # (B*N, 4, h, w) posterior sample
    noise: torch.Tensor                # (B, N, 4, h, w)
    timesteps: torch.Tensor            # (B,), one per sample, all views
    drop_mask: Optional[torch.Tensor]  # (B, N), 1 -> uncond cam and text


def make_drop_mask(generator: torch.Generator, batch: int, n_cam: int,
                   drop_cond_ratio: float, drop_cam_num: int,
                   device=None) -> torch.Tensor:
    """(B, N) float mask: with probability ``drop_cond_ratio`` per sample,
    ``drop_cam_num`` of its cameras chosen at random are 1."""
    hit = torch.rand((batch, 1), generator=generator,
                     device=device) < drop_cond_ratio
    scores = torch.rand((batch, n_cam), generator=generator, device=device)
    thresh = scores.sort(dim=1).values[:, drop_cam_num - 1:drop_cam_num]
    return (hit & (scores <= thresh)).float()


def sample_draws(cfg: TrainConfig, schedule: NoiseSchedule, B: int, N: int,
                 latent_hw: Tuple[int, int], generator: torch.Generator,
                 device=None) -> StepDraws:
    h, w = latent_hw
    vae_noise = torch.randn((B * N, 4, h, w), generator=generator,
                            device=device)
    t = ddpm.sample_timesteps(generator, B, schedule.num_train_timesteps,
                              device)
    noise = ddpm.noise_with_offset(generator, (B, N, 4, h, w),
                                   cfg.noise_offset, device)
    drop = None
    if cfg.drop_cond_ratio > 0:
        drop = make_drop_mask(generator, B, N, cfg.drop_cond_ratio,
                              cfg.drop_cam_num, device)
    return StepDraws(vae_noise, noise, t, drop)


def batch_tensors(batch: Mapping[str, Any], device) -> Dict[str, torch.Tensor]:
    """A ``collate_fn`` batch on ``device``: ids and classes int64, the rest
    float32."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                               device=device,
                               dtype=torch.long if k in _INT_KEYS
                               else torch.float32)
            for k, v in batch.items()}


def loss_fn(modules, batch: Mapping[str, torch.Tensor], draws: StepDraws,
            cfg: TrainConfig, schedule: NoiseSchedule) -> torch.Tensor:
    """The fp32 MSE between the UNet's prediction and its target.
    ``batch`` as ``batch_tensors`` gives it."""
    m = modules
    px = batch["pixel_values"]
    B, N = px.shape[:2]
    with torch.no_grad():
        text, _ = m.clip(batch["input_ids"])
        uncond_text, _ = m.clip(batch["uncond_ids"])
        latents = m.vae.encode(px.reshape(B * N, *px.shape[2:]).permute(
            0, 3, 1, 2), draws.vae_noise)
    latents = latents.reshape(B, N, *latents.shape[1:])
    t = draws.timesteps
    t_full = t[:, None].expand(B, N)
    noisy = ddpm.add_noise(schedule, latents, draws.noise, t_full)
    down, mid, tokens = m.controlnet(
        noisy, t, batch["camera_param"], text,
        batch["bev_map"].permute(0, 3, 1, 2), batch["bboxes"],
        batch["classes"], batch["masks"],
        encoder_hidden_states_uncond=uncond_text, drop_mask=draws.drop_mask)
    eps = m.unet(noisy.reshape(B * N, *noisy.shape[2:]), t_full.reshape(-1),
                 tokens.reshape(B * N, *tokens.shape[2:]),
                 down_block_additional_residuals=down,
                 mid_block_additional_residual=mid)
    target = ddpm.prediction_target(schedule, latents, draws.noise, t_full,
                                    cfg.prediction_type)
    return ((eps.float().reshape(target.shape) - target.float()) ** 2).mean()


def loss_and_grads(modules, state: TrainState,
                   batch: Mapping[str, torch.Tensor], draws: StepDraws,
                   cfg: TrainConfig, schedule: NoiseSchedule
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and the fp32 gradients of the trainable partition at the
    state's masters (zeros for a weight the loss does not reach)."""
    params = state.copy_into(modules)
    loss = loss_fn(modules, batch, draws, cfg, schedule)
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    return loss.detach(), {
        k: torch.zeros_like(state.masters[k]) if g is None else g.float()
        for (k, _), g in zip(params.items(), grads)}


def train_step(modules, state: TrainState, batch: Mapping[str, Any],
               cfg: TrainConfig, draws: Optional[StepDraws] = None,
               generator: Optional[torch.Generator] = None,
               schedule: Optional[NoiseSchedule] = None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (a ``collate_fn`` batch with
    ``pixel_values``); ``draws`` default to ``sample_draws`` from
    ``generator``. Updates ``state`` in place and returns its metrics as
    tensors (no host sync): the loss and the gradients' global norm."""
    schedule = schedule or NoiseSchedule.create()
    device = next(iter(state.masters.values())).device
    batch = batch_tensors(batch, device)
    if draws is None:
        B, N, H, W = batch["pixel_values"].shape[:4]
        f = 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
        draws = sample_draws(cfg, schedule, B, N, (H // f, W // f),
                             generator, device)
    loss, grads = loss_and_grads(modules, state, batch, draws, cfg, schedule)
    return {"loss": loss, "grad_norm": state.apply_gradients(grads)}
