"""The diffusion train step (counterpart of ``train/train_step.py``).

VAE encode (frozen, no graph) -> noise and timesteps -> ControlNet with the
condition drop -> multiview UNet -> fp32 MSE on the prediction target ->
gradients of the trainable partition -> the optimizer on the fp32 masters.

Every random draw of a step is a field of ``StepDraws``: ``sample_draws``
makes them from a ``torch.Generator``, and a caller may pass its own (the
tests feed the JAX package's draws, since ``jax.random`` and
``torch.Generator`` never agree).

Data parallel (a ``parallel.Mesh`` with a process group): each rank steps
on its rows of the global batch. It draws the global batch's draws and
keeps its rows, so a dp run takes the draws of one process at the global
batch; after the backward the trainable gradients and the loss are
averaged over the ``dp`` group in a few flat fp32 buckets
(``all_reduce_mean``), before the clip, the accumulation and the update,
so every rank makes the same update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from magicdrive_tpu_torch.diffusion import NoiseSchedule, ddpm
from .state import TrainConfig, TrainState

_INT_KEYS = ("input_ids", "uncond_ids", "classes")


@dataclasses.dataclass
class StepDraws:
    vae_noise: torch.Tensor            # (B*N, 4, h, w) posterior sample
    # (B, N, 4, h, w), or (B, 1, 4, h, w) broadcast over the views
    # (train_with_same_noise)
    noise: torch.Tensor
    # (B,), one per sample for all its views; the same for every frame of
    # a clip (frames_per_clip)
    timesteps: torch.Tensor
    drop_mask: Optional[torch.Tensor]  # (B, N), 1 -> uncond cam and text
    # (B,), 1 -> the ControlNet's unconditional map
    map_drop_mask: Optional[torch.Tensor] = None

    def rows(self, index: int, parts: int) -> "StepDraws":
        """The draws of block ``index`` of ``parts`` equal blocks of the
        samples (frames)."""
        def take(t):
            if t is None:
                return None
            b = len(t) // parts  # vae_noise: a row per view
            return t[index * b:(index + 1) * b]
        return StepDraws(*(take(getattr(self, f.name))
                           for f in dataclasses.fields(self)))


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
                 device=None, use_uncond_map: Optional[str] = None
                 ) -> StepDraws:
    """The draws of one step: one timestep per sample, or per clip of
    ``frames_per_clip`` frames repeated over them, and one noise per view,
    or per sample with ``train_with_same_noise``. With ``drop_cond_ratio``
    > 0 the condition drop mask, and where the ControlNet has
    ``use_uncond_map``, the map drop: each sample's map becomes the
    unconditional map with probability ``drop_cond_ratio`` (JAX
    ``train/train_step.py:58-100``)."""
    h, w = latent_hw
    F = cfg.frames_per_clip or 1
    if B % F:
        raise ValueError(f"a batch of {B} frames is no whole number of "
                         f"clips of frames_per_clip={F}")
    vae_noise = torch.randn((B * N, 4, h, w), generator=generator,
                            device=device)
    t = ddpm.sample_timesteps(generator, B // F,
                              schedule.num_train_timesteps,
                              device).repeat_interleave(F)
    noise = ddpm.noise_with_offset(
        generator, (B, 1 if cfg.train_with_same_noise else N, 4, h, w),
        cfg.noise_offset, device)
    drop = map_drop = None
    if cfg.drop_cond_ratio > 0:
        drop = make_drop_mask(generator, B, N, cfg.drop_cond_ratio,
                              cfg.drop_cam_num, device)
        if use_uncond_map:
            map_drop = (torch.rand((B,), generator=generator, device=device)
                        < cfg.drop_cond_ratio).float()
    return StepDraws(vae_noise, noise, t, drop, map_drop)


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
    if not cfg.train_with_same_t:
        # JAX's step hands the ControlNet timesteps of shape (B, N), which
        # its repeat "b -> (b n)" rejects (JAX models/controlnet.py:259-263),
        # so that option trains nowhere and has no semantics to port
        raise NotImplementedError(
            "train_with_same_t=False: the JAX package's train step raises "
            "on it (its ControlNet takes one timestep per sample), so the "
            "port has no semantics to restate")
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
    noise = draws.noise.expand(latents.shape)
    noisy = ddpm.add_noise(schedule, latents, noise, t_full)
    down, mid, tokens = m.controlnet(
        noisy, t, batch["camera_param"], text,
        batch["bev_map"].permute(0, 3, 1, 2), batch["bboxes"],
        batch["classes"], batch["masks"],
        encoder_hidden_states_uncond=uncond_text, drop_mask=draws.drop_mask,
        map_drop_mask=draws.map_drop_mask)
    eps = m.unet(noisy.reshape(B * N, *noisy.shape[2:]), t_full.reshape(-1),
                 tokens.reshape(B * N, *tokens.shape[2:]),
                 down_block_additional_residuals=down,
                 mid_block_additional_residual=mid)
    target = ddpm.prediction_target(schedule, latents, noise, t_full,
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


# elements of one all-reduce bucket (256 MiB of fp32)
BUCKET_ELEMENTS = 1 << 26


def buckets(sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """[start, stop) runs of consecutive tensors of ``sizes`` elements, each
    run one bucket: at most BUCKET_ELEMENTS elements unless one tensor
    alone is larger."""
    runs, start, n = [], 0, 0
    for i, s in enumerate(sizes):
        if n and n + s > BUCKET_ELEMENTS:
            runs.append((start, i))
            start, n = i, 0
        n += s
    runs.append((start, len(sizes)))
    return runs


def all_reduce_mean(grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                    mesh) -> torch.Tensor:
    """Average ``grads`` (fp32, in place) and ``loss`` over the mesh's
    ``dp`` group: one all-reduce a bucket of the flattened tensors, the
    loss in the last bucket; -> the mean loss. Every rank gets the same
    bits."""
    import torch.distributed as dist

    from magicdrive_tpu_torch.parallel.multihost import COLLECTIVES

    tensors = list(grads.values()) + [loss.detach().float().reshape(1)]
    dp = mesh.dp
    for start, stop in buckets([t.numel() for t in tensors]):
        part = tensors[start:stop]
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat, group=mesh.group("dp"))
        COLLECTIVES["all_reduce"] += 1
        flat.div_(dp)
        for t, v in zip(part, flat.split([t.numel() for t in part])):
            t.copy_(v.view_as(t))
    return tensors[-1].reshape(())


def train_step(modules, state: TrainState, batch: Mapping[str, Any],
               cfg: TrainConfig, draws: Optional[StepDraws] = None,
               generator: Optional[torch.Generator] = None,
               schedule: Optional[NoiseSchedule] = None, mesh=None
               ) -> Dict[str, torch.Tensor]:
    """One optimizer step on ``batch`` (a ``collate_fn`` batch with
    ``pixel_values``); ``draws`` default to ``sample_draws`` from
    ``generator``. Updates ``state`` in place and returns its metrics as
    tensors (no host sync): the loss and the gradients' global norm.

    With a ``mesh`` (``parallel.Mesh``) ``batch`` is this rank's rows of a
    global batch of ``len(batch) * mesh.dp`` samples: the default draws
    are the global batch's, cut to this rank's rows, and where a process
    group is up the gradients and the loss are the ``dp`` group's mean."""
    schedule = schedule or NoiseSchedule.create()
    device = next(iter(state.masters.values())).device
    batch = batch_tensors(batch, device)
    dp = mesh.dp if mesh is not None else 1
    if draws is None:
        B, N, H, W = batch["pixel_values"].shape[:4]
        f = 2 ** (len(modules.vae.cfg.block_out_channels) - 1)
        draws = sample_draws(cfg, schedule, B * dp, N, (H // f, W // f),
                             generator, device,
                             modules.controlnet.cfg.use_uncond_map)
        if dp > 1:
            draws = draws.rows(mesh.index("dp"), dp)
    loss, grads = loss_and_grads(modules, state, batch, draws, cfg, schedule)
    if mesh is not None and mesh.group("dp") is not None:
        loss = all_reduce_mean(grads, loss, mesh)
    return {"loss": loss, "grad_norm": state.apply_gradients(grads)}
