"""Given-view generation: condition on provided camera views by latent
substitution inside the denoising loop (counterpart of
``pipeline/given_view.py``; ref:magicdrive/pipeline/
pipeline_bev_controlnet_given_view.py).

Each step re-noises the provided views' clean VAE latents to the current
timestep and substitutes them into the sample (ref::263-295); optionally
the guided noise prediction on the provided views is replaced by the true
noise, so the sampler keeps them on their trajectory (ref::380-389). After
the loop the provided views take their clean latents, so they decode as a
VAE round trip. This drives the "generate the other 5 views given 1" demo
(ref:demo/run_cond_on_view.py).

As in the JAX package, the loop conditions both CFG branches on the
request's text ids and takes its uncond map from
``use_zero_map_as_unconditional`` alone: neither the ControlNet's
``use_uncond_map`` nor ``guess_mode`` nor ``prompt_embeds`` reaches it.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from magicdrive_tpu_torch.config import PipelineConfig
from magicdrive_tpu_torch.pipeline.pipeline import (Conditioning,
                                                    MagicDriveModules,
                                                    MagicDrivePipeline)


class GivenViewPipeline(MagicDrivePipeline):
    """MagicDrivePipeline with per-step latent substitution of the views a
    request provides."""

    def __init__(self, modules: MagicDriveModules, cfg: PipelineConfig,
                 sub_noise_pred: bool = False):
        super().__init__(modules, cfg)
        self.sub_noise_pred = sub_noise_pred
        # float32, as the JAX loop reads them
        self.alpha = self.schedule.alpha_t.astype(np.float32)
        self.sigma = self.schedule.sigma_t.astype(np.float32)

    @torch.no_grad()
    def encode_views(self, images, noise=None) -> torch.Tensor:
        """(B, N, H, W, 3) images in [-1, 1] -> clean latents
        (B, N, h, w, 4): the posterior mean, or a posterior sample with the
        given ``noise`` (B, N, h, w, 4)."""
        px = self._tensor(images, torch.float32)
        B, N = px.shape[:2]
        px = px.reshape(B * N, *px.shape[2:]).permute(0, 3, 1, 2)
        if noise is not None:
            noise = self._tensor(noise, torch.float32)
            noise = noise.reshape(B * N, *noise.shape[2:]).permute(0, 3, 1, 2)
        lat = self.m.vae.encode(px, noise).float()
        return lat.permute(0, 2, 3, 1).reshape(B, N, *lat.shape[2:],
                                               lat.shape[1])

    @torch.no_grad()
    def conditioning(self, batch: Mapping[str, object]) -> Conditioning:
        """Both CFG branches from the text ids; the uncond map is zeros
        with ``use_zero_map_as_unconditional``, else the request's map
        (JAX ``_generate_given_fn``)."""
        text, uncond_text = self.encode_text(
            {k: batch[k] for k in ("input_ids", "uncond_ids")})
        layout = self._layout(batch)
        bev = layout[1]
        uncond_map = torch.zeros_like(bev) if \
            self.cfg.use_zero_map_as_unconditional else bev
        return self.cfg_conditioning(layout, text, uncond_text, uncond_map)

    @torch.no_grad()
    def __call__(self, batch: Mapping[str, object],
                 given_latents=None, view_mask=None,
                 generator: Optional[torch.Generator] = None,
                 latents=None, sub_noise=None) -> torch.Tensor:
        """``given_latents`` (B, N, h, w, 4) from :meth:`encode_views`;
        ``view_mask`` (N,): 1 where the view is provided (kept), 0 where it
        is generated. ``sub_noise`` (B, N, h, w, 4) re-noises the provided
        views at every step; it is drawn from ``generator`` after the
        initial latents when not given. Without ``given_latents`` or
        ``view_mask`` this is the plain pipeline.
        Returns images (B, N, H, W, 3) float32 in [0, 1]."""
        if given_latents is None or view_mask is None:
            return super().__call__(batch, generator=generator,
                                    latents=latents)
        co = self.coeffs
        x = self.initial_latents(batch, generator, latents)
        to_nchw = lambda t: self._tensor(t, torch.float32).permute(
            0, 1, 4, 2, 3)
        given = to_nchw(given_latents)
        noise = to_nchw(sub_noise) if sub_noise is not None else \
            torch.randn(given.shape, generator=generator,
                        device=self.device)
        mask = self._tensor(view_mask, torch.float32).reshape(1, -1, 1, 1, 1)
        cond = self.conditioning(batch)
        state = co.init_state(x)
        for i, t in enumerate(co.timesteps):
            noised = float(self.alpha[t]) * given + \
                float(self.sigma[t]) * noise
            x = mask * noised + (1 - mask) * x
            eps = self.guided_eps(x, t, cond)
            if self.sub_noise_pred:
                eps = mask * noise + (1 - mask) * eps
            x, state = co.step(i, x, eps, state)
        # the provided views decode from their clean latents
        return self.decode(mask * given + (1 - mask) * x)
