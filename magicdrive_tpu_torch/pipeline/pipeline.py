"""Generation pipeline: CFG denoise loop + VAE decode (counterpart of
``pipeline/pipeline.py``; ref:magicdrive/pipeline/pipeline_bev_controlnet.py).

Kept from the JAX pipeline's default branch:
  * CFG batch layout: uncond first, cond second;
  * one initial latent per sample, shared by its views;
  * the uncond branch takes the learned uncond camera, the uncond text,
    all-null boxes and the same map;
  * conditioning (CLIP, tokens, map features) computed once, outside the
    loop.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from magicdrive_tpu_torch.config import ModelPreset, PipelineConfig
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.diffusion import NoiseSchedule, make_unipc_coeffs
from magicdrive_tpu_torch.models.clip_text import CLIPTextModel
from magicdrive_tpu_torch.models.controlnet import BEVControlNet
from magicdrive_tpu_torch.models.unet import UNet2DConditionModel
from magicdrive_tpu_torch.models.vae import AutoencoderKL


@dataclasses.dataclass
class MagicDriveModules:
    unet: UNet2DConditionModel
    controlnet: BEVControlNet
    vae: AutoencoderKL
    clip: CLIPTextModel

    @classmethod
    def create(cls, preset: ModelPreset, device=DEFAULT_DEVICE
               ) -> "MagicDriveModules":
        """Modules of a preset with PyTorch's default initialisation, built
        on ``device``: the card unless the caller asks for the CPU."""
        with torch.device(resolve_device(device)):
            return cls(unet=UNet2DConditionModel(preset.unet),
                       controlnet=BEVControlNet(preset.controlnet),
                       vae=AutoencoderKL(preset.vae),
                       clip=CLIPTextModel(preset.clip))

    def items(self):
        return ((f.name, getattr(self, f.name))
                for f in dataclasses.fields(self))

    def load_state_dicts(self, sds: Mapping[str, Mapping[str, torch.Tensor]]
                         ) -> "MagicDriveModules":
        """Load ``convert.jax_params_to_state_dicts`` output (strict)."""
        for name, mod in self.items():
            mod.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in sds[name].items()}, strict=True)
        return self

    def to(self, device, dtype: torch.dtype) -> "MagicDriveModules":
        for _, mod in self.items():
            mod.to(device=device, dtype=dtype).eval().requires_grad_(False)
        return self


class MagicDrivePipeline:
    """Callable generation pipeline over :class:`MagicDriveModules` (already
    on their device and in the working dtype)."""

    def __init__(self, modules: MagicDriveModules, cfg: PipelineConfig):
        self.m = modules
        self.cfg = cfg
        self.coeffs = make_unipc_coeffs(NoiseSchedule.create(),
                                        cfg.num_inference_steps)
        p = next(modules.unet.parameters())
        self.device, self.dtype = p.device, p.dtype

    def prepare_latents(self, batch_size: int,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
        """One latent per sample replicated over its views:
        (B, N, h, w, 4) float32 (the JAX package's layout)."""
        c = self.cfg
        lat = torch.randn((batch_size, 1, c.latent_height, c.latent_width, 4),
                          generator=generator, device=self.device)
        return lat.expand(-1, c.n_cam, -1, -1, -1)

    def _tensor(self, v, dtype=None) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device, dtype=dtype)

    @torch.no_grad()
    def conditioning(self, batch: Mapping[str, object]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loop-invariant CFG conditioning, uncond first: tokens
        (2B, N, L, d) and map features (2B, 320, h, w)."""
        m, f32 = self.m, torch.float32
        cam = self._tensor(batch["camera_param"], f32)
        B, N = cam.shape[:2]
        bev = self._tensor(batch["bev_map"], f32).permute(0, 3, 1, 2)
        bboxes = self._tensor(batch["bboxes"], f32)
        classes = self._tensor(batch["classes"], torch.long)
        masks = self._tensor(batch["masks"], f32)
        text, _ = m.clip(self._tensor(batch["input_ids"], torch.long))
        uncond_text, _ = m.clip(self._tensor(batch["uncond_ids"], torch.long))
        cn = m.controlnet
        tokens_c = cn.assemble_tokens(cam, text, bboxes, classes, masks)
        tokens_u = cn.assemble_tokens(
            cn.uncond_camera().float().expand(B, N, -1, -1),
            uncond_text.expand(B, -1, -1), torch.zeros_like(bboxes),
            torch.zeros_like(classes), torch.zeros_like(masks))
        return (torch.cat([tokens_u, tokens_c]),
                cn.embed_map(torch.cat([bev, bev])))

    @torch.no_grad()
    def guided_eps(self, x: torch.Tensor, t: int,
                   cond: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """One ControlNet + UNet evaluation of both CFG branches on latents
        x (B, N, 4, h, w) at timestep t, combined at the guidance scale."""
        m, cfg = self.m, self.cfg
        tokens2, cond_feat2 = cond
        B, N = x.shape[:2]
        lat2 = torch.cat([x, x]).to(self.dtype)
        t2 = torch.full((2 * B,), int(t), device=self.device)
        down, mid, _ = m.controlnet(
            lat2, t2, conditioning_scale=cfg.conditioning_scale,
            tokens=tokens2, cond_feat=cond_feat2)
        eps = m.unet(lat2.reshape(2 * B * N, *lat2.shape[2:]),
                     t2.repeat_interleave(N),
                     tokens2.reshape(2 * B * N, *tokens2.shape[2:]),
                     down_block_additional_residuals=down,
                     mid_block_additional_residual=mid)
        eps_u, eps_c = eps.reshape(2 * B, N, *eps.shape[1:]).chunk(2)
        return eps_u + cfg.guidance_scale * (eps_c - eps_u)

    @torch.no_grad()
    def __call__(self, batch: Mapping[str, object],
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """batch: the ``collate_fn`` dict (numpy or tensors) minus
        ``pixel_values``: input_ids (B, 77), uncond_ids (1, 77),
        camera_param (B, N, 3, 7), bev_map (B, H, W, C), bboxes
        (B, N, L, P, 3), classes (B, N, L), masks (B, N, L).
        latents: (B, N, h, w, 4), else drawn from ``generator``.
        Returns images (B, N, H, W, 3) float32 in [0, 1]."""
        co = self.coeffs
        B, N = np.shape(batch["camera_param"])[:2]
        if latents is None:
            latents = self.prepare_latents(B, generator)
        # NCHW inside: (B, N, 4, h, w)
        x = self._tensor(latents, torch.float32).permute(0, 1, 4, 2, 3)
        cond = self.conditioning(batch)
        state = co.init_state(x)
        for i, t in enumerate(co.timesteps):
            x, state = co.step(i, x, self.guided_eps(x, t, cond), state)
        imgs = self.m.vae.decode(x.reshape(B * N, *x.shape[2:]))
        imgs = imgs.float().reshape(B, N, *imgs.shape[1:])
        return (imgs / 2 + 0.5).clamp(0.0, 1.0).permute(0, 1, 3, 4, 2)
