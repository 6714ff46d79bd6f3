"""Generation pipeline: CFG denoise loop + VAE decode (counterpart of
``pipeline/pipeline.py``; ref:magicdrive/pipeline/pipeline_bev_controlnet.py).

Kept from the JAX pipeline, with its options:
  * CFG batch layout: uncond first, cond second;
  * one initial latent per sample, shared by its views (with
    ``fix_seed_within_batch``, one for the whole batch);
  * the text from ``input_ids`` through CLIP, or pre-encoded
    ``prompt_embeds`` and ``uncond_embeds``;
  * the uncond branch takes the learned uncond camera, the uncond text,
    all-null boxes and a map: the ControlNet's unconditional map where it
    has one (``use_uncond_map``), else zeros with
    ``use_zero_map_as_unconditional``, else the same map;
  * guess mode: the ControlNet runs on the cond branch only, with logspace
    residual scaling; the uncond branch gets the uncond token sequence and
    zero residuals;
  * the sampler's coefficients (UniPC or DDIM) precomputed, and the
    conditioning (CLIP, tokens, map features) computed once, outside the
    loop.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from magicdrive_tpu_torch.config import ModelPreset, PipelineConfig
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.diffusion import NoiseSchedule, make_sampler_coeffs
from magicdrive_tpu_torch.models.clip_text import CLIPTextModel
from magicdrive_tpu_torch.models.controlnet import BEVControlNet
from magicdrive_tpu_torch.models.unet import UNet2DConditionModel
from magicdrive_tpu_torch.models.vae import AutoencoderKL
from magicdrive_tpu_torch.parallel.mesh import (Mesh, sharded_frames,
                                               sharded_views)
from magicdrive_tpu_torch.utils import trace


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


# images per VAE decode call. The decoder treats each image alone, so the
# chunks compute the same function; at once, the 16-frame video's 96 images
# would hold activations of 96 * 256 * 224 * 400 > 2**31 elements (fp32 in
# the GroupNorms) in the decoder's last two levels.
DECODE_CHUNK = 12


class Conditioning(NamedTuple):
    """The loop-invariant conditioning of a request: tokens (2B, N, L, d),
    uncond first, and map features (2B, 320, h, w), or (B, ...) of the cond
    branch alone in ``guess_mode``."""
    tokens: torch.Tensor
    cond_feat: torch.Tensor
    guess_mode: bool


class MagicDrivePipeline:
    """Callable generation pipeline over :class:`MagicDriveModules` (already
    on their device and in the working dtype).

    With a ``mesh`` (``parallel.make_mesh``) it generates this rank's block
    of a batch that ``parallel.shard_batch(batch, mesh, n_cam)`` cut: its
    samples, with a ``view`` axis > 1 its cameras, and for the video model
    with a ``t`` axis > 1 its frames. Every per-view operation runs on the
    local cameras as it does unsharded; the cross-view attention gathers
    the other ranks' cameras over the view group and the temporal
    attention exchanges the frames over the t group
    (``core/transformer.py``). Pass the latents of ``shard_batch``:
    latents drawn from a generator are this rank's own."""

    def __init__(self, modules: MagicDriveModules, cfg: PipelineConfig,
                 mesh: Optional[Mesh] = None):
        self.m = modules
        self.cfg = cfg
        self.mesh = mesh
        view = mesh.view if mesh is not None else 1
        if cfg.n_cam % view:
            raise ValueError(f"a view axis of {view} ranks does not divide "
                             f"the {cfg.n_cam} cameras")
        frames = modules.unet.cfg.temporal_frames or 1
        if mesh is not None and frames % mesh.t:
            raise ValueError(f"a t axis of {mesh.t} ranks does not divide "
                             f"the UNet's {frames} frames")
        self.n_views = cfg.n_cam // view  # the cameras a rank generates
        self.schedule = NoiseSchedule.create()
        self.coeffs = make_sampler_coeffs(self.schedule,
                                          cfg.num_inference_steps,
                                          cfg.sampler)
        p = next(modules.unet.parameters())
        self.device, self.dtype = p.device, p.dtype

    def prepare_latents(self, batch_size: int,
                        generator: Optional[torch.Generator],
                        fix_seed_within_batch: bool = False) -> torch.Tensor:
        """One latent per sample replicated over its views:
        (B, N, h, w, 4) float32 (the JAX package's layout). With
        ``fix_seed_within_batch`` every sample starts from the same latent
        (the reference's per-sample re-seeded generators,
        ref:misc/test_utils.py:224-238)."""
        c = self.cfg
        lat = torch.randn((1 if fix_seed_within_batch else batch_size, 1,
                           c.latent_height, c.latent_width, 4),
                          generator=generator, device=self.device)
        return lat.expand(batch_size, self.n_views, -1, -1, -1)

    def _tensor(self, v, dtype=None) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device, dtype=dtype)

    def _layout(self, batch: Mapping[str, object]):
        """camera (B, N, 3, 7), the map (B, C, H, W), boxes (B, N, L, P, 3),
        classes and masks (B, N, L) as tensors on the device."""
        f32 = torch.float32
        return (self._tensor(batch["camera_param"], f32),
                self._tensor(batch["bev_map"], f32).permute(0, 3, 1, 2),
                self._tensor(batch["bboxes"], f32),
                self._tensor(batch["classes"], torch.long),
                self._tensor(batch["masks"], f32))

    def encode_text(self, batch: Mapping[str, object]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(text (B, 77, d), uncond text (1, 77, d)): the batch's
        ``prompt_embeds`` and ``uncond_embeds`` where it has them
        (ref:pipeline_bev_controlnet.py:129-131), else CLIP of
        ``input_ids`` and ``uncond_ids``."""
        if "prompt_embeds" in batch:
            return (self._tensor(batch["prompt_embeds"]),
                    self._tensor(batch["uncond_embeds"]))
        clip = self.m.clip
        return (clip(self._tensor(batch["input_ids"], torch.long))[0],
                clip(self._tensor(batch["uncond_ids"], torch.long))[0])

    def unconditional_map(self, bev: torch.Tensor) -> torch.Tensor:
        """The uncond branch's map: the ControlNet's unconditional map takes
        precedence over the zero map (ref:pipeline_bev_controlnet.py:296-300,
        330-343), else the same map."""
        cn = self.m.controlnet
        if cn.cfg.use_uncond_map:
            return cn.substitute_with_uncond_map(bev).to(bev.dtype)
        if self.cfg.use_zero_map_as_unconditional:
            return torch.zeros_like(bev)
        return bev

    def cfg_conditioning(self, layout, text: torch.Tensor,
                         uncond_text: torch.Tensor,
                         uncond_map: torch.Tensor) -> Conditioning:
        """Both CFG branches, uncond first: the uncond camera, the uncond
        text, null boxes and ``uncond_map`` against the request's own
        (``layout``: :meth:`_layout` of the batch)."""
        cam, bev, bboxes, classes, masks = layout
        B, N = cam.shape[:2]
        cn = self.m.controlnet
        tokens_c = cn.assemble_tokens(cam, text, bboxes, classes, masks)
        tokens_u = cn.assemble_tokens(
            cn.uncond_camera().float().expand(B, N, -1, -1),
            uncond_text.expand(B, -1, -1), torch.zeros_like(bboxes),
            torch.zeros_like(classes), torch.zeros_like(masks))
        return Conditioning(torch.cat([tokens_u, tokens_c]),
                            cn.embed_map(torch.cat([uncond_map, bev])),
                            False)

    @torch.no_grad()
    @trace.spanned("md.pipeline.conditioning")
    def conditioning(self, batch: Mapping[str, object]) -> Conditioning:
        """The loop-invariant conditioning of ``batch`` under the config."""
        text, uncond_text = self.encode_text(batch)
        layout = self._layout(batch)
        if not self.cfg.guess_mode:
            return self.cfg_conditioning(layout, text, uncond_text,
                                         self.unconditional_map(layout[1]))
        cam, bev, bboxes, classes, masks = layout
        cn = self.m.controlnet
        tokens_c = cn.assemble_tokens(cam, text, bboxes, classes, masks)
        tokens_u = cn.uncond_tokens(uncond_text, bboxes.shape[2])
        return Conditioning(
            torch.cat([tokens_u.expand(tokens_c.shape), tokens_c]),
            cn.embed_map(bev), True)

    @torch.no_grad()
    def guided_eps(self, x: torch.Tensor, t: int,
                   cond: Conditioning) -> torch.Tensor:
        """One ControlNet + UNet evaluation of both CFG branches on latents
        x (B, N, 4, h, w) at timestep t, combined at the guidance scale; in
        guess mode the ControlNet runs at batch B on the cond branch and the
        uncond branch takes zero residuals."""
        with sharded_views(self.mesh), sharded_frames(self.mesh):
            return self._guided_eps(x, t, cond)

    def _guided_eps(self, x: torch.Tensor, t: int,
                    cond: Conditioning) -> torch.Tensor:
        m, cfg = self.m, self.cfg
        tokens2 = cond.tokens
        B, N = x.shape[:2]
        lat2 = torch.cat([x, x]).to(self.dtype)
        t2 = torch.full((2 * B,), int(t), device=self.device)
        if cond.guess_mode:
            down, mid, _ = m.controlnet(
                x.to(self.dtype), t2[B:], guess_mode=True,
                conditioning_scale=cfg.conditioning_scale,
                tokens=tokens2[B:], cond_feat=cond.cond_feat)
            down = [torch.cat([torch.zeros_like(d), d]) for d in down]
            mid = torch.cat([torch.zeros_like(mid), mid])
        else:
            down, mid, _ = m.controlnet(
                lat2, t2, conditioning_scale=cfg.conditioning_scale,
                tokens=tokens2, cond_feat=cond.cond_feat)
        eps = m.unet(lat2.reshape(2 * B * N, *lat2.shape[2:]),
                     t2.repeat_interleave(N),
                     tokens2.reshape(2 * B * N, *tokens2.shape[2:]),
                     down_block_additional_residuals=down,
                     mid_block_additional_residual=mid)
        eps_u, eps_c = eps.reshape(2 * B, N, *eps.shape[1:]).chunk(2)
        return eps_u + cfg.guidance_scale * (eps_c - eps_u)

    @torch.no_grad()
    @trace.spanned("md.pipeline.decode")
    def decode(self, x: torch.Tensor) -> torch.Tensor:
        """Latents (B, N, 4, h, w) -> images (B, N, H, W, 3) float32 in
        [0, 1], DECODE_CHUNK images per VAE call."""
        B, N = x.shape[:2]
        flat = x.reshape(B * N, *x.shape[2:]).contiguous()
        imgs = torch.cat([self.m.vae.decode(z).float()
                          for z in flat.split(DECODE_CHUNK)])
        imgs = imgs.reshape(B, N, *imgs.shape[1:])
        return (imgs / 2 + 0.5).clamp(0.0, 1.0).permute(0, 1, 3, 4, 2)

    def initial_latents(self, batch: Mapping[str, object],
                        generator: Optional[torch.Generator],
                        latents) -> torch.Tensor:
        """``latents`` (B, N, h, w, 4), else drawn from ``generator``, as
        (B, N, 4, h, w) float32 on the device."""
        if latents is None:
            latents = self.prepare_latents(
                np.shape(batch["camera_param"])[0], generator)
        return self._tensor(latents, torch.float32).permute(0, 1, 4, 2, 3)

    @torch.no_grad()
    @trace.spanned("md.pipeline.request", unit=True)
    def __call__(self, batch: Mapping[str, object],
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[torch.Tensor] = None) -> torch.Tensor:
        """batch: the ``collate_fn`` dict (numpy or tensors) minus
        ``pixel_values``: input_ids (B, 77), uncond_ids (1, 77) (or
        prompt_embeds (B, 77, d) and uncond_embeds (1, 77, d)),
        camera_param (B, N, 3, 7), bev_map (B, H, W, C), bboxes
        (B, N, L, P, 3), classes (B, N, L), masks (B, N, L).
        latents: (B, N, h, w, 4), else drawn from ``generator``.
        Returns images (B, N, H, W, 3) float32 in [0, 1]."""
        co = self.coeffs
        x = self.initial_latents(batch, generator, latents)
        cond = self.conditioning(batch)
        state = co.init_state(x)
        for i, t in enumerate(co.timesteps):
            with trace.span("md.pipeline.step"):
                x, state = co.step(i, x, self.guided_eps(x, t, cond), state)
        return self.decode(x)
