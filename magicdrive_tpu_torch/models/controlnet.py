"""BEV ControlNet: the conditioning branch producing additive UNet
residuals (counterpart of ``models/controlnet.py``; ref:
magicdrive/networks/unet_addon_rawbox.py BEVControlNetModel), NCHW.

Token sequence per view: [cam(1) | text(77) | bbox(max_len)]
(ref:unet_addon_rawbox.py:317-336, 791-793).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from magicdrive_tpu_torch.config import BEVControlNetConfig
from magicdrive_tpu_torch.models.embedders import (
    BEVMapEmbedder, BEVMapEmbedderPlus, ContinuousBBoxWithTextEmbedding,
    embed_camera)
from magicdrive_tpu_torch.models.unet import (CrossAttnDownBlock,
                                              TimestepEmbedding, UNetMidBlock,
                                              time_embed)


def _zero_conv(ch: int) -> nn.Conv2d:
    conv = nn.Conv2d(ch, ch, 1)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class BEVControlNet(nn.Module):
    def __init__(self, cfg: BEVControlNetConfig):
        super().__init__()
        self.cfg = cfg
        ucfg = dataclasses.replace(cfg.unet, neighboring_view_pair=None)
        self.ucfg = ucfg
        boc = ucfg.block_out_channels
        self.cam2token = nn.Linear(cfg.camera_in_dim, cfg.camera_out_dim)
        # one learned "unconditional camera" row (ref:unet_addon_rawbox.py:
        # 108-112), an Embedding(1, 21)
        self.uncond_cam = nn.Embedding(
            1, cfg.uncond_cam_in_dim[0] * cfg.uncond_cam_in_dim[1])
        self.bbox_embedder = ContinuousBBoxWithTextEmbedding(cfg.bbox)
        if cfg.use_map_embedder_plus:
            self.controlnet_cond_embedding = BEVMapEmbedderPlus(
                cfg.map_size[0], cfg.map_embedder_out_channels, boc[0],
                cfg.map_embedder_plus_size)
        else:
            self.controlnet_cond_embedding = BEVMapEmbedder(
                cfg.map_size[0], cfg.map_embedder_out_channels, boc[0])
        self.time_embedding = TimestepEmbedding(boc[0], boc[0] * 4)
        self.conv_in = nn.Conv2d(ucfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            CrossAttnDownBlock(ucfg, boc[max(i - 1, 0)], ch,
                               ucfg.down_block_has_attn[i],
                               add_downsample=i != len(boc) - 1)
            for i, ch in enumerate(boc)])
        self.mid_block = UNetMidBlock(ucfg)
        # zero-init 1x1 convs, one per residual (ref:unet_addon_rawbox.py:
        # 219-272) and one for the mid block
        res_channels = [boc[0]]
        for i, ch in enumerate(boc):
            res_channels += [ch] * (ucfg.layers_per_block
                                    + (i != len(boc) - 1))
        self.controlnet_down_blocks = nn.ModuleList(
            [_zero_conv(ch) for ch in res_channels])
        self.controlnet_mid_block = _zero_conv(boc[-1])
        # the unconditional map (ref:unet_addon_rawbox.py:188-202), (C, H,
        # W): a buffer for negative1 and random, a parameter for learnable,
        # as the JAX package files it under "buffers" or "params". The JAX
        # package draws the random map from its own PRNG, which this module
        # cannot repeat; converted weights carry its values
        u = cfg.use_uncond_map
        if u == "negative1":
            self.register_buffer("uncond_map", -torch.ones(cfg.map_size))
        elif u == "random":
            self.register_buffer("uncond_map", torch.randn(
                cfg.map_size, device="cpu", generator=torch.Generator(
                ).manual_seed(20230325)).to(self.conv_in.weight.device))
        elif u == "learnable":
            self.uncond_map = nn.Parameter(torch.randn(cfg.map_size))
        elif u is not None:
            raise ValueError(f"use_uncond_map {u!r}: None, negative1, "
                             "random or learnable")

    def uncond_camera(self) -> torch.Tensor:
        """The learned unconditional camera as a (3, 7) parameter."""
        return self.uncond_cam.weight.reshape(self.cfg.uncond_cam_in_dim)

    def uncond_cam_token(self) -> torch.Tensor:
        """The token of the learned unconditional camera, (d,)."""
        return self.cam2token(embed_camera(
            self.uncond_camera().float(), self.cfg.cam_num_freqs).to(
                self.cam2token.weight.dtype))

    def assemble_tokens(self, camera_param: torch.Tensor,
                        encoder_hidden_states: torch.Tensor,
                        bboxes: torch.Tensor, classes: torch.Tensor,
                        masks: torch.Tensor,
                        encoder_hidden_states_uncond: Optional[
                            torch.Tensor] = None,
                        drop_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """camera (B, N, 3, 7), text (B, 77, d), boxes (B, N or 1, L, P, 3),
        classes/masks (B, N or 1, L) -> tokens (B, N, 1 + 77 + L, d).

        Training's condition drop: where ``drop_mask`` (B, N) is 1, the
        view's camera and text tokens become the unconditional camera token
        and ``encoder_hidden_states_uncond`` (1, 77, d), and with
        ``drop_cam_with_box`` its boxes are masked out too."""
        dt = self.cam2token.weight.dtype
        B, N = camera_param.shape[:2]
        cam = self.cam2token(
            embed_camera(camera_param.float(), self.cfg.cam_num_freqs).to(dt))
        text = encoder_hidden_states.to(dt)[:, None].expand(B, N, -1, -1)
        tokens = torch.cat([cam[:, :, None], text], dim=2)
        if drop_mask is not None:
            uncond = torch.cat([self.uncond_cam_token()[None],
                                encoder_hidden_states_uncond[0].to(dt)])
            m = drop_mask.to(dt)[:, :, None, None]
            tokens = tokens * (1 - m) + uncond * m
            if self.cfg.drop_cam_with_box:
                bboxes, classes, masks = (t.expand(B, N, *t.shape[2:])
                                          for t in (bboxes, classes, masks))
                masks = masks * (1 - drop_mask[:, :, None].to(masks.dtype))
        box = self.bbox_embedder(bboxes, classes, masks)
        return torch.cat([tokens, box.expand(B, N, *box.shape[2:])], dim=2)

    def uncond_tokens(self, encoder_hidden_states_uncond: torch.Tensor,
                      n_box_tokens: int) -> torch.Tensor:
        """The CFG negative branch's tokens in guess mode, (1 + 77 +
        n_box_tokens, d): the uncond camera token, the uncond text (1, 77,
        d) and null boxes (ref:unet_addon_rawbox.py:684-702)."""
        dt = self.cam2token.weight.dtype
        head = torch.cat([self.uncond_cam_token()[None],
                          encoder_hidden_states_uncond[0].to(dt)])
        dev = head.device
        null = self.bbox_embedder(
            torch.zeros((n_box_tokens, self.cfg.bbox.n_points, 3),
                        device=dev),
            torch.zeros((n_box_tokens,), dtype=torch.long, device=dev),
            torch.zeros((n_box_tokens,), device=dev))
        return torch.cat([head, null])

    def substitute_with_uncond_map(self, controlnet_cond: torch.Tensor,
                                   mask: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
        """Maps (B, C, H, W) with those of the samples where ``mask`` (B,)
        is 1 (all when None) replaced by the unconditional map
        (ref:unet_addon_rawbox.py:378-412)."""
        u = self.uncond_map[None]
        if mask is None:
            return u.expand(controlnet_cond.shape)
        m = mask.reshape(-1, 1, 1, 1).to(controlnet_cond.dtype)
        return controlnet_cond * (1 - m) + u.to(controlnet_cond.dtype) * m

    def embed_map(self, controlnet_cond: torch.Tensor) -> torch.Tensor:
        """BEV map (B, C_map, H, W) -> (B, 320, h, w)."""
        return self.controlnet_cond_embedding(
            controlnet_cond.to(self.conv_in.weight.dtype))

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                camera_param: Optional[torch.Tensor] = None,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                controlnet_cond: Optional[torch.Tensor] = None,
                bboxes: Optional[torch.Tensor] = None,
                classes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None,
                conditioning_scale: float = 1.0,
                tokens: Optional[torch.Tensor] = None,
                cond_feat: Optional[torch.Tensor] = None,
                encoder_hidden_states_uncond: Optional[torch.Tensor] = None,
                drop_mask: Optional[torch.Tensor] = None,
                guess_mode: bool = False
                ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
        """sample (B, N, 4, h, w), timesteps (B,) or (B*N,). ``tokens`` and
        ``cond_feat`` may be precomputed (they do not change across sampler
        steps) with :meth:`assemble_tokens` / :meth:`embed_map`; otherwise
        the tokens take the condition drop of ``drop_mask``. In
        ``guess_mode`` the residuals are scaled by a logspace from 0.1 (the
        first) to 1 (the mid block's) times ``conditioning_scale``
        (ref:unet_addon_rawbox.py:897-904).
        Returns (down residuals, mid residual, tokens)."""
        B, N = sample.shape[:2]
        dt = self.conv_in.weight.dtype
        if tokens is None:
            tokens = self.assemble_tokens(
                camera_param, encoder_hidden_states, bboxes, classes, masks,
                encoder_hidden_states_uncond, drop_mask)
        if cond_feat is None:
            cond_feat = self.embed_map(controlnet_cond)
        x = sample.reshape(B * N, *sample.shape[2:]).to(dt)
        ctx = tokens.reshape(B * N, *tokens.shape[2:])
        timesteps = timesteps.reshape(-1).expand(
            B if timesteps.numel() == 1 else -1)
        if timesteps.shape[0] == B:
            timesteps = timesteps.repeat_interleave(N)
        temb = time_embed(self.time_embedding, timesteps,
                          self.ucfg.block_out_channels[0])
        x = self.conv_in(x) + cond_feat.repeat_interleave(N, dim=0)
        res = [x]
        for block in self.down_blocks:
            x, r = block(x, temb, ctx)
            res.extend(r)
        x = self.mid_block(x, temb, ctx)
        scales = (np.logspace(-1, 0, len(res) + 1) if guess_mode
                  else np.ones(len(res) + 1)) * conditioning_scale
        down = [conv(r) * float(s) for conv, r, s in
                zip(self.controlnet_down_blocks, res, scales[:-1],
                    strict=True)]
        return (down, self.controlnet_mid_block(x) * float(scales[-1]),
                tokens)
