"""Conditioning embedders: camera pose, 3D boxes and the BEV map
(counterpart of ``models/embedders.py``). NCHW for the map."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdrive_tpu_torch.config import BBoxEmbedderConfig
from magicdrive_tpu_torch.core.embeddings import fourier_embed

# the corners' range under ``minmax_normalize`` (ref:bbox_embedder.py:10-11)
XYZ_MIN = (-200.0, -300.0, -20.0)
XYZ_RANGE = (350.0, 650.0, 80.0)


class ContinuousBBoxWithTextEmbedding(nn.Module):
    """3D box (corners + class) -> one cross-attention token: corners ->
    Fourier -> ``bbox_proj`` -> SiLU, concat the class token, MLP. Padded
    slots (mask 0) blend to the learned null position and class features
    (ref:bbox_embedder.py:145-189). The class tokens are a frozen buffer
    (CLIP-initialised at prepare time), or with ``trainable_class_token`` a
    parameter drawn from N(0, 1); with ``minmax_normalize`` the corners are
    mapped by (xyz - XYZ_MIN) / XYZ_RANGE first."""

    def __init__(self, cfg: BBoxEmbedderConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.proj_dims
        self.null_pos_feature = nn.Parameter(torch.zeros(cfg.pos_dim))
        self.null_class_feature = nn.Parameter(
            torch.zeros(cfg.class_token_dim))
        shape = (cfg.n_classes, cfg.class_token_dim)
        if cfg.trainable_class_token:
            self._class_tokens = nn.Parameter(torch.randn(shape))
        else:
            self.register_buffer("_class_tokens", torch.zeros(shape))
        self.bbox_proj = nn.Linear(cfg.pos_dim, d[0])
        self.second_linear = nn.Sequential(
            nn.Linear(d[0] + cfg.class_token_dim, d[1]), nn.SiLU(),
            nn.Linear(d[1], d[2]), nn.SiLU(), nn.Linear(d[2], d[3]))

    def forward(self, bboxes: torch.Tensor, classes: torch.Tensor,
                masks: torch.Tensor) -> torch.Tensor:
        """bboxes (..., P, 3), classes (...,) int, masks (...,) -> (..., d)."""
        dt = self.bbox_proj.weight.dtype
        bboxes = bboxes.float()
        if self.cfg.minmax_normalize:
            bboxes = (bboxes - bboxes.new_tensor(XYZ_MIN)) / \
                bboxes.new_tensor(XYZ_RANGE)
        pos = fourier_embed(bboxes, self.cfg.embedder_num_freq)
        pos = pos.reshape(*pos.shape[:-2], -1).to(dt)
        m = masks.to(dt)[..., None]
        pos = pos * m + self.null_pos_feature * (1 - m)
        cls = self._class_tokens[classes.long().clamp(
            0, self.cfg.n_classes - 1)].to(dt)
        cls = cls * m + self.null_class_feature * (1 - m)
        emb = F.silu(self.bbox_proj(pos))
        return self.second_linear(torch.cat([emb, cls], dim=-1))


def embed_camera(camera_param: torch.Tensor, num_freqs: int = 4
                 ) -> torch.Tensor:
    """Camera (..., 3, 7) -> (..., 189): each of the 7 columns Fourier
    embedded (27 values), concatenated column by column."""
    emb = fourier_embed(camera_param.transpose(-1, -2), num_freqs)
    return emb.reshape(*emb.shape[:-2], -1)


class BEVMapEmbedder(nn.Module):
    """BEV map (B, C_map, H, W) -> latent-resolution features: conv_in, six
    SiLU convs with the asymmetric (2, 1) padding of the later stages, and
    a zero-init conv_out ((8, 200, 200) -> (320, 28, 50) for the 224x400
    model, (8, 400, 400) -> (320, 53, 100) for the 424x800 one)."""

    def __init__(self, in_channels: int, block_out_channels: Tuple[int, ...],
                 out_channels: int):
        super().__init__()
        boc = block_out_channels
        self.conv_in = nn.Conv2d(in_channels, boc[0], 3, padding=1)
        specs = []  # (in, out, padding (h, w), stride (h, w))
        for i in range(len(boc) - 2):
            specs.append((boc[i], boc[i], (1, 1), (1, 1)))
            specs.append((boc[i], boc[i + 1], (2, 1), (2, 2)))
        specs.append((boc[-2], boc[-2], (2, 1), (1, 1)))
        specs.append((boc[-2], boc[-1], (2, 1), (2, 1)))
        self.blocks = nn.ModuleList([
            nn.Conv2d(ci, co, 3, stride=s, padding=p)
            for ci, co, p, s in specs])
        self.conv_out = nn.Conv2d(boc[-1], out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(x))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class BEVMapEmbedderPlus(nn.Module):
    """The hi-res map embedder (ref:map_embedder.py:79-127): conv_in and six
    SiLU convs with symmetric padding 1 and stride 1 at the first stage,
    then an adaptive average pool to ``out_hw`` and the zero-init conv_out
    ((8, 200, 200) -> (320, 34, 92) for the 272x736 model). The pool's bins
    are torch's, [floor(i * in / out), ceil((i + 1) * in / out)), as the JAX
    package restates them."""

    def __init__(self, in_channels: int, block_out_channels: Tuple[int, ...],
                 out_channels: int, out_hw: Tuple[int, int]):
        super().__init__()
        boc = block_out_channels
        self.out_hw = tuple(out_hw)
        self.conv_in = nn.Conv2d(in_channels, boc[0], 3, padding=1)
        specs = []  # (in, out, stride (h, w))
        for i in range(len(boc) - 2):
            specs.append((boc[i], boc[i], (1, 1)))
            specs.append((boc[i], boc[i + 1], (1, 1) if i == 0 else (2, 2)))
        specs.append((boc[-2], boc[-2], (1, 1)))
        specs.append((boc[-2], boc[-1], (2, 1)))
        self.blocks = nn.ModuleList([
            nn.Conv2d(ci, co, 3, stride=s, padding=1) for ci, co, s in specs])
        self.conv_out = nn.Conv2d(boc[-1], out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)
        nn.init.zeros_(self.conv_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(x))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(F.adaptive_avg_pool2d(h, self.out_hw))
