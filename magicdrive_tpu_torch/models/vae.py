"""SD-v1.5 AutoencoderKL (counterpart of ``models/vae.py``), NCHW,
diffusers state_dict names. Norms use eps 1e-6, resnets have no time
embedding, and the mid attention is one head over H*W (D=512: it runs
``F.scaled_dot_product_attention``, as the JAX package runs it through
XLA). Training encodes images into sampled latents; generation decodes."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdrive_tpu_torch.config import VAEConfig
from magicdrive_tpu_torch.core.attention import Attention
from magicdrive_tpu_torch.core.resnet import (GroupNorm, ResnetBlock2D,
                                              Upsample2D)


class VAEAttention(Attention):
    """GroupNorm, single-head self-attention over positions, residual."""

    def __init__(self, channels: int, groups: int):
        super().__init__(channels, 1, channels, qkv_bias=True)
        self.group_norm = GroupNorm(groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)
        y = super().forward(y)
        return y.transpose(1, 2).reshape(b, c, h, w) + x


class DownEncoderBlock2D(nn.Module):
    """Resnets, then a stride-2 3x3 conv after a (0, 1, 0, 1) zero pad (the
    diffusers VAE's asymmetric downsample)."""

    def __init__(self, in_ch: int, out_ch: int, num_layers: int, groups: int,
                 add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, None, groups,
                          eps=1e-6) for i in range(num_layers)])
        self.downsamplers = nn.ModuleList([VAEDownsample(out_ch)]) \
            if add_downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.downsamplers is None else self.downsamplers[0](x)


class VAEDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, num_layers: int, groups: int,
                 add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_ch if i == 0 else out_ch, out_ch, None, groups,
                          eps=1e-6) for i in range(num_layers)])
        self.upsamplers = nn.ModuleList([Upsample2D(out_ch)]) \
            if add_upsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        return x if self.upsamplers is None else self.upsamplers[0](x)


class MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(ch, ch, None, groups, eps=1e-6) for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        return self.resnets[1](self.attentions[0](x))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(boc[max(i - 1, 0)], ch, cfg.layers_per_block,
                               g, add_downsample=i != len(boc) - 1)
            for i, ch in enumerate(boc)])
        self.mid_block = MidBlock(boc[-1], g)
        self.conv_norm_out = GroupNorm(g, boc[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out_channels))
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0], g)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rev[max(i - 1, 0)], ch, cfg.layers_per_block + 1,
                             g, add_upsample=i != len(rev) - 1)
            for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode_moments(self, x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Images (B, 3, H, W) in [-1, 1] -> posterior mean and logvar, each
        (B, 4, H/8, W/8); logvar clipped to [-30, 20]."""
        moments = self.quant_conv(
            self.encoder(x.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled latents: a posterior sample mean + exp(logvar / 2) * noise,
        or the mean when ``noise`` is None."""
        mean, logvar = self.encode_moments(x)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.cfg.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1]."""
        z = (z / self.cfg.scaling_factor).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
