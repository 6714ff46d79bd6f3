"""Fourier and timestep embeddings (counterpart of ``core/embeddings.py``)."""
from __future__ import annotations

import math

import torch


def fourier_embed(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """NeRF-style embedding over the last axis, log-sampled frequencies
    2**i: ``[x, sin(x*f0), cos(x*f0), sin(x*f1), cos(x*f1), ...]``
    (ref:magicdrive/networks/embedder.py:15-40)."""
    freqs = 2.0 ** torch.linspace(0.0, num_freqs - 1, num_freqs,
                                  device=x.device)
    xf = x[..., None, :] * freqs[:, None].to(x.dtype)   # (..., F, d)
    sc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, d)
    sc = sc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    return torch.cat([x, sc], dim=-1)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           max_period: int = 10000) -> torch.Tensor:
    """diffusers' sinusoidal embedding with SD-v1.5 settings
    (flip_sin_to_cos=True, freq_shift=0): ``[cos | sin]``, in float32."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb
