"""Transformer blocks with the multi-view (cross-view) attention (counterpart
of ``core/transformer.py``).

Sequences arrive flattened as (B*N_cam, L, C) with the views innermost.
The cross-view attention runs in "add" mode over ring neighbours (view v
reads views (v + s1) % n and (v + s2) % n) with a zero_linear connector.
The video model's temporal attention runs over the frames of each view
and position, the batch then laid out (B*F*N_cam) with views innermost,
through a zero_linear connector of its own.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdrive_tpu_torch.core.attention import Attention, sdpa
from magicdrive_tpu_torch.core.resnet import GroupNorm
from magicdrive_tpu_torch.kernels import autograd, dispatch
from magicdrive_tpu_torch.kernels.reference import ring_views


class LayerNorm32(nn.LayerNorm):
    """LayerNorm with float32 statistics; output in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class GEGLU(nn.Module):
    """Holds ``ff.net.0.proj``: value rows first, gate rows second."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU feed-forward: K3 (whole FF) where ``ff_full_fusion_fits``
    holds for the input's element size, as the JAX package decides, else K4
    (stage 1) followed by the stage-2 ``nn.Linear``; their gradients come
    from ``kernels.autograd``."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.dim, self.inner = dim, dim * mult
        self.net = nn.ModuleList([GEGLU(dim, self.inner), nn.Identity(),
                                  nn.Linear(self.inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        if dispatch.ff_full_fusion_fits(self.dim, self.inner, self.dim,
                                        x.element_size()):
            return autograd.fused_ff(x, proj.weight, proj.bias,
                                     out.weight) + out.bias
        return out(autograd.fused_geglu(x, proj.weight, proj.bias))


def ring_shift(idx: Sequence[int], n: int) -> Optional[int]:
    """s such that idx[i] == (i + s) % n for every view i, else None."""
    idx = list(idx)
    if len(idx) != n:
        return None
    s = idx[0] % n
    return s if all(j == (i + s) % n for i, j in enumerate(idx)) else None


def _zero_linear(dim: int) -> nn.Linear:
    lin = nn.Linear(dim, dim)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


class BasicTransformerBlock(nn.Module):
    """Self-attention, text cross-attention, optional cross-view attention
    (``attn4``, between attn2 and the FF, through a zero-init linear
    ``connector``), optional temporal attention over ``temporal_frames``
    frames (``attn_temp``, after the cross-view one, through the zero-init
    ``connector_temp``) and the GEGLU feed-forward, each pre-normed and
    residual. At init the zero connectors make the block the stock SD
    block."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 cross_attention_dim: int,
                 neighboring_view_pair: Optional[
                     Tuple[Tuple[int, int], ...]] = None,
                 temporal_frames: Optional[int] = None):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = Attention(dim, n_heads, d_head)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = Attention(dim, n_heads, d_head,
                               cross_attention_dim=cross_attention_dim)
        self.shifts = None
        if neighboring_view_pair is not None:
            n = len(neighboring_view_pair)
            shifts = tuple(ring_shift([p[i] for p in neighboring_view_pair],
                                      n) for i in range(2))
            if any(len(p) != 2 for p in neighboring_view_pair) or \
                    None in shifts:
                raise ValueError("cross-view attention takes two ring "
                                 f"neighbours per view, got "
                                 f"{neighboring_view_pair}")
            self.shifts = (*shifts, n)
            self.norm4 = LayerNorm32(dim)
            self.attn4 = Attention(dim, n_heads, d_head,
                                   cross_attention_dim=dim)
            self.connector = _zero_linear(dim)
        self.frames = None
        if temporal_frames is not None and temporal_frames > 1:
            # (frames, views): the batch is (B*F*n) with the views innermost
            self.frames = (temporal_frames, len(neighboring_view_pair)
                           if neighboring_view_pair else 1)
            self.norm_temp = LayerNorm32(dim)
            self.attn_temp = Attention(dim, n_heads, d_head)
            self.connector_temp = _zero_linear(dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        if self.shifts is not None:
            x = self.connector(self._cross_view(self.norm4(x))) + x
        if self.frames is not None:
            x = self.connector_temp(self._temporal(self.norm_temp(x))) + x
        return self.ff(self.norm3(x)) + x

    def _temporal(self, h: torch.Tensor) -> torch.Tensor:
        """Self-attention over the frames at each view and position:
        (b f n) l c -> (b n l) f c, ``attn_temp`` (Lq = Lk = F, under the
        kernels' threshold: SDPA, as the JAX package leaves it to XLA), and
        back (JAX ``core/transformer.py`` ``_temporal``)."""
        f, n = self.frames
        bfn, L, C = h.shape
        b = bfn // (f * n)
        h = h.reshape(b, f, n, L, C).permute(0, 2, 3, 1, 4)
        o = self.attn_temp(h.reshape(b * n * L, f, C))
        return o.reshape(b, n, L, f, C).permute(0, 3, 1, 2, 4).reshape(
            bfn, L, C)

    def _cross_view(self, h: torch.Tensor) -> torch.Tensor:
        """Sum over the two ring neighbours of separate attentions, out-
        projected with the bias counted twice (ref:blocks.py:213-217): by
        K2 and ``project_out``, by the K8 pair, or, where the pair's rule
        fails, one attention per neighbour summed in the working dtype (JAX
        ``core/transformer.py`` ``_cross_view``): K1's outputs then
        ``project_out``, K8's out-projected outputs then the bias twice, or
        the projected route's (or SDPA's) outputs then ``project_out``."""
        a = self.attn4
        s1, s2, n = self.shifts
        L = h.shape[-2]
        route = dispatch.pair_route(L, h.shape[-1], a.dim_head,
                                    h.element_size())
        w = (a.to_q.weight, a.to_k.weight, a.to_v.weight)
        lin = a.to_out[0]
        if route in ("out", "out_loop"):
            if route == "out":
                y = autograd.fused_qkv_out_attention_pair(
                    h, *w, lin.weight, a.heads, a.scale, self.shifts)
            else:
                y = sum(autograd.fused_qkv_out_attention(
                    h, ring_views(h, s, n), *w, lin.weight, a.heads, a.scale)
                    for s in (s1, s2))
            return y if lin.bias is None else y + 2 * lin.bias
        if route == "kvstat":
            o = autograd.kvstat_attention_pair(h, *w, a.heads, a.scale,
                                               self.shifts)
        elif route == "kvstat_loop":
            o = sum(autograd.kvstat_attention(h, ring_views(h, s, n), *w,
                                              a.heads, a.scale)
                    for s in (s1, s2))
        else:
            attend = autograd.flash_attention if route == "projected_loop" \
                else sdpa
            q, k, v = a.to_q(h), a.to_k(h), a.to_v(h)
            o = sum(attend(q, ring_views(k, s, n), ring_views(v, s, n),
                           a.heads, a.scale) for s in (s1, s2))
        return a.project_out(o, n_summed=2)


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) -> 1x1 proj_in -> one block -> 1x1 proj_out +
    residual (SD-v1.5, use_linear_projection=False). NCHW."""

    def __init__(self, n_heads: int, d_head: int, cross_attention_dim: int,
                 norm_num_groups: int,
                 neighboring_view_pair: Optional[
                     Tuple[Tuple[int, int], ...]] = None,
                 temporal_frames: Optional[int] = None):
        super().__init__()
        c = n_heads * d_head
        self.norm = GroupNorm(norm_num_groups, c, eps=1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            c, n_heads, d_head, cross_attention_dim, neighboring_view_pair,
            temporal_frames)])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wdt = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(b, hgt * wdt, c)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.reshape(b, hgt, wdt, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x
