"""Transformer blocks with the multi-view (cross-view) attention (counterpart
of ``core/transformer.py``).

Sequences arrive flattened as (B*N_cam, L, C) with the views innermost.
The cross-view attention reads each view's neighbours through a table of
view indices, in "add", "concat" or "self" form, through a zero_linear,
gated or no connector (``BasicTransformerBlock``). The video model's
temporal attention runs over the frames of each view and position, the
batch then laid out (B*F*N_cam) with views innermost, through a connector
of the same kind.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from magicdrive_tpu_torch.core.attention import Attention, sdpa
from magicdrive_tpu_torch.core.resnet import GroupNorm
from magicdrive_tpu_torch.kernels import autograd, dispatch
from magicdrive_tpu_torch.kernels.reference import take_views
from magicdrive_tpu_torch.parallel.mesh import (gather_views, local_views,
                                               view_mesh)


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


class GatedConnector(nn.Module):
    """tanh(alpha) * x with alpha (dim,) zero at init, the tanh taken in fp32
    and cast to x's dtype (JAX ``core/transformer.py`` ``GatedConnector``,
    ref:blocks.py:24-32)."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.alpha.float()).to(x.dtype) * x


def _zero_linear(dim: int) -> nn.Linear:
    lin = nn.Linear(dim, dim)
    nn.init.zeros_(lin.weight)
    nn.init.zeros_(lin.bias)
    return lin


ATTN_TYPES = ("add", "concat", "self")
ZERO_MODULE_TYPES = ("zero_linear", "gated", "none")


def _connector(kind: str, dim: int) -> nn.Module:
    """The zero-init module a cross-view or temporal output passes through
    (ref:blocks.py:139-151): a zero linear, the gated tanh, or none (an
    identity without parameters)."""
    if kind == "zero_linear":
        return _zero_linear(dim)
    if kind == "gated":
        return GatedConnector(dim)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"zero_module_type {kind!r}: one of {ZERO_MODULE_TYPES}")


def neighbour_table(neighboring_view_pair: Sequence[Sequence[int]]
                    ) -> torch.Tensor:
    """The (k, n) int32 table of a neighbour list, n views of k neighbours
    each: row i holds every view's i-th neighbour."""
    pairs = [list(p) for p in neighboring_view_pair]
    n = len(pairs)
    k = len(pairs[0]) if pairs else 0
    if k < 1 or any(len(p) != k for p in pairs) or \
            any(not 0 <= j < n for p in pairs for j in p):
        raise ValueError(f"neighboring_view_pair: every one of the {n} views "
                         f"takes the same number (>= 1) of neighbours among "
                         f"them, got {neighboring_view_pair}")
    return torch.tensor(pairs, dtype=torch.int32).t().contiguous()


class BasicTransformerBlock(nn.Module):
    """Self-attention, text cross-attention, optional cross-view attention
    (``attn4``, between attn2 and the FF, through the zero-init
    ``connector``), optional temporal attention over ``temporal_frames``
    frames (``attn_temp``, after the cross-view one, through the zero-init
    ``connector_temp``) and the GEGLU feed-forward, each pre-normed and
    residual. At init the zero connectors make the block the stock SD
    block.

    The cross-view attention takes ``neighboring_view_pair``, k neighbours
    for each of the n views (the ``neighbors`` buffer, the (k, n) table),
    in the form ``neighboring_attn_type`` (JAX ``core/transformer.py``
    ``_cross_view``):
      * "add": one attention per neighbour list, the outputs summed and
        out-projected with the bias counted k times (ref:blocks.py:
        213-217): K2 or the K8 pair where k = 2 and the pair's rule holds,
        else one K1, K8, projected (K5) or SDPA attention per neighbour,
        summed in the working dtype (``dispatch.pair_route``);
      * "concat": one attention whose keys and values are the k neighbours'
        views end to end (Lk = k L), routed as any attention, the bias once;
      * "self": one attention over the (n l) tokens of a sample.
    ``zero_module_type`` picks both connectors: a zero linear, the gated
    tanh (``GatedConnector``) or none."""

    def __init__(self, dim: int, n_heads: int, d_head: int,
                 cross_attention_dim: int,
                 neighboring_view_pair: Optional[
                     Tuple[Tuple[int, ...], ...]] = None,
                 temporal_frames: Optional[int] = None,
                 neighboring_attn_type: str = "add",
                 zero_module_type: str = "zero_linear"):
        super().__init__()
        self.norm1 = LayerNorm32(dim)
        self.attn1 = Attention(dim, n_heads, d_head)
        self.norm2 = LayerNorm32(dim)
        self.attn2 = Attention(dim, n_heads, d_head,
                               cross_attention_dim=cross_attention_dim)
        self.cross_view = neighboring_view_pair is not None
        if self.cross_view:
            if neighboring_attn_type not in ATTN_TYPES:
                raise ValueError(f"neighboring_attn_type "
                                 f"{neighboring_attn_type!r}: one of "
                                 f"{ATTN_TYPES}")
            self.attn_type = neighboring_attn_type
            self.register_buffer("neighbors",
                                 neighbour_table(neighboring_view_pair),
                                 persistent=False)
            self.norm4 = LayerNorm32(dim)
            self.attn4 = Attention(dim, n_heads, d_head,
                                   cross_attention_dim=dim)
            self.connector = _connector(zero_module_type, dim)
        self.frames = None
        if temporal_frames is not None and temporal_frames > 1:
            # (frames, views): the batch is (B*F*n) with the views innermost
            self.frames = (temporal_frames, len(neighboring_view_pair)
                           if neighboring_view_pair else 1)
            self.norm_temp = LayerNorm32(dim)
            self.attn_temp = Attention(dim, n_heads, d_head)
            self.connector_temp = _connector(zero_module_type, dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        if self.cross_view:
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
        """The cross-view attention of h (B*n, L, C), before the
        connector. Under a view-sharded pipeline (``parallel.mesh.
        sharded_views``) h holds this rank's m = n / view cameras of each
        sample: the queries stay local, and the neighbours are read from
        the normed hidden states of all n cameras, gathered over the view
        group. K2 and the K8 pair take their queries and keys from one
        tensor, so there the "add" form takes their per-neighbour routes
        (K1 or K8 once a neighbour list), which compute only the local
        queries' rows."""
        a, table = self.attn4, self.neighbors
        k, n = table.shape
        BN, L, C = h.shape
        src, mesh = h, view_mesh()
        if mesh is not None:
            table = table[:, local_views(mesh, n)]
            src = gather_views(h, mesh, table.shape[1])
        m = table.shape[1]  # the query cameras of a sample
        if self.attn_type == "self":
            if src is h:
                return a(h.reshape(BN // n, n * L, C)).reshape(BN, L, C)
            return a(h.reshape(BN // m, m * L, C),
                     src.reshape(BN // m, n * L, C)).reshape(BN, L, C)
        if self.attn_type == "concat":
            return a(h, take_views(src, table.t().reshape(-1), n).reshape(
                BN, k * L, C))
        route = dispatch.pair_route(L, C, a.dim_head, h.element_size(), k)
        if src is not h and route in ("kvstat", "out"):
            route += "_loop"
        w = (a.to_q.weight, a.to_k.weight, a.to_v.weight)
        lin = a.to_out[0]
        if route in ("out", "out_loop"):
            if route == "out":
                y = autograd.fused_qkv_out_attention_pair(
                    h, *w, lin.weight, a.heads, a.scale, table)
            else:
                y = sum(autograd.fused_qkv_out_attention(
                    h, take_views(src, idx, n), *w, lin.weight, a.heads,
                    a.scale) for idx in table)
            return y if lin.bias is None else y + k * lin.bias
        if route == "kvstat":
            o = autograd.kvstat_attention_pair(h, *w, a.heads, a.scale,
                                               table)
        elif route == "kvstat_loop":
            o = sum(autograd.kvstat_attention(h, take_views(src, idx, n),
                                              *w, a.heads, a.scale)
                    for idx in table)
        else:
            attend = autograd.flash_attention if route == "projected_loop" \
                else sdpa
            q, kk, vv = a.to_q(h), a.to_k(src), a.to_v(src)
            o = sum(attend(q, take_views(kk, idx, n), take_views(vv, idx, n),
                           a.heads, a.scale) for idx in table)
        return a.project_out(o, n_summed=k)


class Transformer2DModel(nn.Module):
    """GroupNorm (eps 1e-6) -> 1x1 proj_in -> one block -> 1x1 proj_out +
    residual (SD-v1.5, use_linear_projection=False). NCHW."""

    def __init__(self, n_heads: int, d_head: int, cross_attention_dim: int,
                 norm_num_groups: int,
                 neighboring_view_pair: Optional[
                     Tuple[Tuple[int, ...], ...]] = None,
                 temporal_frames: Optional[int] = None,
                 neighboring_attn_type: str = "add",
                 zero_module_type: str = "zero_linear"):
        super().__init__()
        c = n_heads * d_head
        self.norm = GroupNorm(norm_num_groups, c, eps=1e-6)
        self.proj_in = nn.Conv2d(c, c, 1)
        self.transformer_blocks = nn.ModuleList([BasicTransformerBlock(
            c, n_heads, d_head, cross_attention_dim, neighboring_view_pair,
            temporal_frames, neighboring_attn_type, zero_module_type)])
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wdt = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(b, hgt * wdt, c)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        h = h.reshape(b, hgt, wdt, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x
