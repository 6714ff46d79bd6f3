"""Attention with diffusers ``Attention`` semantics (counterpart of
``core/attention.py``).

Shapes with Lq*Lk >= 90 000 and a head depth of at most 128 go to a
kernel (``kernels.dispatch.attention_route``): K1, whose output is
out-projected here, or K8 under ``MAGICDRIVE_FUSED_MODE=auto`` where it
fits, which out-projects in the kernel and leaves the bias to this module;
where neither projection-fused kernel fits, the projected route: q/k/v by
the module's linears, then K5 (the JAX package's lane-padded projections
and flash kernel; the padding is a TPU layout and is left out). Their
gradients come from ``kernels.autograd``. Every other attention projects
q/k/v with ``nn.Linear`` and runs ``F.scaled_dot_product_attention``, as
the JAX package left those shapes to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from magicdrive_tpu_torch.kernels import autograd, dispatch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
         scale: float) -> torch.Tensor:
    """Multi-head attention on (B, L, H*D) projections -> (B, Lq, H*D)."""
    B, Lq, HD = q.shape
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, -1
                                ).transpose(1, 2)
    o = F.scaled_dot_product_attention(split(q), split(k), split(v),
                                       scale=scale)
    return o.transpose(1, 2).reshape(B, Lq, HD)


class Attention(nn.Module):
    """Bias-free q/k/v projections, ``to_out.0`` with bias; query from
    ``x``, key/value from ``context`` (``x`` itself when None).

    ``project_out(o, n_summed=k)`` is the sum of ``k`` out-projections of
    per-branch outputs whose sum is ``o``: ``o W^T + k * bias``."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 cross_attention_dim: Optional[int] = None,
                 qkv_bias: bool = False, out_bias: bool = True):
        super().__init__()
        inner = heads * dim_head
        kv_dim = cross_attention_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.scale = dim_head ** -0.5
        self.to_q = nn.Linear(query_dim, inner, bias=qkv_bias)
        self.to_k = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_v = nn.Linear(kv_dim, inner, bias=qkv_bias)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim,
                                               bias=out_bias)])

    def project_out(self, o: torch.Tensor, n_summed: int = 1) -> torch.Tensor:
        lin = self.to_out[0]
        y = F.linear(o, lin.weight)
        return y if lin.bias is None else y + n_summed * lin.bias

    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        route = None if self.to_q.bias is not None else \
            dispatch.attention_route(
                x.shape[-2], context.shape[-2],
                max(x.shape[-1], context.shape[-1]), self.dim_head,
                x.element_size())
        w = (self.to_q.weight, self.to_k.weight, self.to_v.weight)
        if route == "out":
            lin = self.to_out[0]
            y = autograd.fused_qkv_out_attention(x, context, *w, lin.weight,
                                                 self.heads, self.scale)
            return y if lin.bias is None else y + lin.bias
        if route == "kvstat":
            o = autograd.kvstat_attention(x, context, *w, self.heads,
                                          self.scale)
        elif route == "projected":
            o = autograd.flash_attention(self.to_q(x), self.to_k(context),
                                         self.to_v(context), self.heads,
                                         self.scale)
        else:
            o = sdpa(self.to_q(x), self.to_k(context), self.to_v(context),
                     self.heads, self.scale)
        return self.project_out(o)
