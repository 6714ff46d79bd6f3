"""Gradients of the hand-written kernels (counterpart of the custom VJPs of
``kernels/fused_attention.py`` and ``kernels/geglu.py``).

One gradient per JAX custom VJP; the attention entries (K1, K2, K8, the K8
pair, K5) are ``torch.library`` custom ops (``mdk::*``) with their
gradients registered, so that a selective-checkpoint policy can keep their
outputs (``ATTENTION_OPS``), and K3/K4 are ``torch.autograd.Function``s:
  * K1 (``_fused_kvstat_core``): the backward recomputes q, k and v with
    matrix products, runs the flash forward with logsumexp (K5) on
    ``bf16(f32(q) * scale)``, k and v, then the flash backward (K6), and
    turns dq, dk and dv into the gradients of the hidden states and the
    weights (``_fused_bwd``);
  * K2 (``_kvstat_pair_core``): the K1 backward once per neighbour list on
    the views it gathers; dx_q and the weight gradients are summed over the
    two branches, and each branch's dx_kv is scatter-added back to the
    views it was gathered from (``index_add_``: a view that is no view's
    neighbour gets nothing, one that several views read gets their sum, as
    ``jax.vjp`` of JAX's gather gives);
  * K8 (``_fused_core_out``): dy_heads = bf16(dy Wout) goes through the K1
    backward, and dWout = dy^T o_heads with o_heads recomputed by K7, which
    runs only when dWout is asked for (``_fused_out_bwd``); the K8 pair
    (``_pair_core_out``) runs that once per neighbour list, as K2, and sums
    the two dWout; it computes no K8 primal;
  * K5 (``_flash_core``, the projected route's attention): the backward
    is K6 on the forward's o and lse;
  * K3 (``_ff_core``) and K4 (``_geglu_core``): plain matrix products, as
    the JAX package leaves them to XLA, with its casts (the bf16 product
    x W1 before the bias, dhv and dhg cast to bf16 before their products,
    exact erf).

Every forward and every kernel of a backward is looked up in ``dispatch``
when it runs, so a caller that swaps a wrapper there reaches every call. The
backward computes only the gradients its inputs need
(``ctx.needs_input_grad``): the frozen UNet's attentions and feed-forwards
ask for dx alone. Weights are in ``nn.Linear`` layout (out, in).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import dispatch
from .reference import take_views

Grads = Tuple[Optional[torch.Tensor], ...]


def _to_bh(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H*D) -> (B*H, L, D), contiguous."""
    B, L, HD = t.shape
    return t.reshape(B, L, heads, HD // heads).transpose(1, 2).reshape(
        B * heads, L, HD // heads).contiguous()


def _from_bh(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B*H, L, D) -> (B, L, H*D)."""
    BH, L, D = t.shape
    return t.reshape(BH // heads, heads, L, D).transpose(1, 2).reshape(
        BH // heads, L, heads * D)


def _dw(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The gradient of an ``nn.Linear`` weight: d (..., out), x (..., in) ->
    (out, in)."""
    return d.reshape(-1, d.shape[-1]).t() @ x.reshape(-1, x.shape[-1])


def kvstat_attention_bwd(x_q: torch.Tensor, x_kv: torch.Tensor,
                         wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                         heads: int, scale: float, dy: torch.Tensor,
                         needs: Sequence[bool] = (True,) * 5,
                         ops=dispatch) -> Grads:
    """The backward of K1 at the JAX package's cast points: dy (B, Lq, H*D)
    -> (dx_q, dx_kv, dwq, dwk, dwv), None where ``needs`` is False. ``ops``
    provides ``flash_attention_fwd`` and ``flash_attention_bwd`` (the kernel
    wrappers, or ``reference`` for the plain backward)."""
    dt = x_q.dtype
    q = _to_bh(F.linear(x_q, wq), heads)
    k = _to_bh(F.linear(x_kv, wk), heads)
    v = _to_bh(F.linear(x_kv, wv), heads)
    qs = (q.float() * scale).to(dt)
    o, lse = ops.flash_attention_fwd(qs, k, v)
    dq_s, dk, dv = ops.flash_attention_bwd(qs, k, v, o, lse,
                                           _to_bh(dy.to(dt), heads))
    dq = _from_bh((dq_s.float() * scale).to(dt), heads)
    dk, dv = _from_bh(dk, heads), _from_bh(dv, heads)
    nx_q, nx_kv, nwq, nwk, nwv = needs
    return (dq @ wq if nx_q else None,
            dk @ wk + dv @ wv if nx_kv else None,
            _dw(dq, x_q) if nwq else None,
            _dw(dk, x_kv) if nwk else None,
            _dw(dv, x_kv) if nwv else None)


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]
         ) -> Optional[torch.Tensor]:
    return b if a is None else a + b


def _scatter_views(dx: torch.Tensor, d_taken: torch.Tensor,
                   idx: torch.Tensor, n: int) -> torch.Tensor:
    """The gradient of ``take_views(x, idx, n)``: ``d_taken`` (B*n, ...)
    added into ``dx`` at the views it was gathered from."""
    B = dx.shape[0] // n
    return dx.reshape(B, n, *dx.shape[1:]).index_add(
        1, idx, d_taken.reshape(B, n, *dx.shape[1:])).reshape(dx.shape)


def kvstat_attention_pair_bwd(x: torch.Tensor, wq: torch.Tensor,
                              wk: torch.Tensor, wv: torch.Tensor, heads: int,
                              scale: float, table: torch.Tensor,
                              dy: torch.Tensor,
                              needs: Sequence[bool] = (True,) * 4,
                              ops=dispatch) -> Grads:
    """The backward of K2 over the neighbour ``table`` (2, n): (dx, dwq,
    dwk, dwv), None where ``needs`` is False."""
    n = table.shape[1]
    nx, nwq, nwk, nwv = needs
    dx_q = dwq = dwk = dwv = None
    dx_kv = []
    for idx in table:
        g = kvstat_attention_bwd(x, take_views(x, idx, n), wq, wk, wv, heads,
                                 scale, dy, (nx, nx, nwq, nwk, nwv), ops)
        dx_q, dwq, dwk, dwv = (_add(a, b) for a, b in
                               zip((dx_q, dwq, dwk, dwv), g[:1] + g[2:]))
        dx_kv.append(g[1])
    if nx:
        for idx, d in zip(table, dx_kv):
            dx_q = _scatter_views(dx_q, d, idx, n)
    return dx_q, dwq, dwk, dwv


def fused_qkv_out_attention_bwd(x_q: torch.Tensor, x_kv: torch.Tensor,
                                wq: torch.Tensor, wk: torch.Tensor,
                                wv: torch.Tensor, wout: torch.Tensor,
                                heads: int, scale: float, dy: torch.Tensor,
                                needs: Sequence[bool] = (True,) * 6,
                                ops=dispatch) -> Grads:
    """The backward of K8: dy (B, Lq, C_out) -> (dx_q, dx_kv, dwq, dwk, dwv,
    dwout). ``ops`` also provides ``fused_qkv_attention`` (K7)."""
    dy_heads = (dy @ wout).to(x_q.dtype)
    g = kvstat_attention_bwd(x_q, x_kv, wq, wk, wv, heads, scale, dy_heads,
                             needs[:5], ops)
    dwout = _dw(dy, ops.fused_qkv_attention(x_q, x_kv, wq, wk, wv, heads,
                                            scale)) if needs[5] else None
    return (*g, dwout)


def fused_qkv_out_attention_pair_bwd(x: torch.Tensor, wq: torch.Tensor,
                                     wk: torch.Tensor, wv: torch.Tensor,
                                     wout: torch.Tensor, heads: int,
                                     scale: float, table: torch.Tensor,
                                     dy: torch.Tensor,
                                     needs: Sequence[bool] = (True,) * 5,
                                     ops=dispatch) -> Grads:
    """The backward of the K8 pair: (dx, dwq, dwk, dwv, dwout)."""
    n = table.shape[1]
    dy_heads = (dy @ wout).to(x.dtype)
    g = kvstat_attention_pair_bwd(x, wq, wk, wv, heads, scale, table,
                                  dy_heads, needs[:4], ops)
    dwout = None
    if needs[4]:
        for idx in table:
            o = ops.fused_qkv_attention(x, take_views(x, idx, n), wq, wk, wv,
                                        heads, scale)
            dwout = _add(dwout, _dw(dy, o))
    return (*g, dwout)


def _halves(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 GEGLU halves as the JAX backward recomputes them: the
    product in the input dtype, then the bias in fp32."""
    h = F.linear(x, w1).float()
    if b1 is not None:
        h = h + b1.float()
    return h.chunk(2, dim=-1)


def fused_geglu_bwd(x: torch.Tensor, w1: torch.Tensor,
                    b1: Optional[torch.Tensor], dy: torch.Tensor,
                    needs: Sequence[bool] = (True,) * 3) -> Grads:
    """The backward of K4: dy (..., N) -> (dx, dw1, db1)."""
    dt = x.dtype
    x2 = x.reshape(-1, x.shape[-1])
    hv, hg = _halves(x2, w1, b1)
    dy32 = dy.reshape(hv.shape).float()
    # d gelu(z) = Phi(z) + z phi(z)
    dgelu = 0.5 * (1.0 + torch.erf(hg * math.sqrt(0.5))) + \
        hg * torch.exp(-0.5 * hg * hg) / math.sqrt(2 * math.pi)
    dhv = (dy32 * F.gelu(hg)).to(dt)
    dhg = (dy32 * hv * dgelu).to(dt)
    wv, wg = w1.chunk(2)
    nx, nw, nb = needs
    dx = (dhv @ wv + dhg @ wg).reshape(x.shape) if nx else None
    dw1 = torch.cat([dhv.t() @ x2, dhg.t() @ x2]) if nw else None
    db1 = torch.cat([dhv.sum(0), dhg.sum(0)]) if nb and b1 is not None \
        else None
    return dx, dw1, db1


def fused_ff_bwd(x: torch.Tensor, w1: torch.Tensor,
                 b1: Optional[torch.Tensor], w2: torch.Tensor,
                 dy: torch.Tensor, needs: Sequence[bool] = (True,) * 4
                 ) -> Grads:
    """The backward of K3: dy (..., C) -> (dx, dw1, db1, dw2)."""
    dt = x.dtype
    hv, hg = _halves(x.reshape(-1, x.shape[-1]), w1, b1)
    dy2 = dy.reshape(-1, w2.shape[0]).to(dt)
    dw2 = dy2.t() @ (hv * F.gelu(hg)).to(dt) if needs[3] else None
    dx, dw1, db1 = fused_geglu_bwd(x, w1, b1, dy2 @ w2, needs[:3])
    return dx, dw1, db1, dw2


# The attention entries are ``torch.library`` custom ops with their
# gradients registered, so that a selective-checkpoint policy sees each
# attention's core as one op (``models/unet.py``'s "attn" keeps exactly
# these outputs); an ``autograd.Function``'s ctypes launches are invisible
# to it. Each op runs the ``dispatch`` wrapper looked up when it runs.
_T = torch.Tensor


@torch.library.custom_op("mdk::kvstat_attention", mutates_args=())
def _kvstat_attention_op(x_q: _T, x_kv: _T, wq: _T, wk: _T, wv: _T,
                         heads: int, scale: float) -> _T:
    return dispatch.kvstat_attention(x_q, x_kv, wq, wk, wv, heads, scale)


def _save(ctx, inputs, output) -> None:
    """setup_context of the attention ops: the tensors, then the head
    count and the scale, which come after them in every signature but the
    pairs', whose table comes last and is saved with the tensors."""
    tensors = [t for t in inputs if isinstance(t, torch.Tensor)]
    ctx.save_for_backward(*tensors)
    ctx.heads, ctx.scale = [a for a in inputs
                            if not isinstance(a, torch.Tensor)]


def _kvstat_attention_bwd(ctx, dy):
    return (*kvstat_attention_bwd(*ctx.saved_tensors, ctx.heads, ctx.scale,
                                  dy, ctx.needs_input_grad[:5]),
            None, None)


_kvstat_attention_op.register_autograd(_kvstat_attention_bwd,
                                       setup_context=_save)


@torch.library.custom_op("mdk::kvstat_attention_pair", mutates_args=())
def _kvstat_attention_pair_op(x: _T, wq: _T, wk: _T, wv: _T, heads: int,
                              scale: float, table: _T) -> _T:
    return dispatch.kvstat_attention_pair(x, wq, wk, wv, heads, scale, table)


def _kvstat_attention_pair_bwd(ctx, dy):
    *ins, table = ctx.saved_tensors
    return (*kvstat_attention_pair_bwd(*ins, ctx.heads, ctx.scale, table, dy,
                                       ctx.needs_input_grad[:4]),
            None, None, None)


_kvstat_attention_pair_op.register_autograd(_kvstat_attention_pair_bwd,
                                            setup_context=_save)


@torch.library.custom_op("mdk::fused_qkv_out_attention", mutates_args=())
def _fused_qkv_out_attention_op(x_q: _T, x_kv: _T, wq: _T, wk: _T, wv: _T,
                                wout: _T, heads: int, scale: float) -> _T:
    return dispatch.fused_qkv_out_attention(x_q, x_kv, wq, wk, wv, wout,
                                            heads, scale)


def _fused_qkv_out_attention_bwd(ctx, dy):
    return (*fused_qkv_out_attention_bwd(*ctx.saved_tensors, ctx.heads,
                                         ctx.scale, dy,
                                         ctx.needs_input_grad[:6]),
            None, None)


_fused_qkv_out_attention_op.register_autograd(_fused_qkv_out_attention_bwd,
                                              setup_context=_save)


@torch.library.custom_op("mdk::fused_qkv_out_attention_pair",
                         mutates_args=())
def _fused_qkv_out_attention_pair_op(x: _T, wq: _T, wk: _T, wv: _T,
                                     wout: _T, heads: int, scale: float,
                                     table: _T) -> _T:
    return dispatch.fused_qkv_out_attention_pair(x, wq, wk, wv, wout, heads,
                                                 scale, table)


def _fused_qkv_out_attention_pair_bwd(ctx, dy):
    *ins, table = ctx.saved_tensors
    return (*fused_qkv_out_attention_pair_bwd(
        *ins, ctx.heads, ctx.scale, table, dy, ctx.needs_input_grad[:5]),
        None, None, None)


_fused_qkv_out_attention_pair_op.register_autograd(
    _fused_qkv_out_attention_pair_bwd, setup_context=_save)


@torch.library.custom_op("mdk::flash_attention", mutates_args=())
def _flash_attention_op(q: _T, k: _T, v: _T) -> Tuple[_T, _T]:
    return dispatch.flash_attention_fwd(q, k, v)


def _save_flash(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs, *output)


def _flash_attention_bwd(ctx, do, dlse):
    return dispatch.flash_attention_bwd(*ctx.saved_tensors, do.contiguous())


_flash_attention_op.register_autograd(_flash_attention_bwd,
                                      setup_context=_save_flash)

# the attention cores, as a selective-checkpoint policy sees them
ATTENTION_OPS = tuple(op.default for op in (
    torch.ops.mdk.kvstat_attention, torch.ops.mdk.kvstat_attention_pair,
    torch.ops.mdk.fused_qkv_out_attention,
    torch.ops.mdk.fused_qkv_out_attention_pair,
    torch.ops.mdk.flash_attention))


class FusedGeglu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1):
        ctx.save_for_backward(x, w1, b1)
        return dispatch.fused_geglu(x, w1, b1)

    @staticmethod
    def backward(ctx, dy):
        return fused_geglu_bwd(*ctx.saved_tensors, dy,
                               ctx.needs_input_grad)


class FusedFF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2):
        ctx.save_for_backward(x, w1, b1, w2)
        return dispatch.fused_ff(x, w1, b1, w2)

    @staticmethod
    def backward(ctx, dy):
        return fused_ff_bwd(*ctx.saved_tensors, dy, ctx.needs_input_grad)


def kvstat_attention(x_q: torch.Tensor, x_kv: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, heads: int,
                     scale: float) -> torch.Tensor:
    """K1 with its gradient (``dispatch.kvstat_attention``)."""
    return _kvstat_attention_op(x_q, x_kv, wq, wk, wv, heads, scale)


def kvstat_attention_pair(x: torch.Tensor, wq: torch.Tensor,
                          wk: torch.Tensor, wv: torch.Tensor, heads: int,
                          scale: float, table: torch.Tensor) -> torch.Tensor:
    """K2 with its gradient (``dispatch.kvstat_attention_pair``)."""
    return _kvstat_attention_pair_op(x, wq, wk, wv, heads, scale, table)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, scale: float) -> torch.Tensor:
    """The projected route's attention (``flash_attention``'s function) with
    its gradient: q, k, v (B, L, H*D) projections -> (B, Lq, H*D). q is
    scaled in fp32 and cast back outside the kernel, as the JAX entry folds
    the scale in, so autograd carries the scale into dq; K5 runs the
    heads, K6 their backward."""
    qs = (q.float() * scale).to(q.dtype)
    o, _ = _flash_attention_op(_to_bh(qs, heads), _to_bh(k, heads),
                               _to_bh(v, heads))
    return _from_bh(o, heads)


def fused_geglu(x: torch.Tensor, w1: torch.Tensor,
                b1: Optional[torch.Tensor]) -> torch.Tensor:
    """K4 with its gradient (``dispatch.fused_geglu``)."""
    return FusedGeglu.apply(x, w1, b1)


def fused_ff(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
             w2: torch.Tensor) -> torch.Tensor:
    """K3 with its gradient (``dispatch.fused_ff``)."""
    return FusedFF.apply(x, w1, b1, w2)


def fused_qkv_out_attention(x_q: torch.Tensor, x_kv: torch.Tensor,
                            wq: torch.Tensor, wk: torch.Tensor,
                            wv: torch.Tensor, wout: torch.Tensor, heads: int,
                            scale: float) -> torch.Tensor:
    """K8 with its gradient (``dispatch.fused_qkv_out_attention``)."""
    return _fused_qkv_out_attention_op(x_q, x_kv, wq, wk, wv, wout, heads,
                                       scale)


def fused_qkv_out_attention_pair(x: torch.Tensor, wq: torch.Tensor,
                                 wk: torch.Tensor, wv: torch.Tensor,
                                 wout: torch.Tensor, heads: int, scale: float,
                                 table: torch.Tensor) -> torch.Tensor:
    """The K8 pair with its gradient
    (``dispatch.fused_qkv_out_attention_pair``)."""
    return _fused_qkv_out_attention_pair_op(x, wq, wk, wv, wout, heads,
                                            scale, table)
