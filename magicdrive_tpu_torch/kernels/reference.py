"""Plain PyTorch versions of the hand-written kernels (K1-K8).

Each computes the same function as its CUDA kernel with the same cast
points (the JAX kernels' own): projections accumulate in fp32, q is scaled
in fp32 and cast to the input dtype, k and v are cast to the input dtype,
logits and softmax statistics are fp32, p is cast to the input dtype before
PV, o is divided by the row sum in fp32; the GEGLU halves and biases are
fp32 and the gated product is cast before stage 2. The flash forward (K5)
and backward (K6) take (BH, L, D) tensors with q already scaled, mask keys at
positions >= kv_len, and cast p and ds to the input dtype before their
products; lse and every accumulation are fp32. K7 computes K1's function;
K8 casts each head's normalised o (the pair: the fp32 sum of its two) to the
input dtype and out-projects it with fp32 accumulation, cast once, without
the bias. Weights are in ``nn.Linear`` layout (out, in).

Every cast point casts to the input's dtype, so at fp32 each is the
identity: that is the contract of the kernels' fp32 instances
(``csrc/f32_*.cu``), as of the JAX kernels at the element size 4.

On the CPU the port runs through these functions; the tests hold them
against the JAX Pallas kernels in interpret mode, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


# The plain attentions materialise their fp32 logits, so they run over
# slices of the batch axis whose logits stay within LOGIT_BYTES (12 views of
# 8 heads at L=5300 hold 10.8 GB of them); the items are independent, so the
# slices change no value.
LOGIT_BYTES = 1 << 30


def _by_batch(fn, logits_per_item: int, *ts: torch.Tensor):
    """``fn(*ts)``, run on slices of the leading axis of ``ts`` and
    concatenated (each output, for a tuple)."""
    n = ts[0].shape[0]
    step = max(1, LOGIT_BYTES // (4 * logits_per_item))
    if step >= n:
        return fn(*ts)
    outs = [fn(*(t[i:i + step] for t in ts)) for i in range(0, n, step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def _linear32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float().t()


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, L, HD = t.shape
    return t.reshape(B, L, heads, HD // heads).transpose(1, 2)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int) -> torch.Tensor:
    """softmax(q k^T) v per head; q already scaled. (B, Lq, H*D) fp32."""
    return _by_batch(lambda *t: _attend_all(*t, heads),
                     heads * q.shape[1] * k.shape[1], q, k, v)


def _attend_all(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                heads: int) -> torch.Tensor:
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    s = qh.float() @ kh.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (p.to(q.dtype).float() @ vh.float()) / p.sum(-1, keepdim=True)
    B, _, Lq, D = o.shape
    return o.transpose(1, 2).reshape(B, Lq, heads * D)


def _project(x_q, x_kv, wq, wk, wv, scale):
    dt = x_q.dtype
    q = (_linear32(x_q, wq) * scale).to(dt)
    return q, _linear32(x_kv, wk).to(dt), _linear32(x_kv, wv).to(dt)


def kvstat_attention(x_q: torch.Tensor, x_kv: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, heads: int,
                     scale: float) -> torch.Tensor:
    """K1. x_q (B, Lq, C), x_kv (B, Lk, Ck) -> (B, Lq, H*D)."""
    q, k, v = _project(x_q, x_kv, wq, wk, wv, scale)
    return _attend(q, k, v, heads).to(x_q.dtype)


def ring_table(shifts: Sequence[int], n: int) -> torch.Tensor:
    """The neighbour table of a ring over n views: row i lists
    (v + shifts[i]) % n for v = 0..n-1 (int32, on the CPU)."""
    return torch.tensor([[(v + s) % n for v in range(n)] for s in shifts],
                        dtype=torch.int32)


def take_views(t: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Views gathered by a neighbour list on a flattened (B*n, ...) batch
    of n views a sample: out[(b, j)] = t[(b, idx[j])], (B*m, ...) for m
    indices (JAX ``core/transformer.py`` ``_take_views``)."""
    tv = t.reshape(t.shape[0] // n, n, *t.shape[1:])
    return tv.index_select(1, idx).reshape(-1, *t.shape[1:])


def kvstat_attention_pair(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, heads: int, scale: float,
                          table: torch.Tensor) -> torch.Tensor:
    """K2. The sum over the two neighbour lists of ``table`` (2, n) of
    separate softmax attentions, summed in fp32: view v of a sample attends
    to k and v projected from views table[0, v] and table[1, v] of the same
    sample. x (B, L, C), B a multiple of n -> (B, L, H*D)."""
    n = table.shape[1]
    q, k, v = _project(x, x, wq, wk, wv, scale)
    o = sum(_attend(q, take_views(k, idx, n), take_views(v, idx, n), heads)
            for idx in table)
    return o.to(x.dtype)


# K7 computes K1's function (the JAX kernels share their cast points); only
# the kernel's plan differs
fused_qkv_attention = kvstat_attention


def out_projection(o: torch.Tensor, wout: torch.Tensor) -> torch.Tensor:
    """The out-projection launch of K8 and its pair: o (B, Lq, H*D) in the
    input dtype times Wout^T, wout (C_out, H*D), accumulated in fp32 and
    cast once -> (B, Lq, C_out)."""
    return _linear32(o, wout).to(o.dtype)


def fused_qkv_out_attention(x_q: torch.Tensor, x_kv: torch.Tensor,
                            wq: torch.Tensor, wk: torch.Tensor,
                            wv: torch.Tensor, wout: torch.Tensor, heads: int,
                            scale: float) -> torch.Tensor:
    """K8. K1's output out-projected: -> (B, Lq, C_out)."""
    return out_projection(
        kvstat_attention(x_q, x_kv, wq, wk, wv, heads, scale), wout)


def fused_qkv_out_attention_pair(x: torch.Tensor, wq: torch.Tensor,
                                 wk: torch.Tensor, wv: torch.Tensor,
                                 wout: torch.Tensor, heads: int, scale: float,
                                 table: torch.Tensor) -> torch.Tensor:
    """The K8 pair. K2's output (the fp32 sum, cast once) out-projected."""
    return out_projection(
        kvstat_attention_pair(x, wq, wk, wv, heads, scale, table), wout)


def _gated(x: torch.Tensor, w1: torch.Tensor,
           b1: Optional[torch.Tensor]) -> torch.Tensor:
    h = _linear32(x, w1)
    if b1 is not None:
        h = h + b1.float()
    hv, hg = h.chunk(2, dim=-1)
    return hv * F.gelu(hg)  # exact erf GELU


def fused_geglu(x: torch.Tensor, w1: torch.Tensor,
                b1: Optional[torch.Tensor]) -> torch.Tensor:
    """K4. (x Wv + bv) * gelu(x Wg + bg): x (..., K) -> (..., N)."""
    return _gated(x, w1, b1).to(x.dtype)


def fused_ff(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
             w2: torch.Tensor) -> torch.Tensor:
    """K3. the FeedForward without its stage-2 bias: x (..., K) -> (..., C)."""
    return _linear32(_gated(x, w1, b1).to(x.dtype), w2).to(x.dtype)


NEG_INF = -1e30  # the masked logit of the JAX kernels


def _masked_logits(q: torch.Tensor, k: torch.Tensor,
                   kv_len: Optional[int]) -> torch.Tensor:
    s = q.float() @ k.float().transpose(-1, -2)
    if kv_len is not None and kv_len < k.shape[-2]:
        s[..., kv_len:] = NEG_INF
    return s


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5. q (BH, Lq, D) pre-scaled, k/v (BH, Lk, D) -> o (BH, Lq, D) in
    q's dtype and lse (BH, Lq) fp32."""
    return _by_batch(lambda *t: _flash_fwd(*t, kv_len),
                     q.shape[1] * k.shape[1], q, k, v)


def _flash_fwd(q, k, v, kv_len):
    s = _masked_logits(q, k, kv_len)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, torch.ones_like(l), l)
    o = (p.to(v.dtype).float() @ v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6. The gradients of K5's o with respect to (q, k, v) given do,
    from o and lse: dq (BH, Lq, D), dk and dv (BH, Lk, D) in q's dtype."""
    return _by_batch(lambda *t: _flash_bwd(*t, kv_len),
                     q.shape[1] * k.shape[1], q, k, v, o, lse, do)


def _flash_bwd(q, k, v, o, lse, do, kv_len):
    dt = q.dtype
    p = torch.exp(_masked_logits(q, k, kv_len) - lse[..., None])
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta)
    ds16 = ds.to(dt).float()
    dq = ds16 @ k.float()
    dk = ds16.transpose(-1, -2) @ q.float()
    dv = p.to(dt).float().transpose(-1, -2) @ do.float()
    return dq.to(dt), dk.to(dt), dv.to(dt)


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """K6's row term delta = rowsum(do * o) in fp32: (BH, Lq)."""
    return (do.float() * o.float()).sum(-1)


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           o: torch.Tensor, lse: torch.Tensor,
                           do: torch.Tensor, kv_len: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's first launch: dq (BH, Lq, D) and delta (BH, Lq) fp32."""
    return (flash_attention_bwd(q, k, v, o, lse, do, kv_len)[0],
            flash_delta(o, do))


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, do: torch.Tensor,
                            kv_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's second launch: dk and dv (BH, Lk, D) from lse and delta, with
    ``flash_attention_bwd``'s cast points."""
    return _by_batch(lambda *t: _flash_bwd_dkv(*t, kv_len),
                     q.shape[1] * k.shape[1], q, k, v, lse, delta, do)


def _flash_bwd_dkv(q, k, v, lse, delta, do, kv_len):
    dt = q.dtype
    p = torch.exp(_masked_logits(q, k, kv_len) - lse[..., None])
    ds = p * (do.float() @ v.float().transpose(-1, -2) - delta[..., None])
    dk = ds.to(dt).float().transpose(-1, -2) @ q.float()
    dv = p.to(dt).float().transpose(-1, -2) @ do.float()
    return dk.to(dt), dv.to(dt)
