"""Kernel entry points, routing rules and launch counts.

Each wrapper takes the tensors the model holds (weights in ``nn.Linear``
layout) and dispatches on the device of its input alone: on ``cpu`` it runs
the plain PyTorch version (``reference.py``); on ``cuda`` it launches the
hand-written kernel, or raises for what the kernel does not take. There is
no fallback from one to the other.

``LAUNCHES`` counts, per kernel, the launches made through its wrapper
(``chip_smoke.py`` reads it to show the main path ran every kernel); K6's
wrapper launches two kernels and counts each.

The routing rules restate the JAX package's decisions as pure functions:
K1/K2 take an attention when Lq*Lk >= 90 000 and the head depth is at most
128 (``core/attention.py`` ``_pallas_route``, ``core/transformer.py``); K3
takes the FeedForward where ``ff_full_fusion_fits`` holds at bf16, K4 every
other one (``core/transformer.py`` ``FeedForward``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import reference

LAUNCHES = {"kvstat_attention": 0, "kvstat_attention_pair": 0,
            "fused_ff": 0, "fused_geglu": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}

KVSTAT_MIN_LOGITS = 90_000
KVSTAT_MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def uses_kvstat(Lq: int, Lk: int, dim_head: int) -> bool:
    """Whether an attention of this shape goes to K1 (or K2, for the
    cross-view pair)."""
    return Lq * Lk >= KVSTAT_MIN_LOGITS and dim_head <= KVSTAT_MAX_HEAD_DIM


# The JAX package's whole-FF routing rule (kernels/geglu.py
# ff_full_fusion_fits) with its byte budget, restated so both packages send
# the same FeedForward widths to the whole-FF kernel. The budget belongs to
# that rule; K3 sizes its own shared-memory plan (csrc/geglu.cu FFLayout).
_FF_RULE_BUDGET = 11 << 20


def ff_full_fusion_fits(K: int, N: int, C: int, esize: int = 2) -> bool:
    """Whether the FeedForward (in K, inner N, out C) goes to K3."""
    fixed = (2 * K * N + N * C) * esize
    bm = 128
    var = bm * K * esize + 2 * bm * N * 4 + bm * N * esize + bm * C * 4
    return fixed + var <= _FF_RULE_BUDGET


# ---------------------------------------------------------------------------


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return False


def _check(name: str, *tensors: Optional[torch.Tensor]) -> None:
    dev = tensors[0].device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, the kernels launch on "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.dtype != torch.bfloat16 or \
                not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous bf16 tensors on one "
                f"device, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")


def _run(fn, *args) -> None:
    from . import build

    rc = fn(*args)
    if rc != 0:
        msg = build.load().mdk_error_string(rc).decode()
        raise RuntimeError(f"{fn.__name__} failed: {msg} ({rc})")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _project_kv(lib, x_kv, wk, wv, heads):
    B, Lk, Ck = x_kv.shape
    D = wk.shape[0] // heads
    k = torch.empty(B, heads, Lk, D, dtype=x_kv.dtype, device=x_kv.device)
    v = torch.empty_like(k)
    _run(lib.mdk_kv_project, _ptr(x_kv), _ptr(wk), _ptr(wv), _ptr(k),
         _ptr(v), B, Lk, Ck, heads, D, _stream())
    return k, v


def kvstat_attention(x_q: torch.Tensor, x_kv: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, heads: int,
                     scale: float) -> torch.Tensor:
    """K1: softmax((x_q Wq^T) scale (x_kv Wk^T)^T) (x_kv Wv^T) per head.
    x_q (B, Lq, C), x_kv (B, Lk, Ck), wq (H*D, C), wk/wv (H*D, Ck) ->
    (B, Lq, H*D) at the logical head depth."""
    if _on_cpu(x_q):
        return reference.kvstat_attention(x_q, x_kv, wq, wk, wv, heads, scale)
    from . import build

    _check("kvstat_attention", x_q, x_kv, wq, wk, wv)
    B, Lq, C = x_q.shape
    D = wq.shape[0] // heads
    if x_kv.shape[0] != B or wq.shape != (heads * D, C) or \
            wk.shape != (heads * D, x_kv.shape[2]) or wv.shape != wk.shape:
        raise ValueError("kvstat_attention: shapes do not agree")
    lib = build.load()
    k, v = _project_kv(lib, x_kv, wk, wv, heads)
    out = torch.empty(B, Lq, heads * D, dtype=x_q.dtype, device=x_q.device)
    _run(lib.mdk_kvstat_attention, _ptr(x_q), _ptr(wq), _ptr(k), _ptr(v),
         _ptr(out), B, Lq, C, x_kv.shape[1], heads, D, float(scale),
         _stream())
    LAUNCHES["kvstat_attention"] += 1
    return out


def kvstat_attention_pair(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, heads: int, scale: float,
                          shifts: Tuple[int, int, int]) -> torch.Tensor:
    """K2: the cross-view pair. Views of x (B, L, C), B a multiple of n,
    attend to their ring neighbours (v + s1) % n and (v + s2) % n with
    separate softmaxes; the two outputs are summed. -> (B, L, H*D)."""
    if _on_cpu(x):
        return reference.kvstat_attention_pair(x, wq, wk, wv, heads, scale,
                                               shifts)
    from . import build

    _check("kvstat_attention_pair", x, wq, wk, wv)
    s1, s2, n = shifts
    B, L, C = x.shape
    D = wq.shape[0] // heads
    if B % n or not (0 <= s1 < n and 0 <= s2 < n) or \
            not wq.shape == wk.shape == wv.shape == (heads * D, C):
        raise ValueError("kvstat_attention_pair: shapes do not agree")
    lib = build.load()
    k, v = _project_kv(lib, x, wk, wv, heads)  # once for every view
    out = torch.empty(B, L, heads * D, dtype=x.dtype, device=x.device)
    _run(lib.mdk_kvstat_attention_pair, _ptr(x), _ptr(wq), _ptr(k), _ptr(v),
         _ptr(out), B, L, C, heads, D, float(scale), s1, s2, n, _stream())
    LAUNCHES["kvstat_attention_pair"] += 1
    return out


def fused_geglu(x: torch.Tensor, w1: torch.Tensor,
                b1: Optional[torch.Tensor]) -> torch.Tensor:
    """K4: (x Wv^T + bv) * gelu_erf(x Wg^T + bg), Wv/Wg the value and gate
    halves of w1 (2N, K). x (..., K) -> (..., N)."""
    if _on_cpu(x):
        return reference.fused_geglu(x, w1, b1)
    from . import build

    _check("fused_geglu", x, w1, b1)
    K = x.shape[-1]
    N = w1.shape[0] // 2
    if w1.shape != (2 * N, K) or (b1 is not None and b1.shape != (2 * N,)):
        raise ValueError("fused_geglu: shapes do not agree")
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    _run(build.load().mdk_geglu, _ptr(x), _ptr(w1), _ptr(b1), _ptr(out),
         M, K, N, _stream())
    LAUNCHES["fused_geglu"] += 1
    return out


def fused_ff(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
             w2: torch.Tensor) -> torch.Tensor:
    """K3: the whole FeedForward but its stage-2 bias,
    bf16(geglu(x)) W2^T with w2 (C, N). x (..., K) -> (..., C)."""
    if _on_cpu(x):
        return reference.fused_ff(x, w1, b1, w2)
    from . import build

    _check("fused_ff", x, w1, b1, w2)
    K = x.shape[-1]
    N = w1.shape[0] // 2
    C = w2.shape[0]
    if w1.shape != (2 * N, K) or w2.shape != (C, N) or \
            (b1 is not None and b1.shape != (2 * N,)):
        raise ValueError("fused_ff: shapes do not agree")
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], C, dtype=x.dtype, device=x.device)
    _run(build.load().mdk_ff, _ptr(x), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(out),
         M, K, N, C, _stream())
    LAUNCHES["fused_ff"] += 1
    return out


def _flash_shapes(name, q, k, kv_len):
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    if k.shape != (BH, Lk, D) or not 0 < kv_len <= Lk or D > 128:
        raise ValueError(f"{name}: shapes do not agree")
    return BH, Lq, Lk, D, kv_len


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: o = softmax(q k^T) v with keys >= kv_len masked, q already
    scaled; q (BH, Lq, D), k/v (BH, Lk, D) -> o (BH, Lq, D) and the fp32
    row logsumexp lse (BH, Lq)."""
    if _on_cpu(q):
        return reference.flash_attention_fwd(q, k, v, kv_len)
    from . import build

    _check("flash_attention_fwd", q, k, v)
    BH, Lq, Lk, D, kv_len = _flash_shapes("flash_attention_fwd", q, k,
                                          kv_len)
    if v.shape != k.shape:
        raise ValueError("flash_attention_fwd: shapes do not agree")
    o = torch.empty_like(q)
    lse = torch.empty(BH, Lq, dtype=torch.float32, device=q.device)
    _run(build.load().mdk_flash_fwd, _ptr(q), _ptr(k), _ptr(v), _ptr(o),
         _ptr(lse), BH, Lq, Lk, D, kv_len, _stream())
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def _flash_bwd_args(name, q, k, v, o, lse, do, kv_len):
    _check(name, q, k, v, o, do)
    BH, Lq, Lk, D, kv_len = _flash_shapes(name, q, k, kv_len)
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (BH, Lq) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: shapes do not agree")
    return (_ptr(q), _ptr(k), _ptr(v), _ptr(o), _ptr(lse), _ptr(do)), \
        (BH, Lq, Lk, D, kv_len, _stream())


def flash_attention_bwd_dq(q, k, v, o, lse, do, kv_len=None) -> torch.Tensor:
    """K6, first launch: dq (BH, Lq, D). CUDA tensors only."""
    from . import build

    ptrs, dims = _flash_bwd_args("flash_attention_bwd_dq", q, k, v, o, lse,
                                 do, kv_len)
    dq = torch.empty_like(q)
    _run(build.load().mdk_flash_bwd_dq, *ptrs, _ptr(dq), *dims)
    LAUNCHES["flash_attention_bwd_dq"] += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, o, lse, do, kv_len=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, second launch: dk and dv (BH, Lk, D). CUDA tensors only."""
    from . import build

    ptrs, dims = _flash_bwd_args("flash_attention_bwd_dkv", q, k, v, o, lse,
                                 do, kv_len)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run(build.load().mdk_flash_bwd_dkv, *ptrs, _ptr(dk), _ptr(dv), *dims)
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: the gradients of K5 given do, from its o and lse, as two
    launches (dq; dk and dv) -> dq (BH, Lq, D), dk and dv (BH, Lk, D)."""
    if _on_cpu(q):
        return reference.flash_attention_bwd(q, k, v, o, lse, do, kv_len)
    dq = flash_attention_bwd_dq(q, k, v, o, lse, do, kv_len)
    return (dq, *flash_attention_bwd_dkv(q, k, v, o, lse, do, kv_len))
