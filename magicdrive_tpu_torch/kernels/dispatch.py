"""Kernel entry points, routing rules and launch counts.

Each wrapper takes the tensors the model holds (weights in ``nn.Linear``
layout) and dispatches on the device of its input alone: on ``cpu`` it runs
the plain PyTorch version (``reference.py``); on ``cuda`` it launches the
hand-written kernel, or raises for what the kernel does not take. There is
no fallback from one to the other. Every kernel has a bf16 and an fp32
instance (``csrc/f32_*.cu``, the C entries named with ``_f32``): a call
whose floating tensors are all bf16 launches the first, one whose floating
tensors are all fp32 the second, and any other call raises.

``LAUNCHES`` counts, per kernel, the launches made through its wrapper
at either element size (``chip_smoke.py`` reads it to show the main path
ran every kernel); K6's wrapper launches two kernels and counts each. The
attention wrappers count one per call: K1, K2 and K7 are the kv
projection and the heads' kernel, K8 and its pair add the
out-projection.

The routing rules restate the JAX package's decisions as pure functions of
ints, so both packages send each shape to the same kernel:
  * an attention is a kernel's when Lq*Lk >= 90 000 and the head depth is
    at most 128 (``core/attention.py`` ``_pallas_route``), else SDPA;
  * ``fused_mode_for`` then picks K1 ("kvstat") or K8 ("out") by the JAX
    package's VMEM fit rules under ``FUSED_MODE`` (``core/attention.py``
    ``fused_mode_for``), or neither: the projected route, the module's
    projections and then K5; the cross-view "add" attention over two
    neighbour lists takes K2 or the K8 pair where the pair's own rule
    holds, else one K1, K8 or projected attention per neighbour
    (``core/transformer.py`` ``_cross_view``);
  * K3 takes the FeedForward where ``ff_full_fusion_fits`` holds, K4 every
    other one (``core/transformer.py`` ``FeedForward``).
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

import torch

from . import reference

LAUNCHES = {"kvstat_attention": 0, "kvstat_attention_pair": 0,
            "fused_ff": 0, "fused_geglu": 0, "flash_attention_fwd": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
            "fused_qkv_attention": 0, "fused_qkv_out_attention": 0,
            "fused_qkv_out_attention_pair": 0}

MIN_LOGITS = 90_000
MAX_HEAD_DIM = 128

FUSED_MODES = ("kvstat", "auto")


def _mode_from_env() -> str:
    mode = os.environ.get("MAGICDRIVE_FUSED_MODE", "kvstat")
    if mode not in FUSED_MODES:
        raise ValueError(f"MAGICDRIVE_FUSED_MODE={mode!r}: takes one of "
                         f"{FUSED_MODES}")
    return mode


# "kvstat": K1/K2 wherever they fit; "auto": K8 (and its pair) where the
# q-block count is at most 2, K1/K2 beyond. Read once, as the JAX package
# reads its _FUSED_MODE.
FUSED_MODE = _mode_from_env()


@contextlib.contextmanager
def fused_mode(mode: str) -> Iterator[None]:
    """Route under ``mode`` inside the block, then restore the mode."""
    global FUSED_MODE
    if mode not in FUSED_MODES:
        raise ValueError(f"fused mode {mode!r}: takes one of {FUSED_MODES}")
    saved, FUSED_MODE = FUSED_MODE, mode
    try:
        yield
    finally:
        FUSED_MODE = saved


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# The JAX package's VMEM byte rules (kernels/fused_attention.py _auto_bq,
# _auto_bq_kvstat; budget kernels/flash_attention.py _VMEM_BUDGET) with
# their constants. They belong to the routing only: the CUDA kernels size
# their own shared-memory plans (csrc/proj_attend.cuh ProjAttendSmem).
_ATTN_RULE_BUDGET = 11 << 20
_KV_CHUNK = 512
_BQ_CANDIDATES = (1024, 768, 512, 384, 256, 128)


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _d_pad(dim_head: int) -> int:
    return _ceil_to(max(dim_head, 128), 128)


def _q_blocks(Lq: int):
    top = _ceil_to(Lq, 16)
    return (top,) + tuple(b for b in _BQ_CANDIDATES if b <= top)


def _auto_bq(Lq: int, Lk: int, C: int, d_pad: int, esize: int,
             n_kv: int = 1) -> int:
    """The out-fused kernel's q block: logits, x_q, q/acc and the
    out-projection scratch beside the resident x_kv, k/v and weights."""
    lk_pad = _ceil_to(Lk, 128)
    fixed = n_kv * Lk * C * esize + 2 * lk_pad * d_pad * 4 + \
        3 * C * d_pad * esize
    for bq in _q_blocks(Lq):
        var = bq * lk_pad * 4 + bq * C * esize + 2 * bq * d_pad * 4 + \
            bq * C * 4
        if fixed + var <= _ATTN_RULE_BUDGET:
            return bq
    return 128


def _auto_bq_kvstat(Lq: int, Lk: int, C: int, d_pad: int, esize: int,
                    n_kv: int = 1) -> Optional[int]:
    """The kv-stationary kernel's q block, None if even 128 rows do not
    fit beside the resident k/v."""
    lk_pad = _ceil_to(Lk, 16)
    ck = min(lk_pad, _KV_CHUNK)
    fixed = n_kv * Lk * C * esize + n_kv * 2 * lk_pad * d_pad * esize + \
        2 * ck * d_pad * 4 + 3 * C * d_pad * esize
    for bq in _q_blocks(Lq):
        var = bq * lk_pad * (4 + esize) + bq * C * esize + 2 * bq * d_pad * 4
        if fixed + var <= _ATTN_RULE_BUDGET:
            return bq
    return None


def kvstat_is_efficient(Lq: int, Lk: int, C: int, dim_head: int,
                        esize: int = 2) -> bool:
    return _auto_bq_kvstat(Lq, Lk, C, _d_pad(dim_head), esize) is not None


def kvstat_pair_fits(Lq: int, Lk: int, C: int, dim_head: int,
                     esize: int = 2) -> bool:
    return _auto_bq_kvstat(Lq, Lk, C, _d_pad(dim_head), esize,
                           n_kv=2) is not None


def fused_is_efficient(Lq: int, Lk: int, C: int, dim_head: int,
                       esize: int = 2) -> bool:
    """At most 2 q blocks: the out-fused kernel's economics."""
    return -(-Lq // _auto_bq(Lq, Lk, C, _d_pad(dim_head), esize)) <= 2


def pair_is_efficient(Lq: int, Lk: int, C: int, dim_head: int,
                      esize: int = 2) -> bool:
    return -(-Lq // _auto_bq(Lq, Lk, C, _d_pad(dim_head), esize,
                             n_kv=2)) <= 2


def fused_mode_for(Lq: int, Lk: int, C: int, dim_head: int,
                   esize: int) -> Optional[str]:
    """The fused kernel of a gated attention under ``FUSED_MODE``: "kvstat"
    (K1), "out" (K8) or None (the projected route). C is max(C, Ck), esize
    the input's element size."""
    args = (Lq, Lk, C, dim_head, esize)
    if FUSED_MODE == "kvstat" and kvstat_is_efficient(*args):
        return "kvstat"
    if fused_is_efficient(*args):
        return "out"
    if kvstat_is_efficient(*args):
        return "kvstat"
    return None


def attention_route(Lq: int, Lk: int, C: int, dim_head: int,
                    esize: int) -> Optional[str]:
    """The kernel of an attention: None (SDPA), "kvstat" (K1), "out" (K8)
    or "projected" (the module's projections, then K5), where neither fused
    kernel's rule holds (``core/attention.py`` ``Attention.__call__``)."""
    if Lq * Lk < MIN_LOGITS or dim_head > MAX_HEAD_DIM:
        return None
    return fused_mode_for(Lq, Lk, C, dim_head, esize) or "projected"


def pair_route(L: int, C: int, dim_head: int, esize: int,
               neighbours: int = 2) -> Optional[str]:
    """The kernel of the cross-view "add" attention over ``neighbours``
    neighbour lists: None (SDPA per neighbour), "kvstat" (K2) or "out" (the
    K8 pair) where there are two lists and the pair's own rule holds, else
    one attention per neighbour, summed in the working dtype
    (``core/transformer.py`` ``_cross_view``): "kvstat_loop" (K1 per
    neighbour), "out_loop" (K8 per neighbour) or "projected_loop" (K5 per
    neighbour)."""
    mode = attention_route(L, L, C, dim_head, esize)
    if mode == "projected":
        return "projected_loop"
    fits = {"kvstat": kvstat_pair_fits, "out": pair_is_efficient}
    if mode is not None and (neighbours != 2 or
                             not fits[mode](L, L, C, dim_head, esize)):
        return mode + "_loop"
    return mode


# The JAX package's whole-FF routing rule (kernels/geglu.py
# ff_full_fusion_fits) with its byte budget, restated so both packages send
# the same FeedForward widths to the whole-FF kernel. The budget belongs to
# that rule; K3 sizes its own shared-memory plan (csrc/geglu.cu launch_ff).
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


# the element types the kernels take, and the suffix of each one's C entry
_ENTRY_SUFFIX = {torch.bfloat16: "", torch.float32: "_f32"}


def _check(name: str, *tensors: Optional[torch.Tensor]) -> str:
    """Raise unless the floating tensors are contiguous, on the current
    card, and all bf16 or all fp32; -> the C entry suffix of their type."""
    dev, dt = tensors[0].device, tensors[0].dtype
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, the kernels launch on "
                         f"cuda:{torch.cuda.current_device()}")
    for t in tensors:
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or dt not in _ENTRY_SUFFIX or \
                not t.is_contiguous():
            raise ValueError(
                f"{name}: the kernel takes contiguous tensors on one device, "
                f"all bf16 or all fp32; got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()}) beside "
                f"{dt} on {dev}")
    return _ENTRY_SUFFIX[dt]


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
    entry = "mdk_kv_project" + _ENTRY_SUFFIX[x_kv.dtype]
    _run(getattr(lib, entry), _ptr(x_kv), _ptr(wk), _ptr(wv), _ptr(k),
         _ptr(v), B, Lk, Ck, heads, D, _stream())
    return k, v


def _out_project(lib, o, wout):
    """The out-projection launch of K8 and its pair: o Wout^T in o's type
    (bf16: fp32 accumulation over H*D, cast once), no bias. o (B, Lq, H*D),
    wout (C_out, H*D) -> (B, Lq, C_out)."""
    B, Lq, HD = o.shape
    C_out = wout.shape[0]
    y = torch.empty(B, Lq, C_out, dtype=o.dtype, device=o.device)
    entry = "mdk_out_project" + _ENTRY_SUFFIX[o.dtype]
    _run(getattr(lib, entry), _ptr(o), _ptr(wout), _ptr(y), B * Lq, HD,
         C_out, _stream())
    return y


def check_table(name: str, table: torch.Tensor, x: torch.Tensor) -> None:
    """Raise unless a pair entry's neighbour table is int32 (2, n),
    contiguous, on x's device, with n dividing x's batch and every entry in
    [0, n). The entries are read to the host once per table and per
    in-place change of it, not on every call."""
    if table.dim() != 2 or table.shape[0] != 2 or table.shape[1] < 1 or \
            table.dtype != torch.int32 or table.device != x.device or \
            not table.is_contiguous() or x.shape[0] % table.shape[1]:
        raise ValueError(
            f"{name}: the neighbour table takes a contiguous int32 (2, n) "
            f"tensor on {x.device}, n dividing the batch {x.shape[0]}; got "
            f"{table.dtype} {tuple(table.shape)} on {table.device}")
    n = table.shape[1]
    seen = (n, None if table.is_inference() else table._version)
    if getattr(table, "_checked_for", None) != seen:
        if int(table.min()) < 0 or int(table.max()) >= n:
            raise ValueError(f"{name}: neighbour table entries outside "
                             f"[0, {n}): {table.tolist()}")
        table._checked_for = seen


def _attention(name, x_q, x_kv, wq, wk, wv, wout, heads, scale, table=None):
    """One projection-fused attention, counted once under ``name``: k and v
    projected once by K1's projection kernel, then the heads by K1's kernel
    (with ``table``, K2's: the pair, x_kv being x_q itself, neighbour i of
    view v read from view table[i, v] of the same sample) into
    (B, Lq, H*D), and with ``wout`` that output out-projected into
    (B, Lq, C_out). K7 is K1's launches; K8 and its pair add the
    out-projection. The pair entries have checked ``table``."""
    from . import build

    sfx = _check(name, x_q, x_kv, wq, wk, wv, wout)
    B, Lq, C = x_q.shape
    D = wq.shape[0] // heads
    if x_kv.shape[0] != B or wq.shape != (heads * D, C) or \
            wk.shape != (heads * D, x_kv.shape[2]) or wv.shape != wk.shape or \
            (wout is not None and (wout.dim() != 2 or
                                   wout.shape[1] != heads * D)):
        raise ValueError(f"{name}: shapes do not agree")
    lib = build.load()
    k, v = _project_kv(lib, x_kv, wk, wv, heads)  # once for every view
    o = torch.empty(B, Lq, heads * D, dtype=x_q.dtype, device=x_q.device)
    ptrs = (_ptr(x_q), _ptr(wq), _ptr(k), _ptr(v), _ptr(o))
    if table is None:
        _run(getattr(lib, "mdk_kvstat_attention" + sfx), *ptrs, B, Lq, C,
             x_kv.shape[1], heads, D, float(scale), _stream())
    else:
        _run(getattr(lib, "mdk_kvstat_attention_pair" + sfx), *ptrs, B, Lq, C,
             heads, D, float(scale), _ptr(table), table.shape[1], _stream())
    if wout is not None:
        o = _out_project(lib, o, wout)
    LAUNCHES[name] += 1
    return o


def kvstat_attention(x_q: torch.Tensor, x_kv: torch.Tensor, wq: torch.Tensor,
                     wk: torch.Tensor, wv: torch.Tensor, heads: int,
                     scale: float) -> torch.Tensor:
    """K1: softmax((x_q Wq^T) scale (x_kv Wk^T)^T) (x_kv Wv^T) per head.
    x_q (B, Lq, C), x_kv (B, Lk, Ck), wq (H*D, C), wk/wv (H*D, Ck) ->
    (B, Lq, H*D) at the logical head depth."""
    if _on_cpu(x_q):
        return reference.kvstat_attention(x_q, x_kv, wq, wk, wv, heads, scale)
    return _attention("kvstat_attention", x_q, x_kv, wq, wk, wv, None, heads,
                      scale)


def kvstat_attention_pair(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                          wv: torch.Tensor, heads: int, scale: float,
                          table: torch.Tensor) -> torch.Tensor:
    """K2: the cross-view pair. View v of each sample of x (B, L, C), B a
    multiple of n, attends to views table[0, v] and table[1, v] of the same
    sample, ``table`` the (2, n) int32 neighbour table, with separate
    softmaxes; the two outputs are summed. -> (B, L, H*D)."""
    check_table("kvstat_attention_pair", table, x)
    if _on_cpu(x):
        return reference.kvstat_attention_pair(x, wq, wk, wv, heads, scale,
                                               table)
    return _attention("kvstat_attention_pair", x, x, wq, wk, wv, None, heads,
                      scale, table)


def fused_qkv_attention(x_q: torch.Tensor, x_kv: torch.Tensor,
                        wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                        heads: int, scale: float) -> torch.Tensor:
    """K7: K1's function, launched as K1 (the TPU kernel's per-q-block
    recompute of k/v is a tile plan, not the contract). Shapes as
    ``kvstat_attention``."""
    if _on_cpu(x_q):
        return reference.fused_qkv_attention(x_q, x_kv, wq, wk, wv, heads,
                                             scale)
    return _attention("fused_qkv_attention", x_q, x_kv, wq, wk, wv, None,
                      heads, scale)


def fused_qkv_out_attention(x_q: torch.Tensor, x_kv: torch.Tensor,
                            wq: torch.Tensor, wk: torch.Tensor,
                            wv: torch.Tensor, wout: torch.Tensor, heads: int,
                            scale: float) -> torch.Tensor:
    """K8: K1's attention out-projected without the out bias: o Wout^T
    with wout (C_out, H*D), o in the input's type, fp32 accumulation over
    every head, one cast -> (B, Lq, C_out). C_out and H*D are multiples of
    8."""
    if _on_cpu(x_q):
        return reference.fused_qkv_out_attention(x_q, x_kv, wq, wk, wv, wout,
                                                 heads, scale)
    return _attention("fused_qkv_out_attention", x_q, x_kv, wq, wk, wv, wout,
                      heads, scale)


def fused_qkv_out_attention_pair(x: torch.Tensor, wq: torch.Tensor,
                                 wk: torch.Tensor, wv: torch.Tensor,
                                 wout: torch.Tensor, heads: int, scale: float,
                                 table: torch.Tensor) -> torch.Tensor:
    """The K8 pair: K2's two neighbour attentions over ``table`` summed in
    fp32 and cast once, then out-projected as K8 without the bias
    -> (B, L, C_out)."""
    check_table("fused_qkv_out_attention_pair", table, x)
    if _on_cpu(x):
        return reference.fused_qkv_out_attention_pair(x, wq, wk, wv, wout,
                                                      heads, scale, table)
    return _attention("fused_qkv_out_attention_pair", x, x, wq, wk, wv, wout,
                      heads, scale, table)


def fused_geglu(x: torch.Tensor, w1: torch.Tensor,
                b1: Optional[torch.Tensor]) -> torch.Tensor:
    """K4: (x Wv^T + bv) * gelu_erf(x Wg^T + bg), Wv/Wg the value and gate
    halves of w1 (2N, K). x (..., K) -> (..., N)."""
    if _on_cpu(x):
        return reference.fused_geglu(x, w1, b1)
    from . import build

    sfx = _check("fused_geglu", x, w1, b1)
    K = x.shape[-1]
    N = w1.shape[0] // 2
    if w1.shape != (2 * N, K) or (b1 is not None and b1.shape != (2 * N,)):
        raise ValueError("fused_geglu: shapes do not agree")
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], N, dtype=x.dtype, device=x.device)
    _run(getattr(build.load(), "mdk_geglu" + sfx), _ptr(x), _ptr(w1), _ptr(b1),
         _ptr(out), M, K, N, _stream())
    LAUNCHES["fused_geglu"] += 1
    return out


def fused_ff(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
             w2: torch.Tensor) -> torch.Tensor:
    """K3: the whole FeedForward but its stage-2 bias,
    geglu(x) W2^T with geglu(x) in x's type, w2 (C, N). x (..., K) ->
    (..., C)."""
    if _on_cpu(x):
        return reference.fused_ff(x, w1, b1, w2)
    from . import build

    sfx = _check("fused_ff", x, w1, b1, w2)
    K = x.shape[-1]
    N = w1.shape[0] // 2
    C = w2.shape[0]
    if w1.shape != (2 * N, K) or w2.shape != (C, N) or \
            (b1 is not None and b1.shape != (2 * N,)):
        raise ValueError("fused_ff: shapes do not agree")
    M = x.numel() // K
    out = torch.empty(*x.shape[:-1], C, dtype=x.dtype, device=x.device)
    _run(getattr(build.load(), "mdk_ff" + sfx), _ptr(x), _ptr(w1), _ptr(b1),
         _ptr(w2), _ptr(out), M, K, N, C, _stream())
    LAUNCHES["fused_ff"] += 1
    return out


def _flash_shapes(name, q, k, kv_len):
    BH, Lq, D = q.shape
    Lk = k.shape[1]
    kv_len = Lk if kv_len is None else kv_len
    if k.shape != (BH, Lk, D) or not 0 < kv_len <= Lk:
        raise ValueError(f"{name}: shapes do not agree")
    if D > 128 or D % 8:
        # the kernels copy rows as whole 16-byte vectors (32 bytes and more
        # in fp32)
        raise ValueError(f"{name}: the kernel takes a head depth that is a "
                         f"multiple of 8 up to 128, got {D}")
    return BH, Lq, Lk, D, kv_len


def _fp32_rows(name, t, BH, Lq, device):
    if t.shape != (BH, Lq) or t.dtype != torch.float32 or \
            t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: a row statistic takes a contiguous fp32 "
                         f"({BH}, {Lq}) tensor, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: o = softmax(q k^T) v with keys >= kv_len masked, q already
    scaled; q (BH, Lq, D), k/v (BH, Lk, D) -> o (BH, Lq, D) and the fp32
    row logsumexp lse (BH, Lq)."""
    if _on_cpu(q):
        return reference.flash_attention_fwd(q, k, v, kv_len)
    from . import build

    sfx = _check("flash_attention_fwd", q, k, v)
    BH, Lq, Lk, D, kv_len = _flash_shapes("flash_attention_fwd", q, k,
                                          kv_len)
    if v.shape != k.shape:
        raise ValueError("flash_attention_fwd: shapes do not agree")
    o = torch.empty_like(q)
    lse = torch.empty(BH, Lq, dtype=torch.float32, device=q.device)
    _run(getattr(build.load(), "mdk_flash_fwd" + sfx), _ptr(q), _ptr(k),
         _ptr(v), _ptr(o), _ptr(lse), BH, Lq, Lk, D, kv_len, _stream())
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bwd_dq(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, o: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor,
                           kv_len: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, first launch: dq (BH, Lq, D) and the fp32 row term
    delta = rowsum(do * o) (BH, Lq), which the second launch reads."""
    if _on_cpu(q):
        return reference.flash_attention_bwd_dq(q, k, v, o, lse, do, kv_len)
    from . import build

    name = "flash_attention_bwd_dq"
    sfx = _check(name, q, k, v, o, do)
    BH, Lq, Lk, D, kv_len = _flash_shapes(name, q, k, kv_len)
    if v.shape != k.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"{name}: shapes do not agree")
    _fp32_rows(name, lse, BH, Lq, q.device)
    dq = torch.empty_like(q)
    delta = torch.empty(BH, Lq, dtype=torch.float32, device=q.device)
    _run(getattr(build.load(), "mdk_flash_bwd_dq" + sfx), _ptr(q), _ptr(k),
         _ptr(v), _ptr(o), _ptr(lse), _ptr(do), _ptr(dq), _ptr(delta), BH, Lq,
         Lk, D, kv_len, _stream())
    LAUNCHES[name] += 1
    return dq, delta


def flash_attention_bwd_dkv(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lse: torch.Tensor,
                            delta: torch.Tensor, do: torch.Tensor,
                            kv_len: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, second launch: dk and dv (BH, Lk, D) from the first launch's
    delta."""
    if _on_cpu(q):
        return reference.flash_attention_bwd_dkv(q, k, v, lse, delta, do,
                                                 kv_len)
    from . import build

    name = "flash_attention_bwd_dkv"
    sfx = _check(name, q, k, v, do)
    BH, Lq, Lk, D, kv_len = _flash_shapes(name, q, k, kv_len)
    if v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"{name}: shapes do not agree")
    _fp32_rows(name, lse, BH, Lq, q.device)
    _fp32_rows(name, delta, BH, Lq, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _run(getattr(build.load(), "mdk_flash_bwd_dkv" + sfx), _ptr(q), _ptr(k),
         _ptr(v), _ptr(lse), _ptr(delta), _ptr(do), _ptr(dk), _ptr(dv), BH, Lq,
         Lk, D, kv_len, _stream())
    LAUNCHES[name] += 1
    return dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6: the gradients of K5 given do, from its o and lse, as two
    launches (dq and delta; dk and dv) -> dq (BH, Lq, D), dk and dv
    (BH, Lk, D)."""
    if _on_cpu(q):
        return reference.flash_attention_bwd(q, k, v, o, lse, do, kv_len)
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, kv_len)
    return (dq, *flash_attention_bwd_dkv(q, k, v, lse, delta, do, kv_len))
