"""The port's K7, K8 and K8 pair against the JAX Pallas kernels they replace,
run in interpret mode as tests/test_kernels.py runs them: the plain versions
against the forward entries, the autograd Functions against jax.vjp of the
entries (whose backward is _fused_out_bwd / _pair_out_bwd: K7, the flash
forward and backward, in interpret mode).

fp32, atol 1e-4 / rtol 1e-3, as the K1-K6 tests; K8 and its pair are also
held as the port launches them, K1's (K2's) plain version followed by the
out-projection's, in fp32 (atol 2e-4 / rtol 2e-3) and on bf16 inputs (within
1e-2 * max|ref|). The JAX kernels
take weights lane-padded to 128 per head (Wout padded in its rows); their
per-head outputs and weight gradients are sliced back to the logical depth.
The port's weights are in nn.Linear (out, in) layout, Wout (C_out, H*D).
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from magicdrive_tpu.kernels import fused_attention as jfa

from magicdrive_tpu_torch.kernels import autograd, dispatch, reference
from test_torch_port_kernels import (ATOL, DP, RTOL, TABLES, _grads_of,
                                     _pad_rows, gathered, table_of,
                                     _unpad, _weights)

torch.set_num_threads(1)


def _wout(rs, H, D, C_out):
    """(H*D, C_out) weight -> (JAX row-padded (H*DP, C_out), port
    (C_out, H*D))."""
    w = (rs.randn(H, D, C_out) * (H * D) ** -0.5).astype(np.float32)
    padded = np.pad(w, ((0, 0), (0, DP - D), (0, 0))).reshape(H * DP, C_out)
    return jnp.asarray(padded), torch.from_numpy(
        np.ascontiguousarray(w.reshape(H * D, C_out).T))


def _unpad_wout(g, H, D):
    """A JAX Wout gradient (H*DP, C_out) -> the port's layout (C_out, H*D)."""
    g = np.asarray(g)
    return g.reshape(H, DP, -1)[:, :D].reshape(H * D, -1).T


def _inputs(rs, B, Lq, Lk, C, Ck, H, D):
    xq = rs.randn(B, Lq, C).astype(np.float32)
    xkv = xq if Lk == Lq and Ck == C else \
        rs.randn(B, Lk, Ck).astype(np.float32)
    return xq, xkv, [_weights(rs, c, H, D) for c in (C, Ck, Ck)]


@pytest.mark.parametrize("B,Lq,Lk,C,Ck,H,D", [
    (2, 48, 48, 32, 32, 2, 16),     # self-attention
    (1, 64, 64, 48, 48, 2, 40),     # the level-0 head depth
    (2, 40, 24, 32, 48, 3, 16),     # cross-attention onto wider context
])
def test_k7_plain_matches_pallas(B, Lq, Lk, C, Ck, H, D):
    """K7's plain version is K1's: held to the recomputing Pallas kernel."""
    rs = np.random.RandomState(20)
    xq, xkv, w = _inputs(rs, B, Lq, Lk, C, Ck, H, D)
    scale = D ** -0.5
    want = jfa.fused_qkv_attention(jnp.asarray(xq), jnp.asarray(xkv),
                                   *(j for j, _ in w), heads=H, scale=scale,
                                   interpret=True)
    got = reference.fused_qkv_attention(torch.from_numpy(xq),
                                        torch.from_numpy(xkv),
                                        *(t for _, t in w), H, scale)
    np.testing.assert_allclose(got.numpy(), _unpad(want, B, Lq, H, D),
                               atol=ATOL, rtol=RTOL)


# the last case has C_out != C, so a transposed Wout cannot pass
_K8_CASES = [(2, 48, 48, 32, 32, 2, 16, 32), (1, 64, 64, 48, 48, 2, 40, 48),
             (2, 40, 24, 32, 48, 3, 16, 24)]


@pytest.mark.parametrize("B,Lq,Lk,C,Ck,H,D,C_out", _K8_CASES)
def test_k8_plain_matches_pallas(B, Lq, Lk, C, Ck, H, D, C_out):
    rs = np.random.RandomState(21)
    xq, xkv, w = _inputs(rs, B, Lq, Lk, C, Ck, H, D)
    jo, to = _wout(rs, H, D, C_out)
    scale = D ** -0.5
    want = jfa.fused_qkv_out_attention(jnp.asarray(xq), jnp.asarray(xkv),
                                       *(j for j, _ in w), jo, heads=H,
                                       scale=scale, interpret=True)
    got = reference.fused_qkv_out_attention(torch.from_numpy(xq),
                                            torch.from_numpy(xkv),
                                            *(t for _, t in w), to, H, scale)
    assert got.shape == (B, Lq, C_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# (1, 2) is not symmetric: a branch that reads the wrong neighbour, or a
# gradient scattered to the wrong views, shows there even where (5, 1) hides
# it; the port takes the ring's neighbour table, the JAX pair the shifts
_PAIR_CASES = [((5, 1, 6), 3, 16, 48), ((1, 2, 6), 2, 40, 24),
               ((5, 1, 6), 2, 40, 48), ((1, 2, 6), 3, 16, 24)]


@pytest.mark.parametrize("shifts,H,D,C_out", _PAIR_CASES)
def test_k8_pair_plain_matches_pallas_ring_shifts(shifts, H, D, C_out):
    rs = np.random.RandomState(22)
    n, Bg, L, C = 6, 2, 36, 48
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    w = [_weights(rs, C, H, D) for _ in range(3)]
    jo, to = _wout(rs, H, D, C_out)
    scale = D ** -0.5
    xj = jnp.asarray(x)
    want = jfa.fused_qkv_out_attention_pair(
        xj, xj, xj, *(j for j, _ in w), jo, heads=H, scale=scale,
        interpret=True, shifts=shifts)
    got = reference.fused_qkv_out_attention_pair(
        torch.from_numpy(x), *(t for _, t in w), to, H, scale,
        reference.ring_table(shifts[:2], n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_k8_pair_plain_matches_pallas_tables(name):
    """The K8 pair over a neighbour table against the JAX pair with
    shifts=None on the gathered views."""
    rs = np.random.RandomState(28)
    n, Bg, L, C, H, D, C_out = 6, 2, 36, 48, 2, 40, 24
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    w = [_weights(rs, C, H, D) for _ in range(3)]
    jo, to = _wout(rs, H, D, C_out)
    scale = D ** -0.5
    xj = jnp.asarray(x)
    want = jfa.fused_qkv_out_attention_pair(
        xj, gathered(xj, name, 0), gathered(xj, name, 1),
        *(j for j, _ in w), jo, heads=H, scale=scale, interpret=True,
        shifts=None)
    got = reference.fused_qkv_out_attention_pair(
        torch.from_numpy(x), *(t for _, t in w), to, H, scale,
        table_of(name))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_k8_pair_autograd_matches_jax_vjp_not_a_permutation():
    """Every gradient of the K8 pair Function over two triangles, against
    jax.vjp of the JAX pair on the gathered views: dx sums over the views
    that read each one."""
    rs = np.random.RandomState(29)
    n, Bg, L, C, H, D, C_out = 6, 2, 36, 32, 2, 16, 24
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    w = [_weights(rs, C, H, D) for _ in range(3)]
    jo, to = _wout(rs, H, D, C_out)
    dy = rs.randn(Bg * n, L, C_out).astype(np.float32)
    scale = D ** -0.5
    name = "not_a_permutation"

    def pair(x, wq, wk, wv, wo):
        return jfa.fused_qkv_out_attention_pair(
            x, gathered(x, name, 0), gathered(x, name, 1), wq, wk, wv, wo,
            heads=H, scale=scale, interpret=True, shifts=None)

    _, vjp = jax.vjp(pair, jnp.asarray(x), *(j for j, _ in w), jo)
    want = vjp(jnp.asarray(dy))
    table = table_of(name)
    got = _grads_of(lambda *a: autograd.fused_qkv_out_attention_pair(
        *a, H, scale, table), (x, *(t.numpy() for _, t in w), to.numpy()),
        dy)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=RTOL)
    for g, wt in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g, _pad_rows(wt, H, D), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(got[4], _unpad_wout(want[4], H, D), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("B,Lq,Lk,C,Ck,H,D,C_out",
                         [_K8_CASES[0], _K8_CASES[2]])
def test_k8_autograd_matches_jax_vjp(B, Lq, Lk, C, Ck, H, D, C_out):
    """Every gradient of the K8 Function, dWout included, against jax.vjp of
    the Pallas entry."""
    rs = np.random.RandomState(23)
    xq = rs.randn(B, Lq, C).astype(np.float32)
    xkv = rs.randn(B, Lk, Ck).astype(np.float32)
    w = [_weights(rs, c, H, D) for c in (C, Ck, Ck)]
    jo, to = _wout(rs, H, D, C_out)
    dy = rs.randn(B, Lq, C_out).astype(np.float32)
    scale = D ** -0.5
    _, vjp = jax.vjp(lambda *a: jfa.fused_qkv_out_attention(
        *a, heads=H, scale=scale, interpret=True), jnp.asarray(xq),
        jnp.asarray(xkv), *(j for j, _ in w), jo)
    want = vjp(jnp.asarray(dy))
    got = _grads_of(lambda *a: autograd.fused_qkv_out_attention(*a, H, scale),
                    (xq, xkv, *(t.numpy() for _, t in w), to.numpy()), dy)
    for g, wt in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, np.asarray(wt), atol=ATOL, rtol=RTOL)
    for g, wt in zip(got[2:5], want[2:5]):
        np.testing.assert_allclose(g, _pad_rows(wt, H, D), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(got[5], _unpad_wout(want[5], H, D), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("shifts", [(5, 1, 6), (1, 2, 6)])
def test_k8_pair_autograd_matches_jax_vjp_ring_shifts(shifts):
    """Every gradient of the K8 pair Function, dWout summed over both
    branches, against jax.vjp of the JAX pair with in-grid ring shifts."""
    rs = np.random.RandomState(24)
    n, Bg, L, C, H, D, C_out = 6, 1, 36, 32, 2, 16, 24
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    w = [_weights(rs, C, H, D) for _ in range(3)]
    jo, to = _wout(rs, H, D, C_out)
    dy = rs.randn(Bg * n, L, C_out).astype(np.float32)
    scale = D ** -0.5

    def pair(x, wq, wk, wv, wo):
        return jfa.fused_qkv_out_attention_pair(
            x, x, x, wq, wk, wv, wo, heads=H, scale=scale, interpret=True,
            shifts=shifts)

    _, vjp = jax.vjp(pair, jnp.asarray(x), *(j for j, _ in w), jo)
    want = vjp(jnp.asarray(dy))
    table = reference.ring_table(shifts[:2], n)
    got = _grads_of(lambda *a: autograd.fused_qkv_out_attention_pair(
        *a, H, scale, table), (x, *(t.numpy() for _, t in w), to.numpy()),
        dy)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=RTOL)
    for g, wt in zip(got[1:4], want[1:4]):
        np.testing.assert_allclose(g, _pad_rows(wt, H, D), atol=ATOL,
                                   rtol=RTOL)
    np.testing.assert_allclose(got[4], _unpad_wout(want[4], H, D), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("pair", [False, True])
def test_k7_runs_only_for_dwout(pair, monkeypatch):
    """K7 recomputes o only when Wout needs its gradient (once per branch
    of the pair); a frozen Wout costs no K7 call and gets no gradient."""
    calls = []
    k7 = dispatch.fused_qkv_attention
    monkeypatch.setattr(dispatch, "fused_qkv_attention",
                        lambda *a: calls.append(1) or k7(*a))
    rs = np.random.RandomState(25)
    x = torch.from_numpy(rs.randn(6, 20, 16).astype(np.float32))
    w = [torch.from_numpy(rs.randn(16, 16).astype(np.float32))
         for _ in range(4)]
    fn = (lambda *a: autograd.fused_qkv_out_attention_pair(
        *a, 2, 0.3, reference.ring_table((5, 1), 6))) if pair else \
        (lambda x, *ws: autograd.fused_qkv_out_attention(x, x, *ws, 2, 0.3))
    xg = x.clone().requires_grad_()
    fn(xg, *w).sum().backward()
    assert calls == [] and xg.grad is not None
    wo = w[3].clone().requires_grad_()
    fn(x, *w[:3], wo).sum().backward()
    assert len(calls) == (2 if pair else 1) and wo.grad is not None


def _in_dtype(dtype, *arrays):
    """The JAX and the port's form of each array in ``dtype`` (bf16 rounds
    once, on the numpy values both sides share)."""
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return [(jnp.asarray(a).astype(jd),
             torch.from_numpy(np.array(a, np.float32)).to(dtype))
            for a in arrays]


def _assert_close(got, want, dtype):
    """fp32: atol 2e-4 / rtol 2e-3. bf16: within 1e-2 * max|ref|, which
    holds the cast points (bf16 o before the product, one cast after) and
    leaves room for one bf16 rounding of an output."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-3)
    else:
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Lq,Lk,C,Ck,H,D,C_out", _K8_CASES)
def test_two_step_plain_k8_matches_pallas(B, Lq, Lk, C, Ck, H, D, C_out,
                                          dtype):
    """K8 as the port launches it, K1's plain version and then the
    out-projection's, against the Pallas K8 that out-projects inside."""
    rs = np.random.RandomState(26)
    xq, xkv, w = _inputs(rs, B, Lq, Lk, C, Ck, H, D)
    jo, to = _wout(rs, H, D, C_out)
    (jxq, txq), (jxkv, txkv), (jwo, _) = _in_dtype(dtype, xq, xkv, jo)
    jw = [j for j, _ in _in_dtype(dtype, *(j for j, _ in w))]
    tw = [t.to(dtype) for _, t in w]
    scale = D ** -0.5
    want = jfa.fused_qkv_out_attention(jxq, jxkv, *jw, jwo, heads=H,
                                       scale=scale, interpret=True)
    o = reference.kvstat_attention(txq, txkv, *tw, H, scale)
    got = reference.out_projection(o, to.to(dtype))
    assert got.shape == (B, Lq, C_out) and got.dtype == dtype
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifts", [(5, 1, 6), (1, 2, 6)])
def test_two_step_plain_k8_pair_matches_pallas_ring_shifts(shifts, dtype):
    """The K8 pair as the port launches it, K2's plain version (the two
    neighbours summed in fp32, cast once) and then the out-projection's,
    against the Pallas pair under both ring-shift sets."""
    rs = np.random.RandomState(27)
    n, Bg, L, C, H, D, C_out = 6, 2, 36, 48, 2, 40, 24
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    w = [_weights(rs, C, H, D) for _ in range(3)]
    jo, to = _wout(rs, H, D, C_out)
    (jx, tx), (jwo, _) = _in_dtype(dtype, x, jo)
    jw = [j for j, _ in _in_dtype(dtype, *(j for j, _ in w))]
    tw = [t.to(dtype) for _, t in w]
    scale = D ** -0.5
    want = jfa.fused_qkv_out_attention_pair(
        jx, jx, jx, *jw, jwo, heads=H, scale=scale, interpret=True,
        shifts=shifts)
    o = reference.kvstat_attention_pair(tx, *tw, H, scale,
                                        reference.ring_table(shifts[:2], n))
    got = reference.out_projection(o, to.to(dtype))
    _assert_close(got, want, dtype)
