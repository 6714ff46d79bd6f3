"""The plain versions of the port's kernels K1-K4 against the JAX Pallas
kernels they replace, run in interpret mode as tests/test_kernels.py runs
them, and the port's routing rules against the JAX package's.

fp32 throughout, atol 1e-4 / rtol 1e-3. The JAX kernels take weights
lane-padded to 128 per head; their outputs are sliced back to the logical
head depth D. The port's weights are in nn.Linear (out, in) layout.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from magicdrive_tpu.kernels import fused_attention as jfa
from magicdrive_tpu.kernels import geglu as jgg

from magicdrive_tpu_torch.kernels import dispatch, reference

torch.set_num_threads(1)

ATOL, RTOL = 1e-4, 1e-3
DP = 128


def _weights(rs, cin, H, D):
    """(C, H, D) weight -> (JAX lane-padded (C, H*DP), port (H*D, C))."""
    w = (rs.randn(cin, H, D) * cin ** -0.5).astype(np.float32)
    padded = np.pad(w, ((0, 0), (0, 0), (0, DP - D))).reshape(cin, H * DP)
    return jnp.asarray(padded), torch.from_numpy(
        np.ascontiguousarray(w.reshape(cin, H * D).T))


def _unpad(o, B, L, H, D):
    return np.asarray(o).reshape(B, L, H, DP)[..., :D].reshape(B, L, H * D)


@pytest.mark.parametrize("B,Lq,Lk,C,Ck,H,D", [
    (2, 48, 48, 32, 32, 2, 16),     # self-attention
    (1, 64, 64, 48, 48, 2, 40),     # the level-0 head depth
    (2, 40, 24, 32, 48, 3, 16),     # cross-attention onto wider context
])
def test_k1_plain_matches_pallas(B, Lq, Lk, C, Ck, H, D):
    rs = np.random.RandomState(0)
    xq = rs.randn(B, Lq, C).astype(np.float32)
    xkv = xq if Lk == Lq and Ck == C else \
        rs.randn(B, Lk, Ck).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, c, H, D)
                                    for c in (C, Ck, Ck))
    scale = D ** -0.5
    want = jfa.fused_kvstat_attention(jnp.asarray(xq), jnp.asarray(xkv),
                                      jq, jk, jv, heads=H, scale=scale,
                                      interpret=True)
    got = reference.kvstat_attention(torch.from_numpy(xq),
                                     torch.from_numpy(xkv), tq, tk, tv, H,
                                     scale)
    np.testing.assert_allclose(got.numpy(), _unpad(want, B, Lq, H, D),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("H,D", [(3, 16), (2, 40)])
def test_k2_plain_matches_pallas_ring_shifts(H, D):
    """The pair over the ring's neighbour table for the shifts (5, 1) over
    6 views, as the nuScenes neighbours give them, against the JAX
    shifts=(s1, s2, n) path."""
    rs = np.random.RandomState(1)
    n, Bg, L, C = 6, 2, 36, 48
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, C, H, D) for _ in range(3))
    scale = D ** -0.5
    shifts = (5, 1, n)
    xj = jnp.asarray(x)
    want = jfa.fused_kvstat_attention_pair(xj, xj, xj, jq, jk, jv, heads=H,
                                           scale=scale, interpret=True,
                                           shifts=shifts)
    got = reference.kvstat_attention_pair(torch.from_numpy(x), tq, tk, tv, H,
                                          scale, reference.ring_table(
                                              shifts[:2], n))
    np.testing.assert_allclose(got.numpy(), _unpad(want, Bg * n, L, H, D),
                               atol=ATOL, rtol=RTOL)


# neighbour lists of 6 views that a ring shift does not give: the nuScenes
# ring with the cameras numbered another way, and two triangles (view 2 is
# no view's first neighbour, view 0 that of two); the ring itself
TABLES = {"ring": ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0)),
          "permuted": ((1, 2), (4, 0), (0, 5), (5, 4), (3, 1), (2, 3)),
          "not_a_permutation": ((1, 2), (0, 2), (0, 1), (4, 5), (3, 5),
                                (3, 4))}


def table_of(name):
    """The port's (2, n) int32 table of a neighbour list of TABLES."""
    return torch.tensor(TABLES[name], dtype=torch.int32).t().contiguous()


def gathered(x, name, i, n=6):
    """The JAX side's x_kv of neighbour list i: the views gathered along
    the view axis, as ``_take_views`` does before the Pallas pair with
    shifts=None."""
    idx = jnp.asarray([p[i] for p in TABLES[name]])
    return jnp.take(x.reshape(-1, n, *x.shape[1:]), idx, axis=1).reshape(
        x.shape)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_k2_plain_matches_pallas_tables(name):
    """The pair over a neighbour table against the JAX pair with
    shifts=None on the views gathered by the same lists (the ring's table
    here and its shifts in test_k2_plain_matches_pallas_ring_shifts give
    the same function)."""
    rs = np.random.RandomState(10)
    n, Bg, L, C, H, D = 6, 2, 36, 48, 2, 40
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, C, H, D) for _ in range(3))
    scale = D ** -0.5
    xj = jnp.asarray(x)
    want = jfa.fused_kvstat_attention_pair(
        xj, gathered(xj, name, 0), gathered(xj, name, 1), jq, jk, jv,
        heads=H, scale=scale, interpret=True, shifts=None)
    got = reference.kvstat_attention_pair(torch.from_numpy(x), tq, tk, tv, H,
                                          scale, table_of(name))
    np.testing.assert_allclose(got.numpy(), _unpad(want, Bg * n, L, H, D),
                               atol=ATOL, rtol=RTOL)


def _ff_weights(rs, K, N, C):
    k1 = (rs.randn(K, 2 * N) * K ** -0.5).astype(np.float32)
    b1 = (rs.randn(2 * N) * 0.1).astype(np.float32)
    k2 = (rs.randn(N, C) * N ** -0.5).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (jnp.asarray(k1), jnp.asarray(b1), jnp.asarray(k2)), \
        (t(k1.T), t(b1), t(k2.T))


def test_k3_plain_matches_pallas():
    rs = np.random.RandomState(2)
    K, N, C = 48, 160, 48
    x = rs.randn(2, 37, K).astype(np.float32)
    (k1, b1, k2), (w1, tb1, w2) = _ff_weights(rs, K, N, C)
    want = jgg.fused_ff(jnp.asarray(x), k1, b1, k2, interpret=True)
    got = reference.fused_ff(torch.from_numpy(x), w1, tb1, w2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_k4_plain_matches_pallas(with_bias):
    rs = np.random.RandomState(3)
    K, N = 48, 160
    x = rs.randn(2, 37, K).astype(np.float32)
    (k1, b1, _), (w1, tb1, _) = _ff_weights(rs, K, N, K)
    want = jgg.fused_geglu(jnp.asarray(x), k1, b1 if with_bias else None,
                           interpret=True)
    got = reference.fused_geglu(torch.from_numpy(x), w1,
                                tb1 if with_bias else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# every transformer of the 224x400 preset: (latent level L, width C, head
# depth D); 8 heads, text context 1 + 77 + 160 tokens of width 768
_LEVELS = [(1400, 320, 40), (350, 640, 80), (91, 1280, 160),
           (28, 1280, 160)]
_CTX, _CTX_DIM = 1 + 77 + 160, 768


def _jax_route(monkeypatch, mode, Lq, Lk, C, D, esize):
    """The JAX package's kernel for an attention: None (XLA), "kvstat",
    "out" or "projected", with its _FUSED_MODE patched to ``mode``."""
    from magicdrive_tpu.core import attention as jattn

    if Lq * Lk < jattn._AUTO_PALLAS_MIN_LOGITS or D > jattn._LANE:
        return None
    monkeypatch.setattr(jattn, "_FUSED_MODE", mode)
    return jattn.fused_mode_for(Lq, Lk, C, D, esize) or "projected"


def _jax_pair_route(monkeypatch, mode, L, C, D, esize):
    """As _jax_route for the cross-view pair (core/transformer.py
    _cross_view): "loops" where it runs one attention per neighbour."""
    route = _jax_route(monkeypatch, mode, L, L, C, D, esize)
    fits = {"out": jfa.pair_is_efficient, "kvstat": jfa.kvstat_pair_fits}
    if route in fits and not fits[route](L, L, C, D, esize):
        return "loops"
    return route


# the port's per-neighbour loops under the names _jax_route and
# _jax_pair_route give the JAX package's branches
_JAX_NAME = {"kvstat_loop": "loops", "out_loop": "loops",
             "projected_loop": "projected"}


def _port_route(fn, *args):
    """The port's route, its loop names mapped onto JAX's "loops" and
    "projected"."""
    route = fn(*args)
    return _JAX_NAME.get(route, route)


def test_routing_matches_jax_rules_224x400(monkeypatch):
    """In either fused mode each 224x400 shape goes to the JAX package's
    kernel: under "kvstat" K1 at attn1 on both upper levels and attn2 at
    level 0, K2 at attn4 on both; under "auto" K8 and its pair at the same
    shapes. K3 takes the FF at level 0 only."""
    for mode, single, pair in (("kvstat", "kvstat", "kvstat"),
                               ("auto", "out", "out")):
        chosen = set()
        with dispatch.fused_mode(mode):
            for L, C, D in _LEVELS:
                for name, Lk, Ck in (("attn1", L, C),
                                     ("attn2", _CTX, _CTX_DIM)):
                    want = _jax_route(monkeypatch, mode, L, Lk, max(C, Ck),
                                      D, 2)
                    got = dispatch.attention_route(L, Lk, max(C, Ck), D, 2)
                    assert got == want, (mode, name, L, C, D)
                    if got:
                        chosen.add((name, L, got))
                want = _jax_pair_route(monkeypatch, mode, L, C, D, 2)
                got = dispatch.pair_route(L, C, D, 2)
                assert got == want, (mode, "attn4", L, C, D)
                if got:
                    chosen.add(("attn4", L, got))
                assert dispatch.ff_full_fusion_fits(C, 4 * C, C) == \
                    jgg.ff_full_fusion_fits(C, 4 * C, C, 2), C
        assert chosen == {("attn1", 1400, single), ("attn1", 350, single),
                          ("attn2", 1400, single), ("attn4", 1400, pair),
                          ("attn4", 350, pair)}, mode
    assert [dispatch.ff_full_fusion_fits(C, 4 * C, C)
            for _, C, _ in _LEVELS] == [True, False, False, False]


_JAX_PRESETS = ("sd15mv_rawbox_224x400", "sd15mv_rawbox_272x736",
                "sd15mv_rawbox_424x800", "sd15mv_rawbox_video_16f",
                "tiny_debug", "micro_debug", "small_parity")


def _attention_shapes(preset):
    """Every attention of a preset's UNet and ControlNet as (kind, Lq, Lk,
    C, D): attn1, attn2 (C = max(C, Ck)), attn4 (the cross-view pair, Lk =
    Lq) and the temporal attention over frames, at every latent level."""
    u = preset.unet
    h, w = preset.pipeline.latent_height, preset.pipeline.latent_width
    ctx = 1 + 77 + preset.bbox_max_len
    shapes = []
    for C in u.block_out_channels:
        L, D = h * w, C // u.num_attention_heads
        shapes += [("attn1", L, L, C, D),
                   ("attn2", L, ctx, max(C, u.cross_attention_dim), D)]
        if u.neighboring_view_pair is not None:
            shapes.append(("attn4", L, L, C, D))
        F = getattr(u, "temporal_frames", None)  # the port has no video
        if F:
            shapes.append(("temporal", F, F, C, D))
        h, w = -(-h // 2), -(-w // 2)
    return shapes


@pytest.mark.parametrize("name", _JAX_PRESETS)
def test_routing_matches_jax_every_preset(name, monkeypatch):
    """Both fused modes, bf16 and fp32 elements: the port picks the JAX
    package's kernel at every attention shape, the per-neighbour loops and
    the projected route included."""
    from magicdrive_tpu.config import presets as jp

    preset = getattr(jp, name)()
    routes = set()
    for mode in dispatch.FUSED_MODES:
        with dispatch.fused_mode(mode):
            for esize in (2, 4):
                for kind, Lq, Lk, C, D in _attention_shapes(preset):
                    if kind == "attn4":
                        want = _jax_pair_route(monkeypatch, mode, Lq, C, D,
                                               esize)
                        got = _port_route(dispatch.pair_route, Lq, C, D,
                                          esize)
                    else:
                        want = _jax_route(monkeypatch, mode, Lq, Lk, C, D,
                                          esize)
                        got = _port_route(dispatch.attention_route, Lq, Lk,
                                          C, D, esize)
                    assert got == want, (mode, esize, kind, Lq, Lk, C, D)
                    routes.add((mode, esize, kind, Lq, got))
    if name == "sd15mv_rawbox_424x800":
        # the level-0 pair does not fit K2's rule: JAX runs one K1 per
        # neighbour, and so does the port; at fp32 its attn1 there takes
        # the projected route
        assert ("kvstat", 2, "attn4", 5300, "loops") in routes
        assert dispatch.pair_route(5300, 320, 40, 2) == "kvstat_loop"
        assert ("kvstat", 4, "attn1", 5300, "projected") in routes


# the routes the port's modules take (core/attention.py Attention.forward,
# core/transformer.py BasicTransformerBlock._cross_view)
_MODULE_ROUTES = {None, "kvstat", "out", "projected"}
_MODULE_PAIR_ROUTES = {None, "kvstat", "out", "kvstat_loop", "out_loop",
                       "projected_loop"}


def test_port_presets_reach_no_unported_route():
    """The port's presets route every attention to SDPA or a route its
    modules take, in both modes: 224x400, 272x736 and 424x800 in bf16, the
    type they run in on the card, tiny_debug in bf16 and in fp32, the CPU
    tests' type. The hi-res presets reach the per-neighbour K1 loop at bf16
    (424x800 level 0) and, at fp32, the projected route and its loop."""
    from magicdrive_tpu_torch import config

    seen = set()
    for preset, esizes in ((config.sd15mv_rawbox_224x400(), (2,)),
                           (config.sd15mv_rawbox_272x736(), (2, 4)),
                           (config.sd15mv_rawbox_424x800(), (2, 4)),
                           (config.tiny_debug(), (2, 4))):
        for mode in dispatch.FUSED_MODES:
            with dispatch.fused_mode(mode):
                for esize in esizes:
                    for kind, Lq, Lk, C, D in _attention_shapes(preset):
                        if kind == "attn4":
                            route = dispatch.pair_route(Lq, C, D, esize)
                            assert route in _MODULE_PAIR_ROUTES, route
                        else:
                            route = dispatch.attention_route(Lq, Lk, C, D,
                                                             esize)
                            assert route in _MODULE_ROUTES, route
                        seen.add((preset.name, esize, route))
    assert ("SDv1.5mv-rawbox-424x800", 2, "kvstat_loop") in seen
    assert ("SDv1.5mv-rawbox-424x800", 4, "projected_loop") in seen
    assert ("SDv1.5mv-rawbox-272x736", 4, "projected") in seen


def test_fused_mode_is_read_once_and_switchable(monkeypatch):
    """MAGICDRIVE_FUSED_MODE takes "kvstat" (the default) or "auto";
    anything else raises, from the environment and from the context
    manager, which restores the mode it found."""
    monkeypatch.delenv("MAGICDRIVE_FUSED_MODE", raising=False)
    assert dispatch._mode_from_env() == "kvstat"
    monkeypatch.setenv("MAGICDRIVE_FUSED_MODE", "auto")
    assert dispatch._mode_from_env() == "auto"
    monkeypatch.setenv("MAGICDRIVE_FUSED_MODE", "out")
    with pytest.raises(ValueError, match="MAGICDRIVE_FUSED_MODE"):
        dispatch._mode_from_env()
    before = dispatch.FUSED_MODE
    with dispatch.fused_mode("auto"):
        assert dispatch.FUSED_MODE == "auto"
        assert dispatch.attention_route(1400, 1400, 320, 40, 2) == "out"
    assert dispatch.FUSED_MODE == before
    with pytest.raises(ValueError):
        with dispatch.fused_mode("kvstat-only"):
            pass
    assert dispatch.FUSED_MODE == before


@pytest.mark.parametrize("C", [8, 16, 32, 512, 560, 576])
def test_ff_rule_matches_jax_off_preset(C):
    """Other widths (tiny presets, and near the rule's edge) too."""
    assert dispatch.ff_full_fusion_fits(C, 4 * C, C) == \
        jgg.ff_full_fusion_fits(C, 4 * C, C, 2)


def test_cpu_wrappers_run_plain_versions_uncounted():
    """On the CPU the wrappers are the plain versions and count nothing;
    a device without a kernel raises."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(6, 20, 16).astype(np.float32))
    w = [torch.from_numpy(rs.randn(16, 16).astype(np.float32))
         for _ in range(4)]
    b = torch.from_numpy(rs.randn(32).astype(np.float32))
    ring = reference.ring_table((5, 1), 6)
    dispatch.reset_launches()
    torch.testing.assert_close(
        dispatch.kvstat_attention(x, x, *w[:3], 2, 0.3),
        reference.kvstat_attention(x, x, *w[:3], 2, 0.3), rtol=0, atol=0)
    torch.testing.assert_close(
        dispatch.kvstat_attention_pair(x, *w[:3], 2, 0.3, ring),
        reference.kvstat_attention_pair(x, *w[:3], 2, 0.3, ring),
        rtol=0, atol=0)
    for name, args in (("fused_qkv_attention", (x, x, *w[:3], 2, 0.3)),
                       ("fused_qkv_out_attention", (x, x, *w, 2, 0.3)),
                       ("fused_qkv_out_attention_pair",
                        (x, *w, 2, 0.3, ring))):
        torch.testing.assert_close(getattr(dispatch, name)(*args),
                                   getattr(reference, name)(*args),
                                   rtol=0, atol=0)
    w1 = torch.cat([w[0], w[1]])
    torch.testing.assert_close(dispatch.fused_ff(x, w1, b, w[2]),
                               reference.fused_ff(x, w1, b, w[2]),
                               rtol=0, atol=0)
    torch.testing.assert_close(dispatch.fused_geglu(x, w1, b),
                               reference.fused_geglu(x, w1, b),
                               rtol=0, atol=0)
    assert all(v == 0 for v in dispatch.LAUNCHES.values())
    with pytest.raises(ValueError, match="no kernel for device"):
        dispatch.fused_geglu(x.to("meta"), w1.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# K5 and K6 (the flash forward and backward), and the autograd of K1-K4
# ---------------------------------------------------------------------------

# the module (the package re-exports its function under the same name)
jfl = importlib.import_module("magicdrive_tpu.kernels.flash_attention")

from magicdrive_tpu_torch.kernels import autograd  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _flash_inputs(rs, BH, Lq, Lk, D):
    q = (rs.randn(BH, Lq, D) * D ** -0.5).astype(np.float32)
    k, v = (rs.randn(BH, Lk, D).astype(np.float32) for _ in range(2))
    return q, k, v


# (BH, Lq, Lk, D, kv_len, block_q, block_k): the level-0 head depth with
# several k blocks (the online rescaling), a ragged Lk with keys masked past
# kv_len, and one block covering everything
_FLASH_CASES = [(3, 80, 96, 40, 96, 32, 32), (2, 48, 72, 16, 61, 16, 32),
                (2, 40, 24, 80, 24, 64, 64)]


@pytest.mark.parametrize("BH,Lq,Lk,D,kv_len,bq,bk", _FLASH_CASES)
def test_k5_plain_matches_pallas(BH, Lq, Lk, D, kv_len, bq, bk):
    q, k, v = _flash_inputs(np.random.RandomState(5), BH, Lq, Lk, D)
    o, lse = jfl._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            1.0, kv_len, bq, bk, True, with_lse=True)
    got_o, got_lse = reference.flash_attention_fwd(_t(q), _t(k), _t(v),
                                                   kv_len)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse)[..., 0],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("BH,Lq,Lk,D,kv_len,bq,bk", _FLASH_CASES)
def test_k6_plain_matches_pallas(BH, Lq, Lk, D, kv_len, bq, bk, monkeypatch):
    """The backward picks its own blocks; they are forced small here so
    that the dq pass streams several k blocks and the dk/dv pass several q
    blocks."""
    monkeypatch.setattr(jfl, "_auto_blocks_bwd", lambda *a: (bq, bk))
    rs = np.random.RandomState(6)
    q, k, v = _flash_inputs(rs, BH, Lq, Lk, D)
    do = rs.randn(BH, Lq, D).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = jfl._flash_fwd(jq, jk, jv, 1.0, kv_len, bq, bk, True)
    want = jfl._flash_bwd(jq, jk, jv, o, lse, jnp.asarray(do), 1.0, kv_len,
                          bq, bk, True)
    got = reference.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(np.asarray(o)), _t(np.asarray(lse)[..., 0]),
        _t(do), kv_len)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("BH,Lq,Lk,D,kv_len,bq,bk", _FLASH_CASES)
def test_k6_launches_match_pallas(BH, Lq, Lk, D, kv_len, bq, bk,
                                  monkeypatch):
    """K6 as its wrappers split it, through the plain path: the first
    launch's dq and delta = rowsum(dO * O), then dk and dv from that delta
    in place of o, against the Pallas backward (which computes delta
    inside); the whole wrapper gives the same three gradients."""
    monkeypatch.setattr(jfl, "_auto_blocks_bwd", lambda *a: (bq, bk))
    rs = np.random.RandomState(7)
    q, k, v = _flash_inputs(rs, BH, Lq, Lk, D)
    do = rs.randn(BH, Lq, D).astype(np.float32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = jfl._flash_fwd(jq, jk, jv, 1.0, kv_len, bq, bk, True)
    want = jfl._flash_bwd(jq, jk, jv, o, lse, jnp.asarray(do), 1.0, kv_len,
                          bq, bk, True)
    tq, tk, tv, to, tdo = map(_t, (q, k, v, np.asarray(o), do))
    tlse = _t(np.asarray(lse)[..., 0])
    dispatch.reset_launches()
    dq, delta = dispatch.flash_attention_bwd_dq(tq, tk, tv, to, tlse, tdo,
                                                kv_len)
    assert delta.shape == (BH, Lq) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(),
                               (do * np.asarray(o)).sum(-1), atol=ATOL,
                               rtol=RTOL)
    dk, dv = dispatch.flash_attention_bwd_dkv(tq, tk, tv, tlse, delta, tdo,
                                              kv_len)
    for g, w, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    whole = dispatch.flash_attention_bwd(tq, tk, tv, to, tlse, tdo, kv_len)
    for g, w in zip(whole, (dq, dk, dv)):
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
    assert all(n == 0 for n in dispatch.LAUNCHES.values())


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    """Shape rules of the flash wrappers, checked before any launch: a head
    depth the kernels do not take (not a multiple of 8, or over 128), kv_len
    out of range, and row statistics of the wrong shape or dtype."""
    q = torch.zeros(2, 24, 40)
    assert dispatch._flash_shapes("f", q, torch.zeros(2, 30, 40), 17) == \
        (2, 24, 30, 40, 17)
    assert dispatch._flash_shapes("f", q, torch.zeros(2, 30, 40), None)[-1] \
        == 30
    for bad_q, bad_k, kv_len in ((torch.zeros(2, 24, 36),
                                  torch.zeros(2, 30, 36), None),
                                 (torch.zeros(2, 24, 136),
                                  torch.zeros(2, 30, 136), None),
                                 (q, torch.zeros(2, 30, 40), 31),
                                 (q, torch.zeros(2, 30, 40), 0),
                                 (q, torch.zeros(3, 30, 40), None)):
        with pytest.raises(ValueError, match="flash"):
            dispatch._flash_shapes("flash", bad_q, bad_k, kv_len)
    dispatch._fp32_rows("f", torch.zeros(2, 24), 2, 24, q.device)
    for bad in (torch.zeros(2, 23), torch.zeros(2, 24, dtype=torch.float64),
                torch.zeros(24, 2).t()):
        with pytest.raises(ValueError, match="row statistic"):
            dispatch._fp32_rows("f", bad, 2, 24, q.device)


def _grads_of(fn, inputs, dy):
    ts = [_t(a).requires_grad_() for a in inputs]
    fn(*ts).backward(_t(dy))
    return [t.grad.numpy() for t in ts]


def _pad_rows(w, H, D):
    """A JAX weight gradient (C, H*DP) -> the port's layout (H*D, C)."""
    w = np.asarray(w)
    return w.reshape(w.shape[0], H, DP)[..., :D].reshape(-1, H * D).T


@pytest.mark.parametrize("B,Lq,Lk,C,Ck,H,D", [
    (2, 48, 48, 32, 32, 2, 16),     # self-attention
    (1, 40, 24, 32, 48, 2, 40),     # cross-attention onto wider context
])
def test_k1_autograd_matches_jax_vjp(B, Lq, Lk, C, Ck, H, D):
    """The K1 Function's gradients against jax.vjp of the Pallas entry
    (whose backward is _fused_bwd: the flash forward and backward in
    interpret mode)."""
    rs = np.random.RandomState(7)
    xq = rs.randn(B, Lq, C).astype(np.float32)
    xkv = rs.randn(B, Lk, Ck).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, c, H, D)
                                    for c in (C, Ck, Ck))
    dy = rs.randn(B, Lq, H * D).astype(np.float32)
    scale = D ** -0.5
    dy_pad = np.pad(dy.reshape(B, Lq, H, D),
                    ((0, 0),) * 3 + ((0, DP - D),)).reshape(B, Lq, H, DP)
    _, vjp = jax.vjp(lambda *a: jfa.fused_kvstat_attention(
        *a, heads=H, scale=scale, interpret=True), jnp.asarray(xq),
        jnp.asarray(xkv), jq, jk, jv)
    want = vjp(jnp.asarray(dy_pad))
    got = _grads_of(lambda *a: autograd.kvstat_attention(*a, H, scale),
                    (xq, xkv, tq.numpy(), tk.numpy(), tv.numpy()), dy)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, _pad_rows(w, H, D), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("shifts", [(5, 1, 6), (1, 2, 6)])
def test_k2_autograd_matches_jax_vjp_ring_shifts(shifts):
    """The K2 Function's gradients over the ring's table against jax.vjp
    of the JAX pair with in-grid ring shifts. (1, 2) is not symmetric: a
    scatter of dx_kv to the wrong views would show there even where (5, 1)
    hid it."""
    rs = np.random.RandomState(8)
    n, Bg, L, C, H, D = 6, 1, 36, 32, 2, 16
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, C, H, D) for _ in range(3))
    dy = rs.randn(Bg * n, L, H * D).astype(np.float32)
    scale = D ** -0.5
    dy_pad = np.pad(dy.reshape(-1, L, H, D), ((0, 0),) * 3 + ((0, DP - D),))

    def pair(x, wq, wk, wv):
        return jfa.fused_kvstat_attention_pair(
            x, x, x, wq, wk, wv, heads=H, scale=scale, interpret=True,
            shifts=shifts)

    _, vjp = jax.vjp(pair, jnp.asarray(x), jq, jk, jv)
    want = vjp(jnp.asarray(dy_pad))
    table = reference.ring_table(shifts[:2], n)
    got = _grads_of(lambda *a: autograd.kvstat_attention_pair(
        *a, H, scale, table), (x, tq.numpy(), tk.numpy(), tv.numpy()), dy)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, _pad_rows(w, H, D), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("name", ["permuted", "not_a_permutation"])
def test_k2_autograd_matches_jax_vjp_tables(name):
    """The K2 Function's gradients over a neighbour table against jax.vjp
    of the JAX pair on gathered views. Off a permutation a view's dx_kv is
    the sum over the views that read it, or zero where none does."""
    rs = np.random.RandomState(11)
    n, Bg, L, C, H, D = 6, 2, 36, 32, 2, 16
    x = rs.randn(Bg * n, L, C).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_weights(rs, C, H, D) for _ in range(3))
    dy = rs.randn(Bg * n, L, H * D).astype(np.float32)
    scale = D ** -0.5
    dy_pad = np.pad(dy.reshape(-1, L, H, D), ((0, 0),) * 3 + ((0, DP - D),))

    def pair(x, wq, wk, wv):
        return jfa.fused_kvstat_attention_pair(
            x, gathered(x, name, 0), gathered(x, name, 1), wq, wk, wv,
            heads=H, scale=scale, interpret=True, shifts=None)

    _, vjp = jax.vjp(pair, jnp.asarray(x), jq, jk, jv)
    want = vjp(jnp.asarray(dy_pad))
    table = table_of(name)
    got = _grads_of(lambda *a: autograd.kvstat_attention_pair(
        *a, H, scale, table), (x, tq.numpy(), tk.numpy(), tv.numpy()), dy)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=RTOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, _pad_rows(w, H, D), atol=ATOL,
                                   rtol=RTOL)


def test_pair_tables_are_checked():
    """A pair entry takes a (2, n) int32 table on its input's device whose
    n divides the batch and whose entries lie in [0, n), on either device
    type."""
    x = torch.zeros(12, 8, 16)
    w = [torch.zeros(16, 16)] * 3
    for bad in (table_of("ring")[:1], table_of("ring").long(),
                table_of("ring").t(), torch.zeros(2, 5, dtype=torch.int32),
                torch.full((2, 6), 6, dtype=torch.int32),
                torch.full((2, 6), -1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="neighbour table"):
            dispatch.kvstat_attention_pair(x, *w, 2, 0.3, bad)
        with pytest.raises(ValueError, match="neighbour table"):
            dispatch.fused_qkv_out_attention_pair(x, *w, w[0], 2, 0.3, bad)
    table = table_of("ring")
    dispatch.kvstat_attention_pair(x, *w, 2, 0.3, table)
    table[0, 0] = 7  # an in-place change is checked again
    with pytest.raises(ValueError, match="outside"):
        dispatch.kvstat_attention_pair(x, *w, 2, 0.3, table)


@pytest.mark.parametrize("with_bias", [True, False])
def test_k4_autograd_matches_jax_vjp(with_bias):
    rs = np.random.RandomState(9)
    K, N = 48, 160
    x = rs.randn(2, 37, K).astype(np.float32)
    (k1, b1, _), (w1, tb1, _) = _ff_weights(rs, K, N, K)
    dy = rs.randn(2, 37, N).astype(np.float32)
    args = (jnp.asarray(x), k1) + ((b1,) if with_bias else ())
    _, vjp = jax.vjp(lambda x, k, *b: jgg.fused_geglu(
        x, k, b[0] if b else None, interpret=True), *args)
    want = vjp(jnp.asarray(dy))
    inputs = (x, w1.numpy()) + ((tb1.numpy(),) if with_bias else ())
    got = _grads_of(lambda x, w, *b: autograd.fused_geglu(
        x, w, b[0] if b else None), inputs, dy)
    np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]).T, atol=ATOL,
                               rtol=RTOL)
    if with_bias:
        np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=ATOL,
                                   rtol=RTOL)


def test_k3_autograd_matches_jax_vjp():
    rs = np.random.RandomState(10)
    K, N, C = 48, 160, 48
    x = rs.randn(2, 37, K).astype(np.float32)
    (k1, b1, k2), (w1, tb1, w2) = _ff_weights(rs, K, N, C)
    dy = rs.randn(2, 37, C).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jgg.fused_ff(*a, interpret=True),
                     jnp.asarray(x), k1, b1, k2)
    want = vjp(jnp.asarray(dy))
    got = _grads_of(autograd.fused_ff,
                    (x, w1.numpy(), tb1.numpy(), w2.numpy()), dy)
    for g, w, transpose in zip(got, want, (False, True, False, True)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w.T if transpose else w, atol=ATOL,
                                   rtol=RTOL)


def test_autograd_skips_gradients_not_needed():
    """Frozen weights get no gradient and cost no product; the forward is
    the dispatch wrapper's output exactly."""
    rs = np.random.RandomState(11)
    x = _t(rs.randn(2, 20, 16).astype(np.float32)).requires_grad_()
    w = [_t(rs.randn(16, 16).astype(np.float32)) for _ in range(3)]
    y = autograd.kvstat_attention(x, x, *w, 2, 0.3)
    torch.testing.assert_close(
        y, dispatch.kvstat_attention(x, x, *w, 2, 0.3), rtol=0, atol=0)
    y.sum().backward()
    assert x.grad is not None and all(t.grad is None for t in w)
    g = autograd.kvstat_attention_bwd(x.detach(), x.detach(), *w, 2, 0.3,
                                      torch.ones_like(y),
                                      (True, False, False, True, False))
    assert [t is None for t in g] == [False, True, True, False, True]
