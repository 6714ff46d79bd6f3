"""The hi-res presets (272x736 and 424x800) in the port against the JAX
package, at the tiny widths with the hi-res geometry.

The Plus map embedder (200x200 -> 34x92), the standard one on a 400x400 map
(-> 53x100), one guided ControlNet + UNet eps on the 53x100 and 34x92
latents (the 53x100 level 0 takes the projected route and its
per-neighbour loop at fp32), the VAE decoder from 53x100, the cross-view
block's per-neighbour K1 and K8 loops, and the projected route's gradient,
each on converted weights against the JAX module. fp32, atol 2e-4 / rtol
2e-3 (tests/test_torch_port_modules.py), but for one bf16 case that tells
the loop's sum in the working dtype from K2's fp32 sum. JAX's guided eps
is one jit per preset, taken as two calls (the two CFG halves, six views
each, which share no attention) to halve the logits JAX holds at L=5300.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from magicdrive_tpu_torch.kernels import dispatch
from test_torch_port_modules import (ATOL, RTOL, close, init_random, load,
                                     nchw, shaped, to_nhwc)

torch.set_num_threads(1)

# the tiny widths with each hi-res geometry: latent (h, w), map (H, W), the
# Plus map embedder or not
_GEOMETRY = {"424x800": ((53, 100), (400, 400), False),
             "272x736": ((34, 92), (200, 200), True)}


# a ring of three cameras, each reading both others
_RING3 = ((2, 1), (0, 2), (1, 0))


def _tiny_hires(config, name):
    """``config.tiny_debug()`` (the JAX package's or the port's) at the
    latent, map and embedder of the hi-res preset ``name``, with one head
    and three cameras: the attention's logits at L=5300 are what the CPU
    time of this file goes to."""
    (h, w), map_hw, plus = _GEOMETRY[name]
    p = config.tiny_debug()
    unet = dataclasses.replace(p.unet, num_attention_heads=1,
                               neighboring_view_pair=_RING3)
    cn = dataclasses.replace(
        p.controlnet, unet=dataclasses.replace(unet,
                                               neighboring_view_pair=None),
        map_size=(8, *map_hw), use_map_embedder_plus=plus,
        map_embedder_plus_size=(h, w))
    return dataclasses.replace(
        p, unet=unet, controlnet=cn, map_hw=map_hw,
        image_size=(8 * h, 8 * w), pipeline=dataclasses.replace(
            p.pipeline, latent_height=h, latent_width=w, n_cam=3))


def test_map_embedder_plus_matches_jax():
    """The Plus embedder on a 200x200 map -> (34, 92), with its parameters
    converted strictly: conv_in, blocks.0-5 and conv_out."""
    from magicdrive_tpu.models.embedders import BEVMapEmbedderPlus as J

    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.models.embedders import BEVMapEmbedderPlus as T

    rs = np.random.RandomState(30)
    bev = (rs.rand(1, 200, 200, 8) > 0.5).astype(np.float32)
    jm = J(conditioning_embedding_size=(34, 92),
           block_out_channels=(4, 4, 8, 8), out_channels=8)
    v = init_random(jm, 31, jnp.asarray(bev))
    assert {k.rsplit(".", 1)[0] for k in module_state_dict(v)} == \
        {"conv_in", "conv_out"} | {f"blocks.{i}" for i in range(6)}
    tm = load(T(8, (4, 4, 8, 8), 8, (34, 92)), v)
    with torch.no_grad():
        got = tm(nchw(bev))
    want = jm.apply(v, jnp.asarray(bev))
    assert want.shape == (1, 34, 92, 8)
    close(to_nhwc(got), want)


def test_map_embedder_on_a_400x400_map():
    """The standard embedder's stride and padding plan takes the 424x800
    model's 400x400 map to its 53x100 latent."""
    from magicdrive_tpu.models.embedders import BEVMapEmbedder as J

    from magicdrive_tpu_torch.models.embedders import BEVMapEmbedder as T

    rs = np.random.RandomState(32)
    bev = (rs.rand(1, 400, 400, 8) > 0.5).astype(np.float32)
    jm = J(block_out_channels=(4, 4, 8, 8), out_channels=8)
    v = init_random(jm, 33, jnp.asarray(bev))
    tm = load(T(8, (4, 4, 8, 8), 8), v)
    with torch.no_grad():
        got = tm(nchw(bev))
    want = jm.apply(v, jnp.asarray(bev))
    assert want.shape == (1, 53, 100, 8)
    close(to_nhwc(got), want)


def _jax_guided_eps(jp, cn_vars, unet_vars, x, t, tokens2, bev2, g):
    """The JAX pipeline's guided eps (pipeline/pipeline.py ``_generate_fn``
    ``body``) on given tokens and maps, one CFG half at a time through one
    jit."""
    from magicdrive_tpu.models.controlnet import BEVControlNet
    from magicdrive_tpu.models.unet import UNet2DConditionModel

    cn = BEVControlNet(jp.controlnet, dtype=jnp.float32)
    unet = UNet2DConditionModel(jp.unet, dtype=jnp.float32)
    B, N, h, w, _ = x.shape
    L = jp.bbox_max_len

    @jax.jit
    def half_eps(cn_vars, unet_vars, x, tok, bev):
        feat = cn.apply(cn_vars, bev, method=BEVControlNet.embed_map)
        down, mid, _ = cn.apply(
            cn_vars, x, jnp.full((B,), t, jnp.int32),
            jnp.zeros((B, N, 3, 7)), jnp.zeros((B, 77, tok.shape[-1])), bev,
            jnp.zeros((B, N, L, 8, 3)), jnp.zeros((B, N, L), jnp.int32),
            jnp.zeros((B, N, L)), conditioning_scale=0.7, tokens=tok,
            cond_feat=feat)
        return unet.apply(
            unet_vars, x.reshape(N, h, w, 4), jnp.full((N,), t, jnp.int32),
            tok.reshape(N, *tok.shape[2:]),
            down_block_additional_residuals=down,
            mid_block_additional_residual=mid)

    eps_u, eps_c = (np.asarray(half_eps(
        cn_vars, unet_vars, jnp.asarray(x), jnp.asarray(tokens2[i:i + 1]),
        jnp.asarray(bev2[i:i + 1]))) for i in range(2))
    return (eps_u + g * (eps_c - eps_u))[None]


@pytest.fixture(scope="module", params=sorted(_GEOMETRY))
def hires_eps(request):
    """(JAX eps, port eps, the (L, C) of every transformer the port ran,
    the port's kernel calls, the port's preset) for one guided step of a
    tiny hi-res preset on seeded weights and inputs."""
    from magicdrive_tpu.config import presets as jconfig
    from magicdrive_tpu.models.controlnet import BEVControlNet
    from magicdrive_tpu.models.unet import UNet2DConditionModel

    from magicdrive_tpu_torch import config as tconfig
    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.core.transformer import BasicTransformerBlock
    from magicdrive_tpu_torch.models.clip_text import CLIPTextModel
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet as TCN
    from magicdrive_tpu_torch.models.unet import UNet2DConditionModel as TU
    from magicdrive_tpu_torch.models.vae import AutoencoderKL
    from magicdrive_tpu_torch.pipeline.pipeline import (Conditioning,
                                                        MagicDriveModules,
                                                        MagicDrivePipeline)

    jp = _tiny_hires(jconfig, request.param)
    tp = _tiny_hires(tconfig, request.param)
    h, w = tp.pipeline.latent_height, tp.pipeline.latent_width
    mh, mw = tp.map_hw
    N, L, d = 3, tp.bbox_max_len, tp.unet.cross_attention_dim
    rs = np.random.RandomState(34)
    key = jax.random.PRNGKey(0)
    z = jnp.zeros
    cn_vars = shaped(jax.eval_shape(
        BEVControlNet(jp.controlnet, dtype=jnp.float32).init, key,
        z((1, N, h, w, 4)), z((1,), jnp.int32), z((1, N, 3, 7)),
        z((1, 77, d)), z((1, mh, mw, 8)), z((1, N, L, 8, 3)),
        z((1, N, L), jnp.int32), z((1, N, L))), rs)
    unet_vars = shaped(jax.eval_shape(
        UNet2DConditionModel(jp.unet, dtype=jnp.float32).init, key,
        z((N, h, w, 4)), z((N,), jnp.int32), z((N, 1 + 77 + L, d))), rs)

    x = rs.randn(1, N, h, w, 4).astype(np.float32)
    tokens2 = rs.randn(2, N, 1 + 77 + L, d).astype(np.float32)
    bev2 = np.repeat((rs.rand(1, mh, mw, 8) > 0.5).astype(np.float32), 2, 0)
    t, g = 421, 2.0
    want = _jax_guided_eps(jp, cn_vars, unet_vars, x, t, tokens2, bev2, g)

    with torch.device("cpu"):
        mods = MagicDriveModules(
            unet=TU(tp.unet), controlnet=TCN(tp.controlnet),
            vae=AutoencoderKL(tp.vae), clip=CLIPTextModel(tp.clip))
    for mod, v in ((mods.controlnet, cn_vars), (mods.unet, unet_vars)):
        mod.load_state_dict({k: torch.from_numpy(a) for k, a in
                             module_state_dict(v).items()}, strict=True)
    mods.to("cpu", torch.float32)
    pipe = MagicDrivePipeline(mods, dataclasses.replace(
        tp.pipeline, guidance_scale=g, conditioning_scale=0.7))
    lengths = []
    for m in list(mods.controlnet.modules()) + list(mods.unet.modules()):
        if isinstance(m, BasicTransformerBlock):
            m.register_forward_hook(
                lambda m, a, out: lengths.append(tuple(a[0].shape[1:])))
    cond = Conditioning(torch.from_numpy(tokens2),
                        mods.controlnet.embed_map(nchw(bev2)), False)
    with torch.no_grad(), \
            chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        got = pipe.guided_eps(
            torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()), t, cond)
    return want, got.numpy().transpose(0, 1, 3, 4, 2), lengths, calls, tp


def test_hires_guided_eps_matches_jax(hires_eps):
    """One guided step (CFG 2.0, conditioning scale 0.7) of the ControlNet
    and the multiview UNet at the hi-res latent, every zero-initialised
    branch live; at 53x100 (fp32) level 0 runs the projected route and its
    per-neighbour loop, which the routing asserts."""
    want, got, _, _, tp = hires_eps
    if tp.pipeline.latent_height == 53:
        assert dispatch.attention_route(5300, 5300, 8, 8, 4) == "projected"
        assert dispatch.pair_route(5300, 8, 8, 4) == "projected_loop"
    assert got.shape == want.shape == (1, 3, tp.pipeline.latent_height,
                                       tp.pipeline.latent_width, 4)
    assert np.abs(want).max() > 0.1
    close(got, want)


def test_hires_levels_and_calls_match_the_derived_counts(hires_eps):
    """The UNet and ControlNet downsample the odd latents as the launch
    counts derive them (chip_smoke._transformers: ceil halving, 53x100 ->
    27x50 -> 14x25 -> 7x13, 34x92 -> 17x46 -> 9x23 -> 5x12): every
    transformer of the guided step ran, in order, at the derived length and
    width, and the kernel wrappers were called as often as
    chip_smoke.expected_launches derives for one forward at fp32."""
    _, _, lengths, calls, tp = hires_eps
    derived = [(L, C) for _, _, L, C, _ in chip_smoke._transformers(tp)]
    # uncond and cond branches run in one batch: each transformer once
    assert lengths == derived
    assert calls == chip_smoke.expected_launches(tp, dispatch.FUSED_MODE,
                                                 forwards=1, esize=4)
    if tp.pipeline.latent_height == 53:
        # 7 attn1 and 5 attn4 pairs at level 0 take K5, each pair twice
        assert calls["flash_attention_fwd"] == 17


def test_vae_decoder_from_53x100():
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.vae import AutoencoderKL as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.vae import AutoencoderKL as T

    rs = np.random.RandomState(35)
    z = rs.randn(1, 53, 100, 4).astype(np.float32)
    jm = J(jtiny().vae)
    v = init_random(jm, 36, jnp.zeros((1, 64, 96, 3)))
    tm = load(T(tiny_debug().vae), v)
    with torch.no_grad():
        got = tm.decode(nchw(z))
    want = jm.apply(v, jnp.asarray(z), method=J.decode)
    assert want.shape == (1, 424, 800, 3)
    close(to_nhwc(got), want)


def _block_pair(rs, C, H, D, Cc=24):
    """A JAX BasicTransformerBlock with the nuScenes ring on seeded
    weights, and the port's block loaded with them."""
    from magicdrive_tpu.core.transformer import BasicTransformerBlock as J
    from magicdrive_tpu.models.unet import NUSCENES_NEIGHBORS

    from magicdrive_tpu_torch.core.transformer import (
        BasicTransformerBlock as T)

    jm = J(C, H, D, cross_attention_dim=Cc,
           neighboring_view_pair=NUSCENES_NEIGHBORS)
    zeros = (jnp.zeros((6, 8, C)), jnp.zeros((6, 7, Cc)))
    v = shaped(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *zeros), rs)
    return jm, v, load(T(C, H, D, Cc, NUSCENES_NEIGHBORS), v)


@pytest.mark.parametrize("mode,L,C,D,kernel,route", [
    # 424x800 level 1 at fp32: K2's rule fails, one K1 per neighbour
    ("kvstat", 1350, 640, 80, "kvstat_attention", "kvstat_loop"),
    # 224x400 level 0 under auto at fp32: the K8 pair's rule fails, one K8
    # per neighbour, the out bias added twice
    ("auto", 1400, 320, 40, "fused_qkv_out_attention", "out_loop"),
])
def test_cross_view_loops_match_jax(mode, L, C, D, kernel, route):
    """The whole block (6 views, 8 heads) at a shape where the fp32 rules
    send the cross-view pair to a per-neighbour loop: attn1 and the two
    neighbours take the kernel (three calls), the pair kernels none. JAX
    runs XLA on the CPU, whatever its fused mode."""
    pair = {"kvstat_attention": "kvstat_attention_pair",
            "fused_qkv_out_attention": "fused_qkv_out_attention_pair"}[kernel]
    rs = np.random.RandomState(37)
    jm, v, tm = _block_pair(rs, C, 8, D)
    x = rs.randn(6, L, C).astype(np.float32)
    ctx = rs.randn(6, 7, 24).astype(np.float32)
    with dispatch.fused_mode(mode), torch.no_grad(), \
            chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        assert dispatch.pair_route(L, C, D, 4) == route
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    assert (calls[kernel], calls[pair]) == (3, 0)
    close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(ctx)))


@pytest.mark.parametrize("mode,L,C,D,kernel,route", [
    ("kvstat", 1350, 640, 80, "kvstat_attention", "kvstat_loop"),
    ("auto", 1400, 320, 40, "fused_qkv_out_attention", "out_loop"),
])
def test_cross_view_loops_grads_match_jax(mode, L, C, D, kernel, route):
    """The backward of the per-neighbour loops (ROADMAP A11, the routes a
    view-sharded step runs): at the shapes above, the gradients of the
    block's x, its context and its trainable weights (``norm4``,
    ``attn4``, ``connector``) against ``jax.vjp`` of the JAX block."""
    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.train.state import is_trainable

    rs = np.random.RandomState(38)
    jm, v, tm = _block_pair(rs, C, 8, D)
    x = rs.randn(6, L, C).astype(np.float32)
    ctx = rs.randn(6, 7, 24).astype(np.float32)
    dy = rs.randn(6, L, C).astype(np.float32)
    want, vjp = jax.vjp(lambda v, x, c: jm.apply(v, x, c), v,
                        jnp.asarray(x), jnp.asarray(ctx))
    gv, gx, gc = vjp(jnp.asarray(dy))
    del vjp
    gw = module_state_dict(gv)
    tx = torch.from_numpy(x).requires_grad_()
    tc = torch.from_numpy(ctx).requires_grad_()
    with dispatch.fused_mode(mode), \
            chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        assert dispatch.pair_route(L, C, D, 4) == route
        out = tm(tx, tc)
        out.backward(torch.from_numpy(dy))
    assert calls[kernel] >= 3 and not calls[kernel + "_pair"]
    close(out, want)
    close(tx.grad, gx)
    close(tc.grad, gc)
    trained = [k for k, _ in tm.named_parameters()
               if is_trainable("unet", k)]
    assert {k.split(".")[0] for k in trained} == {"norm4", "attn4",
                                                  "connector"}
    params = dict(tm.named_parameters())
    for k in trained:
        # a weight's gradient sums 6 L rows of O(1) terms, up to |g| ~ 200:
        # atol 2e-4 of the tensor's largest where that exceeds 1 (fp32)
        close(params[k].grad, gw[k],
              atol=ATOL * max(1.0, float(np.abs(gw[k]).max())))


def test_kvstat_loop_sums_in_bf16_as_jax(monkeypatch):
    """On bf16 inputs the per-neighbour K1 loop adds the two bf16 outputs in
    bf16, as JAX adds its two kernel outputs, where K2 sums in fp32 and
    casts once. The loop is forced at a small shape on both sides (the
    pair rules patched to fail; JAX's K1 in interpret mode), and attn4's
    out-projection and the connector are identities without bias, so the
    block's cross-view output is the summed o itself: the port's equals
    JAX's but for rare roundings of fp32 sums taken in another order, and
    differs from K2's plain version in many elements."""
    import flax.linen as nn

    from magicdrive_tpu.core import attention as jattn
    from magicdrive_tpu.core.transformer import BasicTransformerBlock as J
    from magicdrive_tpu.kernels import fused_attention as jfa

    class CrossView(J):
        """The JAX block's cross-view branch alone (norm4 to connector)."""
        @nn.compact
        def __call__(self, x):
            return self._cross_view(x)

    rs = np.random.RandomState(39)
    L, C, H, D = 300, 32, 2, 16
    jm, v, tm = _block_pair(rs, C, H, D)
    p = v["params"]
    eye = np.eye(C, dtype=np.float32)
    p["attn4"]["to_out"]["kernel"], p["connector"]["kernel"] = eye, eye
    p["attn4"]["to_out"]["bias"] = np.zeros(C, np.float32)
    p["connector"]["bias"] = np.zeros(C, np.float32)
    # weights exact in bf16: JAX keeps the LayerNorm's in fp32, the port's
    # bf16 module holds them in bf16
    v = jax.tree_util.tree_map(lambda a: np.asarray(
        jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32)), v)
    tm = load(type(tm)(C, H, D, 24, jm.neighboring_view_pair), v)
    tm.to(torch.bfloat16)
    x = rs.randn(6, L, C).astype(np.float32)

    def port(forced_loop):
        with monkeypatch.context() as m, torch.no_grad():
            if forced_loop:
                m.setattr(dispatch, "kvstat_pair_fits", lambda *a: False)
            route = dispatch.pair_route(L, C, D, 2)
            out = tm.connector(tm._cross_view(tm.norm4(
                torch.from_numpy(x).to(torch.bfloat16))))
        return route, out.float().numpy()

    route, got = port(True)
    assert route == "kvstat_loop"
    k2_route, k2 = port(False)
    assert k2_route == "kvstat"
    jb = CrossView(C, H, D, cross_attention_dim=24, dtype=jnp.bfloat16,
                   neighboring_view_pair=jm.neighboring_view_pair)
    with monkeypatch.context() as m:
        m.setattr(jattn, "_pallas_route", lambda *a: True)
        m.setattr(jattn, "_ATTN_IMPL", "fused")
        m.setattr(jattn, "_FUSED_MODE", "kvstat")
        m.setattr(jfa, "kvstat_pair_fits", lambda *a: False)
        want = np.asarray(jb.apply(v, jnp.asarray(x).astype(jnp.bfloat16)),
                          np.float32)
    assert np.mean(got != want) < 0.01
    assert np.mean(got != k2) > 0.1
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


def test_projected_attention_matches_jax():
    """An attention the fp32 rule sends to the projected route (Lq = Lk =
    5300, C = 8, D = 4: the tiny 424x800 level 0): the module's
    projections, then K5's plain version, against the JAX Attention."""
    from magicdrive_tpu.core.attention import Attention as J

    from magicdrive_tpu_torch.core.attention import Attention as T

    rs = np.random.RandomState(41)
    C, H, D, L = 8, 2, 4, 5300
    assert dispatch.attention_route(L, L, C, D, 4) == "projected"
    x = rs.randn(1, L, C).astype(np.float32)
    jm = J(C, H, D)
    v = init_random(jm, 42, jnp.asarray(x[:, :8]))
    tm = load(T(C, H, D), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    close(got, jm.apply(v, jnp.asarray(x)))


def test_projected_route_gradient_matches_jax_vjp():
    """The projected route's Function (q scaled outside, K5 forward, K6
    backward on its o and lse) against jax.vjp of the JAX flash_attention
    entry in interpret mode, whose custom VJP is the flash backward: the
    output and dq, dk, dv."""
    import importlib

    from magicdrive_tpu_torch.kernels import autograd

    jfl = importlib.import_module("magicdrive_tpu.kernels.flash_attention")
    rs = np.random.RandomState(43)
    B, Lq, Lk, H, D = 2, 80, 96, 2, 40
    q = rs.randn(B, Lq, H, D).astype(np.float32)
    k, v = (rs.randn(B, Lk, H, D).astype(np.float32) for _ in range(2))
    do = rs.randn(B, Lq, H, D).astype(np.float32)
    scale = D ** -0.5
    want, vjp = jax.vjp(lambda *a: jfl.flash_attention(
        *a, interpret=True, scale=scale), *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(do))
    ts = [torch.from_numpy(a.reshape(B, -1, H * D)).requires_grad_()
          for a in (q, k, v)]
    got = autograd.flash_attention(*ts, H, scale)
    got.backward(torch.from_numpy(do.reshape(B, Lq, H * D)))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want).reshape(B, Lq, H * D),
                               atol=ATOL, rtol=RTOL)
    for t, w, name in zip(ts, want_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(),
                                   np.asarray(w).reshape(t.shape),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
