"""One tiny guided eps of the cross-view variants the card runs, in the
port against the JAX package.

The variants (``chip_smoke.CROSS_VIEW_VARIANTS`` at tiny width): (a) "add"
over the nuScenes ring with the cameras numbered another way, the gated
connector, trainable class tokens and min-max boxes; (c) "concat" over the
ring without a connector. On seeded weights (``jax.eval_shape``'s shapes)
and inputs, one guided ControlNet + UNet step (CFG 2.0, conditioning scale
0.7) at a 14x25 latent through the Plus map embedder, whose level 0
(L = 350) takes the kernel routes: the tokens assembled from a camera,
text and boxes, and the eps, in both fused modes, against JAX at atol
2e-3 / rtol 2e-3, and the kernel calls as ``chip_smoke.expected_launches``
derives them at fp32. One JAX jit per variant, for both CFG branches.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from magicdrive_tpu_torch.kernels import dispatch
from test_torch_port_modules import close, nchw, shaped

torch.set_num_threads(1)

# the neighbour lists of the variants: the nuScenes ring, and the same ring
# with the cameras numbered another way (0-1-4-3-5-2)
TABLES = {"ring": ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0)),
          "permuted": ((1, 2), (4, 0), (0, 5), (5, 4), (3, 1), (2, 3))}

# the variants the card runs (chip_smoke.CROSS_VIEW_VARIANTS), at tiny width
VARIANTS = {
    "a": dict(form="add", table="permuted", connector="gated",
              trainable=True, minmax=True),
    "c": dict(form="concat", table="ring", connector="none",
              trainable=False, minmax=False),
}


# the variants' latent: 14x25 through the Plus map embedder, so that level
# 0 (L = 350) takes the kernel routes and the CPU time stays small
LATENT = (14, 25)


def _variant(config, v):
    """``config.tiny_debug()`` (the JAX package's or the port's) in a
    cross-view variant of VARIANTS, at the LATENT size."""
    p = config.tiny_debug()
    unet = dataclasses.replace(
        p.unet, neighboring_view_pair=TABLES[v["table"]],
        neighboring_attn_type=v["form"], zero_module_type=v["connector"])
    bbox = dataclasses.replace(p.controlnet.bbox,
                               trainable_class_token=v["trainable"],
                               minmax_normalize=v["minmax"])
    cn = dataclasses.replace(
        p.controlnet, bbox=bbox, use_map_embedder_plus=True,
        map_embedder_plus_size=LATENT,
        unet=dataclasses.replace(unet, neighboring_view_pair=None))
    return dataclasses.replace(
        p, unet=unet, controlnet=cn, image_size=(8 * LATENT[0],
                                                 8 * LATENT[1]),
        pipeline=dataclasses.replace(p.pipeline, latent_height=LATENT[0],
                                     latent_width=LATENT[1]))


@functools.lru_cache(maxsize=None)
def _variant_trees(name):
    """The JAX variable trees of a variant's ControlNet and UNet."""
    from magicdrive_tpu.config import presets as jconfig
    from magicdrive_tpu.models.controlnet import BEVControlNet
    from magicdrive_tpu.models.unet import UNet2DConditionModel

    jp = _variant(jconfig, VARIANTS[name])
    h, w = jp.pipeline.latent_height, jp.pipeline.latent_width
    N, Lb, d = 6, jp.bbox_max_len, jp.unet.cross_attention_dim
    key, z = jax.random.PRNGKey(0), jnp.zeros
    rs = np.random.RandomState(43)
    cn = shaped(jax.eval_shape(
        BEVControlNet(jp.controlnet, dtype=jnp.float32).init, key,
        z((1, N, h, w, 4)), z((1,), jnp.int32), z((1, N, 3, 7)),
        z((1, 77, d)), z((1, 200, 200, 8)), z((1, N, Lb, 8, 3)),
        z((1, N, Lb), jnp.int32), z((1, N, Lb))), rs)
    unet = shaped(jax.eval_shape(
        UNet2DConditionModel(jp.unet, dtype=jnp.float32).init, key,
        z((N, h, w, 4)), z((N,), jnp.int32), z((N, 1 + 77 + Lb, d))), rs)
    return jp, cn, unet


def _jax_guided_eps(jp, cn_vars, unet_vars, x, t, inputs, g):
    """The JAX pipeline's guided eps (pipeline/pipeline.py ``_generate_fn``
    ``body``) on one request's tokens, assembled from its camera, the two
    CFG branches' text and its boxes, one branch at a time through one jit;
    -> (eps, the two branches' tokens)."""
    from magicdrive_tpu.models.controlnet import BEVControlNet
    from magicdrive_tpu.models.unet import UNet2DConditionModel

    cn = BEVControlNet(jp.controlnet, dtype=jnp.float32)
    unet = UNet2DConditionModel(jp.unet, dtype=jnp.float32)
    cam, text2, boxes, classes, masks, bev = map(jnp.asarray, inputs)
    B, N, h, w, _ = x.shape

    @jax.jit
    def branch(cn_vars, unet_vars, x, text):
        feat = cn.apply(cn_vars, bev, method=BEVControlNet.embed_map)
        tok = cn.apply(cn_vars, cam, text, boxes, classes, masks,
                       method=BEVControlNet.assemble_tokens)
        down, mid, _ = cn.apply(
            cn_vars, x, jnp.full((B,), t, jnp.int32), cam, text, bev,
            boxes, classes, masks, conditioning_scale=0.7, tokens=tok,
            cond_feat=feat)
        return unet.apply(
            unet_vars, x.reshape(N, h, w, 4), jnp.full((N,), t, jnp.int32),
            tok.reshape(N, *tok.shape[2:]),
            down_block_additional_residuals=down,
            mid_block_additional_residual=mid), tok

    (eps_u, tok_u), (eps_c, tok_c) = (
        (np.asarray(a) for a in branch(cn_vars, unet_vars, jnp.asarray(x),
                                       text[None])) for text in text2)
    return (eps_u + g * (eps_c - eps_u))[None], np.concatenate([tok_u,
                                                                tok_c])


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_eps(request):
    """(JAX eps and tokens, the port's preset and pipeline, its inputs)
    for one guided step of a tiny variant on seeded weights and inputs."""
    from magicdrive_tpu_torch import config as tconfig
    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)

    jp, cn_vars, unet_vars = _variant_trees(request.param)
    tp = _variant(tconfig, VARIANTS[request.param])
    h, w = tp.pipeline.latent_height, tp.pipeline.latent_width
    N, Lb, d = 6, tp.bbox_max_len, tp.unet.cross_attention_dim
    rs = np.random.RandomState(44)
    x = rs.randn(1, N, h, w, 4).astype(np.float32)
    inputs = (rs.randn(1, N, 3, 7).astype(np.float32),
              rs.randn(2, 77, d).astype(np.float32),
              (rs.randn(1, N, Lb, 8, 3) * 40).astype(np.float32),
              rs.randint(0, 10, (1, N, Lb)).astype(np.int32),
              (rs.rand(1, N, Lb) > 0.3).astype(np.float32),
              (rs.rand(1, 200, 200, 8) > 0.5).astype(np.float32))
    t, g = 421, 2.0
    want = _jax_guided_eps(jp, cn_vars, unet_vars, x, t, inputs, g)
    mods = MagicDriveModules.create(tp, device="cpu")
    for mod, v in ((mods.controlnet, cn_vars), (mods.unet, unet_vars)):
        mod.load_state_dict({k: torch.from_numpy(a) for k, a in
                             module_state_dict(v).items()}, strict=True)
    mods.to("cpu", torch.float32)
    pipe = MagicDrivePipeline(mods, dataclasses.replace(
        tp.pipeline, guidance_scale=g, conditioning_scale=0.7))
    return want, tp, pipe, x, t, inputs


@pytest.mark.parametrize("mode", dispatch.FUSED_MODES)
def test_variant_guided_eps_matches_jax(variant_eps, mode):
    """One guided step of the variant: the tokens (min-max boxes and
    trainable class tokens in (a)) and the eps against JAX, the kernel
    calls as ``chip_smoke.expected_launches`` derives them at fp32."""
    from magicdrive_tpu_torch.pipeline.pipeline import Conditioning

    (want, want_tok), tp, pipe, x, t, inputs = variant_eps
    cam, text2, boxes, classes, masks, bev = map(torch.from_numpy, inputs)
    cn = pipe.m.controlnet
    with torch.no_grad(), dispatch.fused_mode(mode), \
            chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        tokens = torch.cat([cn.assemble_tokens(cam, text[None], boxes,
                                               classes, masks)
                            for text in text2])
        close(tokens, want_tok)
        # the map of both CFG branches
        cond = Conditioning(tokens, cn.embed_map(nchw(np.repeat(
            inputs[-1], 2, 0))), False)
        got = pipe.guided_eps(
            torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()), t, cond)
    got = got.numpy().transpose(0, 1, 3, 4, 2)
    assert np.abs(want).max() > 0.1
    close(got, want, atol=2e-3, rtol=2e-3)
    assert calls == chip_smoke.expected_launches(tp, mode, forwards=1,
                                                 esize=4)
