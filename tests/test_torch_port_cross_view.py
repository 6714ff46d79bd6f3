"""The cross-view forms and the box-embedder options in the port against the
JAX package.

The cross-view attention of ``BasicTransformerBlock`` in each form ("add",
"concat", "self"), through each connector ("zero_linear", "gated",
"none"), over each kind of neighbour table of 6 views (the nuScenes ring,
the ring listed in another camera order, two 3-camera triangles, which is
not a permutation, one neighbour and three): the block's output, the
gradients of its inputs and those of its trainable weights (``norm4``,
``attn4``, ``connector``) against ``jax.vjp`` of the JAX block, in both
fused modes (the CPU runs each kernel's plain version); the routes of the
forms as ``chip_smoke`` derives its launch counts from them. The box
embedder with trainable class tokens and min-max boxes. Each form's
weights: the JAX converter's released layout loaded strictly, the tree
through ``modules_to_jax_params`` and back, and the trainable set of JAX's
``split_params``. fp32, atol 2e-4 / rtol 2e-3
(tests/test_torch_port_modules.py). The JAX variables are seeded values on
``jax.eval_shape``'s shapes, one tree per connector or form, shared across
cases; no JAX function is jitted. The guided eps of the variants the card
runs is in test_torch_port_cross_view_eps.py.
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
from test_torch_port_convert import _released
from test_torch_port_cross_view_eps import VARIANTS, _variant
from test_torch_port_modules import close, load, shaped

torch.set_num_threads(1)

# neighbour lists of 6 views: the nuScenes ring; the same ring with the
# cameras numbered another way (0-1-4-3-5-2); two triangles, where view 0
# is read by views 1 and 2 of the first list and view 2 by none; one
# neighbour; three (the ring and the opposite camera)
TABLES = {
    "ring": ((5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0)),
    "permuted": ((1, 2), (4, 0), (0, 5), (5, 4), (3, 1), (2, 3)),
    "not_a_permutation": ((1, 2), (0, 2), (0, 1), (4, 5), (3, 5), (3, 4)),
    "k1": ((1,), (2,), (0,), (4,), (5,), (3,)),
    "k3": ((5, 1, 3), (0, 2, 4), (1, 3, 5), (2, 4, 0), (3, 5, 1),
           (4, 0, 2)),
}
FORMS = ("add", "concat", "self")
CONNECTORS = ("zero_linear", "gated", "none")

# the block: one sample of 6 views at L = 300, at the kernel threshold
# (L^2 = 90 000 logits); the guided eps (test_torch_port_cross_view_eps.py)
# runs two samples, the CFG branches, in one batch
C, H, D, CC, L, VIEWS = 32, 2, 16, 24, 300, 6


def _block_inputs():
    rs = np.random.RandomState(40)
    return (rs.randn(VIEWS, L, C).astype(np.float32),
            rs.randn(VIEWS, 7, CC).astype(np.float32),
            rs.randn(VIEWS, L, C).astype(np.float32))


def _jax_block(form, connector, pairs):
    from magicdrive_tpu.core.transformer import BasicTransformerBlock

    return BasicTransformerBlock(C, H, D, cross_attention_dim=CC,
                                 neighboring_view_pair=pairs,
                                 neighboring_attn_type=form,
                                 zero_module_type=connector)


@functools.lru_cache(maxsize=None)
def _block_variables(connector):
    """The block's JAX variables for a connector: the forms and tables use
    the same weights."""
    x, ctx, _ = _block_inputs()
    abstract = jax.eval_shape(
        _jax_block("add", connector, TABLES["ring"]).init,
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ctx))
    return shaped(abstract, np.random.RandomState(41))


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("connector", CONNECTORS)
@pytest.mark.parametrize("form", FORMS)
def test_cross_view_block_matches_jax(form, connector, table):
    """Output and gradients (inputs, trainable weights) of the block in
    each form, connector and table, under both fused modes."""
    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.core.transformer import BasicTransformerBlock
    from magicdrive_tpu_torch.train.state import is_trainable

    pairs = TABLES[table]
    x, ctx, dy = _block_inputs()
    v = _block_variables(connector)
    jm = _jax_block(form, connector, pairs)
    want, vjp = jax.vjp(lambda v, x, c: jm.apply(v, x, c), v,
                        jnp.asarray(x), jnp.asarray(ctx))
    gv, gx, gc = vjp(jnp.asarray(dy))
    gw = module_state_dict(gv)
    tm = load(BasicTransformerBlock(C, H, D, CC, pairs, None, form,
                                    connector), v)
    trained = [k for k, _ in tm.named_parameters()
               if is_trainable("unet", k)]
    assert trained and all(k.split(".")[0] in ("norm4", "attn4", "connector")
                           for k in trained)
    assert any(k.startswith("connector.") for k in trained) == \
        (connector != "none")
    assert set(gw) >= set(trained)
    for mode in dispatch.FUSED_MODES:
        tm.zero_grad()
        tx = torch.from_numpy(x).requires_grad_()
        tc = torch.from_numpy(ctx).requires_grad_()
        with dispatch.fused_mode(mode):
            out = tm(tx, tc)
            out.backward(torch.from_numpy(dy))
        close(out, want)
        close(tx.grad, gx)
        close(tc.grad, gc)
        params = dict(tm.named_parameters())
        for k in trained:
            close(params[k].grad, gw[k])


def test_block_routes_each_form_as_jax():
    """The routes of the forms at the block's shape: the "add" pair at two
    lists, one call a list otherwise, "concat" as one attention of 2L or 3L
    keys, "self" over the 6L tokens of a sample."""
    from magicdrive_tpu_torch import config

    for mode, pair, single in (("kvstat", "kvstat_attention_pair",
                                "kvstat_attention"),
                               ("auto", "fused_qkv_out_attention_pair",
                                "fused_qkv_out_attention")):
        with dispatch.fused_mode(mode):
            for form, table, want in (
                    ("add", "ring", (pair, 1, 2)),
                    ("add", "not_a_permutation", (pair, 1, 2)),
                    ("add", "k1", (single, 1, 1)),
                    ("add", "k3", (single, 3, 3)),
                    ("concat", "k3", (single, 1, 1)),
                    ("self", "ring", None)):
                cfg = dataclasses.replace(
                    config.UNetConfig(), neighboring_view_pair=TABLES[table],
                    neighboring_attn_type=form)
                got = chip_smoke.cross_view_calls(cfg, L, C, D, 4)
                if want is not None:
                    assert got == want, (mode, form, table)
    with dispatch.fused_mode("kvstat"):
        # "self" at the 224x400 level 0 (Lq = Lk = 6 * 1400, bf16): the
        # projected route, K1 above it
        cfg = dataclasses.replace(config.UNetConfig(),
                                  neighboring_view_pair=TABLES["ring"],
                                  neighboring_attn_type="self")
        assert chip_smoke.cross_view_calls(cfg, 1400, 320, 40, 2) == (
            "flash_attention_fwd", 1, 1)
        assert chip_smoke.cross_view_calls(cfg, 350, 640, 80, 2) == (
            "kvstat_attention", 1, 1)


@pytest.mark.parametrize("minmax", [False, True])
@pytest.mark.parametrize("trainable", [False, True])
def test_bbox_embedder_options_match_jax(trainable, minmax):
    """Trainable class tokens (a parameter, in JAX's params) and min-max
    boxes: the embedding and, with trainable tokens, their gradient."""
    from magicdrive_tpu.models.embedders import (
        BBoxEmbedderConfig as JC, ContinuousBBoxWithTextEmbedding as J)

    from magicdrive_tpu_torch.config import BBoxEmbedderConfig as TC
    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.models.embedders import (
        ContinuousBBoxWithTextEmbedding as T)

    rs = np.random.RandomState(42)
    boxes = (rs.randn(2, 6, 5, 8, 3) * 40).astype(np.float32)
    classes = rs.randint(-1, 10, (2, 6, 5)).astype(np.int32)
    masks = (rs.rand(2, 6, 5) > 0.4).astype(np.float32)
    kw = dict(class_token_dim=16, proj_dims=(16, 8, 8, 16),
              trainable_class_token=trainable, minmax_normalize=minmax)
    jm = J(JC(**kw))
    jargs = tuple(map(jnp.asarray, (boxes, classes, masks)))
    v = shaped(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jargs), rs)
    assert ("class_tokens" in v["params"]) == trainable
    tm = load(torch.nn.ModuleDict({"bbox_embedder": T(TC(**kw))}),
              {c: {"bbox_embedder": tree} for c, tree in v.items()})
    emb = tm["bbox_embedder"]
    assert isinstance(emb._class_tokens, torch.nn.Parameter) == trainable
    dy = rs.randn(2, 6, 5, 16).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jm.apply(v, *jargs), v)
    got = emb(torch.from_numpy(boxes), torch.from_numpy(classes),
              torch.from_numpy(masks))
    close(got, want)
    if trainable:
        got.backward(torch.from_numpy(dy))
        g = module_state_dict({"params": {"bbox_embedder": vjp(
            jnp.asarray(dy))[0]["params"]}})
        close(emb._class_tokens.grad, g["bbox_embedder._class_tokens"])


# the JAX init tree of each form with its port preset: the variants (a)
# and (c), and "self" with the zero linear; each connector of the video
# model's temporal attention
def _form_presets(config):
    p = config.tiny_debug()
    v = config.tiny_video_debug(2, 6)
    return {
        "a": _variant(config, VARIANTS["a"]),
        "c": _variant(config, VARIANTS["c"]),
        "self": dataclasses.replace(p, unet=dataclasses.replace(
            p.unet, neighboring_attn_type="self")),
        "video_gated": dataclasses.replace(v, unet=dataclasses.replace(
            v.unet, zero_module_type="gated")),
        "video_none": dataclasses.replace(v, unet=dataclasses.replace(
            v.unet, zero_module_type="none")),
    }


@functools.lru_cache(maxsize=None)
def _form_tree(name):
    from magicdrive_tpu.config import presets as P

    jp = _form_presets(P)[name]
    m = jp.modules(dtype=jnp.float32)
    return shaped(jax.eval_shape(lambda k: P.init_params(jp, m, k),
                                 jax.random.PRNGKey(0)),
                  np.random.RandomState(45))


@pytest.mark.parametrize("name", ["a", "c", "self", "video_gated",
                                  "video_none"])
def test_form_weights_load_and_train_as_jax(name):
    """Each form's JAX tree: the JAX converter's released layout of its
    UNet and ControlNet loads strictly (``torch_weights.convert_module``)
    to the values the JAX converter reads; the tree goes through
    ``modules_to_jax_params`` and back; the trainable set is JAX's
    ``split_params`` key for key (the trainable class tokens and the gated
    alphas in it, no connector under "none")."""
    from magicdrive_tpu.convert import torch_weights as jtw
    from magicdrive_tpu.train.state import split_params

    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.convert import (jax_params_to_state_dicts,
                                              module_state_dict,
                                              modules_to_jax_params,
                                              torch_key)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.torch_weights import convert_module
    from magicdrive_tpu_torch.train.state import trainable_parameters
    from test_torch_port_config import _assert_trees_equal

    tree = _form_tree(name)
    preset = _form_presets(config)[name]
    mods = MagicDriveModules.create(preset, device="cpu")
    for mod_name in ("unet", "controlnet"):
        sd = _released(tree[mod_name])
        jax_read, _ = jtw.convert_module(tree[mod_name], sd, strict=True)
        mod = getattr(mods, mod_name)
        assert convert_module(mod, sd, strict=True) == []
        want = module_state_dict(jax_read)
        got = mod.state_dict()
        assert set(got) == set(want)
        for k, a in want.items():
            np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    mods.load_state_dicts(jax_params_to_state_dicts(tree))
    _assert_trees_equal(modules_to_jax_params(mods), tree, name)
    trainable, _ = split_params({n: tree[n] for n in ("unet", "controlnet")})
    want = {f"{n}.{torch_key(tuple(k.split('/')[2:]))}" for k in trainable
            for n in [k.split("/")[0]]}
    got = set(trainable_parameters(mods))
    assert got == want
    connectors = {k for k in got if ".connector" in k}
    unet_cfg = preset.unet
    if unet_cfg.zero_module_type == "none":
        assert not connectors
    else:
        assert connectors
    assert ("controlnet.bbox_embedder._class_tokens" in got) == \
        preset.controlnet.bbox.trainable_class_token
