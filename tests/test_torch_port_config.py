"""The port's config loader, presets from configs and run weights against
the JAX package.

``compose`` over the repository's ``configs/`` equals the JAX package's for
the root config, each exp, runner=debug, model=tiny_debug and the override
forms; ``preset_from_config`` equals the JAX package's field by field for
every exp and tiny_debug; the run config and its overrides replay, and a
run directory written by either package reads in the other. The weights:
``modules_to_jax_params`` inverts ``jax_params_to_state_dicts`` on every
JAX tree layout (tiny_debug, micro_debug with the Plus map embedder, the
video UNet, the unconditional maps), and ``save_params`` / ``load_params``
read and write the JAX package's ``params.npz`` + ``manifest.json``, bf16
leaves included. No JAX function is traced here beyond ``eval_shape``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_modules import shaped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")

OVERRIDES = [
    [],
    ["exp=224x400"],
    ["exp=272x736"],
    ["exp=424x800"],
    ["runner=debug"],
    ["model=tiny_debug"],
    ["model=tiny_debug", "runner=debug", "fid=default"],
    ["exp=272x736", "runner.learning_rate=1e-3", "seed=7",
     "model.unet.block_out_channels=[8,16,16,16]",
     "+runner.extra.depth=3", "+note=null", "dataset.version=v1.0-mini"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o)
                         or "root")
def test_compose_matches_jax(overrides):
    from magicdrive_tpu.config.loader import compose as jcompose

    from magicdrive_tpu_torch.config_loader import compose

    got = compose(CONFIGS, overrides=overrides)
    want = jcompose(CONFIGS, overrides=overrides)
    assert got == want
    assert got.runner.pipeline_param["num_inference_steps"] == \
        want.runner.pipeline_param["num_inference_steps"]


def test_compose_errors_match_jax():
    """An unknown key without ``+`` raises in both; unresolved
    interpolation is kept with ``resolve=False``."""
    from magicdrive_tpu.config.loader import compose as jcompose

    from magicdrive_tpu_torch.config_loader import compose

    for fn in (compose, jcompose):
        with pytest.raises(KeyError):
            fn(CONFIGS, overrides=["runner.no_such_key=1"])
        with pytest.raises(ValueError):
            fn(CONFIGS, overrides=["runner.learning_rate"])
    assert compose(CONFIGS, resolve=False) == jcompose(CONFIGS,
                                                       resolve=False)


def _same_fields(port, ref, where="preset"):
    """Every field of the port's dataclass equals the JAX one's field of
    that name (dtypes by name); returns the JAX fields the port lacks."""
    extra = {f.name for f in dataclasses.fields(ref)} - {
        f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(port):
        p, r = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(p):
            extra |= {f"{f.name}.{e}" for e in
                      _same_fields(p, r, f"{where}.{f.name}")}
        elif f.name == "dtype":
            assert str(p).split(".")[-1] == jnp.dtype(r).name, where
        else:
            assert p == r, f"{where}.{f.name}: {p!r} != {r!r}"
    return extra


# the JAX preset fields the port has no counterpart for: the UNet's launch
# layout (the port has one layout), the ControlNet's training drop ratios
# (the port's TrainConfig), and the
# options the port implements at one value (config._PORTED)
_NOT_MIRRORED = {
    "unet.neighboring_attn_type": "add", "unet.zero_module_type":
    "zero_linear", "unet.neighbor_batched": False,
    "controlnet.bbox.trainable_class_token": False,
    "controlnet.bbox.minmax_normalize": False,
    "controlnet.drop_cond_ratio": 0.25, "controlnet.drop_cam_num": 6,
}


@pytest.mark.parametrize("overrides", [
    ["exp=224x400"], ["exp=272x736"], ["exp=424x800"],
    ["model=tiny_debug", "runner=debug"]], ids=lambda o: " ".join(o))
def test_preset_from_config_matches_jax(overrides):
    from magicdrive_tpu.config.loader import compose as jcompose
    from magicdrive_tpu.config.presets import preset_from_config as jpreset

    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose

    got = preset_from_config(compose(CONFIGS, overrides=overrides))
    want = jpreset(jcompose(CONFIGS, overrides=overrides))
    extra = _same_fields(got, want)
    extra -= {"controlnet.unet." + k[5:] for k in _NOT_MIRRORED
              if k.startswith("unet.")}
    assert extra == set(_NOT_MIRRORED), extra
    for key, value in _NOT_MIRRORED.items():
        obj = want
        for part in key.split("."):
            obj = getattr(obj, part)
        assert obj == value, key


def test_preset_from_config_matches_the_hand_made_presets():
    """The configs' exps are the port's hand-made presets, but for the
    remat policy: the config reader's default is "dots" and the presets'
    None, as in the JAX package (either is inert without
    gradient_checkpointing)."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.config_loader import compose

    for exp, preset in (("224x400", config.sd15mv_rawbox_224x400()),
                        ("272x736", config.sd15mv_rawbox_272x736()),
                        ("424x800", config.sd15mv_rawbox_424x800())):
        got = config.preset_from_config(compose(CONFIGS,
                                                overrides=[f"exp={exp}"]))
        for u in (got.unet, got.controlnet.unet):
            assert u.remat_policy == "dots" and not u.gradient_checkpointing
        unet = dataclasses.replace(got.unet, remat_policy=None)
        got = dataclasses.replace(
            got, name=preset.name, unet=unet,
            controlnet=dataclasses.replace(got.controlnet, unet=dataclasses.
                                           replace(unet,
                                                   neighboring_view_pair=None)))
        assert got == preset, exp


def test_preset_from_config_raises_for_unported_options():
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose

    for ov in ("model.unet.neighboring_attn_type=concat",
               "model.unet.zero_module_type=gated",
               "model.bbox_embedder_param.minmax_normalize=true"):
        with pytest.raises(NotImplementedError, match=ov.split("=")[0][6:]):
            preset_from_config(compose(CONFIGS, overrides=[ov]))


def test_run_config_replays_across_packages(tmp_path):
    """Each package's run directory reads in the other: the composed
    config (plus the perf knobs recorded beside it) and the overrides,
    which recompose the same config."""
    from magicdrive_tpu.config import loader as jloader

    from magicdrive_tpu_torch import config_loader as loader

    overrides = ["model=tiny_debug", "runner=debug", "seed=3"]
    cfg = loader.compose(CONFIGS, overrides=overrides)
    for writer, reader in ((loader, jloader), (jloader, loader),
                           (loader, loader)):
        d = tmp_path / f"{writer.__name__}-{reader.__name__}"
        writer.save_run_config(cfg, str(d), overrides)
        back = reader.load_run_config(str(d))
        knobs = back.pop("perf_knobs")
        assert back == cfg
        assert "fused_mode" in knobs
        replay = reader.load_run_overrides(str(d))
        assert replay == overrides
        assert loader.compose(CONFIGS, overrides=replay) == cfg
    with open(tmp_path / f"{loader.__name__}-{jloader.__name__}"
              / "run_config.yaml") as f:
        assert yaml.safe_load(f)["perf_knobs"] == {"fused_mode": "kvstat"}


def test_run_overrides_empty_and_missing(tmp_path):
    """An empty overrides file and a missing one both replay as []."""
    from magicdrive_tpu_torch.config_loader import (load_run_overrides,
                                                    save_run_config)

    assert load_run_overrides(str(tmp_path)) == []
    save_run_config({"seed": 1}, str(tmp_path), [])
    assert load_run_overrides(str(tmp_path)) == []


def _jax_trees():
    """(name, JAX variable tree, port preset) for each tree layout: numpy
    leaves, seeded (``shaped``) on ``eval_shape``'s shapes."""
    from magicdrive_tpu.config import presets as P

    from magicdrive_tpu_torch import config

    def uncond(p, u):
        return dataclasses.replace(p, controlnet=dataclasses.replace(
            p.controlnet, use_uncond_map=u))

    cases = [("tiny_debug", P.tiny_debug(), config.tiny_debug()),
             ("tiny_video_debug", P.tiny_video_debug(2, 3),
              config.tiny_video_debug(2, 3))]
    for u in ("negative1", "learnable"):
        cases.append((f"uncond_{u}", uncond(P.tiny_debug(), u),
                      uncond(config.tiny_debug(), u)))
    rs = np.random.RandomState(0)
    for name, jp, tp in cases:
        m = jp.modules(dtype=jnp.float32)
        yield name, shaped(jax.eval_shape(
            lambda k: P.init_params(jp, m, k), jax.random.PRNGKey(0)), rs), tp


def _micro_keys():
    """Every state_dict key of micro_debug's tree (the Plus map embedder)
    with its flax path."""
    from flax import traverse_util
    from magicdrive_tpu.config import presets as P

    from magicdrive_tpu_torch.convert import clip_torch_key, torch_key

    p = P.micro_debug()
    m = p.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: P.init_params(p, m, k),
                            jax.random.PRNGKey(0))
    for name, tree in shapes.items():
        for path in traverse_util.flatten_dict(tree):
            key = (clip_torch_key if name == "clip" else torch_key)(path[1:])
            yield name, key, path[1:]


def _assert_trees_equal(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{where}/{k}")
        else:
            g = got[k]
            g = g.float().numpy() if isinstance(g, torch.Tensor) else g
            assert np.shape(g) == np.shape(want[k]), f"{where}/{k}"
            np.testing.assert_array_equal(g, np.asarray(want[k], np.float32)
                                          if np.asarray(want[k]).dtype.name
                                          == "bfloat16" else want[k],
                                          err_msg=f"{where}/{k}")


def test_modules_to_jax_params_inverts_the_converter():
    """The port's modules, loaded from a JAX tree, give that tree back:
    every path, collection and value, for every tree layout."""
    from magicdrive_tpu_torch.convert import (flax_path,
                                              jax_params_to_state_dicts,
                                              modules_to_jax_params)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    for name, tree, preset in _jax_trees():
        mods = MagicDriveModules.create(preset, device="cpu")
        mods.load_state_dicts(jax_params_to_state_dicts(tree))
        _assert_trees_equal(modules_to_jax_params(mods), tree, name)
    for module, key, path in _micro_keys():
        assert flax_path(module, key) == path, (module, key)


def test_serialization_matches_jax(tmp_path):
    """A tree saved by either package loads in the other unchanged; bf16
    leaves keep their dtype through the manifest (torch bf16 here,
    ml_dtypes bf16 in JAX) and their values."""
    from magicdrive_tpu.utils import serialization as jser

    from magicdrive_tpu_torch.utils import serialization as ser

    rs = np.random.RandomState(1)
    tree = {"unet": {"params": {"conv_in": {
        "kernel": rs.randn(3, 3, 4, 8).astype(np.float32),
        "bias": rs.randn(8).astype(np.float32)}}},
        "clip": {"params": {"position_embedding": rs.randn(77, 16).astype(
            np.float32)}}}
    bf16 = jnp.asarray(rs.randn(5, 3), jnp.bfloat16)
    jtree = {**tree, "vae": {"params": {"scale": np.asarray(bf16)}}}
    ptree = {**tree, "vae": {"params": {"scale": torch.from_numpy(
        np.array(bf16.astype(jnp.float32))).to(torch.bfloat16)}}}
    ser.save_params(ptree, str(tmp_path / "port"))
    jser.save_params(jtree, str(tmp_path / "jax"))
    for d in ("port", "jax"):
        with open(tmp_path / d / "manifest.json") as f:
            manifest = f.read()
        assert '"bfloat16"' in manifest
        got = ser.load_params(str(tmp_path / d))
        assert got["vae"]["params"]["scale"].dtype == torch.bfloat16
        _assert_trees_equal(got, jtree, d)
        back = jser.load_params(str(tmp_path / d))
        assert back["vae"]["params"]["scale"].dtype.name == "bfloat16"
        _assert_trees_equal(back, jtree, d)
    with open(tmp_path / "port" / "manifest.json") as f, \
            open(tmp_path / "jax" / "manifest.json") as g:
        assert f.read() == g.read()
