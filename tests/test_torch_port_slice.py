"""The port's generation slice against the JAX pipeline, the port's freedom
from jax, and the weight carry-over.

The ``tiny_debug`` preset (the 224x400 geometry at narrow widths) runs
2 UniPC steps at B=1 from the same numpy latents on converted weights in
both packages; the [0, 1] images agree to atol 2e-3. Every floating JAX
variable is replaced by seeded normals first, so the zero-initialised
cross-view connectors, ControlNet zero-convs and map-embedder conv_out are
live.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modules import randomized

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_jax():
    from magicdrive_tpu.config.presets import init_params, tiny_debug

    preset = tiny_debug()
    preset = dataclasses.replace(preset, pipeline=dataclasses.replace(
        preset.pipeline, num_inference_steps=2))
    modules = preset.modules(dtype=jnp.float32)
    params = init_params(preset, modules, jax.random.PRNGKey(0))
    return preset, modules, params


def _batch(preset):
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_dataset

    batch = collate_fn(make_dataset(1), CollateConfig(
        bbox_max_len=preset.bbox_max_len, canvas_hw=preset.image_size,
        is_train=False))
    del batch["pixel_values"]
    return batch


@pytest.fixture(scope="module")
def tiny_images(tiny_jax):
    """The JAX pipeline's images on randomized weights from numpy latents,
    with what the port needs to repeat the run."""
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline as JPipe

    preset, modules, params = tiny_jax
    rs = np.random.RandomState(0)
    params = randomized(params, rs)
    batch = _batch(preset)
    lat = np.repeat(rs.randn(1, 1, 28, 50, 4).astype(np.float32), 6, axis=1)
    want = np.asarray(JPipe(modules, params, preset.pipeline)(
        {k: jnp.asarray(v) for k, v in batch.items()},
        latents=jnp.asarray(lat)))
    return params, batch, lat, want


def _port_images(params, batch, lat):
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)

    tp = tiny_debug()
    mods = MagicDriveModules.create(tp, device="cpu").load_state_dicts(
        jax_params_to_state_dicts(params)).to("cpu", torch.float32)
    pipe = MagicDrivePipeline(mods, dataclasses.replace(
        tp.pipeline, num_inference_steps=2))
    return pipe(batch, latents=torch.from_numpy(lat)).numpy()


def test_tiny_pipeline_matches_jax(tiny_images):
    params, batch, lat, want = tiny_images
    got = _port_images(params, batch, lat)
    assert got.shape == want.shape == (1, 6, 224, 400, 3)
    assert 0.1 < want.std()  # the weights give the images real structure
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_tiny_pipeline_matches_jax_auto(tiny_images):
    """The same under MAGICDRIVE_FUSED_MODE=auto, where the port's 28x50 and
    14x25 attentions take K8 and the K8 pair (their plain versions here)
    instead of K1 and K2."""
    from magicdrive_tpu_torch.kernels import dispatch

    params, batch, lat, want = tiny_images
    with dispatch.fused_mode("auto"):
        assert dispatch.attention_route(1400, 1400, 8, 4, 4) == "out"
        assert dispatch.pair_route(350, 16, 8, 4) == "out"
        got = _port_images(params, batch, lat)
    np.testing.assert_allclose(got, want, atol=2e-3)


def assert_converts_every_leaf(params, port_preset):
    """Every leaf of a JAX ``init_params`` tree becomes exactly one
    state_dict entry, under the key the JAX package's torch->JAX converter
    reads it from, and the port's modules of ``port_preset`` load them
    strictly."""
    from magicdrive_tpu.convert.torch_weights import (
        _SPECIALS, _clip_prefix_key, _flax_path_to_torch_key,
        _strip_collection)
    from flax import traverse_util

    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    sds = jax_params_to_state_dicts(jax.tree_util.tree_map(np.asarray,
                                                           params))
    for name, tree in params.items():
        flat = traverse_util.flatten_dict(tree)
        want = {}
        for path, leaf in flat.items():
            spath = _strip_collection(path)
            joined = "/".join(spath)
            if name == "clip":
                key = _SPECIALS.get(joined) or _clip_prefix_key(spath)
            else:
                key = _SPECIALS.get(joined) or _flax_path_to_torch_key(spath)
            want[key] = int(np.size(leaf))
        assert len(want) == len(flat), name
        assert {k: v.size for k, v in sds[name].items()} == want, name
    MagicDriveModules.create(port_preset, device="cpu").load_state_dicts(sds)
    return sds


def test_converter_consumes_every_leaf(tiny_jax):
    """Every leaf of the tiny_debug tree converts and loads strictly."""
    from magicdrive_tpu_torch.config import tiny_debug

    assert_converts_every_leaf(tiny_jax[2], tiny_debug())


@pytest.mark.parametrize("seed", [0, 3])
def test_port_batches_match_jax_collate(seed):
    """The port's fixture scene and generation batch equal the JAX data
    layer's, but for the caption word ids (the JAX stand-in tokenizer
    hashes words with Python's per-process ``hash``): those keep its
    BOS/EOS framing."""
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_sample

    from magicdrive_tpu_torch import data

    want = collate_fn([make_sample(seed + i, with_images=False)
                       for i in range(2)],
                      CollateConfig(bbox_max_len=20, is_train=False))
    got = data.collate_fn([data.make_sample(seed + i) for i in range(2)],
                          data.CollateConfig(bbox_max_len=20))
    assert set(got) == set(want)
    for k in ("camera_param", "bev_map", "bboxes", "classes", "masks",
              "uncond_ids"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    assert got["masks"].sum() > 0 and (got["masks"] == 0).any()
    frame = np.isin(want["input_ids"], (49406, 49407))
    assert got["input_ids"].shape == want["input_ids"].shape
    np.testing.assert_array_equal(got["input_ids"][frame],
                                  want["input_ids"][frame])
    assert not np.isin(got["input_ids"][~frame], (49406, 49407)).any()


@pytest.mark.parametrize("seed", [0, 3])
def test_port_fixture_images_match_jax(seed):
    """The training fixture: images in [-1, 1] drawn before the boxes, as
    the JAX fixture draws them, so the scene after them is the same too;
    collate_fn stacks them into pixel_values."""
    from magicdrive_tpu.data.fixtures import make_sample

    from magicdrive_tpu_torch import data

    want = make_sample(seed)
    got = data.make_sample(seed, with_images=True)
    assert got["img"].dtype == np.float32 and got["img"].shape == \
        (6, 224, 400, 3)
    np.testing.assert_array_equal(got["img"], want["img"])
    for k in ("boxes", "labels", "bev_map"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert "img" not in data.make_sample(seed)
    batch = data.collate_fn([got], data.CollateConfig(bbox_max_len=8))
    np.testing.assert_array_equal(batch["pixel_values"][0], want["img"])


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports nothing of jax, flax or the JAX package."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "magicdrive_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "magicdrive_tpu"}, roots


def test_port_imports_no_jax():
    """A process that imports the port (its training modules and the
    given-view and video pipelines included), makes a request batch, runs a
    tiny forward and the backward of a transformer block through the
    kernels' autograd and a temporal block's forward never loads jax, flax
    or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        import magicdrive_tpu_torch
        from magicdrive_tpu_torch.config import tiny_debug
        from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
        from magicdrive_tpu_torch.core.transformer import (
            BasicTransformerBlock)
        from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                               make_dataset)
        from magicdrive_tpu_torch.diffusion import ddpm, make_sampler_coeffs
        from magicdrive_tpu_torch.kernels import autograd, build, dispatch
        from magicdrive_tpu_torch.pipeline.given_view import (
            GivenViewPipeline)
        from magicdrive_tpu_torch.pipeline.pipeline import (
            MagicDriveModules, MagicDrivePipeline)
        from magicdrive_tpu_torch.pipeline.video import VideoPipeline
        from magicdrive_tpu_torch.train import (Runner, TrainConfig,
                                                create_train_state,
                                                train_step)
        torch.set_num_threads(1)
        batch = collate_fn(make_dataset(1), CollateConfig(bbox_max_len=8))
        assert batch["bboxes"].shape == (1, 6, 8, 8, 3)
        blk = BasicTransformerBlock(16, 2, 8, 16, ((5, 1), (0, 2), (1, 3),
                                                   (2, 4), (3, 5), (4, 0)))
        with torch.no_grad():
            y = blk(torch.randn(6, 320, 16), torch.randn(6, 7, 16))
        assert y.shape == (6, 320, 16)
        x = torch.randn(6, 320, 16, requires_grad=True)
        blk(x, torch.randn(6, 7, 16)).square().mean().backward()
        assert x.grad.abs().max() > 0
        vid = BasicTransformerBlock(16, 2, 8, 16, ((2, 1), (0, 2), (1, 0)),
                                    temporal_frames=2)
        with torch.no_grad():
            assert vid(torch.randn(6, 10, 16),
                       torch.randn(6, 7, 16)).shape == (6, 10, 16)
        state = create_train_state(
            MagicDriveModules.create(tiny_debug(), device="cpu"),
            TrainConfig(), device="cpu")
        assert len(state.masters) > 100
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "magicdrive_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
