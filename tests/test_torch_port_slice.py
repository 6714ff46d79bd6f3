"""The port's generation slice against the JAX pipeline, the port's freedom
from jax, and the weight carry-over.

The ``tiny_debug`` preset (the 224x400 geometry at narrow widths) runs
2 UniPC steps at B=1 from the same numpy latents on converted weights in
both packages; the [0, 1] images agree to atol 2e-3. Every floating JAX
variable is replaced by seeded normals first, so the zero-initialised
cross-view connectors, ControlNet zero-convs and map-embedder conv_out are
live, and every kernel is then halved. The batch's caption ids come from the
port's CRC32 stand-in tokenizer, so the input is the same in every process
(the JAX stand-in hashes with Python's salted ``hash``). At full fan-in
gain the random network amplifies the two packages' fp32 rounding past the
tolerance for some ids, the CRC32 ones among them; at half gain it does
not.
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

from test_torch_port_modules import randomized, scaled_kernels

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

    from magicdrive_tpu_torch.data.caption import HashTokenizer

    batch = collate_fn(make_dataset(1), CollateConfig(
        bbox_max_len=preset.bbox_max_len, canvas_hw=preset.image_size,
        is_train=False), tokenizer=HashTokenizer())
    del batch["pixel_values"]
    return batch


@pytest.fixture(scope="module")
def tiny_images(tiny_jax):
    """The JAX pipeline's images on randomized weights from numpy latents,
    with what the port needs to repeat the run."""
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline as JPipe

    preset, modules, params = tiny_jax
    rs = np.random.RandomState(0)
    params = scaled_kernels(randomized(params, rs), 0.5)
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
    """A process that imports the port (its training modules and 8-bit
    optimizer, the parallel package, ``cli.val_set_gen`` with
    ``--multihost`` alone, the given-view and video pipelines, the config
    loader, the
    nuScenes data path with its flip, rot-scale-trans and cache, the native
    codecs, the viz, the run weights, the weight converter, the loader, the
    demo fixtures, the FID layer and every CLI included), makes
    a request batch, runs a tiny forward and the backward of a transformer
    block through the kernels' autograd and a temporal block's forward
    never loads jax, flax or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import torch
        import magicdrive_tpu_torch
        from magicdrive_tpu_torch import config_loader, viz
        from magicdrive_tpu_torch import torch_weights
        from magicdrive_tpu_torch.cli import (convert_weights, demo, fid,
                                              generate, interactive,
                                              prepare_cache, prepare_data,
                                              train as train_cli,
                                              val_set_gen)
        from magicdrive_tpu_torch.config import tiny_debug
        from magicdrive_tpu_torch.data import loader, torch_fixtures
        from magicdrive_tpu_torch.eval import fid as eval_fid, inception
        from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
        from magicdrive_tpu_torch.core.transformer import (
            BasicTransformerBlock)
        from magicdrive_tpu_torch.data import (CollateConfig, bpe, cache,
                                               caption, collate_fn, datasets,
                                               flip, make_dataset, map_raster,
                                               nuscenes, rot_scale_trans,
                                               synth)
        from magicdrive_tpu_torch.diffusion import ddpm, make_sampler_coeffs
        from magicdrive_tpu_torch.native import bitpack, gxx, raster
        from magicdrive_tpu_torch.utils import serialization
        from magicdrive_tpu_torch.kernels import autograd, build, dispatch
        from magicdrive_tpu_torch.pipeline.given_view import (
            GivenViewPipeline)
        from magicdrive_tpu_torch.pipeline.pipeline import (
            MagicDriveModules, MagicDrivePipeline)
        from magicdrive_tpu_torch.pipeline.video import VideoPipeline
        from magicdrive_tpu_torch.train import (Runner, TrainConfig,
                                                adam8bit, create_train_state,
                                                train_step)
        from magicdrive_tpu_torch import parallel
        from magicdrive_tpu_torch.parallel import mesh, multihost
        torch.set_num_threads(1)
        batch = collate_fn(make_dataset(1), CollateConfig(bbox_max_len=8))
        assert batch["bboxes"].shape == (1, 6, 8, 8, 3)
        local = parallel.shard_batch(batch, mesh.Mesh((1, 2), coords=(0, 1)),
                                     n_cam=6)
        assert local["bboxes"].shape == (1, 3, 8, 8, 3)
        args = val_set_gen.parse_args(["--run_dir", "r", "--out", "o",
                                       "--multihost"])
        assert args.multihost and not multihost.initialize_if_needed("cpu")
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
            TrainConfig(use_8bit_adam=True, gradient_accumulation_steps=2),
            device="cpu")
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


def test_generate_cli_imports_no_jax():
    """The generation CLI run end to end on the CPU (a tiny_debug run
    directory of the port's own weights, a synthetic nuScenes tree, one
    step) and ``python -m magicdrive_tpu_torch.cli.generate --help`` load
    no jax, flax or JAX package module."""
    code = textwrap.dedent("""
        import os, runpy, sys, tempfile
        import torch
        from magicdrive_tpu_torch.cli import generate
        from magicdrive_tpu_torch.config import preset_from_config
        from magicdrive_tpu_torch.config_loader import compose, save_run_config
        from magicdrive_tpu_torch.convert import modules_to_jax_params
        from magicdrive_tpu_torch.data.synth import make_mini_nuscenes
        from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
        from magicdrive_tpu_torch.utils.serialization import save_params
        torch.set_num_threads(1)
        sys.argv = ["generate", "--help"]
        try:
            runpy.run_module("magicdrive_tpu_torch.cli.generate",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        with tempfile.TemporaryDirectory() as tmp:
            root, version = make_mini_nuscenes(os.path.join(tmp, "nusc"))
            overrides = ["model=tiny_debug", "runner=debug"]
            cfg = compose(generate.CONFIG_DIR, overrides=overrides)
            run = os.path.join(tmp, "run")
            save_run_config(cfg, run, overrides)
            mods = MagicDriveModules.create(preset_from_config(cfg),
                                            device="cpu")
            save_params(modules_to_jax_params(mods),
                        os.path.join(run, "weights"))
            made = generate.main(
                ["--run_dir", run, f"dataset.dataset_root={root}",
                 f"dataset.version={version}",
                 "runner.pipeline_param.num_inference_steps=1",
                 "--indices", "2"], device="cpu", dtype=torch.float32)
            assert made.images[0].shape == (1, 6, 224, 400, 3)
            assert os.path.isfile(os.path.join(made.out_dir, "2_gen.png"))
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
    assert "--run_dir" in proc.stdout


def test_convert_and_fid_clis_import_no_jax():
    """``cli.convert_weights`` (sd15 mode on an SD-v1.5 tree written from
    the port's small_parity modules, the VAE under its old attention
    names) and ``cli.fid`` (paths mode, random Inception weights, on the
    CPU) run in a process that loads no jax, flax or JAX package module."""
    code = textwrap.dedent("""
        import os, runpy, sys, tempfile
        import numpy as np, torch
        from PIL import Image
        from magicdrive_tpu_torch.cli import convert_weights, fid
        from magicdrive_tpu_torch.config import small_parity
        from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
        from magicdrive_tpu_torch.utils.serialization import load_params
        torch.set_num_threads(1)
        sys.argv = ["fid", "--help"]
        try:
            runpy.run_module("magicdrive_tpu_torch.cli.fid",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        with tempfile.TemporaryDirectory() as tmp:
            mods = MagicDriveModules.create(small_parity(), device="cpu")
            old = {".to_q.": ".query.", ".to_out.0.": ".proj_attn."}
            for part, mod, name in (
                    ("unet", mods.unet, "diffusion_pytorch_model.bin"),
                    ("vae", mods.vae, "diffusion_pytorch_model.bin"),
                    ("text_encoder", mods.clip, "pytorch_model.bin")):
                sd = {}
                for k, v in mod.state_dict().items():
                    for new, o in old.items():
                        if part == "vae" and ".attentions." in k:
                            k = k.replace(new, o)
                    sd[k] = v
                os.makedirs(os.path.join(tmp, "sd", part))
                torch.save(sd, os.path.join(tmp, "sd", part, name))
            out = convert_weights.main(["sd15", "--src", tmp + "/sd",
                                        "--out", tmp + "/w", "--arch",
                                        "small-test"])
            w = load_params(out)
            np.testing.assert_array_equal(
                w["vae"]["params"]["encoder"]["conv_in"]["kernel"],
                mods.vae.encoder.conv_in.weight.detach().numpy().transpose(
                    2, 3, 1, 0))
            for d in ("a", "b"):
                os.makedirs(os.path.join(tmp, d))
                for i in range(3):
                    Image.fromarray(np.random.default_rng(i + ord(d)).integers(
                        0, 255, (40, 60, 3), np.uint8)).save(
                        os.path.join(tmp, d, f"{i}.png"))
            assert np.isfinite(fid.main(["paths", tmp + "/a", tmp + "/b"],
                                        device="cpu"))
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
    assert "tokens" in proc.stdout and "converted ->" in proc.stdout


def test_train_clis_import_no_jax():
    """``cli.prepare_cache`` on a synthetic nuScenes tree and ``cli.train``
    on it (tiny_debug, one step, its checkpoint and weights) run on the CPU
    in a process that loads no jax, flax or JAX package module. Tensorboard
    is made unimportable there, as on a machine without it: where
    tensorflow is installed, tensorboard's writer imports it, and
    tensorflow may load jax itself."""
    code = textwrap.dedent("""
        import os, sys, tempfile
        sys.modules["torch.utils.tensorboard"] = None
        import torch
        from magicdrive_tpu_torch.cli import prepare_cache, train
        from magicdrive_tpu_torch.data.synth import make_mini_nuscenes
        torch.set_num_threads(1)
        with tempfile.TemporaryDirectory() as tmp:
            root, version = make_mini_nuscenes(os.path.join(tmp, "nusc"))
            path = prepare_cache.main(["--dataroot", root, "--version",
                                       version, "--out", tmp + "/c.h5",
                                       "--workers", "0"])
            run = train.main([
                "model=tiny_debug", "runner=debug",
                "runner.mixed_precision=no", f"log_root_prefix={tmp}/runs",
                f"dataset.dataset_root={root}", f"dataset.version={version}",
                f"dataset.cache_file.train={path}",
                "runner.max_train_steps=1", "runner.checkpointing_steps=1",
                "runner.validation_before_run=false"], device="cpu")
            assert run.state.step == 1 and run.runner.loader.dataset.cache
            assert sorted(os.listdir(run.run_dir)) == [
                "checkpoints", "metrics.jsonl", "overrides.yaml",
                "run_config.yaml", "train.log", "weights"]
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
    assert "cache written" in proc.stdout
