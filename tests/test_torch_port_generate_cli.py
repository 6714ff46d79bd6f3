"""The port's generation CLI against the JAX package's ``tools/generate.py``.

A ``model=tiny_debug runner=debug`` run directory holds the JAX package's
init params of that config with every floating leaf replaced by seeded
normals (``randomized`` on ``eval_shape``'s shapes, then every kernel
halved), written by the JAX package's ``save_params``, and the data
is a synthetic mini-nuScenes tree of the JAX package's
``make_mini_nuscenes``. The kernels are halved because the tree's camera
intrinsics are nuScenes' own (a 1266 px focal length, where the fixture
scenes have a quarter of it): their camera tokens are of order 100, and the
random network at full fan-in gain amplifies their fp32 rounding (about
1e-6 relative, in either package) past the images' tolerance, in the JAX
pipeline against itself as much as against the port. Both CLIs
run on samples 0 and 1 with the same arguments, JAX's with its pipeline
replaced by one that records the batch and latents it is given (the JAX
pipeline is run once, below, in fp32). The port's:
  * writes the PNGs (the generated row its images as uint8, the box row,
    the map) and its run config;
  * collates JAX's batch, up to the stand-in tokenizers' word ids (the
    JAX stand-in hashes with Python's salted ``hash``) and the map, of
    which it passes the model the static channels
    (``dataset.map_channels_used``); JAX's CLI passes all 26;
  * from JAX's latents, makes the images of the JAX pipeline on its batch
    at atol 2e-3 (both fp32: ``main``'s ``dtype`` argument, where the
    card runs bf16 as JAX's CLI does);
  * from a latent drawn per view, which the CLI never draws, makes the JAX
    pipeline's images too, so that the views differ from the first step;
  * writes run weights that the JAX package's ``load_params`` reads as the
    tree it came from.
One JAX pipeline (2 UniPC steps at B=2) is traced here.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_modules import scaled_kernels, shaped

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INDICES = ("0", "1")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run dir, the tree's override arguments, the JAX params). The JAX
    package's native raster library is built where it is missing, so that
    "auto" rasterizes the maps with the same core in both packages."""
    try:
        from magicdrive_tpu.native import raster  # noqa: F401
    except OSError:
        from magicdrive_tpu.native import build

        build.build(verbose=False)
    from magicdrive_tpu.config.loader import compose, save_run_config
    from magicdrive_tpu.config.presets import init_params, preset_from_config
    from magicdrive_tpu.data.synth import make_mini_nuscenes
    from magicdrive_tpu.utils.serialization import save_params

    base = tmp_path_factory.mktemp("cli")
    root, version = make_mini_nuscenes(base / "nuscenes")
    overrides = ["model=tiny_debug", "runner=debug"]
    cfg = compose(os.path.join(REPO, "configs"), overrides=overrides)
    preset = preset_from_config(cfg)
    modules = preset.modules(dtype=jnp.float32)
    params = scaled_kernels(shaped(jax.eval_shape(
        lambda k: init_params(preset, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(0)), 0.5)
    run_dir = str(base / "run")
    save_run_config(cfg, run_dir, overrides)
    save_params(params, os.path.join(run_dir, "weights"))
    args = [f"dataset.dataset_root={root}", f"dataset.version={version}",
            "runner.pipeline_param.num_inference_steps=2"]
    return run_dir, args, params


@pytest.fixture(scope="module")
def jax_cli(run, tmp_path_factory, monkeypatch_module):
    """JAX's ``tools/generate.py`` on the run, with its pipeline recording
    (batch, latents) per call and returning blank images."""
    import magicdrive_tpu.pipeline.pipeline as jpipe
    from tools import generate as jgenerate

    real = jpipe.MagicDrivePipeline
    calls = []

    class Recording:
        def __init__(self, modules, params, cfg):
            self.pipe, self.cfg = real(modules, params, cfg), cfg

        def prepare_latents(self, *args, **kwargs):
            return self.pipe.prepare_latents(*args, **kwargs)

        def __call__(self, batch, latents):
            calls.append(({k: np.asarray(v) for k, v in batch.items()},
                          np.asarray(latents)))
            return jnp.zeros((*latents.shape[:2], 224, 400, 3))

    monkeypatch_module.setattr(jpipe, "MagicDrivePipeline", Recording)
    out = str(tmp_path_factory.mktemp("jax_out"))
    run_dir, args, _ = run
    jgenerate.main(["--run_dir", run_dir, "--out", out, *args, "--indices",
                    *INDICES])
    return out, calls


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def port_cli(run, jax_cli, tmp_path_factory, monkeypatch_module):
    """The port's CLI on the run on the CPU, its latents JAX's."""
    from magicdrive_tpu_torch.cli import generate
    from magicdrive_tpu_torch.pipeline import pipeline

    jax_latents = iter([lat for _, lat in jax_cli[1]])
    monkeypatch_module.setattr(
        pipeline.MagicDrivePipeline, "prepare_latents",
        lambda self, *a, **k: torch.tensor(next(jax_latents)))
    out = str(tmp_path_factory.mktemp("port_out"))
    run_dir, args, _ = run
    made = generate.main(["--run_dir", run_dir, "--out", out, *args,
                          "--indices", *INDICES], device="cpu",
                         dtype=torch.float32)
    monkeypatch_module.undo()
    return made


def test_cli_writes_the_pngs(port_cli, jax_cli):
    """The files of JAX's CLI, each PNG of its shape, the generated row the
    images as uint8 and the box row different from it."""
    made = port_cli
    assert sorted(os.listdir(made.out_dir)) == sorted(os.listdir(jax_cli[0]))
    assert len(made.images) == 1 and made.images[0].shape == (
        2, 6, 224, 400, 3)
    for bi, i in enumerate(INDICES):
        png = np.asarray(Image.open(os.path.join(made.out_dir,
                                                 f"{i}_gen.png")))
        assert png.shape == (2 * 224, 6 * 400, 3)
        want = (np.clip(np.concatenate(list(made.images[0][bi]), axis=1),
                        0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(png[:224], want)
        assert (png[224:] != png[:224]).any()  # boxes drawn
        m = np.asarray(Image.open(os.path.join(made.out_dir, f"{i}_map.png")))
        jm = np.asarray(Image.open(os.path.join(jax_cli[0], f"{i}_map.png")))
        np.testing.assert_array_equal(m, jm)


def test_cli_batch_matches_jax(port_cli, jax_cli):
    """JAX's batch but for the tokenizer's word ids and the map channels
    past dataset.map_channels_used; one call per variant."""
    (want, _), = jax_cli[1]
    got = port_cli.batch
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "bev_map":
            assert v.shape[-1] == 26 and got[k].shape[-1] == 8
            v = v[..., :8]
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if k in ("input_ids", "uncond_ids"):
            frame = np.isin(v, (49406, 49407))
            np.testing.assert_array_equal(got[k][frame], v[frame])
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["masks"].sum() > 0


@pytest.fixture(scope="module")
def jax_pipe(run):
    """The JAX pipeline of the run's config and params in fp32 (one jit)."""
    from magicdrive_tpu.config.loader import compose
    from magicdrive_tpu.config.presets import preset_from_config
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline

    run_dir, args, params = run
    cfg = compose(os.path.join(REPO, "configs"),
                  overrides=["model=tiny_debug", "runner=debug", *args])
    preset = preset_from_config(cfg)
    return MagicDrivePipeline(
        preset.modules(dtype=jnp.float32), params,
        dataclasses.replace(preset.pipeline, dtype=jnp.float32))


def _jax_images(pipe, batch, latents):
    return np.asarray(pipe({k: jnp.asarray(v) for k, v in batch.items()},
                           latents=jnp.asarray(latents)))


def test_cli_images_match_jax_pipeline(port_cli, jax_cli, jax_pipe):
    """The port's images from JAX's latents are the JAX pipeline's on the
    port's batch, at atol 2e-3 (fp32 both)."""
    (_, latents), = jax_cli[1]
    want = _jax_images(jax_pipe, port_cli.batch, latents)
    np.testing.assert_allclose(port_cli.images[0], want, atol=2e-3)
    assert want.std() > 1e-3


def test_cli_pipeline_matches_jax_per_view_latents(port_cli, jax_pipe):
    """The CLI's pipeline on its batch from a latent drawn per view equals
    the JAX pipeline's at atol 2e-3. The CLI's own latents are shared by the
    views, which then differ only by their conditioning, so a fault that
    mixes up the cross-view neighbours hardly shows in its images; here the
    views differ from the first step."""
    lat = np.random.RandomState(1).randn(2, 6, 28, 50, 4).astype(np.float32)
    want = _jax_images(jax_pipe, port_cli.batch, lat)
    got = port_cli.pipe(port_cli.batch, latents=torch.from_numpy(lat))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3)


def test_cli_run_config_replays(run, port_cli):
    from magicdrive_tpu_torch.config_loader import (load_run_config,
                                                    load_run_overrides)

    run_dir, args, _ = run
    assert load_run_overrides(port_cli.out_dir) == \
        ["model=tiny_debug", "runner=debug", *args]
    cfg = load_run_config(port_cli.out_dir)
    assert cfg["model"]["name"] == "tiny-debug"
    assert cfg["runner"]["pipeline_param"]["num_inference_steps"] == 2


def test_port_run_weights_load_in_jax(run, port_cli, tmp_path):
    """The port's modules, written with its save_params, read in the JAX
    package's load_params as the tree they were loaded from."""
    from magicdrive_tpu.utils.serialization import load_params

    from magicdrive_tpu_torch.convert import modules_to_jax_params
    from magicdrive_tpu_torch.utils.serialization import save_params

    _, _, params = run
    save_params(modules_to_jax_params(port_cli.pipe.m), str(tmp_path))
    back = load_params(str(tmp_path))
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert flat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=str(k))


def test_cli_defaults_to_the_card(run, monkeypatch):
    """Without a device argument the CLI runs on the card, and raises
    where there is none."""
    from magicdrive_tpu_torch.cli import generate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        generate.main(["--run_dir", run[0]])


def test_cli_help_runs_as_a_module():
    proc = subprocess.run(
        [sys.executable, "-m", "magicdrive_tpu_torch.cli.generate", "--help"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for flag in ("--run_dir", "--out", "--indices", "--seed", "--times",
                 "overrides"):
        assert flag in proc.stdout
