"""The port's evaluation CLIs against the JAX package's tools:
``cli/val_set_gen.py`` (``tools/val_set_gen.py``), ``cli/fid.py``
(``tools/fid.py``) and ``cli/prepare_data.py`` (``tools/prepare_data.py``).

A ``model=tiny_debug runner=debug`` run directory holds the JAX package's
init tree of that config as seeded normals with the kernels halved (as in
``test_torch_port_generate_cli.py``: the tree's nuScenes intrinsics make
camera tokens of order 100, which a random network at full gain amplifies
past the images' tolerance in fp32), and the data is a synthetic
nuScenes tree of the JAX package's ``make_mini_nuscenes`` with a JPEG per
sample and camera. Both ``val_set_gen`` CLIs run on it at batch size 2 with
two generations per sample, JAX's with its pipeline replaced by one that
records each batch and key and returns blank images; the port's, on the
CPU in fp32, takes the latents JAX's pipeline draws from each key. The
file names agree, each PNG is the port's images as uint8, and the port's
images equal one JAX pipeline's on the port's batch from the same latents
at atol 2e-3 (the port passes the model the static map channels,
``dataset.map_channels_used``; JAX's tool passes all 26, which the tiny
map embedder cannot take, as for ``tools/generate.py``). The FID CLIs are
held to JAX's in ``test_torch_port_eval.py``. One UniPC step keeps the
file near two minutes.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_modules import scaled_kernels, shaped
from test_torch_port_parallel import Background

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES, BATCH, TIMES = 4, 2, 2


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(run dir, the tree's override arguments, JAX params, tree root and
    version). The JAX package's native raster library is built where it
    is missing, so that both packages rasterize with the same core."""
    try:
        from magicdrive_tpu.native import raster  # noqa: F401
    except OSError:
        from magicdrive_tpu.native import build

        build.build(verbose=False)
    from magicdrive_tpu.config.loader import compose, save_run_config
    from magicdrive_tpu.config.presets import init_params, preset_from_config
    from magicdrive_tpu.data.synth import make_mini_nuscenes
    from magicdrive_tpu.utils.serialization import save_params

    base = tmp_path_factory.mktemp("evalcli")
    root, version = make_mini_nuscenes(base / "nuscenes", n_samples=N_SAMPLES,
                                       images_per_sample=True)
    overrides = ["model=tiny_debug", "runner=debug"]
    cfg = compose(os.path.join(REPO, "configs"), overrides=overrides)
    preset = preset_from_config(cfg)
    modules = preset.modules(dtype=jnp.float32)
    params = scaled_kernels(shaped(jax.eval_shape(
        lambda k: init_params(preset, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(2)), 0.5)
    run_dir = str(base / "run")
    save_run_config(cfg, run_dir, overrides)
    save_params(params, os.path.join(run_dir, "weights"))
    args = [f"dataset.dataset_root={root}", f"dataset.version={version}",
            "runner.pipeline_param.num_inference_steps=1"]
    return run_dir, args, params, root, version


def _argv(run, out):
    return ["--run_dir", run[0], "--out", out, "--batch_size", str(BATCH),
            "--times", str(TIMES), "--seed", "5", *run[1]]


@pytest.fixture(scope="module")
def jax_cli(run, tmp_path_factory, monkeypatch_module):
    """JAX's ``tools/val_set_gen.py`` on the run, its pipeline recording
    (batch, latents drawn from the key) per call."""
    import magicdrive_tpu.pipeline.pipeline as jpipe
    from tools import val_set_gen as jvsg

    calls = []

    class Recording:
        def __init__(self, modules, params, cfg):
            self.cfg = cfg

        def __call__(self, batch, key):
            B, c = batch["camera_param"].shape[0], self.cfg
            # the draw of the JAX pipeline's _generate_fn
            lat = jax.random.normal(key, (B, 1, c.latent_height,
                                          c.latent_width, 4), jnp.float32)
            calls.append(({k: np.asarray(v) for k, v in batch.items()},
                          np.asarray(jnp.broadcast_to(
                              lat, (B, c.n_cam, *lat.shape[2:])))))
            return jnp.zeros((B, c.n_cam, 224, 400, 3))

    monkeypatch_module.setattr(jpipe, "MagicDrivePipeline", Recording)
    out = str(tmp_path_factory.mktemp("jax_vsg"))
    jvsg.main(_argv(run, out))
    monkeypatch_module.undo()
    return out, calls


@pytest.fixture(scope="module")
def port_cli(run, jax_cli, tmp_path_factory, monkeypatch_module):
    """The port's CLI on the CPU in fp32, its latents JAX's; records each
    call's (batch, images)."""
    from magicdrive_tpu_torch.cli import val_set_gen
    from magicdrive_tpu_torch.pipeline import pipeline

    jax_latents = iter([lat for _, lat in jax_cli[1]])
    real = pipeline.MagicDrivePipeline.__call__
    calls = []

    def call(self, batch, generator=None, latents=None):
        out = real(self, batch, generator, latents)
        calls.append(({k: np.asarray(v) for k, v in batch.items()},
                      out.numpy()))
        return out

    monkeypatch_module.setattr(
        pipeline.MagicDrivePipeline, "prepare_latents",
        lambda self, *a, **k: torch.tensor(next(jax_latents)))
    monkeypatch_module.setattr(pipeline.MagicDrivePipeline, "__call__", call)
    out = str(tmp_path_factory.mktemp("port_vsg"))
    made = val_set_gen.main(_argv(run, out), device="cpu",
                            dtype=torch.float32)
    monkeypatch_module.undo()
    return made, calls


def test_val_set_gen_writes_jax_files(run, port_cli, jax_cli):
    """The same PNG names (a nuScenes image stem and _gen{rep} per sample,
    camera and rep), each the port's images as uint8; one call per batch
    and rep, one time per batch, the last batch short where the split is."""
    made, calls = port_cli
    names = sorted(os.listdir(made.out_dir))
    assert names == sorted(os.listdir(jax_cli[0]))
    assert len(names) == N_SAMPLES * 6 * TIMES
    assert len(calls) == len(jax_cli[1]) == -(-N_SAMPLES // BATCH) * TIMES
    assert len(made.seconds) == -(-N_SAMPLES // BATCH)
    for i, (batch, imgs) in enumerate(calls):
        bi, rep = divmod(i, TIMES)
        assert imgs.shape == (len(batch["camera_param"]), 6, 224, 400, 3)
        for b in range(len(imgs)):
            files = made.dataset[bi * BATCH + b]["metas"]["filename"]
            for v, f in enumerate(files):
                stem = os.path.splitext(os.path.basename(f))[0]
                png = np.asarray(Image.open(os.path.join(
                    made.out_dir, f"{stem}_gen{rep}.png")))
                want = (np.clip(imgs[b, v], 0, 1) * 255).astype(np.uint8)
                np.testing.assert_array_equal(png, want)


def test_val_set_gen_batches_match_jax(port_cli, jax_cli):
    """JAX's batches but for the stand-in tokenizer's word ids and the
    map channels past dataset.map_channels_used."""
    for (got, _), (want, _) in zip(port_cli[1], jax_cli[1]):
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "bev_map":
                assert v.shape[-1] == 26 and got[k].shape[-1] == 8
                v = v[..., :8]
            assert got[k].shape == v.shape, k
            if k in ("input_ids", "uncond_ids"):
                frame = np.isin(v, (49406, 49407))
                np.testing.assert_array_equal(got[k][frame], v[frame])
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_val_set_gen_images_match_jax_pipeline(run, port_cli, jax_cli):
    """Each batch's images from JAX's latents are the JAX pipeline's on the
    port's batch at atol 2e-3 (one rep per batch; fp32 both)."""
    from magicdrive_tpu.config.loader import compose
    from magicdrive_tpu.config.presets import preset_from_config
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline

    run_dir, args, params = run[:3]
    cfg = compose(os.path.join(REPO, "configs"),
                  overrides=["model=tiny_debug", "runner=debug", *args])
    preset = preset_from_config(cfg)
    pipe = MagicDrivePipeline(
        preset.modules(dtype=jnp.float32), params,
        dataclasses.replace(preset.pipeline, dtype=jnp.float32))
    for i in range(0, len(port_cli[1]), TIMES + 1):
        batch, got = port_cli[1][i]
        want = np.asarray(pipe({k: jnp.asarray(v) for k, v in batch.items()},
                               latents=jnp.asarray(jax_cli[1][i][1])))
        assert want.std() > 1e-3
        np.testing.assert_allclose(got, want, atol=2e-3)


_RANK = """
import sys
import torch
from magicdrive_tpu_torch.cli import val_set_gen
torch.set_num_threads(1)
made = val_set_gen.main(sys.argv[1:], device="cpu", dtype=torch.float32)
assert torch.distributed.get_world_size() == 2
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "magicdrive_tpu")]
assert not bad, bad
print(len(made.dataset))
"""


def test_val_set_gen_multihost_raises(run, port_cli, tmp_path):
    """``--multihost`` over two gloo ranks on the CPU (``torchrun``)
    writes the one-process run's file set into the shared ``--out``, each
    rank every second sample from its rank on; rank 0's first batch draws
    the one-process run's first latents (process 0's seeds are the one
    process's), so its first sample's PNGs are that run's, byte for
    byte. The ranks load no jax, flax or JAX package module."""
    from test_torch_port_parallel import torchrun

    out = str(tmp_path / "out")
    one = str(tmp_path / "one")
    common = ["--run_dir", run[0], "--batch_size", str(BATCH), "--times",
              "1", "--seed", "5", *run[1]]
    from magicdrive_tpu_torch.cli import val_set_gen

    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    ranks = Background(lambda: torchrun(
        str(script), ["--out", out, "--multihost", *common],
        str(tmp_path / "logs"), timeout=300))
    try:  # the one-process run meanwhile
        made = val_set_gen.main(["--out", one, *common], device="cpu",
                                dtype=torch.float32)
    finally:
        results = ranks.join()
    assert [o.strip().splitlines()[-1] for o in results] == [
        str(N_SAMPLES // 2)] * 2
    assert "[process 1] 2/2" in results[1]
    names = sorted(os.listdir(one))
    assert sorted(os.listdir(out)) == names
    assert names == sorted(f for f in os.listdir(port_cli[0].out_dir)
                           if f.endswith("_gen0.png"))
    for f in made.dataset[0]["metas"]["filename"]:
        png = os.path.splitext(os.path.basename(f))[0] + "_gen0.png"
        with open(os.path.join(out, png), "rb") as a, \
                open(os.path.join(one, png), "rb") as b:
            assert a.read() == b.read(), png


def test_val_set_gen_seeds_per_rep_and_batch():
    """Each (rep, batch) has its own stream; the same (seed, rep, batch)
    the same one."""
    from magicdrive_tpu_torch.cli.val_set_gen import batch_generator

    draw = lambda *a: torch.randn(4, generator=batch_generator(*a, "cpu"))
    assert torch.equal(draw(5, 0, 1), draw(5, 0, 1))
    for other in ((5, 1, 0), (5, 0, 2), (6, 0, 1)):
        assert not torch.equal(draw(5, 0, 1), draw(*other))


def test_prepare_data_pickle_loads_in_jax(run, tmp_path):
    """The port's index pickle loads in JAX's NuScenesIndex as the index
    JAX builds from the tree."""
    from magicdrive_tpu.data.nuscenes import NuScenesIndex

    from magicdrive_tpu_torch.cli import prepare_data

    root, version = run[3:]
    path = prepare_data.main(["--dataroot", root, "--version", version,
                              "--out", str(tmp_path / "index.pkl")])
    got, want = NuScenesIndex.load(path), NuScenesIndex(root, version)
    assert len(got.infos) == len(want.infos) == N_SAMPLES
    assert got.scene_of == want.scene_of
    assert got.scene_names == want.scene_names
    assert got.classes == want.classes
    for g, w in zip(got.infos, want.infos):
        assert vars(g).keys() == vars(w).keys()
        for k, v in vars(w).items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(getattr(g, k), v, err_msg=k)
            else:
                assert getattr(g, k) == v, k


def test_val_set_gen_and_fid_default_to_the_card(run, monkeypatch, tmp_path):
    """Without a device argument both CLIs run on the card, and raise
    where there is none."""
    from magicdrive_tpu_torch.cli import fid, val_set_gen

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        val_set_gen.main(["--run_dir", run[0], "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fid.main(["paths", str(tmp_path), str(tmp_path)])
