"""The port's training CLI against the JAX package's ``tools/train.py``.

Both CLIs run ``model=tiny_debug runner=debug`` on the fixture scenes (the
dataset root does not exist): JAX's CLI runs only there, since on a
nuScenes tree its runner hands the model all 26 map channels. Shortened
alike: 2 steps, a checkpoint every step (1 kept), validation before the
run and every 2 steps on sample 0 with one sampler step, one device
(``parallel.mesh_shape=[1,1]``), fp32. JAX's run keeps its runner and
orbax checkpoints but not its model: its jitted step only applies zero
gradients and its validation pipeline records the batch, so no model
compiles (the port's numbers are held to JAX's train step in
``test_torch_port_train_step.py`` and ``test_torch_port_train_modes.py``,
and the validator's grid below). Held equal:
  * the run directory's layout, the logged steps, the kept checkpoints'
    steps and the validation PNGs' names;
  * the ``weights/`` leaves (the port writes them through
    ``convert.modules_to_jax_params``): their names and shapes;
  * ``validation_only``, an external ``resume_from_checkpoint`` (the state
    resumed at JAX's step, validation before the run) and
    ``validation_before_run``;
  * the ``Validator``'s grids (ground-truth row over the generated row)
    against JAX's ``Validator`` on the same weights from JAX's initial
    latents, at atol 2e-3.
Also: ``resume_reset_scheduler`` restarts the port's learning-rate schedule
(and keeps Adam's count) on an external resume, where JAX's runner resets
it only on resuming from the run's own checkpoints; the ``parallel`` group
runs as JAX's runner reads it (two gloo ranks on the CPU; a mesh larger
than the job raises); ``pair_bwd`` is logged as having no effect.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modules import scaled_kernels, shaped

torch.set_num_threads(1)

COMMON = ("model=tiny_debug", "runner=debug", "runner.mixed_precision=no",
          "parallel.mesh_shape=[1,1]", "dataset.dataset_root=/nonexistent",
          "runner.max_train_steps=2", "runner.checkpointing_steps=1",
          "runner.checkpoints_total_limit=1", "runner.validation_steps=2",
          "runner.validation_index=[0]",
          "runner.pipeline_param.num_inference_steps=1",
          "runner.num_workers=1", "+runner.pair_bwd=serial")


@pytest.fixture(scope="module")
def jax_tree():
    """Seeded values on the shapes of JAX's tiny_debug init tree."""
    from magicdrive_tpu.config import presets as jp

    preset = jp.tiny_debug()
    modules = preset.modules(dtype=jnp.float32)
    return scaled_kernels(shaped(jax.eval_shape(
        lambda k: jp.init_params(preset, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(80)), 0.5)


@pytest.fixture(scope="module")
def jax_cli(jax_tree, tmp_path_factory):
    """A function running JAX's ``tools/train.py`` ``main`` with COMMON and
    more overrides, its init params ``jax_tree``, its step applying zero
    gradients, its validation pipeline recording; -> the run directory."""
    import magicdrive_tpu.config.presets as jpresets
    import magicdrive_tpu.train.runner as jrunner
    from tools import train as jtrain

    class Recording:
        def __init__(self, modules, params, cfg):
            self.cfg = cfg

        def __call__(self, batch, key):
            B, N = batch["camera_param"].shape[:2]
            return jnp.zeros((B, N, 224, 400, 3))

    def make_train_step(modules, tcfg):
        def step(state, batch, rng):
            zeros = jax.tree_util.tree_map(jnp.zeros_like, state.trainable)
            return state.apply_gradients(zeros), {"loss": jnp.float32(1.0)}
        return step

    out = tmp_path_factory.mktemp("jax_runs")
    mp = pytest.MonkeyPatch()
    mp.setattr(jrunner, "MagicDrivePipeline", Recording)
    mp.setattr(jrunner, "make_train_step", make_train_step)
    mp.setattr(jpresets, "init_params", lambda *a, **k: jax_tree)

    def run(name, *overrides):
        env = os.environ.get("MAGICDRIVE_PAIR_BWD")
        try:  # JAX's runner exports its pair_bwd to the environment
            return jtrain.main([*COMMON, f"log_root_prefix={out / name}",
                                *overrides])
        finally:
            if env is None:
                os.environ.pop("MAGICDRIVE_PAIR_BWD", None)

    yield run
    mp.undo()


@pytest.fixture(scope="module")
def port_cli(tmp_path_factory):
    """A function running the port's CLI on the CPU with COMMON and more
    overrides; -> its TrainRun."""
    from magicdrive_tpu_torch.cli import train

    out = tmp_path_factory.mktemp("port_runs")

    def run(name, *overrides):
        return train.main([*COMMON, f"log_root_prefix={out / name}",
                           *overrides], device="cpu")
    return run


@pytest.fixture(scope="module")
def runs(jax_cli, port_cli):
    return jax_cli("main"), port_cli("main")


def _ls(path):
    return sorted(os.listdir(path)) if os.path.isdir(path) else []


def _steps(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line)["step"] for line in f]


def _ckpt_steps(run_dir):
    """The checkpoints' steps: orbax's step directories, the port's
    step_*.pt files."""
    return sorted(int(f.split("_")[-1].split(".")[0]) if f.endswith(".pt")
                  else int(f) for f in _ls(os.path.join(run_dir,
                                                        "checkpoints"))
                  if f.endswith(".pt") or f.isdigit())


def test_cli_run_directory_matches_jax(runs):
    """The run directory holds JAX's entries: train.log, metrics.jsonl,
    checkpoints/, val_images/, weights/, the run config and overrides."""
    jax_dir, port = runs
    assert _ls(port.run_dir) == _ls(jax_dir)
    for f in ("train.log", "metrics.jsonl", "run_config.yaml",
              "overrides.yaml"):
        assert os.path.getsize(os.path.join(port.run_dir, f)) > 0, f
    assert os.path.basename(port.run_dir).startswith("224x400_")
    assert port.state.step == 2


def test_cli_logs_checkpoints_and_pngs_match_jax(runs):
    """Steps 1-2 logged; the last checkpoint (step 2) alone kept; the PNGs
    of the validation before the run and at step 2."""
    jax_dir, port = runs
    assert _steps(port.run_dir) == _steps(jax_dir) == [1, 2]
    assert _ckpt_steps(port.run_dir) == _ckpt_steps(jax_dir) == [2]
    pngs = _ls(os.path.join(port.run_dir, "val_images"))
    assert pngs == _ls(os.path.join(jax_dir, "val_images")) == [
        "step0_idx0_0.png", "step2_idx0_0.png"]
    with open(os.path.join(port.run_dir, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert np.isfinite(rec["loss"]) and {"steps_per_sec", "samples_per_sec",
                                         "epoch"} <= set(rec)


def test_cli_weights_match_jax_layout(runs):
    """``weights/`` has the leaves of JAX's, name for name and shape for
    shape; the trainable ones are the fp32 masters, the others the
    modules'; ``cli.generate``'s loader reads them into the modules."""
    from magicdrive_tpu.utils.serialization import load_params as jload

    from magicdrive_tpu_torch.convert import (iter_leaves,
                                              jax_params_to_state_dicts)
    from magicdrive_tpu_torch.utils.serialization import load_params

    jax_dir, port = runs
    got = dict(iter_leaves(load_params(os.path.join(port.run_dir,
                                                    "weights"))))
    want = dict(iter_leaves(jload(os.path.join(jax_dir, "weights"))))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.shape(got[k]) == np.shape(v), k
    sds = jax_params_to_state_dicts(load_params(os.path.join(port.run_dir,
                                                             "weights")))
    for key, master in port.state.masters.items():
        module, name = key.split(".", 1)
        assert torch.equal(torch.as_tensor(sds[module][name]), master), key
    vae = port.runner.modules.vae.state_dict()
    for name, t in vae.items():
        assert torch.equal(torch.as_tensor(sds["vae"][name]), t), name


def test_validation_only_matches_jax(jax_cli, port_cli):
    """``validation_only``: the PNGs of step 0 and nothing trained, saved
    or exported."""
    jax_dir = jax_cli("val_only", "validation_only=true")
    port = port_cli("val_only", "validation_only=true")
    pngs = _ls(os.path.join(port.run_dir, "val_images"))
    assert pngs == _ls(os.path.join(jax_dir, "val_images")) == [
        "step0_idx0_0.png"]
    assert port.state.step == 0
    for d in ("checkpoints", "weights"):
        assert not os.path.exists(os.path.join(port.run_dir, d))
    assert _ckpt_steps(jax_dir) == []


def test_external_resume_matches_jax(runs, jax_cli, port_cli):
    """``resume_from_checkpoint`` naming the first run's checkpoints, to
    step 3: both resume at step 2 (the validation before the run at step
    2), train one step and keep its checkpoint; the port's steps go on
    from the checkpoint's state."""
    jax_dir, port = runs
    extra = ("runner.max_train_steps=3",)
    jax2 = jax_cli("resume", f"resume_from_checkpoint="
                   f"{os.path.join(jax_dir, 'checkpoints')}", *extra)
    port2 = port_cli("resume", f"resume_from_checkpoint="
                     f"{os.path.join(port.run_dir, 'checkpoints')}", *extra)
    assert port2.state.step == 3
    assert _ckpt_steps(port2.run_dir) == _ckpt_steps(jax2) == [3]
    pngs = _ls(os.path.join(port2.run_dir, "val_images"))
    assert pngs == _ls(os.path.join(jax2, "val_images")) == [
        "step2_idx0_0.png"]
    assert _steps(port2.run_dir) == _steps(jax2) == [3]
    assert port2.state.opt.count == port2.state.opt.schedule_count == 3
    ckpt = torch.load(os.path.join(port.run_dir, "checkpoints",
                                   "step_00000002.pt"), weights_only=True)
    moved = sum(not torch.equal(ckpt["masters"][k], t)
                for k, t in port2.state.masters.items())
    assert moved > 0.9 * len(ckpt["masters"])


def test_resume_reset_scheduler_restarts_the_schedule(runs, port_cli):
    """With ``resume_reset_scheduler`` the resumed schedule restarts at
    count 0, so step 3 runs at lr 0 under the 2-step warm-up and leaves the
    masters as the checkpoint holds them, while Adam's count goes on
    (JAX's ``reset_lr_schedule``, held to it in
    ``test_torch_port_train_options.py``)."""
    _, port = runs
    run = port_cli("reset", f"resume_from_checkpoint="
                   f"{os.path.join(port.run_dir, 'checkpoints')}",
                   "runner.max_train_steps=3", "resume_reset_scheduler=true",
                   "runner.validation_before_run=false")
    assert run.state.step == 3
    assert run.state.opt.count == 3 and run.state.opt.schedule_count == 1
    ckpt = torch.load(os.path.join(port.run_dir, "checkpoints",
                                   "step_00000002.pt"), weights_only=True)
    for k, t in run.state.masters.items():
        assert torch.equal(ckpt["masters"][k], t), k
    moved = sum(not torch.equal(ckpt["opt"]["mu"][k], t)
                for k, t in run.state.opt.mu.items())
    assert moved > 0.9 * len(run.state.opt.mu)  # the moments did update


# a small run: 112x200 images (a 14x25 latent through the Plus map
# embedder), one step, no validation
SMALL = ("dataset.image_size=[112,200]",
         "model.controlnet.use_map_embedder_plus=true",
         "model.controlnet.map_embedder_plus_size=[14,25]",
         "runner.max_train_steps=1", "runner.validation_before_run=false",
         "runner.validation_steps=100")

_RANK = """
import json, sys
import torch
from magicdrive_tpu_torch.cli import train
torch.set_num_threads(1)
out, argv = sys.argv[1], sys.argv[2:]
run = train.main(argv, device="cpu")
r = torch.distributed.get_rank()
torch.save(run.state.masters, f"{out}/masters{r}.pt")
print(json.dumps({"rank": r, "run_dir": run.run_dir, "step": run.state.step,
                  "mesh": list(run.runner.mesh.shape),
                  "backend": torch.distributed.get_backend()}))
"""


@pytest.mark.parametrize("override", ["parallel.mesh_shape=[2,1]",
                                      "parallel.multihost=true",
                                      "parallel.shard_views=true",
                                      "parallel.mesh_shape=[2,2]"])
def test_parallel_configs_raise(port_cli, tmp_path, override):
    """The ``parallel`` group as JAX's runner reads it, on a small run:
    a mesh of two ranks, and ``multihost`` with every rank on dp, run as
    two gloo ranks on the CPU (``torchrun``): both take the step,
    on a (2, 1) mesh, into rank 0's run directory, and end with the same
    weights; ``shard_views`` (which JAX's runner never reads) trains as
    without it and says so in train.log; a mesh larger than the job
    raises, as JAX's assert does."""
    from test_torch_port_parallel import torchrun

    if override == "parallel.mesh_shape=[2,2]":
        with pytest.raises(ValueError, match="needs 4 ranks, the job has 1"):
            port_cli("parallel", override, *SMALL)
        return
    if override == "parallel.shard_views=true":
        plain = port_cli("plain", *SMALL)
        run = port_cli("views", override, *SMALL)
        for k, t in plain.state.masters.items():
            assert torch.equal(run.state.masters[k], t), k
        with open(os.path.join(run.run_dir, "train.log")) as f:
            assert "shard_views=true" in f.read()
        return
    extra = ("parallel.mesh_shape=null",) if "multihost" in override else ()
    argv = [*COMMON, *SMALL, f"log_root_prefix={tmp_path}/runs", override,
            *extra]
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    outs = torchrun(str(script), [str(tmp_path), *argv],
                    str(tmp_path / "logs"), timeout=300)
    got = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [g["rank"] for g in got] == [0, 1]
    assert {(g["run_dir"], g["step"], tuple(g["mesh"]), g["backend"])
            for g in got} == {(got[0]["run_dir"], 1, (2, 1), "gloo")}
    assert os.path.isdir(os.path.join(got[0]["run_dir"], "weights"))
    m0, m1 = (torch.load(tmp_path / f"masters{r}.pt", weights_only=True)
              for r in range(2))
    for k, t in m0.items():
        assert torch.equal(m1[k], t), k


def test_pair_bwd_is_logged_and_ignored(runs):
    """JAX's TPU backward knob is read, logged as having no effect, and
    exports nothing."""
    _, port = runs
    with open(os.path.join(port.run_dir, "train.log")) as f:
        log = f.read()
    assert "pair_bwd=serial" in log and "no effect" in log
    assert "MAGICDRIVE_PAIR_BWD" not in os.environ


class _Grids:
    """A metrics logger that keeps the validator's grids."""

    def __init__(self):
        self.grids = {}

    def log_images(self, step, tag, grid):
        self.grids[tag] = np.asarray(grid)


def test_validator_grid_matches_jax(jax_tree, monkeypatch):
    """The port's ``Validator`` on JAX's weights from JAX's initial
    latents: each grid is JAX's ``Validator``'s (fp32, one sampler step,
    samples 0 and 1, B=2), the ground-truth row equal, the generated row
    at atol 2e-3."""
    import magicdrive_tpu.data.collate as jcollate
    import magicdrive_tpu.train.runner as jrunner
    from magicdrive_tpu.config import presets as jp
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline
    from magicdrive_tpu.data.collate import CollateConfig as JCfg
    from magicdrive_tpu.data.fixtures import make_dataset as jmake
    from magicdrive_tpu.train.runner import Validator as JValidator

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.data import CollateConfig, make_dataset
    from magicdrive_tpu_torch.data.caption import HashTokenizer
    from magicdrive_tpu_torch.pipeline import pipeline
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import create_train_state, TrainConfig
    from magicdrive_tpu_torch.train.runner import Validator

    indices = [0, 1]
    jpre = jp.tiny_debug()
    jpre = dataclasses.replace(jpre, pipeline=dataclasses.replace(
        jpre.pipeline, num_inference_steps=1))
    tpre = dataclasses.replace(tiny_debug(), pipeline=dataclasses.replace(
        tiny_debug().pipeline, num_inference_steps=1))
    # JAX's stand-in tokenizer salts its ids per process: both take the
    # port's
    monkeypatch.setattr(jcollate, "HashTokenizer", HashTokenizer)
    monkeypatch.setattr(jrunner, "MagicDrivePipeline", MagicDrivePipeline)
    jval = JValidator(jpre.modules(dtype=jnp.float32), jpre, jmake(2),
                      JCfg(bbox_max_len=8), indices)
    want = _Grids()
    jval.validate(jax_tree, want, 5)

    modules = MagicDriveModules.create(tpre, device="cpu").load_state_dicts(
        jax_params_to_state_dicts(jax_tree))
    state = create_train_state(modules, TrainConfig(), device="cpu",
                               dtype=torch.float32)
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(1000),
                                       (2, 1, 28, 50, 4)))
    monkeypatch.setattr(
        pipeline.MagicDrivePipeline, "prepare_latents",
        lambda self, B, gen, **k: torch.from_numpy(lat).expand(
            B, 6, -1, -1, -1))
    got = _Grids()
    val = Validator(modules, tpre.pipeline,
                    make_dataset(2, with_images=True),
                    CollateConfig(bbox_max_len=8), indices, map_channels=8)
    grids = val.validate(state, got, 5)
    assert got.grids.keys() == want.grids.keys() == {"val/0_0", "val/1_0"}
    for tag, w in want.grids.items():
        g = got.grids[tag]
        assert g.shape == w.shape == (2 * 224, 6 * 400, 3)
        np.testing.assert_allclose(g[:224], w[:224], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g[224:], w[224:], rtol=0, atol=2e-3,
                                   err_msg=tag)
        assert np.abs(w[224:] - 0.5).max() > 0.05  # an image, not blank
    assert len(grids) == 2
