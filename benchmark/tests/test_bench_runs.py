"""Whole runs of the harness on the CPU at the program's CPU presets: the
reference agrees with the program in fp32 and not in bf16, every planted
fault of the timed path makes ``correct`` false, and a cell, a
configuration, a traffic mix and a metric added as files run through the
harness's code paths. The card-marked test runs every cell of
BENCHMARK.json for a few seconds."""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark.tests import cells as tc

SEED = 2_147_483_711  # past 32 signed bits
# fp32 program against fp32 reference, CPU, 2 seeds: the gradient's and the
# change's gaps of norms read at most 5e-5 and 2.4e-4 (q and k leaves,
# whose softmax backward cancels), bf16 0.39 and 0.14 at micro_debug
TIGHT = {"generate": {"latent_gap": 1e-4, "image_gap": 1e-4},
         "train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
                   "grad_median_gap": 1e-3, "change_median_gap": 1e-3}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tc.checkout(str(tmp_path_factory.mktemp("bench")))
    for preset, dtype in (("micro_debug", "float32"),
                          ("micro_debug", "bfloat16"),
                          ("tiny_debug", "float32")):
        cfg = tc.config_of(preset, dtype)
        cfg["name"] = f"{preset}-{dtype}".replace("_", "-")
        for kind, traffic in (("generate", tc.GEN), ("train", tc.TRAIN)):
            tc.add_cell(root, f"{kind}.{cfg['name']}", cfg, f"test-{kind}",
                        traffic, TIGHT[kind])
    return root


def run(root, cell, seconds=0.5):
    from benchmark import run as bench

    return bench.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                       str(seconds), "--trace", "0"], root=root,
                      device="cpu", t0=time.perf_counter())


@pytest.mark.parametrize("cell", [
    "generate.micro-debug-float32", "train.micro-debug-float32",
    "generate.tiny-debug-float32", "train.tiny-debug-float32"])
def test_reference_agrees_with_the_program_in_fp32(root, cell):
    out = run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    e2e = "frames_per_s" if cell.startswith("generate") else \
        "train_samples_per_s"
    assert set(out["metrics"]) == {e2e, "setup_s"}


@pytest.mark.parametrize("kind", ["generate", "train"])
def test_the_same_check_fails_in_bf16(root, kind):
    out = run(root, f"{kind}.micro-debug-bfloat16")
    assert not out["correct"], out["checks"]


def _unchanged_sampler(monkeypatch):
    from magicdrive_tpu_torch.diffusion import samplers

    monkeypatch.setattr(samplers.UniPCCoeffs, "step",
                        lambda self, i, x, eps, state: (x, state))


def _altered_image(monkeypatch):
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    inner = MagicDrivePipeline.decode

    def decode(self, x):
        img = inner(self, x).clone()
        img[0, 0] = 1.0 - img[0, 0]
        return img
    monkeypatch.setattr(MagicDrivePipeline, "decode", decode)


def _unchanged_state(monkeypatch):
    from magicdrive_tpu_torch.train import state

    monkeypatch.setattr(state.AdamW, "step", lambda self, params, grads:
                        state._global_norm(list(grads.values())))


def _half_batch(monkeypatch):
    ts = importlib.import_module("magicdrive_tpu_torch.train.train_step")

    inner = ts.loss_fn

    def loss_fn(modules, batch, draws, cfg, schedule):
        B = batch["pixel_values"].shape[0]
        h = max(1, B // 2)
        n = draws.vae_noise.shape[0] // B
        batch = {k: v if k == "uncond_ids" else v[:h]
                 for k, v in batch.items()}
        draws = ts.StepDraws(draws.vae_noise[:h * n], draws.noise[:h],
                             draws.timesteps[:h], draws.drop_mask[:h])
        return inner(modules, batch, draws, cfg, schedule)
    monkeypatch.setattr(ts, "loss_fn", loss_fn)


def _altered_loss(monkeypatch):
    ts = importlib.import_module("magicdrive_tpu_torch.train.train_step")

    inner = ts.loss_fn
    monkeypatch.setattr(ts, "loss_fn", lambda *a: inner(*a) * 1.05)


@pytest.mark.parametrize("kind,fault", [
    ("generate", _unchanged_sampler), ("generate", _altered_image),
    ("train", _unchanged_state), ("train", _half_batch),
    ("train", _altered_loss)])
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, kind, fault):
    fault(monkeypatch)
    out = run(root, f"{kind}.micro-debug-float32")
    assert not out["correct"], out["checks"]


def test_a_cell_config_and_metric_added_as_files(root, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    file plus an entry of BENCHMARK.json: the harness finds them by name."""
    from benchmark.harness import cells

    local = tc.checkout(str(tmp_path))
    cfg = tc.config_of("micro_debug", n_cam=3)
    cfg["name"] = "micro-three-cameras"
    tc.add_cell(local, "generate.three", cfg, "closed-three",
                dict(tc.GEN, batch=1), TIGHT["generate"])
    with open(os.path.join(local, "BENCHMARK.json")) as f:
        index = json.load(f)
    index["per_layer"].append({
        "name": "frames_done.gen", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "pipeline",
        "moves": "frames_per_s", "workloads": ["generate.three"]})
    tc.write(os.path.join(local, "BENCHMARK.json"), index)
    with open(os.path.join(local, "benchmark", "metrics",
                           "frames_done.gen.py"), "w") as f:
        f.write("def read(record):\n    return record.get('frames')\n")
    out = run(local, "generate.three")
    assert out["correct"], out["checks"]
    cell = cells.resolve(local, "generate.three")
    assert "frames_done.gen" in [m["name"] for m in cell.per_layer]
    read = cells.read_per_layer(cell, {"frames": 7})
    assert read["frames_done.gen"] == {"value": 7.0, "unit": "frames"}


def _cells():
    with open(os.path.join(tc.REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", _cells())
def test_cell_runs_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "3", "--trace", "0"], cwd=tc.REPO,
        capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert torch.cuda.get_device_name(0) == out["device"]["kind"]


def test_modules_built_without_init_load_the_same_state():
    """``skip_init`` leaves no parameter or buffer that the seeded weights
    do not set: built with and without PyTorch's default initialisation,
    the loaded modules hold the same tensors, buffers of no state too."""
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    from benchmark.harness import common, weights
    from benchmark.harness.preset import port_preset

    cfg = tc.config_of("micro_debug")
    sd = weights.make(cfg["model"], SEED, cfg["weights"], "cpu",
                      torch.float32)
    built = []
    for ctx in (common.nothing, common.skip_init):
        with ctx():
            mods = MagicDriveModules.create(port_preset(cfg), device="cpu")
        for name, mod in mods.items():
            mod.load_state_dict(sd[name], strict=True)
        built.append({f"{n}.{k}": t for n, mod in mods.items()
                      for k, t in [*mod.named_parameters(),
                                   *mod.named_buffers()]})
    assert built[0].keys() == built[1].keys()
    for k, t in built[0].items():
        assert torch.equal(t, built[1][k]), k
