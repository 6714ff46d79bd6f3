"""The port's spans (``magicdrive_tpu_torch/utils/trace.py``) on the CPU at
the ``micro_debug`` preset, one module build for the file: nothing recorded
with spans off, one span a layer call with them on, their parents and
units, the profiler's ranges around the ATen operators they hold, the same
images, loss and gradients either way, and the runner's profile window:
the steps' phases, a validation inside it, and spans off again where
training ends or raises inside it."""
import bisect
import collections
import importlib
import json
import os
import threading

import pytest
import torch

from magicdrive_tpu_torch.utils import trace

torch.set_num_threads(1)

STEPS = 3


@pytest.fixture(scope="module")
def micro():
    """(preset, modules in fp32, a collated batch with images)."""
    from magicdrive_tpu_torch.config import micro_debug
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    preset = micro_debug()
    torch.manual_seed(0)
    modules = MagicDriveModules.create(preset, device="cpu").to(
        "cpu", torch.float32)
    batch = collate_fn([make_sample(0, image_hw=preset.image_size,
                                    map_hw=preset.map_hw, with_images=True)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    return preset, modules, batch


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with spans off and none kept."""
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def _generate(micro):
    import dataclasses

    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    preset, modules, batch = micro
    pipe = MagicDrivePipeline(modules, dataclasses.replace(
        preset.pipeline, num_inference_steps=STEPS))
    request = {k: v for k, v in batch.items() if k != "pixel_values"}
    return pipe(request, generator=torch.Generator().manual_seed(0))


def _chrome(prof, tmp_path):
    path = os.path.join(str(tmp_path), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X"]


def _derived(modules) -> collections.Counter:
    """The block spans of a request of STEPS steps, from the modules: each
    step runs the ControlNet and the UNet once, the decode the VAE's
    decoder once."""
    from magicdrive_tpu_torch.core.resnet import ResnetBlock2D
    from magicdrive_tpu_torch.core.transformer import (BasicTransformerBlock,
                                                       Transformer2DModel)

    def of(cls, *mods):
        return [m for mod in mods for m in mod.modules()
                if isinstance(m, cls)]
    eps = (modules.unet, modules.controlnet)
    blocks = of(BasicTransformerBlock, *eps)
    return collections.Counter({
        "md.attn": STEPS * sum(2 + b.cross_view for b in blocks),
        "md.ff": STEPS * len(blocks),
        "md.transformer": STEPS * len(of(Transformer2DModel, *eps)),
        "md.resnet": STEPS * len(of(ResnetBlock2D, *eps)) +
        len(of(ResnetBlock2D, modules.vae.decoder))})


def test_off_records_nothing_and_opens_no_range(micro, tmp_path):
    """Off, a span is the one shared no-op object; a request leaves no span
    to drain and no md.* range in a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    assert not trace.is_enabled()
    assert trace.span("md.a") is trace.span("md.b", unit=True)
    _generate(micro)
    assert trace.drain() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(micro)
    events = _chrome(prof, tmp_path)
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not [e["name"] for e in events
                if e["name"].startswith("md.")]
    assert trace.drain() == []


def test_request_spans_counts_parents_and_unit(micro):
    """One request of STEPS steps: one request, conditioning and decode
    span, STEPS step spans, and the block spans the modules imply; each
    span under the right parent, all of one unit, the request's."""
    with trace.enabled():
        _generate(micro)
    spans = trace.drain()
    got = collections.Counter(s.name for s in spans)
    want = _derived(micro[1]) + collections.Counter({
        "md.pipeline.request": 1, "md.pipeline.conditioning": 1,
        "md.pipeline.decode": 1, "md.pipeline.step": STEPS})
    assert got == want
    by_id = {s.id: s for s in spans}
    parent = {s.id: by_id[s.parent].name if s.parent is not None else None
              for s in spans}
    (req,) = [s for s in spans if s.name == "md.pipeline.request"]
    allowed = {"md.pipeline.request": {None},
               "md.pipeline.conditioning": {"md.pipeline.request"},
               "md.pipeline.step": {"md.pipeline.request"},
               "md.pipeline.decode": {"md.pipeline.request"},
               "md.transformer": {"md.pipeline.step"},
               "md.attn": {"md.transformer"},
               "md.ff": {"md.transformer"},
               "md.resnet": {"md.pipeline.step", "md.pipeline.decode"}}
    for s in spans:
        assert parent[s.id] in allowed[s.name], (s.name, parent[s.id])
        assert s.unit == req.id
        assert req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    steps = sorted(s.start_ns for s in spans if s.name == "md.pipeline.step")
    (cond,) = [s for s in spans if s.name == "md.pipeline.conditioning"]
    (dec,) = [s for s in spans if s.name == "md.pipeline.decode"]
    assert cond.end_ns <= steps[0] and steps[-1] <= dec.start_ns


def test_two_requests_are_two_units(micro):
    with trace.enabled():
        _generate(micro)
        _generate(micro)
    spans = trace.drain()
    reqs = [s for s in spans if s.name == "md.pipeline.request"]
    assert len(reqs) == 2 and reqs[0].id != reqs[1].id
    assert collections.Counter(s.unit for s in spans) == {
        r.id: len(spans) // 2 for r in reqs}


def test_images_bitwise_equal_with_spans_on_and_off(micro):
    off = _generate(micro)
    with trace.enabled():
        on = _generate(micro)
    assert torch.equal(off, on)


def _train(micro):
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state

    _, modules, batch = micro
    cfg = TrainConfig(learning_rate=1e-3, lr_warmup_steps=0)
    return modules, create_train_state(modules, cfg, device="cpu",
                                       dtype=torch.float32), batch, cfg


def test_train_step_phases(micro):
    """One step: one span of each phase, the phases under md.train.step,
    in order, and every span of the step's unit."""
    from magicdrive_tpu_torch.train import train_step

    modules, state, batch, cfg = _train(micro)
    with trace.enabled():
        train_step(modules, state, batch, cfg,
                   generator=torch.Generator().manual_seed(0))
    spans = trace.drain()
    phases = ["md.train.masters", "md.train.encode", "md.train.forward",
              "md.train.backward", "md.train.optimizer"]
    got = collections.Counter(s.name for s in spans
                              if s.name.startswith("md.train."))
    assert got == collections.Counter(["md.train.step"] + phases)
    (step,) = [s for s in spans if s.name == "md.train.step"]
    assert step.parent is None and step.unit == step.id
    top = [s for s in spans if s.parent == step.id]
    assert [s.name for s in top] == phases
    assert all(s.unit == step.id for s in spans)
    blocks = {s.name for s in spans if s.parent is not None
              and s.parent in {t.id for t in top
                               if t.name == "md.train.forward"}}
    assert {"md.transformer", "md.resnet"} <= blocks


def test_loss_and_gradients_bitwise_equal_with_spans_on_and_off(micro):
    from magicdrive_tpu_torch.diffusion import NoiseSchedule

    ts = importlib.import_module("magicdrive_tpu_torch.train.train_step")

    modules, state, batch, cfg = _train(micro)
    schedule = NoiseSchedule.create()
    b = ts.batch_tensors(batch, "cpu")
    B, N, H, W = b["pixel_values"].shape[:4]
    draws = ts.sample_draws(cfg, schedule, B, N, (H // 8, W // 8),
                            torch.Generator().manual_seed(1), "cpu")
    off = ts.loss_and_grads(modules, state, b, draws, cfg, schedule)
    with trace.enabled():
        on = ts.loss_and_grads(modules, state, b, draws, cfg, schedule)
    assert [s.name for s in trace.drain()
            if s.name.startswith("md.train.")].count("md.train.backward") == 1
    assert torch.equal(off[0], on[0])
    assert off[1].keys() == on[1].keys()
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k


def test_profiler_ranges_hold_their_operators(micro, tmp_path):
    """Under a CPU profiler every span is a user_annotation range, as many
    of each name as spans recorded, nested as the spans are, and each
    holds the ATen operators it ran on the trace's clock: every block
    range holds one, and an operator that starts in a range ends in it."""
    from torch.profiler import ProfilerActivity, profile

    with trace.enabled(), profile(activities=[ProfilerActivity.CPU]) as prof:
        _generate(micro)
    spans = trace.drain()
    events = _chrome(prof, tmp_path)
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e["name"].startswith("md.")]
    assert collections.Counter(e["name"] for e in ranges) == \
        collections.Counter(s.name for s in spans)
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["tid"])
                 for e in events if e.get("cat") == "cpu_op")
    starts = [o[0] for o in ops]

    def inside(r):
        a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        return [o for o in ops[bisect.bisect_left(starts, a):
                               bisect.bisect_right(starts, b)]
                if o[2] == r["tid"]], a, b
    for r in ranges:
        held, a, b = inside(r)
        if r["name"] in ("md.attn", "md.ff", "md.resnet", "md.transformer",
                         "md.pipeline.step", "md.pipeline.decode"):
            assert held, r["name"]
        assert all(o[1] <= b + 1.0 for o in held), r["name"]
    outer = {"md.attn": "md.transformer", "md.ff": "md.transformer",
             "md.transformer": "md.pipeline.step",
             "md.pipeline.step": "md.pipeline.request"}
    for r in ranges:
        if r["name"] in outer:
            a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
            assert any(o["name"] == outer[r["name"]]
                       and float(o["ts"]) <= a + 1.0
                       and b <= float(o["ts"]) + float(o["dur"]) + 1.0
                       for o in ranges), r["name"]


def _runner(micro, tmp_path, *overrides, validate=False):
    """A runner of the micro modules on one repeated sample, its config
    ``runner=debug`` in fp32 with ``overrides``; with ``validate`` a
    validation of that sample every ``validation_steps``."""
    from magicdrive_tpu_torch.cli.train import CONFIG_DIR
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.data import make_dataset
    from magicdrive_tpu_torch.train import Runner

    preset, modules, _ = micro
    cfg = compose(CONFIG_DIR, overrides=[
        "model=tiny_debug", "runner=debug", "runner.mixed_precision=no",
        f"dataset.image_size=[{preset.image_size[0]},"
        f"{preset.image_size[1]}]",
        f"runner.bbox_max_length={preset.bbox_max_len}",
        "runner.validation_index=[0]", *overrides])
    data = make_dataset(1, image_hw=preset.image_size, map_hw=preset.map_hw,
                        with_images=True)
    run_dir = str(tmp_path / "run")
    runner = Runner(cfg, preset, modules, data,
                    val_dataset=data if validate else None, run_dir=run_dir,
                    device="cpu")
    return runner, runner.init_state(), run_dir


def _ranges(run_dir, name) -> collections.Counter:
    with open(os.path.join(run_dir, "profile", name)) as f:
        return collections.Counter(
            e["name"] for e in json.load(f)["traceEvents"]
            if e.get("cat") == "user_annotation")


def test_runner_profile_window_turns_spans_on(micro, tmp_path):
    """``profile_steps`` [1, 2]: the exported trace of step 2 holds each
    phase of the step as a range; spans are off again after the window,
    with none left kept."""
    runner, state, run_dir = _runner(micro, tmp_path,
                                     "+runner.profile_steps=[1,2]")
    runner.train(state, [next(iter(runner.loader))] * 3)
    assert state.step == 3
    names = _ranges(run_dir, "steps2-2.json")
    for phase in ("step", "masters", "encode", "forward", "backward",
                  "optimizer"):
        assert names[f"md.train.{phase}"] == 1, phase
    assert names["md.attn"] > 0
    assert not trace.is_enabled() and trace.drain() == []


def test_runner_profile_window_holds_a_validation(micro, tmp_path):
    """``profile_steps`` [1, 3] with a validation after step 2: the trace
    holds two steps and the validation's request, its conditioning, one
    range a denoising step and its decode."""
    runner, state, run_dir = _runner(
        micro, tmp_path, "+runner.profile_steps=[1,3]",
        "runner.validation_steps=2", validate=True)
    runner.train(state, [next(iter(runner.loader))] * 3)
    names = _ranges(run_dir, "steps2-3.json")
    steps = micro[0].pipeline.num_inference_steps
    assert names["md.train.step"] == 2
    assert names["md.pipeline.request"] == 1
    assert names["md.pipeline.conditioning"] == 1
    assert names["md.pipeline.step"] == steps
    assert names["md.pipeline.decode"] == 1
    assert not trace.is_enabled() and trace.drain() == []


@pytest.mark.parametrize("end", ["max_steps", "raises"])
def test_runner_window_cut_short_turns_spans_off(micro, tmp_path,
                                                 monkeypatch, end):
    """A window [1, 5] that training leaves early, at ``max_train_steps``
    3 or by an error in step 3: spans are off after it with none kept, and
    the trace holds the steps finished in it."""
    import magicdrive_tpu_torch.train.runner as runner_mod

    runner, state, run_dir = _runner(
        micro, tmp_path, "+runner.profile_steps=[1,5]",
        f"runner.max_train_steps={3 if end == 'max_steps' else 7}")
    if end == "raises":
        real = runner_mod.train_step

        def step(modules, state, *a, **kw):
            if state.step == 2:
                raise RuntimeError("step 3")
            return real(modules, state, *a, **kw)
        monkeypatch.setattr(runner_mod, "train_step", step)
        with pytest.raises(RuntimeError, match="step 3"):
            runner.train(state, [next(iter(runner.loader))] * 6)
    else:
        runner.train(state, [next(iter(runner.loader))] * 6)
    assert state.step == (3 if end == "max_steps" else 2)
    assert not trace.is_enabled() and trace.drain() == []
    names = _ranges(run_dir, f"steps2-{state.step}.json")
    assert names["md.train.step"] == state.step - 1


def test_enabled_restores_and_nests():
    with trace.enabled():
        assert trace.is_enabled()
        with trace.enabled(False):
            assert not trace.is_enabled()
            with trace.span("md.none"):
                pass
        assert trace.is_enabled()
        with pytest.raises(RuntimeError):
            with trace.enabled(False):
                raise RuntimeError("inside")
        assert trace.is_enabled()
    assert not trace.is_enabled()
    assert trace.drain() == []
    trace.enable()
    assert trace.is_enabled()
    trace.disable()
    assert not trace.is_enabled()


def test_span_on_another_thread_takes_the_open_unit():
    """A span opened on another thread while a unit is open (the autograd
    thread in a step's backward) has no parent there and the unit's id;
    a span that raises is still recorded and closed."""
    with trace.enabled():
        with trace.span("md.unit", unit=True):
            with trace.span("md.inner"):
                worker = threading.Thread(
                    target=trace.call, args=("md.elsewhere", lambda: None))
                worker.start()
                worker.join(timeout=30)
        assert not worker.is_alive()
        with pytest.raises(ValueError):
            with trace.span("md.raises"):
                raise ValueError("inside")
        with trace.span("md.after"):
            pass
    spans = {s.name: s for s in trace.drain()}
    unit, inner, other = (spans[k] for k in ("md.unit", "md.inner",
                                             "md.elsewhere"))
    assert unit.unit == unit.id and inner.parent == unit.id
    assert inner.unit == unit.id
    assert other.parent is None and other.unit == unit.id
    assert spans["md.raises"].unit is None
    assert spans["md.after"].parent is None
