"""Training: back-to-back steps of ``train_step`` at a batch of ``batch``
samples, bf16 modules over fp32 masters and fp32 AdamW.

Set-up builds the modules on the device without their default
initialisation, loads the benchmark's seeded weights, builds the train
state and runs the first ``CHECKED_STEPS`` steps through the window's own
call, on rows that all differ: these are the warm-up and the readings of the comparison (each step's loss, the first
gradient as the optimizer holds it, the masters' change after the last).
The window then steps the same state on in a cycle of ``pool`` seeded
batches, every step with fresh draws (timesteps, noise, the posterior
sample, the condition drop). After the window the plain fp32 reference
trains the same weights on the same batches and draws for those steps.

Per-layer readings (``--trace 1``): CUDA events around
``TrainState.apply_gradients`` over the window, then ``trace_units`` more
steps under the profiler.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common, flops, scenes, trace, weights
from benchmark.harness.preset import dtype as config_dtype
from benchmark.harness.preset import port_preset
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

CHECKED_STEPS = 3


class Program:
    def __init__(self, cell, seed: int, device):
        from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
        from magicdrive_tpu_torch.train import state as st

        self.cell, self.device = cell, device
        cfg = cell.config
        preset = port_preset(cfg)
        t0 = time.perf_counter()
        with common.skip_init():
            self.modules = MagicDriveModules.create(preset, device=device)
        common.sync(device)
        self.times = {"modules": time.perf_counter() - t0}
        sd = weights.make(cfg["model"], seed, cfg["weights"], device,
                          config_dtype(cfg))
        for name, mod in self.modules.items():
            mod.load_state_dict(sd[name], strict=True)
        del sd
        common.sync(device)
        self.times["weights"] = time.perf_counter() - t0 - \
            self.times["modules"]
        self.tcfg = st.TrainConfig(**cell.traffic["optimizer"])
        self.state = st.create_train_state(self.modules, self.tcfg,
                                           device=device,
                                           dtype=config_dtype(cfg))

    def __call__(self, batch, draws):
        from magicdrive_tpu_torch.train.train_step import train_step

        return train_step(self.modules, self.state, batch, self.tcfg,
                          draws=draws)


def data(cell, seed: int, device):
    """(batches: the pool of device batches, draws(i) -> the draws of step
    i as a dict of tensors)."""
    p = scenes.shape_params(cell.config, cell.traffic)
    tr = cell.traffic
    B, N = tr["batch"], cell.config["pipeline"]["n_cam"]
    pool = [scenes.to_tensors(scenes.batch(seed, i, B, p, images=True),
                              device) for i in range(tr["pool"])]
    h, w = (cell.config["pipeline"][k] for k in ("latent_height",
                                                 "latent_width"))
    opt = tr["optimizer"]

    def draws(i: int) -> dict:
        g = common.generator(seed, 2, i, device=device)
        d = {"vae_noise": torch.randn((B * N, 4, h, w), generator=g,
                                      device=device),
             "timesteps": torch.randint(0, 1000, (B,), generator=g,
                                        device=device),
             "noise": torch.randn((B, N, 4, h, w), generator=g,
                                  device=device)}
        hit = torch.rand((B, 1), generator=g, device=device) < \
            opt["drop_cond_ratio"]
        scores = torch.rand((B, N), generator=g, device=device)
        k = opt["drop_cam_num"]
        thresh = scores.sort(dim=1).values[:, k - 1:k]
        d["drop_mask"] = (hit & (scores <= thresh)).float()
        return d
    return pool, draws


def step_draws(d: dict):
    from magicdrive_tpu_torch.train.train_step import StepDraws

    return StepDraws(d["vae_noise"], d["noise"], d["timesteps"],
                     d["drop_mask"])


def _norms(tensors) -> dict:
    return {k: float(v) for k, v in zip(
        tensors, torch.stack(torch._foreach_norm(list(tensors.values())))
        .double().cpu())}


def program_readings(prog, pool, draws) -> dict:
    """The first CHECKED_STEPS steps: losses, the first gradient's norms
    (Adam's first moment after one step over 1 - beta1) and the masters'
    change after the last step, per leaf."""
    start = {k: v.clone() for k, v in prog.state.masters.items()}
    losses, first = [], None
    b1 = prog.tcfg.adam_beta1
    for i in range(CHECKED_STEPS):
        m = prog(pool[i % len(pool)], step_draws(draws(i)))
        losses.append(float(m["loss"]))
        if i == 0:
            first = {k: v / (1 - b1) for k, v in _norms(
                prog.state.opt.mu).items()}
    change = _norms({k: v - start[k]
                     for k, v in prog.state.masters.items()})
    return {"losses": losses, "first": first, "change": change}


def reference_readings(cell, seed: int, pool, draws, device,
                       lower: bool = False) -> dict:
    cfg = cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device(device):
        model = ref_model.Model(cfg["model"])
    sd = weights.make(cfg["model"], seed, cfg["weights"], device,
                      config_dtype(cfg))
    for name in ("unet", "controlnet", "vae", "clip"):
        getattr(model, name).load_state_dict(sd[name], strict=True)
    del sd
    batches = [pool[i % len(pool)] for i in range(CHECKED_STEPS)]
    ds = [draws(i) for i in range(CHECKED_STEPS)]
    with ref_model.lower_precision() if lower else common.nothing():
        losses, first, change, raw = ref_steps.train(
            model, batches, ds, cell.traffic["optimizer"], CHECKED_STEPS)
    out = {"losses": losses, "first": _norms(first),
           "change": _norms(change), "raw": _norms(raw)}
    del model, first, change, raw
    common.free(device)
    return out


def moved(want: dict):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others move by round-off alone."""
    med = float(np.median(list(want["raw"].values())))
    return [k for k, v in want["raw"].items() if v >= 1e-3 * med]


def gaps(got: dict, want: dict) -> dict:
    """loss_gap: the worst step's |loss - ref| / ref; grad_gap and
    change_gap: the worst leaf's gap of norms (``common.leaf_gaps``), the
    change over the ``moved`` leaves; grad_median_gap and
    change_median_gap: the median leaf's gap of the same. The worst leaf
    is one whose gradient passes a peaky softmax's backward, and swings
    from seed to seed; the median leaf is steady."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(got["losses"], want["losses"]))}
    for k, name, keys in (("first", "grad", None),
                          ("change", "change", moved(want))):
        g = list(common.leaf_gaps(got[k], want[k], keys).values())
        out[f"{name}_gap"] = max(g)
        out[f"{name}_median_gap"] = float(np.median(g))
    return out


def worst(got: dict, want: dict) -> dict:
    """The leaf behind grad_gap and change_gap, and the median leaf's
    gaps: what to look at where a number reads high."""
    out = {}
    for k, keys in (("first", None), ("change", moved(want))):
        g = common.leaf_gaps(got[k], want[k], keys)
        out[k] = [max(g, key=g.get), float(np.median(list(g.values())))]
    return out


def run(cell, args, device, log) -> dict:
    t0 = time.perf_counter()
    prog = Program(cell, args.seed, device)
    pool, draws = data(cell, args.seed, device)
    common.sync(device)
    t1 = time.perf_counter()
    got = program_readings(prog, pool, draws)
    common.sync(device)
    log(f"set-up: program, weights and data {t1 - t0:.2f} s (modules "
        f"{prog.times['modules']:.2f}, weights {prog.times['weights']:.2f}),"
        f" {CHECKED_STEPS} checked steps {time.perf_counter() - t1:.2f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_end = time.perf_counter()

    step = lambda i: prog(pool[i % len(pool)], step_draws(draws(i)))
    losses = []
    spans = common.Spans(prog.state, "apply_gradients") if args.trace \
        else None
    win = common.window(
        lambda k: losses.append(step(CHECKED_STEPS + k)["loss"]),
        args.seconds, device)
    opt_ms = spans.close() if spans else None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    B = cell.traffic["batch"]
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    record = {"window_s": win["seconds"], "units": win["units"],
              "samples": win["units"] * B}
    result = {"setup_end": setup_end, "attempted": win["units"],
              "failed": failed, "memory_peak_bytes": int(peak),
              "end_to_end": {"train_samples_per_s":
                             win["units"] * B / win["seconds"]}}
    if args.trace:
        name = torch.cuda.get_device_name(0)
        n = cell.traffic["trace_units"]
        first = CHECKED_STEPS + win["units"]
        record.update(peaks=flops.peaks(name), optimizer_ms=opt_ms,
                      flops={"total": flops.train_step(cell.config, B)},
                      device_name=name, power=common.power_limit(),
                      trace_units=n)
        record["trace"] = trace.traced(
            lambda: [step(first + i) for i in range(n)], args.tmpdir,
            host=False)
        record["trace_host"] = trace.traced(
            lambda: [step(first + n + i) for i in range(n)], args.tmpdir,
            host=True)
        log(f"card: {record['power']}")
    del prog, losses
    common.free(device)
    t0 = time.perf_counter()
    want = reference_readings(cell, args.seed, pool, draws, device)
    log(f"reference: {time.perf_counter() - t0:.2f} s")
    result["numbers"] = gaps(got, want)
    result["record"] = record
    return result
