"""The readings a cell's limits are set from, in one process on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \\
        --controls 3 [--faults 3]

For each of ``--seeds`` seeds the program's numbers against the plain fp32
reference (the lower readings); on the first ``--controls`` of them the
control's: the reference computed with float8 products in the program's
place (the upper readings); for a training cell, on the first
``--faults`` seeds, the program with a planted fault (half of the batch
left out, the loss altered where it is produced). One JSON line per
reading on standard output, then the largest program reading and the
smallest control and fault readings of each number. The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import cells, common  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    mod = importlib.import_module(module)
    inner = getattr(mod, attr)
    setattr(mod, attr, make(inner))
    try:
        yield
    finally:
        setattr(mod, attr, inner)


def half_batch(inner):
    ts = importlib.import_module("magicdrive_tpu_torch.train.train_step")

    def loss_fn(modules, batch, draws, cfg, schedule):
        B = batch["pixel_values"].shape[0]
        h, n = max(1, B // 2), draws.vae_noise.shape[0] // B
        batch = {k: v if k == "uncond_ids" else v[:h]
                 for k, v in batch.items()}
        draws = ts.StepDraws(draws.vae_noise[:h * n], draws.noise[:h],
                             draws.timesteps[:h], draws.drop_mask[:h])
        return inner(modules, batch, draws, cfg, schedule)
    return loss_fn


FAULTS = {"half_batch": half_batch,
          "loss_altered": lambda inner: lambda *a: inner(*a) * 1.01}
HEADS_FAULTS = ("mispaired", "flat")


def seeds(n: int):
    return [3_000_000_019 + 7919 * i for i in range(n)]


def generate(cell, args, dev, emit):
    from benchmark.kinds import generate as g

    prog, model = None, None
    for i, s in enumerate(seeds(args.seeds)):
        if prog is None:
            prog = g.Program(cell, s, dev)
        else:
            prog.load(s)
        req = g.requests(cell, s, dev)(0)
        imgs = prog(req)
        got = (prog.final[-1], imgs)
        model = g.reference_model(cell, s, dev, model)
        want = g.reference(cell, model, req, dev)
        imgr = want[1]
        spread = lambda img: common.rel_gap(torch.as_tensor(img), imgr,
                                            imgr - imgr.mean())
        emit("program", s, g.gaps(got, want), spread_gap=spread(imgs),
             image_spread=float(imgr.std()))
        if i < args.controls:
            ctl = g.reference(cell, model, req, dev, lower=True)
            emit("control", s, g.gaps(ctl, want), spread_gap=spread(ctl[1]))
        for f in HEADS_FAULTS if i < args.faults else ():
            with ref_model.planted(f):
                bad = g.reference(cell, model, req, dev)
            emit(f, s, g.gaps(bad, want))


def train(cell, args, dev, emit):
    from benchmark.kinds import train as t

    for i, s in enumerate(seeds(args.seeds)):
        pool, draws = t.data(cell, s, dev)
        prog = t.Program(cell, s, dev)
        got = t.program_readings(prog, pool, draws)
        del prog
        common.free(dev)
        readings = {}
        if i < args.faults:
            for name, make in FAULTS.items():
                with patched("magicdrive_tpu_torch.train.train_step",
                             "loss_fn", make):
                    prog = t.Program(cell, s, dev)
                    readings[name] = t.program_readings(prog, pool, draws)
                    del prog
                    common.free(dev)
        want = t.reference_readings(cell, s, pool, draws, dev)
        emit("program", s, t.gaps(got, want), worst=t.worst(got, want),
             losses=[got["losses"], want["losses"]])
        for name, r in readings.items():
            emit(name, s, t.gaps(r, want))
        if i < args.controls:
            ctl = t.reference_readings(cell, s, pool, draws, dev, lower=True)
            emit("control", s, t.gaps(ctl, want), worst=t.worst(ctl, want))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--root", default=ROOT)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = cells.resolve(args.root, args.workload)
    dev = torch.device(args.device)
    rows = []

    def emit(what, seed, numbers, **detail):
        rows.append((what, numbers))
        print(json.dumps({"what": what, "seed": seed, "numbers": numbers,
                          **detail, "t": round(time.perf_counter(), 1)}),
              flush=True)
    {"generate": generate, "train": train}[cell.traffic["kind"]](
        cell, args, dev, emit)
    summary = {}
    for what, numbers in rows:
        for k, v in numbers.items():
            agg = max if what == "program" else min
            key = f"{what}.{k}"
            summary[key] = v if key not in summary else agg(summary[key], v)
    print(json.dumps({"summary": summary, "card": common.power_limit()}))


if __name__ == "__main__":
    main()
