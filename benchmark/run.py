"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the program
(``magicdrive_tpu_torch``). The cell's configuration, traffic mix, limits
and per-layer readers are found by name from ``BENCHMARK.json`` (see
``benchmark/harness/cells.py``). With ``--trace 0`` the result carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics. The
run exits non-zero, with no result, where there is no CUDA card or fewer
than the cell asks for, where the program cannot be imported, or where
JAX, Flax or the JAX package is loaded once the window has closed.

The last lines on standard error, and the result's last key ``checks``,
give each number compared with its limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "magicdrive_tpu")


def environment(root: str) -> None:
    """Caches inside the checkout at fixed paths; no JAX through
    transformers."""
    cache = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, root: str = ROOT, device: str = "cuda",
         t0: float = None) -> dict:
    """One run; -> the result line's object. ``device`` "cpu" skips the
    look for a card (the CPU tests)."""
    t0 = T0 if t0 is None else t0
    args = parse(argv)
    environment(root)
    if root not in sys.path:
        sys.path.insert(0, root)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cells, common

    cell = cells.resolve(root, args.workload)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{args.workload} needs {cell.chips} CUDA "
                             f"card(s); torch.cuda.is_available() is "
                             f"{torch.cuda.is_available()}")
        torch.cuda.set_device(0)
    import magicdrive_tpu_torch  # noqa: F401  the program must be here
    log(f"imports: {time.perf_counter() - t0:.2f} s")

    args.tmpdir = os.environ.get("TMPDIR") or os.path.join(root,
                                                           ".bench_cache")
    os.makedirs(args.tmpdir, exist_ok=True)
    out = cells.kind(cell).run(cell, args, dev, log)
    found = loaded_forbidden()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package loaded: {found}")

    numbers = out["numbers"]
    limits = cell.limits["limits"]
    correct = common.within(numbers, limits) and out["failed"] == 0
    if args.trace:
        metrics = cells.read_per_layer(cell, out["record"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["end_to_end"].items() if k in units}
        metrics["setup_s"] = {"value": out["setup_end"] - t0, "unit": "s"}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
        else "cpu", "count": cell.chips,
        "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if args.trace:
        t = out["record"]["trace"]
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {
            "device_ops": t["device_ops"],
            "idle_gaps": out["record"]["trace_host"]["idle_gaps"]}
    line["checks"] = common.checks_line(numbers, limits)
    for k, v in line["checks"].items():
        log(f"check {k}: {v['value']!r} limit {v['limit']!r}")
    return line


if __name__ == "__main__":
    result = main()
    print(json.dumps(result), flush=True)
