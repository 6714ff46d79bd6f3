"""The program's spans in a Chrome trace taken with them on: device time,
host time and idle gaps by span, a unit at a time.

    python3 benchmark/spans_report.py TRACE.json [--unit NAME]

TRACE is a ``torch.profiler`` Chrome trace of the program with its spans
(``magicdrive_tpu_torch.utils.trace``) on: the training runner's
``<run_dir>/profile/steps<a>-<b>.json``, whose ``profile_steps`` window
turns them on, or a trace of any call under ``trace.enabled()``.
``harness/spans.py`` attributes it. One JSON object on standard output:
for each span name its calls, and the device milliseconds of the work
launched inside it (``device_ms``), of the work whose innermost span it is
(``self_ms``) and its host milliseconds (``host_ms``), each over the units,
the ranges named ``--unit`` (by default ``md.train.step`` where the trace
has one, else ``md.pipeline.request``, else the whole trace is one); and
the longest idle gaps of the device by the span the host was in.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import spans  # noqa: E402

UNITS = ("md.train.step", "md.pipeline.request")


def report(events, unit=None) -> dict:
    att = spans.attribute(events)
    names = att["spans"]
    if unit is None:
        unit = next((u for u in UNITS if u in names), None)
    n = names[unit]["calls"] if unit in names else 1

    def ms(seconds):
        return 1e3 * seconds / n
    return {"unit": unit, "units": n, "device_ms": ms(att["device_s"]),
            "outside_ms": ms(att["outside_s"]),
            "window_ms": ms(att["window_s"]),
            "spans": {k: {"calls": v["calls"] / n,
                          "device_ms": ms(v["device_s"]),
                          "self_ms": ms(v["self_s"]),
                          "host_ms": ms(v["host_s"])}
                      for k, v in sorted(names.items())},
            "idle_gaps_ms": [[k, ms(v)] for k, v in att["idle_gaps"]]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("trace")
    p.add_argument("--unit", default=None)
    args = p.parse_args(argv)
    with open(args.trace) as f:
        events = json.load(f)["traceEvents"]
    out = report(events, args.unit)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
