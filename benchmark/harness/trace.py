"""Reading a stretch of the run from the profiler's device trace.

``traced(fn, tmpdir, host)`` runs ``fn`` under ``torch.profiler`` inside
a range ``bench.window`` that ends after a device synchronise, writes the
Chrome trace under ``tmpdir``, reads it and deletes it. From the trace:

* ``window_s``: the length of the stretch;
* ``busy_s``: the union of the device's operations (kernels, copies,
  fills) inside it, not their sum, so overlapping streams count once;
* ``device_ops``: the ten operations that took most device time;
* ``idle_gaps``: the longest stretches with no device operation, summed
  by what the host was doing (its innermost operator or range then);
* ``ranges``: for each range the benchmark opened (``bench.<name>``), the
  device time of the kernels launched inside it, matched through the
  launches' correlation ids.
"""
from __future__ import annotations

import bisect
import json
import os
import time
from collections import defaultdict
from typing import Callable, Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")


def traced(fn: Callable[[], None], tmpdir: str, host: bool) -> dict:
    """``fn`` under the profiler. Without ``host`` only the device is
    traced, which leaves the host's pace nearly as it is untraced: the
    window is the host clock around ``fn`` and a synchronise. With
    ``host`` every host operator is recorded too, which slows a
    host-paced loop several-fold: that trace serves the ranges and the
    labels of the idle gaps, and not the busy share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path = os.path.join(tmpdir, "bench_trace.json")
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("bench.window"):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, None if host else host_s)


def _union(intervals: List[List[float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: List[dict], window_s: float = None) -> dict:
    """The readings above from Chrome-trace events (times in us). The
    window is the ``bench.window`` range, or where the trace has no host
    events, ``window_s`` long from the first device operation."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    win = [e for e in xs if e.get("name") == "bench.window"
           and e.get("cat") == "user_annotation"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    elif window_s is not None and dev:
        w0 = min(float(e["ts"]) for e in xs
                 if e.get("cat") in DEVICE_CATS + LAUNCH_CATS)
        w1 = w0 + 1e6 * window_s
    else:
        raise ValueError("the trace holds no bench.window range")
    spans = [[max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                           w1)] for e in dev]
    busy = _union([s for s in spans if s[1] > s[0]])
    by_name: Dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps, labelled by the innermost host event around their middle
    edges = [w0] + [x for s in busy for x in s] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in xs if e.get("cat") in HOST_CATS
                  and e.get("name") != "bench.window")
    starts = [h[0] for h in host]
    labelled: Dict[str, float] = defaultdict(float)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = (a + b) / 2
        label = "host: no operator"
        for j in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 4000), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        labelled[label] += b - a

    # device time of the kernels launched inside each bench.<name> range
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in xs
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("bench.")
                    and e["name"] != "bench.window")
    r_starts = [r[0] for r in ranges]
    kernel_us = {e["args"]["correlation"]: float(e["dur"]) for e in dev
                 if "correlation" in e.get("args", {})}
    in_range: Dict[str, float] = defaultdict(float)
    for e in xs:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        c = e.get("args", {}).get("correlation")
        if c not in kernel_us:
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(r_starts, ts) - 1
        # ranges do not nest: the one that starts last before the launch
        if i >= 0 and ranges[i][1] >= ts:
            in_range[ranges[i][2][len("bench."):]] += kernel_us[c]
    return {"window_s": (w1 - w0) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": [[k[:160], v / 1e6] for k, v in top],
            "idle_gaps": [[k[:160], v / 1e6] for k, v in sorted(
                labelled.items(), key=lambda kv: -kv[1])[:10]],
            "ranges": {k: v / 1e6 for k, v in in_range.items()},
            "kernels": len(dev)}
