"""A traced stretch's device time and idle gaps by the program's spans.

The program's spans (``magicdrive_tpu_torch.utils.trace``, named ``md.*``)
are ``user_annotation`` ranges of a Chrome trace taken with them on, on the
clock of the device's operations. ``attribute(events)``:

* puts each kernel, copy and fill down to the innermost ``md.*`` range
  around its launch (the ``cuda_runtime`` or ``cuda_driver`` event of the
  same correlation id), the ranges taken on every thread: the autograd
  thread's launches in a step's backward fall into ``md.train.backward``,
  which the main thread holds open around them;
* for each path of nested ranges (``md.pipeline.request/md.pipeline.step/
  md.resnet``) and for each span name gives the calls, the device seconds
  of the work launched inside (``device_s``) and of the work whose
  innermost range it is (``self_s``); device work launched in no range is
  ``outside_s``;
* labels each stretch of the window in which no device operation ran by
  the innermost ``md.*`` range around its middle, or "outside the program".

The benchmark's own ``bench.*`` ranges and the profiler's
``gpu_user_annotation`` events are neither spans nor device work.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "md."
OUTSIDE = "outside the program"


def _union(intervals):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def attribute(events: List[dict], window: Optional[tuple] = None) -> dict:
    """The readings above from Chrome-trace events (times in us); seconds
    out. ``window`` (t0, t1) in us bounds the idle gaps; by default the
    ``bench.window`` range, else the span of the device work."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in xs
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(PREFIX)),
                    key=lambda r: (r[0], -r[1]))
    if window is None:
        win = [e for e in xs if e.get("name") == "bench.window"
               and e.get("cat") == "user_annotation"]
        if win:
            window = (float(win[0]["ts"]),
                      float(win[0]["ts"]) + float(win[0]["dur"]))
        elif dev:
            window = (min(float(e["ts"]) for e in dev),
                      max(float(e["ts"]) + float(e["dur"]) for e in dev))
        else:
            window = (0.0, 0.0)
    w0, w1 = window

    device_us: Dict[int, float] = defaultdict(float)
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            device_us[c] += float(e["dur"])
    launches = sorted((float(e["ts"]), device_us[c]) for e in xs
                      if e.get("cat") in LAUNCH_CATS
                      for c in [e.get("args", {}).get("correlation")]
                      if c in device_us)
    busy = _union([[max(float(e["ts"]), w0),
                    min(float(e["ts"]) + float(e["dur"]), w1)] for e in dev
                   if float(e["ts"]) + float(e["dur"]) > w0
                   and float(e["ts"]) < w1])
    edges = [w0] + [x for s in busy for x in s] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]

    # one sweep in time: range starts (outer first), then the points
    # (launches with their device us, gap middles with their length) they
    # hold; the innermost range open at a point is the latest started that
    # has not ended
    START, LAUNCH, GAP = 0, 1, 2
    marks = [(r[0], START, i) for i, r in enumerate(ranges)]
    marks += [(t, LAUNCH, us) for t, us in launches]
    marks += [((a + b) / 2, GAP, b - a) for a, b in gaps]
    marks.sort(key=lambda m: (m[0], m[1]))
    parent: List[Optional[int]] = [None] * len(ranges)
    path: List[str] = [""] * len(ranges)
    own: Dict[int, float] = defaultdict(float)  # range -> self device us
    outside = 0.0
    labelled: Dict[str, float] = defaultdict(float)
    stack: List[int] = []
    for t, kind, v in marks:
        while stack and ranges[stack[-1]][1] < t:
            stack.pop()
        top = stack[-1] if stack else None
        if kind == START:
            parent[v] = top
            path[v] = ranges[v][2] if top is None else \
                path[top] + "/" + ranges[v][2]
            stack.append(v)
        elif kind == LAUNCH:
            if top is None:
                outside += v
            else:
                own[top] += v
        else:
            labelled[OUTSIDE if top is None else ranges[top][2]] += v

    paths: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"calls": 0, "device_s": 0.0, "self_s": 0.0})
    names: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"calls": 0, "device_s": 0.0, "self_s": 0.0, "host_s": 0.0})
    for i, (a, b, name) in enumerate(ranges):
        paths[path[i]]["calls"] += 1
        names[name]["calls"] += 1
        names[name]["host_s"] += (b - a) / 1e6
    for i, us in own.items():
        s = us / 1e6
        paths[path[i]]["self_s"] += s
        names[ranges[i][2]]["self_s"] += s
        seen = set()
        j: Optional[int] = i
        while j is not None:
            paths[path[j]]["device_s"] += s
            if ranges[j][2] not in seen:
                seen.add(ranges[j][2])
                names[ranges[j][2]]["device_s"] += s
            j = parent[j]
    return {"paths": dict(paths), "spans": dict(names),
            "outside_s": outside / 1e6,
            "device_s": sum(device_us.values()) / 1e6,
            "window_s": (w1 - w0) / 1e6,
            "idle_gaps": [[k, v / 1e6] for k, v in sorted(
                labelled.items(), key=lambda kv: -kv[1])[:10]]}


def device_s(att: dict, name: str, inside: Optional[str] = None,
             own: bool = False) -> float:
    """Device seconds of the ranges named ``name`` (their ``self_s`` with
    ``own``) over every path that ends in it and, given ``inside``, passes
    through a range of that name."""
    key = "self_s" if own else "device_s"
    total = 0.0
    for p, v in att["paths"].items():
        parts = p.split("/")
        if parts[-1] == name and (inside is None or inside in parts[:-1]):
            total += v[key]
    return total
