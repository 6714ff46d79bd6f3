"""BENCHMARK.json against the benchmark's contract, every cell's files, the
import rules and the FLOP counts."""
from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.tests.cells import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def index():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_index_keys_names_and_units():
    b = index()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(map(_line, b["command"]))
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if m in b["end_to_end"] else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in b["configs"]}) == len(b["configs"])
    assert len({w["name"] for w in b["workloads"]}) == len(b["workloads"])
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len(json.dumps(b)) < 64 * 1024


def test_metric_sources_bounds_and_moves():
    b = index()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells
            assert "workloads" not in moved or w in moved["workloads"]
    for w in cells:
        assert any("workloads" in m and w in m["workloads"]
                   for m in b["end_to_end"])
        assert any(w in m["workloads"] for m in b["per_layer"])


def test_every_cell_resolves_its_files():
    from benchmark.harness import cells

    b = index()
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(REPO, c["file"]))
    for w in b["workloads"]:
        cell = cells.resolve(REPO, w["name"])
        assert os.path.isfile(cell.path("kinds", cell.traffic["kind"] + ".py"))
        assert set(cell.limits["limits"])
        for m in cell.per_layer:
            assert os.path.isfile(cell.path("metrics", m["name"] + ".py"))
        assert cell.config["reduced"] == [
            c for c in b["configs"] if c["name"] == w["config"]][0]["reduced"]


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def _sources(*sub):
    top = os.path.join(BENCH, *sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_under_benchmark_imports_jax():
    bad = {"jax", "jaxlib", "flax", "magicdrive_tpu"}
    for path in _sources():
        assert not set(_imports(path)) & bad, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "magicdrive_tpu_torch" not in set(_imports(path)), path
        assert "magicdrive_tpu" not in set(_imports(path)), path


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "magicdrive_tpu_torch_x", sys)
    before = run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "magicdrive_tpu.data", sys)
    assert run.loaded_forbidden() == sorted(set(before) |
                                            {"magicdrive_tpu"})


def test_run_fails_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result."""
    from benchmark.tests.cells import checkout

    root = checkout(str(tmp_path))
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gen-224x400-b4",
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=root,
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


ISSUE_COUNTS = {"sd15mv-224x400": (0.315e12, 0.85e12),
                "sd15mv-424x800": (1.64e12, 3.27e12)}


@pytest.mark.parametrize("config", sorted(ISSUE_COUNTS))
def test_flop_counts_repeat_and_match_the_hand_counts(config):
    from benchmark.harness import flops

    with open(os.path.join(BENCH, "configs", config + ".json")) as f:
        cfg = json.load(f)
    a = flops.request(cfg, 1, 20)
    b = flops.request(cfg, 1, 20)
    assert (a["total"], a["unet_view"], a["decode"]) == \
        (b["total"], b["unet_view"], b["decode"])
    unet, dec = ISSUE_COUNTS[config]
    assert abs(a["unet_view"] / unet - 1) < 0.01
    assert abs(a["decode"] / cfg["pipeline"]["n_cam"] / dec - 1) < 0.01


def _synthetic_trace(calls, slowdown: float):
    """Chrome-trace events: one bench.attn range a call, its kernel as long
    as the call's least time times ``slowdown``, and a kernel outside every
    range overlapping the first."""
    from benchmark.harness import flops

    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": 0.0, "dur": 1e9}]
    t = 10.0
    for i, c in enumerate(calls):
        us = 1e6 * flops.attention_bound([c], 2, 989e12, 3.35e12) * slowdown
        ev += [{"ph": "X", "cat": "user_annotation", "name": "bench.attn",
                "ts": t, "dur": 5.0},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": t + 1, "dur": 1.0, "args": {"correlation": i}},
               {"ph": "X", "cat": "kernel", "name": "k", "ts": t + 2,
                "dur": us, "args": {"correlation": i}}]
        t += 10.0 + us
    ev.append({"ph": "X", "cat": "kernel", "name": "other", "ts": 12.0,
               "dur": 3.0, "args": {"correlation": 10 ** 6}})
    return ev


@pytest.mark.parametrize("slowdown", [1.0, 1.7])
def test_attention_roofline_of_a_synthetic_trace(slowdown):
    from benchmark.harness import cells, flops, trace

    with open(os.path.join(BENCH, "configs", "sd15mv-224x400.json")) as f:
        calls = flops.request(json.load(f), 1, 1)["attention"]
    t = trace.summarize(_synthetic_trace(calls, slowdown))
    bound = flops.attention_bound(calls, 2, 989e12, 3.35e12)
    assert t["ranges"]["attn"] == pytest.approx(bound * slowdown)
    reader = cells.load_module(os.path.join(BENCH, "metrics",
                                            "attn_roofline.gen.py"), "r")
    share = reader.read({"trace_host": t, "attention_bound_s": bound})
    assert share <= 100.0 + 1e-9
    assert share == pytest.approx(100.0 / slowdown)
    # the kernel outside the ranges overlaps the first: counted once
    first = t["busy_s"] - bound * slowdown
    assert first == pytest.approx(0.0, abs=1e-12)
