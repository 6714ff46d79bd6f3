"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the ``file`` of its entry; the traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the driver
``benchmark/kinds/<kind>.py``; the cell's limits of the comparison are in
``benchmark/workloads/<cell>.json``; a per-layer metric's reader is
``benchmark/metrics/<metric>.py``. Nothing here lists a cell, a
configuration or a metric.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def path(self, *parts) -> str:
        return os.path.join(self.root, "benchmark", *parts)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(root: str, name: str) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, its files read."""
    index = _load(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in index["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in index["configs"]}
    config = _load(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load(os.path.join(root, "benchmark", "traffic",
                                 w["traffic"] + ".json"))
    limits = _load(os.path.join(root, "benchmark", "workloads",
                                name + ".json"))
    return Cell(root, name, w["chips"], config, traffic, limits,
                [m for m in index["end_to_end"] if _reports(m, name)],
                [m for m in index["per_layer"] if _reports(m, name)])


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(cell: Cell):
    return load_module(cell.path("kinds", cell.traffic["kind"] + ".py"),
                       "bench_kind_" + cell.traffic["kind"])


def read_per_layer(cell: Cell, record: dict) -> Dict[str, dict]:
    """{metric: {"value", "unit"}} of every per-layer metric of the cell
    whose reader finds something in ``record``."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(cell.path("metrics", m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
