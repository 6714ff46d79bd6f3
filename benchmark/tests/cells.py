"""Cells at the CPU presets, written as files into a copy of the
benchmark: the way a later change adds a configuration, a traffic mix, a
cell and a metric."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def _plain(v):
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    return v


def config_of(preset_name: str, dtype: str = "float32", **kw) -> dict:
    """A configuration file's content for a preset of the program."""
    from magicdrive_tpu_torch import config as pc

    d = dataclasses.asdict(getattr(pc, preset_name)(**kw))
    pipe = d.pop("pipeline")
    pipe.pop("dtype")
    return {"name": preset_name, "source": "test", "dtype": dtype,
            "model": {k: _plain(d[k]) for k in ("unet", "controlnet", "vae",
                                                 "clip")},
            "pipeline": _plain(pipe), "image_size": _plain(d["image_size"]),
            "map_hw": _plain(d["map_hw"]), "map_channels": d["map_channels"],
            "bbox_max_len": d["bbox_max_len"],
            "weights": {"gain": 0.2, "qk_gain": 1.4},
            "reduced": []}


def write(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def checkout(tmp: str) -> str:
    """``tmp``/ with BENCHMARK.json and a copy of ``benchmark/``."""
    shutil.copytree(BENCH, os.path.join(tmp, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp)
    return tmp


def add_cell(root: str, cell: str, config: dict, traffic_name: str,
             traffic: dict, limits: dict, chips: int = 1) -> None:
    """Files and entries of one more cell (its configuration and traffic
    mix too) in ``root``."""
    b = os.path.join(root, "benchmark")
    write(os.path.join(b, "configs", config["name"] + ".json"), config)
    write(os.path.join(b, "traffic", traffic_name + ".json"), traffic)
    write(os.path.join(b, "workloads", cell + ".json"), {"limits": limits})
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        index = json.load(f)
    if config["name"] not in {c["name"] for c in index["configs"]}:
        index["configs"].append({
            "name": config["name"], "source": "test",
            "file": f"benchmark/configs/{config['name']}.json",
            "reduced": [], "why": "test"})
    index["workloads"].append({"name": cell, "config": config["name"],
                               "traffic": traffic_name, "chips": chips,
                               "why": "test"})
    for m in index["end_to_end"] + index["per_layer"]:
        if "workloads" in m and _moves_kind(m, traffic["kind"]):
            m["workloads"].append(cell)
    write(path, index)


def _moves_kind(metric: dict, kind: str) -> bool:
    name = metric.get("moves", metric["name"])
    return (name == "frames_per_s") == (kind == "generate")


GEN = {"kind": "generate", "batch": 2, "pool": 3, "trace_units": 1,
       "boxes": [2, 6], "words": [3, 8]}
TRAIN = {"kind": "train", "batch": 2, "pool": 3, "trace_units": 1,
         "boxes": [2, 6], "words": [3, 8],
         "optimizer": {"learning_rate": 8e-05, "adam_beta1": 0.9,
                       "adam_beta2": 0.999, "adam_weight_decay": 0.01,
                       "adam_epsilon": 1e-08, "use_8bit_adam": False,
                       "max_grad_norm": 1.0, "lr_warmup_steps": 0,
                       "train_with_same_t": True, "drop_cond_ratio": 0.25,
                       "drop_cam_num": 6}}
