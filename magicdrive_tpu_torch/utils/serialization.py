"""Run weights as a flat-key ``.npz`` (counterpart of
``utils/serialization.py``).

The JAX package's format: ``params.npz`` holds one array per leaf of the
nested variable tree under its '/'-joined path, and ``manifest.json`` each
leaf's shape and dtype. npz has no bfloat16, so bf16 leaves are stored as
float32 and restored from the manifest (here with torch: numpy has no
bf16). A JAX run's ``weights/`` loads here and goes to the port's modules
through ``convert.jax_params_to_state_dicts``; the port writes its modules
with ``convert.modules_to_jax_params``, and the JAX package loads the
result.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _unflatten(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _is_bf16(v) -> bool:
    return isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16


def as_numpy(v) -> np.ndarray:
    """A leaf as numpy; a bf16 tensor (numpy has no bf16) as float32."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.float().numpy() if _is_bf16(v) else v.numpy()
    return np.asarray(v)


def save_params(params: Mapping[str, Any], out_dir: str) -> str:
    """Write ``params`` (nested dicts of numpy arrays or tensors) as
    ``out_dir/params.npz`` + ``out_dir/manifest.json``."""
    os.makedirs(out_dir, exist_ok=True)
    flat = _flatten(params)
    arrays = {k: as_numpy(v) for k, v in flat.items()}
    manifest = {k: {"shape": list(a.shape), "dtype": "bfloat16"
                    if _is_bf16(flat[k]) else str(a.dtype)}
                for k, a in arrays.items()}
    np.savez(os.path.join(out_dir, "params.npz"), **arrays)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return out_dir


def load_params(out_dir: str) -> Dict[str, Any]:
    """The nested tree of ``save_params``: numpy arrays, and bf16 tensors
    for the leaves the manifest records as bfloat16."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    with np.load(os.path.join(out_dir, "params.npz")) as z:
        for k in z.files:
            v = z[k]
            if manifest.get(k, {}).get("dtype") == "bfloat16":
                v = torch.from_numpy(v).to(torch.bfloat16)
            flat[k] = v
    return _unflatten(flat)
