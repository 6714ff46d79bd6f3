"""Hydra-style config composition on plain YAML (counterpart of
``config/loader.py``).

Composes the repository's ``configs/`` tree as the JAX package does:
  * group composition from the root ``defaults`` list (``{model:
    SDv1.5mv_rawbox}`` loads ``model/SDv1.5mv_rawbox.yaml`` under ``model``);
  * ``_global_: true`` overlays (``exp/224x400.yaml`` merges at the root);
  * ``${a.b.c}`` interpolation, resolved after the merge;
  * overrides ``a.b=v`` (the key must exist), ``+a.b=v`` (may add) and
    ``group=name`` (swaps a group file, or loads one as an overlay);
  * the run directory's config and raw overrides, saved for replay, with
    the port's perf knob (the fused mode) beside them.
"""
from __future__ import annotations

import ast
import copy
import logging
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import yaml

log = logging.getLogger(__name__)


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) and not isinstance(v, Config) \
            else v

    def __setattr__(self, k, v):
        self[k] = v


def _deep_merge(base: Dict, over: Dict) -> Dict:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP = re.compile(r"^\$\{([a-zA-Z0-9_.]+)\}$")
_INTERP_PART = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _lookup(tree: Dict, dotted: str):
    cur: Any = tree
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _resolve(node: Any, root: Dict, depth: int = 0) -> Any:
    if depth > 20:
        raise ValueError("interpolation cycle")
    if isinstance(node, dict):
        return {k: _resolve(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve(v, root, depth) for v in node]
    if isinstance(node, str):
        m = _INTERP.match(node)
        if m:  # a whole-value interpolation keeps the value's type
            return _resolve(_lookup(root, m.group(1)), root, depth + 1)
        return _INTERP_PART.sub(
            lambda mm: str(_resolve(_lookup(root, mm.group(1)), root,
                                    depth + 1)), node)
    return node


def _parse_value(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        low = s.lower()
        if low in ("true", "false"):
            return low == "true"
        if low in ("null", "none"):
            return None
        return s


def _set_dotted(tree: Dict, dotted: str, value: Any, allow_new: bool) -> None:
    parts = dotted.split(".")
    cur = tree
    for p in parts[:-1]:
        if p not in cur:
            if not allow_new:
                raise KeyError(
                    f"unknown config path '{dotted}' (use +{dotted}= to add)")
            cur[p] = {}
        cur = cur[p]
    if parts[-1] not in cur and not allow_new:
        raise KeyError(
            f"unknown config key '{dotted}' (use +{dotted}= to add)")
    cur[parts[-1]] = value


def _load_yaml(path: str) -> Any:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _overlay(tree: Dict, config_dir: str, group: str, fname: str) -> Dict:
    """``tree`` with ``{config_dir}/{group}/{fname}.yaml`` merged in: at the
    root for a ``_global_`` file, else under ``group``."""
    sub = _load_yaml(os.path.join(config_dir, group, f"{fname}.yaml"))
    if sub.pop("_global_", False):
        return _deep_merge(tree, sub)
    return _deep_merge(tree, {group: sub})


def compose(config_dir: str, name: str = "config",
            overrides: Optional[Sequence[str]] = None,
            resolve: bool = True) -> Config:
    """Compose ``{config_dir}/{name}.yaml`` with its defaults and overrides.

    Override syntax: ``a.b=v`` (must exist), ``+a.b=v`` (may add),
    ``group=name`` where ``group`` is in the defaults list or is a directory
    of ``config_dir`` (swaps the group file, e.g. ``runner=debug``, or loads
    it as an overlay, e.g. ``exp=272x736``).
    """
    overrides = list(overrides or [])
    root_cfg = _load_yaml(os.path.join(config_dir, f"{name}.yaml"))
    defaults = root_cfg.pop("defaults", [])

    group_names = [list(d)[0] if isinstance(d, dict) else d for d in defaults]
    remaining = []
    swaps: Dict[str, str] = {}
    for ov in overrides:
        key = ov.split("=", 1)[0].lstrip("+")
        if "=" in ov and "." not in key and (
                key in group_names or
                os.path.isdir(os.path.join(config_dir, key))):
            swaps[key] = ov.split("=", 1)[1]
        else:
            remaining.append(ov)

    tree: Dict = {}
    for d in defaults:
        if isinstance(d, dict):
            group, fname = next(iter(d.items()))
            fname = swaps.get(group, fname)
            if fname is not None:
                tree = _overlay(tree, config_dir, group, fname)
        else:  # a plain file at the root
            tree = _deep_merge(tree, _load_yaml(
                os.path.join(config_dir, f"{d}.yaml")))
    tree = _deep_merge(tree, root_cfg)

    # groups outside the defaults (``exp=224x400``, ``fid=default``) load as
    # overlays, in the order given
    for group, fname in swaps.items():
        if group not in group_names:
            tree = _overlay(tree, config_dir, group, fname)

    for ov in remaining:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, val = ov.split("=", 1)
        _set_dotted(tree, key.lstrip("+"), _parse_value(val),
                    key.startswith("+"))

    if resolve:
        tree = _resolve(tree, tree)
    return Config(tree)


def perf_knob_snapshot() -> Dict[str, object]:
    """The port's perf knob in effect: the fused attention mode
    (``MAGICDRIVE_FUSED_MODE``, the JAX package's ``fused_mode`` knob)."""
    from magicdrive_tpu_torch.kernels import dispatch

    return {"fused_mode": dispatch.FUSED_MODE}


def save_run_config(cfg: Config, run_dir: str,
                    overrides: Optional[Sequence[str]] = None) -> None:
    """Write ``run_config.yaml`` (the composed config and the perf knobs in
    effect under ``perf_knobs``) and ``overrides.yaml`` (the raw overrides,
    for replay) into ``run_dir``."""
    os.makedirs(run_dir, exist_ok=True)
    payload = dict(cfg)
    payload["perf_knobs"] = perf_knob_snapshot()
    with open(os.path.join(run_dir, "run_config.yaml"), "w") as f:
        yaml.safe_dump(payload, f, sort_keys=False)
    with open(os.path.join(run_dir, "overrides.yaml"), "w") as f:
        yaml.safe_dump(list(overrides or []), f)


def load_run_config(run_dir: str) -> Config:
    """A run's composed config, with a warning for each perf knob it
    recorded whose value in effect now differs (knobs of the JAX package
    that the port does not have are not compared)."""
    cfg = Config(_load_yaml(os.path.join(run_dir, "run_config.yaml")))
    current = perf_knob_snapshot()
    for k, want in (cfg.get("perf_knobs") or {}).items():
        if k in current and current[k] != want:
            log.warning("perf knob mismatch vs run config: %s was %r at run "
                        "time, effective now %r — set MAGICDRIVE_%s to "
                        "replay exactly", k, want, current[k], k.upper())
    return cfg


def load_run_overrides(run_dir: str) -> List[str]:
    """The run's raw overrides ([] where it saved none)."""
    path = os.path.join(run_dir, "overrides.yaml")
    return list(_load_yaml(path) or []) if os.path.isfile(path) else []
