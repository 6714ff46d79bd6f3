"""JAX parameter tree -> the port's state_dicts (the inverse of
``magicdrive_tpu/convert/torch_weights.py``, restated without flax).

Each leaf of the JAX ``init_params`` tree, given as nested dicts of numpy
arrays, maps to one diffusers/transformers state_dict key:
  * conv kernels HWIO -> OIHW, dense kernels (in, out) -> (out, in), the
    ControlNet's unconditional map (H, W, C) -> (C, H, W);
  * ``scale`` / ``kernel`` / ``embedding`` -> ``weight``;
  * flax scope names -> torch module paths (``_PRE_RULES``, list indices,
    ``to_out`` -> ``to_out.0``) and the special keys (``_SPECIALS``).
The whole tree converts, the VAE's encoder included; ``trainable_keys``
names the keys the train step updates. ``modules_to_jax_params`` is the
inverse: the port's modules as the JAX tree, for ``utils.serialization``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from magicdrive_tpu_torch.utils.serialization import as_numpy

_PRE_RULES = (
    (r"/LayerNorm_0", ""),
    (r"/GroupNorm_0", ""),
    (r"net_0_proj", "net.0.proj"),
    (r"net_2", "net.2"),
    (r"mlp_fc1", "mlp.fc1"),
    (r"mlp_fc2", "mlp.fc2"),
    (r"second_linear_(\d+)", r"second_linear.\1"),
    (r"mid_block_resnets_(\d+)", r"mid_block.resnets.\1"),
    (r"mid_block_attentions_(\d+)", r"mid_block.attentions.\1"),
    (r"down_blocks_(\d+)_resnets_(\d+)", r"down_blocks.\1.resnets.\2"),
    (r"down_blocks_(\d+)_downsamplers_0_conv",
     r"down_blocks.\1.downsamplers.0.conv"),
    (r"up_blocks_(\d+)_resnets_(\d+)", r"up_blocks.\1.resnets.\2"),
    (r"up_blocks_(\d+)_upsamplers_0_conv", r"up_blocks.\1.upsamplers.0.conv"),
)
# names whose trailing _<digit> is part of the name, not a list index
_KEEP_UNDERSCORE_NUM = {"linear_1", "linear_2", "norm1", "norm2", "norm3",
                        "norm4", "layer_norm1", "layer_norm2", "mlp_fc1",
                        "mlp_fc2"}
_SPECIALS = {
    "uncond_cam": "uncond_cam.weight",
    "position_embedding": "text_model.embeddings.position_embedding.weight",
    "bbox_embedder/class_tokens": "bbox_embedder._class_tokens",
}
_COLLECTIONS = ("params", "buffers")


def _index_segment(m: "re.Match[str]") -> str:
    name = m.group(1) + "_" + m.group(2)
    if name in _KEEP_UNDERSCORE_NUM:
        return m.group(0)
    return f"{m.group(1)}.{m.group(2)}{m.group(3)}"


def torch_key(path: Tuple[str, ...]) -> str:
    """Flax path (collection stripped) -> torch state_dict key."""
    joined = "/".join(path)
    if joined in _SPECIALS:
        return _SPECIALS[joined]
    *mods, leaf = path
    s = "/".join(mods)
    for pat, rep in _PRE_RULES:
        s = re.sub(pat, rep, s)
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"([A-Za-z0-9.]+)_(\d+)(/|$|\.)", _index_segment, s)
    s = re.sub(r"\bto_out\b", "to_out.0", s.replace("/", "."))
    if leaf in ("kernel", "scale", "embedding"):
        return s + ".weight"
    if leaf == "bias":
        return s + ".bias"
    return s + "." + leaf if s else leaf


def clip_torch_key(path: Tuple[str, ...]) -> str:
    """As :func:`torch_key`, with the transformers ``text_model`` prefixes."""
    s = torch_key(path)
    if s.startswith("token_embedding"):
        return "text_model.embeddings." + s
    if s.startswith("layers."):
        return "text_model.encoder." + s
    if s.startswith("final_layer_norm"):
        return "text_model." + s
    return s


def _transform(value: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    if path[-1] == "kernel":
        return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    if path == ("uncond_cam",):
        return value.reshape(1, -1)  # Embedding(1, 21)
    if path == ("uncond_map",):
        return value.transpose(2, 0, 1)  # (H, W, C) -> (C, H, W)
    return value


def iter_leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from iter_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), as_numpy(v)


def module_state_dict(variables: Mapping[str, Any], clip: bool = False
                      ) -> Dict[str, np.ndarray]:
    """One module's flax variables ({collection: tree}) -> state_dict."""
    out: Dict[str, np.ndarray] = {}
    for path, value in iter_leaves(variables):
        if path[0] not in _COLLECTIONS:
            raise ValueError(f"unexpected collection {path[0]!r}")
        spath = path[1:]
        key = clip_torch_key(spath) if clip else torch_key(spath)
        if key in out:
            raise ValueError(f"two leaves map to {key}")
        out[key] = np.array(_transform(value, spath), dtype=np.float32,
                            order="C")  # a writable copy
    return out


def trainable_keys(params_np: Mapping[str, Any]) -> Dict[str, set]:
    """{module: the state_dict keys of its trainable parameters} for a JAX
    ``init_params`` tree, by the port's ``train.state.is_trainable`` over
    the converted keys; buffers are never trainable."""
    from magicdrive_tpu_torch.train.state import is_trainable

    out = {}
    for n in ("unet", "controlnet", "vae", "clip"):
        keys = (clip_torch_key if n == "clip" else torch_key)
        out[n] = {keys(path[1:]) for path, _ in iter_leaves(params_np[n])
                  if path[0] == "params" and is_trainable(n, keys(path[1:]))}
    return out


def jax_params_to_state_dicts(params_np: Mapping[str, Any]
                              ) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX ``init_params`` tree ({"unet", "controlnet", "vae", "clip"},
    each {collection: tree} of numpy arrays) -> {name: state_dict}."""
    return {n: module_state_dict(params_np[n], clip=n == "clip")
            for n in ("unet", "controlnet", "vae", "clip")}


# torch key -> flax path (the inverse of ``torch_key``): the special keys,
# then the module path with list indices folded back into their names
_INV_SPECIALS = {v: tuple(k.split("/")) for k, v in _SPECIALS.items()}
_NORM = re.compile(r"^(norm\d?|norm_temp|conv_norm_out|group_norm|"
                   r"layer_norm\d|final_layer_norm)$")
_VAE_STAGES = ("down_blocks_", "up_blocks_", "mid_block")


def _fold_indices(mods):
    """``["down_blocks", "0", "to_out", "0"]`` -> ``["down_blocks_0",
    "to_out"]``; ``ff.net.0.proj`` -> ``net_0_proj``, ``mlp.fc1`` ->
    ``mlp_fc1``."""
    out = []
    for m in mods:
        if m.isdigit() and out:
            out[-1] = f"{out[-1]}_{m}"
        else:
            out.append(m)
    out = ["to_out" if m == "to_out_0" else m for m in out]
    for i in range(len(out) - 1, 0, -1):
        if (out[i - 1], out[i]) in (("net_0", "proj"), ("mlp", "fc1"),
                                    ("mlp", "fc2")):
            out[i - 1:i + 1] = [f"{out[i - 1]}_{out[i]}"]
    return out


def flax_path(module: str, key: str) -> Tuple[str, ...]:
    """The JAX package's variable path (collection stripped) of the port's
    state_dict ``key`` of ``module`` ("unet", "controlnet", "vae", "clip");
    ``torch_key`` (``clip_torch_key``) of it gives ``key`` back."""
    if key in _INV_SPECIALS:
        return _INV_SPECIALS[key]
    if key == "uncond_map":
        return ("uncond_map",)
    if module == "clip":
        for prefix in ("text_model.embeddings.", "text_model.encoder.",
                       "text_model."):
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
    *mods, leaf = key.split(".")
    mods = _fold_indices(mods)
    if module == "vae" and len(mods) > 2 and \
            mods[1].startswith(_VAE_STAGES):
        # the VAE's blocks are flat scopes: down_blocks_0_resnets_1,
        # mid_block_attentions_0, up_blocks_2_upsamplers_0_conv
        n = 3 if mods[2].endswith(("samplers_0",)) else 2
        mods = [mods[0], "_".join(mods[1:1 + n])] + mods[1 + n:]
    norm = bool(mods) and bool(_NORM.match(mods[-1]))
    if norm and len(mods) > 1 and mods[-2].startswith("transformer_blocks_"):
        mods.append("LayerNorm_0")  # the transformer's fp32 LayerNorm scope
    if leaf == "weight":
        leaf = "scale" if norm else (
            "embedding" if mods and mods[-1] == "token_embedding"
            else "kernel")
    return (*mods, leaf)


def _jax_value(value: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    """The inverse of ``_transform``."""
    if path[-1] == "kernel":
        return value.transpose(2, 3, 1, 0) if value.ndim == 4 else value.T
    if path == ("uncond_cam",):
        return value.reshape(-1)
    if path == ("uncond_map",):
        return value.transpose(1, 2, 0)
    return value


def modules_to_jax_params(modules, values: Optional[Mapping[
        str, torch.Tensor]] = None) -> Dict[str, Dict[str, Any]]:
    """The port's modules (``MagicDriveModules``) as the JAX ``init_params``
    tree ({"unet", "controlnet", "vae", "clip"}, each {"params",
    "buffers"} of nested dicts of float32 numpy arrays): the tree that
    ``jax_params_to_state_dicts`` maps back to their state_dicts.
    ``values`` ({"<module>.<key>": tensor}, say a train state's fp32
    masters) stand in for the modules' own tensors of those keys."""
    values = values or {}
    out: Dict[str, Dict[str, Any]] = {}
    for name, mod in modules.items():
        buffers = {k for k, _ in mod.named_buffers()}
        tree: Dict[str, Any] = {}
        for key, value in mod.state_dict().items():
            value = values.get(f"{name}.{key}", value)
            path = flax_path(name, key)
            node = tree.setdefault("buffers" if key in buffers else "params",
                                   {})
            for p in path[:-1]:
                node = node.setdefault(p, {})
            if path[-1] in node:
                raise ValueError(f"two state_dict keys map to {path}")
            node[path[-1]] = np.ascontiguousarray(
                _jax_value(as_numpy(value).astype(np.float32, copy=False),
                           path))
        out[name] = tree
    return out
