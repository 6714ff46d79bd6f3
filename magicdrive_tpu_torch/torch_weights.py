"""Released torch checkpoints -> the port's modules (counterpart of
``magicdrive_tpu/convert/torch_weights.py``).

The released SD-v1.5 and MagicDrive checkpoints are diffusers
``save_pretrained`` trees (ref:magicdrive/misc/test_utils.py:100-116), and
the port's modules already carry their state_dict keys (``convert.py``):
a checkpoint fills a module key by key, with no layout change. What the
JAX package's converter adds is restated here:
  * the old VAE attention names (``query``/``key``/``value``/
    ``proj_attn``) are renamed to diffusers' current ones;
  * CLIP's keys carry transformers' ``text_model.`` prefixes, as the
    port's CLIP module does;
  * the ControlNet's ``uncond_cam`` is reshaped to the module's shape, and
    the box embedder's ``_class_tokens`` is an ordinary key;
  * strict mode fails on a key of the module that the file lacks (the
    JAX converter's rule: a leaf of its tree that the state dict lacks);
    keys of the file that no module reads are ignored.

``.safetensors`` files are read by :func:`load_safetensors`, written here
(an 8-byte little-endian header length, a JSON header, raw buffers), so
that one code path serves every machine. All of this is host work: it
reads files into numpy and fills modules built on the CPU in fp32, and
touches no device.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping

import numpy as np
import torch

_SAFETENSORS_DTYPES = {"F32": "<f4", "F16": "<f2", "BF16": "<u2",
                       "I64": "<i8", "I32": "<i4"}


def load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as {name: numpy array}; BF16 tensors come
    back as float32 (numpy has no bfloat16; the widening is exact)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        dt = info["dtype"]
        if dt not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {dt}, not one of "
                             f"{sorted(_SAFETENSORS_DTYPES)}")
        start, end = info["data_offsets"]
        a = data[start:end].view(_SAFETENSORS_DTYPES[dt]).reshape(
            info["shape"])
        if dt == "BF16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.bin``/``.pt``/``.safetensors`` state dict as numpy arrays
    (bf16 tensors as float32)."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def find_weights_file(model_dir: str) -> str:
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin", "model.safetensors",
                 "pytorch_model.bin"):
        p = os.path.join(model_dir, name)
        if os.path.isfile(p):
            return p
    raise FileNotFoundError(f"no weights file under {model_dir}")


def normalize_vae_attention_keys(sd: Mapping[str, np.ndarray]
                                 ) -> Dict[str, np.ndarray]:
    """Old-format VAE checkpoints (the released SD-v1.5 weights) name the
    mid-block attention query/key/value/proj_attn; diffusers renamed them
    to_q/to_k/to_v/to_out.0."""
    ren = {".query.": ".to_q.", ".key.": ".to_k.", ".value.": ".to_v.",
           ".proj_attn.": ".to_out.0."}
    out = {}
    for k, v in sd.items():
        for old, new in ren.items():
            if ".attentions." in k and old in k:
                k = k.replace(old, new)
                break
        out[k] = v
    return out


def convert_module(module: torch.nn.Module,
                   torch_sd: Mapping[str, np.ndarray], strict: bool = True
                   ) -> List[str]:
    """Fill ``module``'s state_dict from ``torch_sd`` in place; returns the
    module's keys that the file lacks, which keep their values. A shape
    mismatch raises (``uncond_cam.weight`` is reshaped where its size
    agrees); with ``strict`` a missing key raises."""
    own = module.state_dict()
    new, missing = {}, []
    for key, tmpl in own.items():
        if key not in torch_sd:
            missing.append(key)
            continue
        v = np.asarray(torch_sd[key])
        if v.shape != tuple(tmpl.shape):
            if key == "uncond_cam.weight" and v.size == tmpl.numel():
                v = v.reshape(tuple(tmpl.shape))
            else:
                raise ValueError(f"shape mismatch {key}: {v.shape} vs "
                                 f"{tuple(tmpl.shape)}")
        new[key] = torch.from_numpy(np.array(v)).to(tmpl.dtype)
    if strict and missing:
        raise KeyError(f"{len(missing)} keys of the module missing in the "
                       f"state dict, e.g. {missing[:8]}")
    module.load_state_dict(new, strict=False)
    return missing
