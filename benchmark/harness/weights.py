"""Seeded weights for every floating tensor of a configuration's state
dicts, made on the device in a few large calls.

One normal draw of the whole parameter count, in the dtype the weights are
served in, cut into the tensors in state-dict order and scaled: a norm's
weight 1 + 0.1 z, a tensor of rank >= 2 z * gain / sqrt(fan_in), any
other 0.1 z. The gain is the configuration's ``weights`` entry: ``qk_gain``
for an attention's query and key projections, ``gain`` for every other
matrix. After a norm, q and k then have about ``qk_gain`` standard
deviation, so the logits q.k / sqrt(d) spread by about ``qk_gain``**2 and
every softmax picks out some tens of keys, as a trained model's does, and
not their mean. Nothing is zero, so the zero-initialised connectors, the
ControlNet's output convolutions and the map embedder's last convolution
all carry signal. The same seed gives the same tensors on the same
device.
"""
from __future__ import annotations

from typing import Dict

import torch

from benchmark.harness import common
from benchmark.reference.model import Model, norm_parameter_names

# draws per randn call: 2**28 bfloat16 values take 512 MiB
CHUNK = 1 << 28
# the ends of the state-dict keys of attention queries and keys
QUERIES_KEYS = (".to_q.weight", ".to_k.weight", ".q_proj.weight",
                ".k_proj.weight")
GAINS = {"qk": "qk_gain", "matrix": "gain"}


def layout(model_cfg: dict):
    """[(module, key, shape, kind)] of the reference on the meta device:
    kind "norm", "qk", "matrix" or "vector". Built without the
    default fills, whose meta versions would import torch._dynamo."""
    with torch.device("meta"), common.skip_init():
        ref = Model(model_cfg)
    norms = set(norm_parameter_names(ref))
    out = []
    for name, t in ref.state_dict().items():
        if not t.is_floating_point():
            continue
        mod, key = name.split(".", 1)
        kind = "norm" if name in norms else "vector" if t.dim() < 2 \
            else "qk" if name.endswith(QUERIES_KEYS) else "matrix"
        out.append((mod, key, tuple(t.shape), kind))
    return out


@torch.no_grad()
def make(model_cfg: dict, seed: int, gains: dict, device,
         dtype: torch.dtype) -> Dict[str, Dict[str, torch.Tensor]]:
    """{module: {key: tensor}} of ``dtype`` on ``device``; ``gains``: the
    configuration's ``weights`` entry."""
    items = layout(model_cfg)
    total = sum(_numel(s) for _, _, s, _ in items)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.empty(total, dtype=dtype, device=device)
    for i in range(0, total, CHUNK):
        n = min(CHUNK, total - i)
        flat[i:i + n] = torch.randn(n, generator=gen, dtype=dtype,
                                    device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    at = 0
    for mod, key, shape, kind in items:
        n = _numel(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "norm":
            t.mul_(0.1).add_(1.0)
        elif kind in GAINS:
            t.mul_(gains[GAINS[kind]] / (n // shape[0]) ** 0.5)
        else:
            t.mul_(0.1)
        out.setdefault(mod, {})[key] = t
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
