"""Block-wise 8-bit AdamW (counterpart of ``train/adam8bit.py``): the
reference's ``use_8bit_adam`` memory knob (ref:magicdrive/runner/
base_runner.py:181-216, bitsandbytes' AdamW8bit), as the JAX package
restates it in plain array code.

Both Adam moments are stored as int8 in blocks of 256 elements of each
tensor, with one fp32 scale per block: linear absmax quantization,
round half to even. The second moment is stored in the sqrt domain:
sqrt(nu) has mu's dynamic range, so an entry survives both quantizations
or neither, and mu / (sqrt(0) + eps) never explodes. Per parameter that is
2 x (1 + 4/256) bytes of state against fp32 AdamW's 8.

The chain is the JAX package's: the global-norm clip, the 8-bit Adam
direction, the decoupled decay added to it, then the learning rate
(``optax.chain(scale_by_adam_8bit, add_decayed_weights,
scale_by_learning_rate)``). No kernel is written for it: the JAX package
runs it as plain array code too.
"""
from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .state import AdamW, bias_corrections

BLOCK = 256


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes (nblocks, BLOCK), fp32 scales (nblocks, 1)) of ``x``
    flattened and zero-padded to whole blocks."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    absmax = flat.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               shape: Sequence[int]) -> torch.Tensor:
    """The fp32 tensor of ``shape`` that ``quantize`` codes."""
    n = int(np.prod(shape, dtype=np.int64))
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


class AdamW8bit(AdamW):
    """``AdamW`` with int8 block-quantized moments: ``mu`` and ``nu`` hold
    {key: (codes, scales)}."""

    def _init_moments(self, params: Mapping[str, torch.Tensor]) -> None:
        self.mu = {k: quantize(torch.zeros_like(p))
                   for k, p in params.items()}
        self.nu = {k: quantize(torch.zeros_like(p))
                   for k, p in params.items()}

    def _directions(self, keys, g) -> list:
        c = self.cfg
        bc1, bc2 = bias_corrections(c, self.count)
        out = []
        for k, gk in zip(keys, g):
            mu = c.adam_beta1 * dequantize(*self.mu[k], gk.shape) + \
                (1 - c.adam_beta1) * gk
            r = dequantize(*self.nu[k], gk.shape)  # sqrt(nu)
            nu = c.adam_beta2 * (r * r) + (1 - c.adam_beta2) * (gk * gk)
            out.append((mu / bc1) / ((nu / bc2).sqrt() + c.adam_epsilon))
            self.mu[k], self.nu[k] = quantize(mu), quantize(nu.sqrt())
        return out

    def _moments_state(self) -> Dict[str, dict]:
        return {name: {k: {"q": q, "scale": s} for k, (q, s) in m.items()}
                for name, m in (("mu", self.mu), ("nu", self.nu))}

    def _load_moments(self, sd: Mapping) -> None:
        for name in ("mu", "nu"):
            mine = getattr(self, name)
            for k, (q, s) in mine.items():
                q.copy_(sd[name][k]["q"])
                s.copy_(sd[name][k]["scale"])
