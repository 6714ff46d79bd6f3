"""The work of a request or a training step, counted on the benchmark's
reference on meta tensors from the configuration's shapes.

Matrix products and convolutions are counted (``FlopCounterMode``: 2 per
multiply-add); elementwise work is not. A request is CLIP of its prompts,
the conditioning of both guidance branches, ``steps`` guided ControlNet
and UNet evaluations and the VAE decode of every image. A training step
is the VAE encode, CLIP, the ControlNet and UNet forward and the backward
that the trained partition needs; nothing is counted twice for a
recompute.

The least time of an attention (``attention_bound``) is the frozen
arithmetic of ``chip_smoke.py`` ``_flops`` and ``_bytes``: q, k and v
projected once (a neighbour pair's views share k and v), q k^T and p v
per neighbour, the out-projection; each input read once and each output
written once; at the bf16 tensor peak and the HBM bandwidth of the card.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

# published peaks (NVIDIA's data sheet, SXM part, dense, at its 700 W
# limit): card name -> (bf16 tensor FLOP/s, HBM bytes/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (989e12, 3.35e12)}


def peaks(device_name: str):
    """(FLOP/s, bytes/s) of the card, or None for a card not listed."""
    return PEAKS.get(device_name)


def _meta_request(config: dict, B: int):
    N = config["pipeline"]["n_cam"]
    H, W = config["image_size"]
    mh, mw = config["map_hw"]
    L = config["bbox_max_len"]
    h, w = config["pipeline"]["latent_height"], \
        config["pipeline"]["latent_width"]
    z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)
    return {"input_ids": z(B, 77, dt=torch.long),
            "uncond_ids": z(1, 77, dt=torch.long),
            "camera_param": z(B, N, 3, 7),
            "bev_map": z(B, mh, mw, config["map_channels"]),
            "bboxes": z(B, N, L, 8, 3), "classes": z(B, N, L, dt=torch.long),
            "masks": z(B, N, L), "latents": z(B, N, 4, h, w),
            "pixel_values": z(B, N, H, W, 3)}


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def request(config: dict, B: int, steps: int) -> Dict[str, object]:
    """{"total", "conditioning", "eps", "decode", "unet_view",
    "attention": [calls of one guided eps]} for a guided request of B
    frames."""
    with torch.device("meta"):
        m = ref_model.Model(config["model"])
        req = _meta_request(config, B)
        g = config["pipeline"]["guidance_scale"]
        with torch.no_grad():
            cond = [None]
            c = _counted(lambda: cond.__setitem__(
                0, ref_steps.conditioning(m, req)))
            calls: List[Tuple] = []
            ref_model.ATTENTION_LOG["calls"] = calls
            try:
                e = _counted(lambda: ref_steps.guided_eps(
                    m, cond[0], req["latents"], 999, g))
            finally:
                ref_model.ATTENTION_LOG["calls"] = None
            d = _counted(lambda: ref_steps.decode(m, req["latents"]))
            N = req["latents"].shape[1]
            u = _counted(lambda: m.unet(
                req["latents"][0], torch.zeros(N), cond[0][0][0])) // N
    return {"total": c + steps * e + d, "conditioning": c, "eps": e,
            "decode": d, "unet_view": u, "attention": calls}


def train_step(config: dict, B: int) -> int:
    """FLOPs of one training step of B samples."""
    with torch.device("meta"):
        m = ref_model.Model(config["model"])
        b = _meta_request(config, B)
        N = config["pipeline"]["n_cam"]
        h, w = config["pipeline"]["latent_height"], \
            config["pipeline"]["latent_width"]
        draws = {"vae_noise": torch.zeros(B * N, 4, h, w),
                 "noise": torch.zeros(B, N, 4, h, w),
                 "timesteps": torch.zeros(B, dtype=torch.long),
                 "drop_mask": torch.zeros(B, N)}
        params = ref_steps.trainable(m)
        for p in m.parameters():
            p.requires_grad_(False)
        for p in params.values():
            p.requires_grad_(True)

        def step():
            lo = ref_steps.loss(m, b, draws)
            torch.autograd.grad(lo, list(params.values()))
        return _counted(step)


def attention_bound(calls, esize: int, peak_flops: float,
                    peak_bytes: float) -> float:
    """Seconds: the sum over ``calls`` of the larger of operations over
    the FLOP peak and bytes over the bandwidth."""
    total = 0.0
    for c in calls:
        if c[0] == "attn":
            _, B, Lq, C, Lk, Ck, HD, own = c
            flops = 2 * B * (Lq * C + 2 * Lk * Ck) * HD \
                + 4 * B * Lq * Lk * HD + 2 * B * Lq * HD * C
            ctx = 0 if own else B * Lk * Ck
            elems = B * Lq * C + ctx + HD * (C + 2 * Ck) + C * HD + C \
                + B * Lq * C
        else:
            _, B, L, C, k, HD = c
            flops = 2 * B * 3 * L * C * HD + k * 4 * B * L * L * HD \
                + 2 * B * L * HD * C
            elems = B * L * C + 4 * HD * C + C + B * L * C
        total += max(flops / peak_flops, elems * esize / peak_bytes)
    return total
