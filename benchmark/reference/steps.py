"""The plain reference of a guided request and of a training step.

A request: CLIP of the prompt and of the null prompt, the ControlNet's
tokens and map features for both classifier-free-guidance branches
(unconditional first: the learned unconditional camera, the null prompt,
no boxes, the same map), the 2nd-order UniPC sampler (bh2, predicting x0,
lower order at the last step) over SD-v1.5's scaled-linear schedule, and
the VAE decode. A training step: the VAE posterior sample, the noised
latents, the ControlNet with the condition drop, the UNet, the mean
squared error against the noise, the gradients of the ControlNet and of
the UNet's cross-view modules, and AdamW (global-norm clip, decoupled
decay, optax's bias corrections) on float32 parameters.

Written from the MagicDrive reference and diffusers' UniPC scheduler; it
imports nothing of the system under test.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import CHECKPOINT, Model

TRAINABLE_UNET_PARTS = ("norm4", "attn4", "connector")


# ----------------------------------------------------------------------------
# schedule and sampler


def schedule(T: int = 1000, beta_start: float = 0.00085,
             beta_end: float = 0.012):
    """(alpha_t, sigma_t, lambda_t) of SD-v1.5's scaled-linear betas,
    float64."""
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, T) ** 2
    ac = np.cumprod(1.0 - betas)
    alpha, sigma = np.sqrt(ac), np.sqrt(1.0 - ac)
    return alpha, sigma, np.log(alpha) - np.log(sigma)


def timesteps(steps: int, T: int = 1000) -> List[int]:
    t = np.linspace(0, T - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
    _, idx = np.unique(t, return_index=True)
    return [int(v) for v in t[np.sort(idx)]]


def unipc(x: torch.Tensor, eps_fn, steps: int) -> torch.Tensor:
    """UniPC-2 with bh2 from x at t = 999 to the clean sample, written as
    diffusers' multistep update: the UniC corrector of each x with the new
    model output, then the UniP predictor."""
    alpha, sigma, lam = schedule()
    ts = timesteps(steps)
    K = len(ts)
    hist_m: List[torch.Tensor] = []
    x_prev = None
    for i, t in enumerate(ts):
        m = (x - sigma[t] * eps_fn(x, t)) / alpha[t]   # x0 prediction
        if i > 0:  # corrector at t from s0 = ts[i - 1]
            s0 = ts[i - 1]
            h = lam[t] - lam[s0]
            hh = -h
            phi1 = np.expm1(hh)
            Bh = np.expm1(hh)
            order = min(2, K - (i - 1), i)
            m0 = hist_m[-1]
            x_c = sigma[t] / sigma[s0] * x_prev - alpha[t] * phi1 * m0
            if order == 1:
                x_c = x_c - alpha[t] * Bh * 0.5 * (m - m0)
            else:
                rk = (lam[ts[i - 2]] - lam[s0]) / h
                b1 = (phi1 / hh - 1.0) / Bh
                b2 = ((phi1 / hh - 1.0) / hh - 0.5) * 2.0 / Bh
                rhos = np.linalg.solve(np.array([[1.0, 1.0], [rk, 1.0]]),
                                       np.array([b1, b2]))
                d1 = (hist_m[-2] - m0) / rk
                x_c = x_c - alpha[t] * Bh * (rhos[0] * d1
                                             + rhos[1] * (m - m0))
            x = x_c
        hist_m.append(m)
        prev_t = ts[i + 1] if i < K - 1 else 0
        h = lam[prev_t] - lam[t]
        phi1 = np.expm1(-h)
        x_next = sigma[prev_t] / sigma[t] * x - alpha[prev_t] * phi1 * m
        if min(2, K - i, i + 1) >= 2:
            rk = (lam[ts[i - 1]] - lam[t]) / h
            d1 = (hist_m[-2] - m) / rk
            x_next = x_next - alpha[prev_t] * phi1 * 0.5 * d1
        x_prev, x = x, x_next
    return x


# ----------------------------------------------------------------------------
# a guided request


def conditioning(model: Model, req: Mapping[str, torch.Tensor]):
    """(tokens (2B, N, T, d), map features (2B, C, h, w)) of both
    guidance branches, unconditional first."""
    cn = model.controlnet
    text = model.clip(req["input_ids"])
    uncond = model.clip(req["uncond_ids"])
    cam, bev = req["camera_param"], req["bev_map"].permute(0, 3, 1, 2)
    boxes, classes, masks = req["bboxes"], req["classes"], req["masks"]
    B, N = cam.shape[:2]
    ui = cn.c["uncond_cam_in_dim"]
    tok_c = cn.tokens(cam, text, boxes, classes, masks)
    tok_u = cn.tokens(cn.uncond_cam.weight.reshape(ui).expand(B, N, -1, -1),
                      uncond.expand(B, -1, -1), torch.zeros_like(boxes),
                      torch.zeros_like(classes), torch.zeros_like(masks))
    return (torch.cat([tok_u, tok_c]),
            cn.controlnet_cond_embedding(torch.cat([bev, bev])))


def guided_eps(model: Model, cond, x: torch.Tensor, t: int,
               guidance: float) -> torch.Tensor:
    """The ControlNet and UNet on both branches of x (B, N, 4, h, w) at
    timestep t, combined at the guidance scale."""
    tokens, feat = cond
    B, N = x.shape[:2]
    x2 = torch.cat([x, x])
    t2 = torch.full((2 * B,), t, device=x.device)
    down, mid = model.controlnet(x2, t2, tokens, feat)
    eps = model.unet(x2.reshape(2 * B * N, *x.shape[2:]),
                     t2.repeat_interleave(N),
                     tokens.reshape(2 * B * N, *tokens.shape[2:]), down, mid)
    e_u, e_c = eps.reshape(2 * B, N, *eps.shape[1:]).chunk(2)
    return e_u + guidance * (e_c - e_u)


def decode(model: Model, x: torch.Tensor) -> torch.Tensor:
    """Latents (B, N, 4, h, w) -> images (B, N, H, W, 3) in [0, 1]."""
    B, N = x.shape[:2]
    imgs = torch.cat([model.vae.decode(z) for z in
                      x.reshape(B * N, *x.shape[2:]).split(6)])
    imgs = (imgs / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 1)
    return imgs.reshape(B, N, *imgs.shape[1:])


@torch.no_grad()
def generate(model: Model, req: Mapping[str, torch.Tensor], steps: int,
             guidance: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """req: input_ids (B, 77), uncond_ids (1, 77), camera_param
    (B, N, 3, 7), bev_map (B, H, W, C), bboxes (B, N, L, P, 3), classes,
    masks (B, N, L), latents (B, N, 4, h, w). -> (final latents (B, N, 4,
    h, w), images (B, N, H, W, 3) in [0, 1])."""
    cond = conditioning(model, req)
    x = unipc(req["latents"].float(),
              lambda x, t: guided_eps(model, cond, x, t, guidance), steps)
    return x, decode(model, x)


# ----------------------------------------------------------------------------
# a training step


def is_trainable(name: str) -> bool:
    """"<module>.<key>": the ControlNet, and the UNet's cross-view parts."""
    mod, key = name.split(".", 1)
    return mod == "controlnet" or (
        mod == "unet" and any(p in TRAINABLE_UNET_PARTS
                              for p in key.split(".")))


def trainable(model: Model) -> Dict[str, torch.nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if is_trainable(n)}


def loss(model: Model, batch: Mapping[str, torch.Tensor],
         draws: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The epsilon MSE of one batch under ``draws``: vae_noise (B*N, 4,
    h, w), noise (B, N, 4, h, w), timesteps (B,), drop_mask (B, N)."""
    alpha, sigma, _ = schedule()
    px = batch["pixel_values"]
    B, N = px.shape[:2]
    with torch.no_grad():
        text = model.clip(batch["input_ids"])
        uncond = model.clip(batch["uncond_ids"])
        lat = model.vae.encode(px.reshape(B * N, *px.shape[2:]).permute(
            0, 3, 1, 2), draws["vae_noise"])
    lat = lat.reshape(B, N, *lat.shape[1:])
    t = draws["timesteps"]
    a = torch.as_tensor(alpha, dtype=torch.float32, device=lat.device)[t]
    s = torch.as_tensor(sigma, dtype=torch.float32, device=lat.device)[t]
    noise = draws["noise"].expand(lat.shape)
    noisy = a[:, None, None, None, None] * lat + \
        s[:, None, None, None, None] * noise
    cn = model.controlnet
    tokens = cn.tokens(batch["camera_param"], text, batch["bboxes"],
                       batch["classes"], batch["masks"], uncond,
                       draws.get("drop_mask"))
    feat = cn.controlnet_cond_embedding(batch["bev_map"].permute(0, 3, 1, 2))
    down, mid = cn(noisy, t, tokens, feat)
    eps = model.unet(noisy.reshape(B * N, *noisy.shape[2:]),
                     t.repeat_interleave(N),
                     tokens.reshape(B * N, *tokens.shape[2:]), down, mid)
    return F.mse_loss(eps.reshape(noise.shape), noise)


class AdamW:
    """optax's clip_by_global_norm then adamw, float32."""

    def __init__(self, params: Mapping[str, torch.Tensor], opt: dict):
        self.o = opt
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def clipped(self, grads: Mapping[str, torch.Tensor]):
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values())).float()
        c = self.o["max_grad_norm"]
        f = 1.0 if norm < c else c / norm
        return {k: g * f for k, g in grads.items()}

    @torch.no_grad()
    def step(self, params, grads) -> Dict[str, torch.Tensor]:
        """Update ``params`` in place; -> the clipped gradients."""
        o = self.o
        b1, b2 = o["adam_beta1"], o["adam_beta2"]
        g = self.clipped(grads)
        self.count += 1
        n = np.float32(self.count)
        bc1 = float(1 - np.float32(b1) ** n)
        bc2 = float(1 - np.float32(b2) ** n)
        for k, p in params.items():
            self.mu[k].mul_(b1).add_(g[k], alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
            upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt()
                                        + o["adam_epsilon"])
            p.sub_(o["learning_rate"] * (upd + o["adam_weight_decay"] * p))
        return g


def train(model: Model, batches, draws, opt: dict, steps: int):
    """``steps`` steps from the model's weights -> (losses, the clipped
    first gradients {name: tensor}, the parameters' change after the last
    step {name: tensor}, the first step's raw gradients)."""
    params = trainable(model)
    for p in model.parameters():
        p.requires_grad_(False)
    for p in params.values():
        p.requires_grad_(True)
    start = {k: p.detach().clone() for k, p in params.items()}
    adam = AdamW(params, opt)
    losses, first, raw = [], None, None
    CHECKPOINT["on"] = True
    try:
        for i in range(steps):
            lo = loss(model, batches[i], draws[i])
            grads = torch.autograd.grad(lo, list(params.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(params.items(), grads)}
            losses.append(float(lo.detach()))
            g = adam.step(params, grads)
            if i == 0:
                first, raw = g, grads
    finally:
        CHECKPOINT["on"] = False
    change = {k: (p.detach() - start[k]) for k, p in params.items()}
    return losses, first, change, raw
