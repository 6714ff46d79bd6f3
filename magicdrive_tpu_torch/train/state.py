"""Training state: the trainable partition, fp32 masters and the optimizer
(counterpart of ``train/state.py``).

The trainable set is the reference's: every parameter of the ControlNet and,
of the UNet, only the cross-view modules (``norm4``, ``attn4``,
``connector``, and their temporal ``*_temp`` counterparts), named by
``is_trainable`` over state_dict keys.

Mixed precision as in the JAX package: the modules hold every weight in the
working dtype (bf16), the frozen ones included, and run in it throughout;
the state keeps fp32 masters of the trainable weights, copies them into the
modules before each step, and takes the modules' gradients as fp32.

The optimizer restates ``optax.chain(clip_by_global_norm(max_grad_norm),
adamw(schedule, ...))``: the clip scales by max_norm / norm only where the
global norm reaches max_norm (no epsilon, unlike ``clip_grad_norm_``), the
decay is added to the bias-corrected Adam direction, and the schedule is read
at the update count before it increments, so warm-up starts from lr 0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device

UNET_TRAINABLE_SUBMODULES = ("norm4", "attn4", "connector",
                             "norm_temp", "attn_temp", "connector_temp")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The recipe of configs/runner/default.yaml (224x400 experiment). The
    train step draws one timestep per sample for all its views, as the
    recipe's ``train_with_same_t`` does."""
    learning_rate: float = 8e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    lr_warmup_steps: int = 3000  # linear from 0, then constant
    max_train_steps: int = 100000
    prediction_type: str = "epsilon"
    noise_offset: float = 0.0
    drop_cond_ratio: float = 0.25
    drop_cam_num: int = 6


def is_trainable(module: str, key: str) -> bool:
    """Whether the parameter ``key`` (a state_dict name) of ``module``
    ("unet", "controlnet", "vae" or "clip") is trained. Buffers never
    are."""
    if module == "controlnet":
        return True
    if module == "unet":
        return any(p in UNET_TRAINABLE_SUBMODULES for p in key.split("."))
    return False


def trainable_parameters(modules) -> Dict[str, torch.nn.Parameter]:
    """{"<module>.<key>": parameter} of the trainable partition."""
    return {f"{name}.{k}": p for name, mod in modules.items()
            for k, p in mod.named_parameters() if is_trainable(name, k)}


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """The constant-with-warmup schedule at update ``count`` (0 for the
    first update)."""
    warm = cfg.lr_warmup_steps
    return cfg.learning_rate * (count / warm if count < warm else 1.0)


class AdamW:
    """Global-norm clip then AdamW over a dict of fp32 tensors, updated in
    place."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: TrainConfig):
        self.cfg = cfg
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One update; returns the global norm of ``grads`` (before the
        clip), as a tensor, without a host sync."""
        c = self.cfg
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k].float() for k in keys]
        mu = [self.mu[k] for k in keys]
        nu = [self.nu[k] for k in keys]
        norm = torch.stack(torch._foreach_norm(g)).square().sum().sqrt()
        clip = torch.where(norm < c.max_grad_norm, torch.ones_like(norm),
                           c.max_grad_norm / norm)
        torch._foreach_mul_(g, clip)
        torch._foreach_mul_(mu, c.adam_beta1)
        torch._foreach_add_(mu, g, alpha=1 - c.adam_beta1)
        torch._foreach_mul_(nu, c.adam_beta2)
        torch._foreach_addcmul_(nu, g, g, value=1 - c.adam_beta2)
        lr = learning_rate(c, self.count)
        self.count += 1
        denom = torch._foreach_div(nu, 1 - c.adam_beta2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.adam_epsilon)
        upd = torch._foreach_div(mu, 1 - c.adam_beta1 ** self.count)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, p, alpha=c.adam_weight_decay)
        torch._foreach_add_(p, upd, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: Mapping) -> None:
        self.count = int(sd["count"])
        for mine, theirs in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            for k, t in mine.items():
                t.copy_(theirs[k])


@dataclasses.dataclass
class TrainState:
    step: int
    masters: Dict[str, torch.Tensor]
    opt: AdamW

    def copy_into(self, modules) -> Dict[str, torch.nn.Parameter]:
        """Write the masters into the modules' working copies; returns the
        trainable parameters of ``modules``."""
        params = trainable_parameters(modules)
        with torch.no_grad():
            torch._foreach_copy_([params[k] for k in self.masters],
                                 list(self.masters.values()))
        return params

    def apply_gradients(self, grads: Mapping[str, torch.Tensor]
                        ) -> torch.Tensor:
        norm = self.opt.step(self.masters, grads)
        self.step += 1
        return norm

    def state_dict(self) -> dict:
        return {"step": self.step, "masters": self.masters,
                "opt": self.opt.state_dict()}

    def load_state_dict(self, sd: Mapping) -> None:
        self.step = int(sd["step"])
        for k, t in self.masters.items():
            t.copy_(sd["masters"][k])
        self.opt.load_state_dict(sd["opt"])


def create_train_state(modules, cfg: TrainConfig, device=DEFAULT_DEVICE,
                       dtype: torch.dtype = torch.bfloat16) -> TrainState:
    """fp32 masters from the modules' current trainable weights, then the
    modules moved to ``device`` (the card unless the caller asks for the
    CPU) and ``dtype`` (frozen weights included) with only the trainable
    partition requiring gradients."""
    device = resolve_device(device)
    masters = {k: p.detach().to(device, torch.float32).clone()
               for k, p in trainable_parameters(modules).items()}
    modules.to(device, dtype)  # also freezes every parameter
    for p in trainable_parameters(modules).values():
        p.requires_grad_(True)
    return TrainState(step=0, masters=masters, opt=AdamW(masters, cfg))
