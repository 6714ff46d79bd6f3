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

The optimizer restates JAX's ``make_optimizer``:
``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule, ...))``,
or ``adamw_8bit`` with ``use_8bit_adam`` (``adam8bit.py``), inside
``optax.MultiSteps`` with ``gradient_accumulation_steps`` > 1. The clip
scales by max_norm / norm only where the global norm reaches max_norm (no
epsilon, unlike ``clip_grad_norm_``), the decay is added to the
bias-corrected Adam direction, and the schedule is read at its count before
it increments, so warm-up starts from lr 0. As in optax, the schedule's
count and Adam's bias-correction count are two counts: ``reset_lr_schedule``
zeroes the first and keeps the second.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device

UNET_TRAINABLE_SUBMODULES = ("norm4", "attn4", "connector",
                             "norm_temp", "attn_temp", "connector_temp")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Every field of the JAX package's ``TrainConfig``, with its defaults
    (the recipe of configs/runner/default.yaml, 224x400 experiment)."""
    learning_rate: float = 8e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    # int8 block-quantized moments (adam8bit.py)
    use_8bit_adam: bool = False
    max_grad_norm: float = 1.0
    lr_warmup_steps: int = 3000
    lr_schedule: str = "constant_with_warmup"  # | cosine
    max_train_steps: int = 100000
    gradient_accumulation_steps: int = 1
    prediction_type: str = "epsilon"
    # one timestep per sample for all its views; False raises in the train
    # step, as the JAX package's step fails (train_step.py)
    train_with_same_t: bool = True
    # one noise per sample, broadcast over its views
    train_with_same_noise: bool = False
    # video: the batch is (clips * frames_per_clip) frames, one timestep
    # per clip
    frames_per_clip: Optional[int] = None
    noise_offset: float = 0.0
    drop_cond_ratio: float = 0.25
    drop_cam_num: int = 6
    # the collate's (model.bbox_view_shared): the step takes the boxes as
    # the batch holds them, per view or one set for all views
    bbox_view_shared: bool = False


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


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at update ``count`` (0 for the first update):
    optax's join of a linear warm-up from 0 and a constant
    (``constant_with_warmup``), or ``warmup_cosine_decay_schedule(0, lr,
    lr_warmup_steps, max_train_steps)`` (``cosine``)."""
    lr, warm = cfg.learning_rate, cfg.lr_warmup_steps
    if cfg.lr_schedule == "constant_with_warmup":
        def tail(count):
            return lr
    elif cfg.lr_schedule == "cosine":
        decay = cfg.max_train_steps - warm
        if decay <= 0:
            raise ValueError(f"the cosine schedule needs max_train_steps "
                             f"({cfg.max_train_steps}) > lr_warmup_steps "
                             f"({warm})")

        def tail(count):
            return lr * 0.5 * (1 + math.cos(math.pi * min(count, decay)
                                            / decay))
    else:
        raise ValueError(f"lr_schedule {cfg.lr_schedule!r}: "
                         "constant_with_warmup or cosine")

    def schedule(count: int) -> float:
        if count < warm:  # a warm-up of 0 steps is the tail alone
            return lr * count / warm
        return tail(count - warm)
    return schedule


def bias_corrections(cfg: TrainConfig, count: int) -> Tuple[float, float]:
    """(1 - b1**count, 1 - b2**count) in fp32 arithmetic, as optax computes
    them (1 - b2**count loses digits in fp32, and the port keeps optax's
    rounding)."""
    n = np.float32(count)
    return (float(1 - np.float32(cfg.adam_beta1) ** n),
            float(1 - np.float32(cfg.adam_beta2) ** n))


def _global_norm(g) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(g)).square().sum().sqrt()


class AdamW:
    """Global-norm clip then AdamW over a dict of fp32 tensors, updated in
    place. ``count`` is Adam's bias-correction count (optax's
    ``ScaleByAdamState.count``), ``schedule_count`` the learning-rate
    schedule's (``ScaleByScheduleState.count``)."""

    def __init__(self, params: Mapping[str, torch.Tensor], cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg)
        self.count = 0
        self.schedule_count = 0
        self._init_moments(params)

    def _init_moments(self, params: Mapping[str, torch.Tensor]) -> None:
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    def _directions(self, keys, g) -> list:
        """Update the moments with the clipped gradients ``g`` and return
        the bias-corrected Adam directions (``count`` already advanced)."""
        c = self.cfg
        mu = [self.mu[k] for k in keys]
        nu = [self.nu[k] for k in keys]
        torch._foreach_mul_(mu, c.adam_beta1)
        torch._foreach_add_(mu, g, alpha=1 - c.adam_beta1)
        torch._foreach_mul_(nu, c.adam_beta2)
        torch._foreach_addcmul_(nu, g, g, value=1 - c.adam_beta2)
        bc1, bc2 = bias_corrections(c, self.count)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, c.adam_epsilon)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        return upd

    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One update; returns the global norm of ``grads`` (before the
        clip), as a tensor, without a host sync."""
        c = self.cfg
        keys = list(params)
        p = [params[k] for k in keys]
        g = [grads[k].float() for k in keys]
        norm = _global_norm(g)
        # optax's clip: g where norm < max_norm, else (g / norm) * max_norm
        clip = norm < c.max_grad_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(g, torch.where(clip, one, norm))
        torch._foreach_mul_(g, torch.where(clip, one, c.max_grad_norm * one))
        self.count += 1
        upd = self._directions(keys, g)
        torch._foreach_add_(upd, p, alpha=c.adam_weight_decay)
        lr = self.schedule(self.schedule_count)
        self.schedule_count += 1
        torch._foreach_add_(p, upd, alpha=-lr)
        return norm

    def _moments_state(self) -> dict:
        return {"mu": self.mu, "nu": self.nu}

    def _load_moments(self, sd: Mapping) -> None:
        for mine, theirs in ((self.mu, sd["mu"]), (self.nu, sd["nu"])):
            for k, t in mine.items():
                t.copy_(theirs[k])

    def state_dict(self) -> dict:
        return {"count": self.count, "schedule_count": self.schedule_count,
                **self._moments_state()}

    def load_state_dict(self, sd: Mapping) -> None:
        self.count = int(sd["count"])
        self.schedule_count = int(sd["schedule_count"])
        self._load_moments(sd)


class MultiSteps:
    """``optax.MultiSteps``: the running mean of k micro-batch gradients,
    handed to the inner optimizer every k-th call; the other calls leave
    the parameters and the inner state as they are."""

    def __init__(self, inner: AdamW, params: Mapping[str, torch.Tensor],
                 k: int):
        self.inner, self.k = inner, k
        self.mini_step = 0
        self.gradient_step = 0
        self.acc = {key: torch.zeros_like(p) for key, p in params.items()}

    def step(self, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """Accumulate ``grads``; returns the global norm of the mean so far
        (on the k-th call, the norm the inner optimizer clips)."""
        keys = list(params)
        acc = [self.acc[key] for key in keys]
        diff = torch._foreach_sub([grads[key].float() for key in keys], acc)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(acc, diff)
        if self.mini_step == self.k - 1:
            norm = self.inner.step(params, self.acc)
            torch._foreach_zero_(acc)
            self.gradient_step += 1
        else:
            norm = _global_norm(acc)
        self.mini_step = (self.mini_step + 1) % self.k
        return norm

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step, "acc": self.acc,
                "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: Mapping) -> None:
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])
        for k, t in self.acc.items():
            t.copy_(sd["acc"][k])
        self.inner.load_state_dict(sd["inner"])


def make_optimizer(params: Mapping[str, torch.Tensor], cfg: TrainConfig):
    """The optimizer of ``cfg`` over ``params`` (JAX ``make_optimizer``)."""
    if cfg.use_8bit_adam:
        from .adam8bit import AdamW8bit

        opt = AdamW8bit(params, cfg)
    else:
        opt = AdamW(params, cfg)
    if cfg.gradient_accumulation_steps > 1:
        opt = MultiSteps(opt, params, cfg.gradient_accumulation_steps)
    return opt


def reset_lr_schedule(state: "TrainState") -> "TrainState":
    """Restart the learning-rate schedule and keep the moments and Adam's
    count: the reference's ``resume_reset_scheduler``
    (ref:magicdrive/runner/utils.py:18-26), JAX's ``reset_lr_schedule``."""
    opt = state.opt
    (opt.inner if isinstance(opt, MultiSteps) else opt).schedule_count = 0
    return state


@dataclasses.dataclass
class TrainState:
    """``step`` counts calls of ``apply_gradients``: micro-steps, under
    gradient accumulation, as JAX's ``TrainState.step`` does."""
    step: int
    masters: Dict[str, torch.Tensor]
    opt: Union[AdamW, MultiSteps]

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
    return TrainState(step=0, masters=masters,
                      opt=make_optimizer(masters, cfg))
