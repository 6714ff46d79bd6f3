"""The training loop (counterpart of the step loop of ``train/runner.py``
``Runner.run``).

The runner takes an iterable of collated batches and steps until it is
exhausted or ``max_train_steps`` is reached. Its knobs are arguments.

  * The NaN/inf check of a step's loss is deferred by one step: the loss of
    step i is read after step i+1 has been queued, so reading it does not
    drain the device. The pending check is drained before every checkpoint
    and at the end, so a non-finite state never becomes a checkpoint.
  * Checkpoints are ``torch.save`` files of the fp32 masters, the optimizer
    moments and the step, under ``<run_dir>/checkpoints``, every
    ``checkpointing_steps`` and at the end (never when it is None); ``run``
    resumes from the latest and keeps the newest ``max_to_keep``.
  * Metrics go to ``<run_dir>/metrics.jsonl``, one JSON object per logged
    step.
  * Each step draws from a generator seeded with (seed, step), so a resumed
    run continues the draws it would have made.
"""
from __future__ import annotations

import json
import math
import os
import re
import time
from typing import Any, Iterable, Mapping, Optional

import torch

from magicdrive_tpu_torch.diffusion import NoiseSchedule
from .state import TrainConfig, TrainState
from .train_step import train_step

_CKPT = re.compile(r"step_(\d+)\.pt$")


class Runner:
    def __init__(self, modules, cfg: TrainConfig, run_dir: str,
                 checkpointing_steps: Optional[int] = 500,
                 max_to_keep: int = 5,
                 log_every: int = 10, seed: int = 42):
        self.modules, self.cfg, self.run_dir = modules, cfg, run_dir
        self.ckpt_dir = os.path.join(run_dir, "checkpoints")
        self.checkpointing_steps = checkpointing_steps
        self.max_to_keep = max_to_keep
        self.log_every = log_every
        self.seed = seed
        self.schedule = NoiseSchedule.create()

    # -- checkpoints ------------------------------------------------------
    def checkpoints(self) -> list:
        """(step, path) of the saved checkpoints, oldest first."""
        if not os.path.isdir(self.ckpt_dir):
            return []
        found = ((_CKPT.search(f), f) for f in os.listdir(self.ckpt_dir))
        return sorted((int(m.group(1)), os.path.join(self.ckpt_dir, f))
                      for m, f in found if m)

    def save(self, state: TrainState) -> None:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, f"step_{state.step:08d}.pt")
        torch.save(state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        for _, old in self.checkpoints()[:-self.max_to_keep]:
            os.remove(old)

    def restore(self, state: TrainState) -> bool:
        """Load the latest checkpoint into ``state``; False if none."""
        ckpts = self.checkpoints()
        if not ckpts:
            return False
        state.load_state_dict(torch.load(ckpts[-1][1], map_location="cpu",
                                         weights_only=True))
        return True

    # -- loop -------------------------------------------------------------
    def run(self, state: TrainState, batches: Iterable[Mapping[str, Any]],
            resume: bool = True) -> TrainState:
        if resume:
            self.restore(state)
        device = next(iter(state.masters.values())).device
        os.makedirs(self.run_dir, exist_ok=True)
        log = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        pending = None  # (step, metrics, n_samples) not yet checked
        t_last = time.perf_counter()

        def check(entry) -> None:
            nonlocal t_last
            step, metrics, n = entry
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(f"NaN/inf loss at step {step}")
            if step % self.log_every == 0 or step <= 3:
                dt = time.perf_counter() - t_last
                k = self.log_every if step % self.log_every == 0 else 1
                log.write(json.dumps({
                    "step": step, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "steps_per_sec": k / dt,
                    "samples_per_sec": k * n / dt}) + "\n")
                log.flush()
                t_last = time.perf_counter()

        try:
            for batch in batches:
                if state.step >= self.cfg.max_train_steps:
                    break
                gen = torch.Generator(device).manual_seed(
                    self.seed * 1_000_003 + state.step)
                metrics = train_step(self.modules, state, batch, self.cfg,
                                     generator=gen, schedule=self.schedule)
                if pending is not None:
                    check(pending)
                pending = (state.step, metrics, len(batch["input_ids"]))
                if self.checkpointing_steps and \
                        state.step % self.checkpointing_steps == 0:
                    check(pending)
                    pending = None
                    self.save(state)
            if pending is not None:
                check(pending)
            if self.checkpointing_steps:
                self.save(state)
        finally:
            log.close()
        return state
