"""The training runtime driven by a composed config (counterpart of
``train/runner.py``; ref:magicdrive/runner/base_runner.py BaseRunner.run,
ref:magicdrive/runner/multiview_runner.py).

``Runner(cfg, preset, modules, train_dataset, val_dataset, run_dir)``
reads the ``runner`` group (``train_config_from_cfg``) and trains on one
device:
  * the loader (``data/loader.py``) at ``train_batch_size``, shuffled from
    the config's seed, over ``num_train_epochs`` epochs up to
    ``max_train_steps``; the model reads the map's first
    ``dataset.map_channels_used`` channels (the JAX package's runner hands
    it a nuScenes map's 26, which its 8-channel embedder rejects);
  * the NaN/inf check of a step's loss deferred by one step, so reading it
    does not drain the device; the pending check is drained before every
    checkpoint and validation, so a non-finite state is never kept;
  * checkpoints (``torch.save`` files of the step, the fp32 masters and the
    optimizer state) every ``checkpointing_steps`` and at the end, the
    newest ``checkpoints_total_limit`` kept, under ``<run_dir>/
    checkpoints``; ``resume_from_checkpoint`` (another run's
    ``checkpoints/``, or this run's own) and ``resume_reset_scheduler``;
  * ``Validator`` grids every ``validation_steps`` (and first, with
    ``validation_before_run``) into ``<run_dir>/val_images``;
  * ``profile_steps`` [a, b]: steps a+1..b under ``torch.profiler`` with
    the port's spans on (``utils.trace``), its trace under
    ``<run_dir>/profile``: each step's phases ``md.train.step``,
    ``md.train.masters``, ``md.train.encode``, ``md.train.forward``,
    ``md.train.backward`` and ``md.train.optimizer``, and inside them the
    blocks' ``md.transformer``, ``md.attn``, ``md.ff`` and ``md.resnet``,
    are ranges on the clock of the kernels they launch. A validation after
    a step a+1..b-1 runs inside the window, with the pipeline's ranges
    ``md.pipeline.request``, ``.conditioning``, ``.step`` (each denoising
    step) and ``.decode``. Where training ends or raises inside the
    window, the trace is written up to the last step finished, and spans
    are off again;
  * metrics as JSON lines in ``<run_dir>/metrics.jsonl`` (steps 1-3, then
    every 10th), and to tensorboard where ``torch.utils.tensorboard``
    imports;
  * at the end the run's weights in ``<run_dir>/weights`` (the JAX
    package's ``params.npz`` + ``manifest.json``, which ``cli.generate``
    reads): the trainable ones from the fp32 masters.
Each step draws from a generator seeded with (seed, step), so a resumed run
continues the draws it would have made. The JAX package's ``pair_bwd`` is a
TPU trace-time knob with no counterpart here: it is logged and ignored.

Several processes (``parallel``; the JAX runner's mesh, :214-273): the
ranks form the mesh of ``parallel.mesh_shape`` (null: every rank on
``dp``), after ``parallel.multihost`` or a ``WORLD_SIZE`` > 1 in the
environment has joined the job's process group. The global batch is
``train_batch_size`` x dp: every rank shuffles alike from the seed and
loads only its rows (ranks of one view group take the same rows, as JAX's
dp-only batch sharding replicates over ``view``); each step draws the
global batch's draws and keeps its rows, and the gradients and the loss
are the dp group's mean (``train_step`` on ``Mesh.dp_only``: the ranks
along ``t`` and ``view`` step as replicas), so every rank makes the same
update. Rank 0 alone writes the checkpoints, metrics, validation grids,
profile and weights, with a barrier after each write; every rank reads a
resume checkpoint. JAX's runner reads no ``shard_views``: it is logged as
having no effect in training.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from magicdrive_tpu_torch.data.collate import CollateConfig, collate_fn
from magicdrive_tpu_torch.data.loader import DataLoader
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.diffusion import NoiseSchedule
from magicdrive_tpu_torch.parallel import multihost
from magicdrive_tpu_torch.parallel.mesh import make_mesh
from magicdrive_tpu_torch.utils import trace
from .state import (TrainConfig, TrainState, create_train_state,
                    reset_lr_schedule)
from .train_step import train_step

log = logging.getLogger(__name__)

_CKPT = re.compile(r"step_(\d+)\.pt$")


def train_config_from_cfg(rc) -> TrainConfig:
    """The ``runner`` group of a composed config -> TrainConfig, field for
    field as the JAX package reads it."""
    return TrainConfig(
        learning_rate=rc["learning_rate"], adam_beta1=rc["adam_beta1"],
        adam_beta2=rc["adam_beta2"], adam_weight_decay=rc["adam_weight_decay"],
        adam_epsilon=rc["adam_epsilon"], max_grad_norm=rc["max_grad_norm"],
        lr_warmup_steps=rc["lr_warmup_steps"], lr_schedule=rc["lr_schedule"],
        max_train_steps=rc["max_train_steps"] or 100000,
        gradient_accumulation_steps=rc["gradient_accumulation_steps"],
        prediction_type=rc["prediction_type"],
        train_with_same_t=rc["train_with_same_t"],
        train_with_same_noise=rc["train_with_same_noise"],
        noise_offset=rc["noise_offset"],
        use_8bit_adam=bool(rc.get("use_8bit_adam", False)),
        frames_per_clip=rc.get("frames_per_clip"))


def join_job(cfg, device=DEFAULT_DEVICE) -> torch.device:
    """Join the job's process group where ``parallel.multihost`` asks for
    it or the environment holds a job of several processes; -> this rank's
    device for ``device`` (``parallel.multihost.rank_device``)."""
    pc = cfg.get("parallel") or {}
    if pc.get("multihost") or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        multihost.initialize_if_needed(device=device)
    return multihost.rank_device(resolve_device(device))


class MetricsLogger:
    """Scalars as JSON lines, and to tensorboard where it imports; with
    ``write`` False (the ranks other than 0) nothing."""

    def __init__(self, run_dir: str, write: bool = True):
        self.f = self.tb = None
        if not write:
            return
        os.makedirs(run_dir, exist_ok=True)
        self.f = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            log.info("torch.utils.tensorboard does not import: metrics go "
                     "to metrics.jsonl only")
        else:
            self.tb = SummaryWriter(os.path.join(run_dir, "tb"))

    def log(self, step: int, scalars: Mapping[str, float]) -> None:
        if self.f is None:
            return
        rec = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), int(step))

    def log_images(self, step: int, tag: str, grid: np.ndarray) -> None:
        """grid: (H, W, 3) in [0, 1]."""
        if self.tb:
            self.tb.add_image(tag, grid, int(step), dataformats="HWC")

    def close(self) -> None:
        if self.f is not None:
            self.f.close()
        if self.tb:
            self.tb.close()


class Validator:
    """Generation on fixed validation samples during training
    (ref:magicdrive/runner/base_validator.py:55-204): one pipeline for the
    run on the training modules, each variant ``rep`` from a generator
    seeded 1000 + rep; a grid per sample (its views in a row, under the
    ground-truth row where the batch has images) as
    ``val_images/step{s}_idx{i}_{rep}.png``."""

    def __init__(self, modules, pipeline_cfg, val_dataset,
                 ccfg: CollateConfig, indices, times: int = 1,
                 map_channels: Optional[int] = None):
        self.modules = modules
        self.pipeline_cfg = pipeline_cfg
        self.dataset = val_dataset
        self.ccfg = dataclasses.replace(ccfg, is_train=False)
        self.indices = [i for i in indices if i < len(val_dataset)]
        self.times = times
        self.map_channels = map_channels
        self.pipe = None

    def batch(self) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
        """The pipeline's batch of the validation samples (the map cut to
        ``map_channels``) and their ground-truth images, or None."""
        batch = collate_fn([self.dataset[i] for i in self.indices],
                           self.ccfg)
        gt = batch.pop("pixel_values", None)
        batch["bev_map"] = batch["bev_map"][..., :self.map_channels]
        return batch, gt

    def validate(self, state: TrainState, logger: MetricsLogger, step: int,
                 run_dir: Optional[str] = None) -> List[np.ndarray]:
        """The grids of the state's weights (copied into the modules),
        rep-major; written under ``run_dir`` where given."""
        from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

        if not self.indices:
            return []
        state.copy_into(self.modules)
        if self.pipe is None:  # on the modules' device and dtype
            self.pipe = MagicDrivePipeline(self.modules, self.pipeline_cfg)
        batch, gt = self.batch()
        grids = []
        for rep in range(self.times):
            gen = torch.Generator(self.pipe.device).manual_seed(1000 + rep)
            imgs = self.pipe(batch, generator=gen).cpu().numpy()
            for b, i in enumerate(self.indices):
                grid = np.concatenate(list(imgs[b]), axis=1)  # views wide
                if gt is not None:
                    gt_row = np.concatenate(list(gt[b] / 2 + 0.5), axis=1)
                    grid = np.concatenate([gt_row, grid], axis=0)
                grids.append(grid)
                logger.log_images(step, f"val/{i}_{rep}", grid)
                if run_dir is not None:
                    from PIL import Image

                    out = os.path.join(run_dir, "val_images")
                    os.makedirs(out, exist_ok=True)
                    Image.fromarray(
                        (np.clip(grid, 0, 1) * 255).astype(np.uint8)).save(
                        os.path.join(out, f"step{step}_idx{i}_{rep}.png"))
        return grids


class Runner:
    """The training loop of a composed config; see the module docstring.

        runner = Runner(cfg, preset, modules, train_ds, val_ds, run_dir)
        state = runner.run()

    The modules train on ``device`` (a CUDA device without an index: this
    rank's card) in ``runner.mixed_precision`` (bf16, or fp32 for any other
    value) over fp32 masters, as the JAX package's ``init_state`` keeps
    them."""

    def __init__(self, cfg, preset, modules, train_dataset,
                 val_dataset=None, run_dir: str = "runs/dev",
                 device=DEFAULT_DEVICE):
        rc = cfg["runner"]
        self.cfg, self.rc = cfg, rc
        self.modules = modules
        self.run_dir = run_dir
        self.device = join_job(cfg, device)
        pc = cfg.get("parallel") or {}
        self.mesh = make_mesh(pc.get("mesh_shape"),
                              tuple(pc.get("axis_names") or ("dp", "view")))
        self.main = multihost.process_index() == 0
        log.info("rank %d of %d (backend %s) at %s of the %s mesh",
                 multihost.process_index(), multihost.process_count(),
                 multihost.backend(), self.mesh.coords, self.mesh.shape)
        if pc.get("shard_views"):
            log.info("parallel.shard_views=true: the JAX package's runner "
                     "reads no shard_views (its batch is dp-sharded only); "
                     "it has no effect in training")
        self.dtype = torch.bfloat16 if rc["mixed_precision"] == "bf16" \
            else torch.float32
        self.tcfg = train_config_from_cfg(rc)
        if rc.get("pair_bwd"):
            log.info("runner.pair_bwd=%s: the JAX package's TPU backward "
                     "schedule knob; it has no effect in the port",
                     rc["pair_bwd"])
        self.seed = cfg.get("seed", 42)
        self.map_channels = cfg["dataset"]["map_channels_used"]
        self.ccfg = CollateConfig(
            template=cfg["dataset"]["template"],
            bbox_mode=cfg["model"]["bbox_mode"],
            bbox_max_len=rc["bbox_max_length"],
            bbox_view_shared=cfg["model"]["bbox_view_shared"],
            canvas_hw=tuple(cfg["dataset"]["image_size"]),
            bbox_drop_ratio=rc["bbox_drop_ratio"],
            bbox_add_ratio=rc["bbox_add_ratio"],
            bbox_add_num=rc["bbox_add_num"])
        self.loader = DataLoader(
            train_dataset, batch_size=rc["train_batch_size"], cfg=self.ccfg,
            shuffle=True, seed=self.seed, num_workers=rc["num_workers"],
            drop_last=True, shard=(self.mesh.index("dp"), self.mesh.dp))
        self.validator = None
        if val_dataset is not None:
            self.validator = Validator(
                modules, preset.pipeline, val_dataset, self.ccfg,
                rc["validation_index"], rc["validation_times"],
                map_channels=self.map_channels)
        self.ckpt_dir = os.path.join(run_dir, "checkpoints")
        self.max_to_keep = rc.get("checkpoints_total_limit") or 5
        self.logger = MetricsLogger(run_dir, write=self.main)
        self.schedule = NoiseSchedule.create()
        self._profiler = None

    def init_state(self) -> TrainState:
        """The train state of the modules as they are: fp32 masters of the
        trainable partition, the modules moved to the device and dtype."""
        return create_train_state(self.modules, self.tcfg, self.device,
                                  self.dtype)

    # -- checkpoints ------------------------------------------------------
    def checkpoints(self, ckpt_dir: Optional[str] = None) -> list:
        """(step, path) of the checkpoints in ``ckpt_dir`` (default this
        run's), oldest first."""
        ckpt_dir = ckpt_dir or self.ckpt_dir
        if not os.path.isdir(ckpt_dir):
            return []
        found = ((_CKPT.search(f), f) for f in os.listdir(ckpt_dir))
        return sorted((int(m.group(1)), os.path.join(ckpt_dir, f))
                      for m, f in found if m)

    def save(self, state: TrainState) -> None:
        """Checkpoint ``state`` (once per step) and keep the newest
        ``max_to_keep``: on rank 0, then a barrier."""
        if self.main:
            self._save(state)
        multihost.barrier("checkpoint")

    def _save(self, state: TrainState) -> None:
        ckpts = self.checkpoints()
        if ckpts and ckpts[-1][0] == state.step:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        path = os.path.join(self.ckpt_dir, f"step_{state.step:08d}.pt")
        torch.save(state.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)
        for _, old in self.checkpoints()[:-self.max_to_keep]:
            os.remove(old)

    def restore(self, state: TrainState,
                ckpt_dir: Optional[str] = None) -> bool:
        """Load the latest checkpoint of ``ckpt_dir`` (default this run's)
        into ``state``; False if there is none."""
        ckpts = self.checkpoints(ckpt_dir)
        if not ckpts:
            return False
        state.load_state_dict(torch.load(ckpts[-1][1], map_location="cpu",
                                         weights_only=True))
        return True

    def resume(self, state: TrainState) -> None:
        """From ``resume_from_checkpoint`` where it names another run's
        checkpoint directory, else from this run's latest checkpoint; then,
        with ``resume_reset_scheduler``, the learning-rate schedule
        restarts (ref:base_runner.py:301-310: the JAX package resets it
        only on resuming from the run's own checkpoints)."""
        src = self.cfg.get("resume_from_checkpoint")
        own = os.path.abspath(self.ckpt_dir)
        if isinstance(src, str) and os.path.isdir(src) and \
                os.path.abspath(src) != own:
            if not self.restore(state, src):
                raise FileNotFoundError(f"no checkpoint in {src}")
            log.info("resumed from external %s step %d", src, state.step)
        elif self.restore(state):
            log.info("resumed from step %d", state.step)
        else:
            return
        if self.cfg.get("resume_reset_scheduler"):
            reset_lr_schedule(state)
            log.info("LR schedule progress reset")

    # -- loop -------------------------------------------------------------
    def run(self, state: Optional[TrainState] = None,
            resume: bool = True) -> TrainState:
        """Train from ``state`` (default ``init_state``), resumed first
        where ``resume``, to ``max_train_steps`` or the last epoch; then
        the final checkpoint and the run's weights."""
        state = state if state is not None else self.init_state()
        if resume:
            self.resume(state)
        if self.rc.get("validation_before_run") and self.validator:
            self.validate(state)
        for epoch in range(self.rc["num_train_epochs"]):
            if state.step >= self.tcfg.max_train_steps:
                break
            self.train(state, self.loader, epoch)
        self.save(state)
        self.save_deployable(state)
        return state

    def validate(self, state: TrainState) -> None:
        """The Validator's grids of ``state`` on rank 0, then a barrier."""
        if self.main:
            self.validator.validate(state, self.logger, state.step,
                                    self.run_dir)
        multihost.barrier("validation")

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        trace.enable()
        self._profiler = profile(activities=acts)
        self._profiler.start()

    def _stop_profile(self, window) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._profiler.stop()
        finally:
            trace.disable()
            trace.drain()  # the exported trace holds them
        out = os.path.join(self.run_dir, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(os.path.join(
            out, f"steps{window[0] + 1}-{window[1]}.json"))
        self._profiler = None

    def train(self, state: TrainState, batches: Iterable[Mapping[str, Any]],
              epoch: int = 0) -> TrainState:
        """Step ``state`` over ``batches`` (collated) until they end or
        ``max_train_steps``, with the checkpoints, validation and profile
        window of the config's cadence; every check drained at the end."""
        rc = self.rc
        window = rc.get("profile_steps")
        pending = None  # (step, metrics, n_samples) not yet checked
        t_last = time.perf_counter()

        def check(entry) -> None:
            nonlocal t_last
            step, metrics, n = entry
            loss = float(metrics["loss"])
            if not math.isfinite(loss):
                raise RuntimeError(f"NaN/inf loss at step {step}")
            if step % 10 == 0 or step <= 3:
                dt = time.perf_counter() - t_last
                k = 10 if step % 10 == 0 else 1
                self.logger.log(step, {
                    "loss": loss, "grad_norm": float(metrics["grad_norm"]),
                    "steps_per_sec": k / dt, "samples_per_sec": k * n / dt,
                    "epoch": epoch})
                t_last = time.perf_counter()

        try:
            for batch in batches:
                if state.step >= self.tcfg.max_train_steps:
                    break
                if window and state.step == window[0] and self.main:
                    self._start_profile()
                batch = dict(batch, bev_map=np.asarray(
                    batch["bev_map"])[..., :self.map_channels])
                gen = torch.Generator(self.device).manual_seed(
                    self.seed * 1_000_003 + state.step)
                metrics = train_step(self.modules, state, batch, self.tcfg,
                                     generator=gen, schedule=self.schedule,
                                     mesh=self.mesh.dp_only())
                if window and state.step == window[1] and self._profiler:
                    self._stop_profile(window)
                if pending is not None:
                    check(pending)
                pending = (state.step, metrics,
                           len(batch["input_ids"]) * self.mesh.dp)
                at_ckpt = state.step % rc["checkpointing_steps"] == 0
                at_val = self.validator is not None and \
                    state.step % rc["validation_steps"] == 0
                if at_ckpt or at_val:
                    check(pending)
                    pending = None
                if at_ckpt:
                    self.save(state)
                if at_val:
                    self.validate(state)
        finally:
            if self._profiler is not None:  # the window did not close
                self._stop_profile((window[0], state.step))
        if pending is not None:
            check(pending)
        return state

    def save_deployable(self, state: TrainState) -> None:
        """The run's weights in ``<run_dir>/weights``: the modules' tree
        with the trainable leaves from the fp32 masters (the counterpart
        of the reference's save_pretrained dirs,
        ref:multiview_runner.py:233-242), on rank 0, then a barrier."""
        from magicdrive_tpu_torch.convert import modules_to_jax_params
        from magicdrive_tpu_torch.utils.serialization import save_params

        if self.main:
            save_params(modules_to_jax_params(self.modules, state.masters),
                        os.path.join(self.run_dir, "weights"))
        multihost.barrier("export")
