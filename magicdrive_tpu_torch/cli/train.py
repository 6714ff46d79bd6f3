"""The training entry point (counterpart of ``tools/train.py``;
ref:tools/train.py).

    python -m magicdrive_tpu_torch.cli.train [exp=224x400] [runner=debug]
        [key=value ...]

Composes the repository's ``configs/`` with the overrides (the config
loader's syntax), makes the run directory
``<log_root_prefix>/<task_id>_<YYYY-mm-dd_HH-MM>`` with ``train.log``,
builds the model of the config with random weights seeded from ``seed``
(as the JAX package's CLI, which loads no pretrained weights), the
datasets (``data/datasets.py``) and the ``Runner``, saves the run's config
and overrides for replay, and trains (``train/runner.py``): metrics,
checkpoints, validation images, the profile window and, at the end,
``weights/``, which ``cli.generate`` and ``cli.val_set_gen`` read. With
``validation_only=true`` it resumes as a run would and only validates.

The model trains in ``runner.mixed_precision``: bf16 in every runner
config, fp32 with ``runner.mixed_precision=no`` (the kernels' fp32
instances on the card). ``main(argv, device="cpu")`` runs on the CPU.
``model.unet.gradient_checkpointing=true`` with
``+model.unet.remat_policy=`` dots, attn or null picks the UNet's remat
policy (``models/unet.py``).

Several processes, one card each (NCCL), data parallel:

    torchrun --nproc_per_node=N -m magicdrive_tpu_torch.cli.train
        exp=224x400 parallel.multihost=true [key=value ...]

Every rank joins the job's process group (``train/runner.py``
``join_job``) and takes rank 0's run directory; rank 0 alone writes the
run's files, and the other ranks log to ``train_rank<r>.log`` there.
"""
from __future__ import annotations

import datetime
import logging
import os
import sys
from typing import NamedTuple, Optional, Sequence

import torch

from magicdrive_tpu_torch.config import preset_from_config
from magicdrive_tpu_torch.config_loader import compose, save_run_config
from magicdrive_tpu_torch.data.datasets import build_datasets
from magicdrive_tpu_torch.device import DEFAULT_DEVICE
from magicdrive_tpu_torch.parallel import multihost
from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
from magicdrive_tpu_torch.train.runner import Runner, join_job
from magicdrive_tpu_torch.train.state import TrainState

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(REPO, "configs")


class TrainRun(NamedTuple):
    """What ``main`` made: the run directory, the runner (its modules,
    datasets, validator and logger) and the final train state."""
    run_dir: str
    runner: Runner
    state: TrainState


def build_modules(preset, device) -> MagicDriveModules:
    """The preset's modules with PyTorch's default initialisation."""
    return MagicDriveModules.create(preset, device=device)


def main(argv: Optional[Sequence[str]] = None,
         device=DEFAULT_DEVICE) -> TrainRun:
    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = compose(CONFIG_DIR, overrides=overrides)
    device = join_job(cfg, device)
    rank = multihost.process_index()
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M")
    # rank 0's: ranks may read the clock on either side of a minute
    run_dir = multihost.all_gather_objects(os.path.join(
        cfg["log_root_prefix"], f"{cfg['task_id']}_{stamp}"))[0]
    os.makedirs(run_dir, exist_ok=True)
    handler = logging.FileHandler(os.path.join(
        run_dir, "train.log" if rank == 0 else f"train_rank{rank}.log"))
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.DEBUG if cfg.get("debug") else logging.INFO)
    try:
        preset = preset_from_config(cfg)
        torch.manual_seed(cfg.get("seed", 42))
        modules = build_modules(preset, device)
        train_ds, val_ds = build_datasets(cfg)
        runner = Runner(cfg, preset, modules, train_ds, val_dataset=val_ds,
                        run_dir=run_dir, device=device)
        if rank == 0:
            save_run_config(cfg, run_dir, overrides)
        state = runner.init_state()
        if cfg.get("validation_only"):
            runner.resume(state)
            runner.validate(state)
            logging.info("validation_only done; run dir: %s", run_dir)
        else:
            runner.run(state,
                       resume=cfg.get("resume_from_checkpoint") is not None)
            logging.info("done at step %d; collectives %s; run dir: %s",
                         state.step, dict(multihost.COLLECTIVES), run_dir)
        runner.logger.close()
        return TrainRun(run_dir, runner, state)
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
        handler.close()


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s")
    main()
    multihost.shutdown()
