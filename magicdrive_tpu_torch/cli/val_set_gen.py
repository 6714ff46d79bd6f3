"""Validation-set synthesis for FID and perception evaluation (counterpart
of ``tools/val_set_gen.py``; ref:perception/data_prepare/val_set_gen.py).

    python -m magicdrive_tpu_torch.cli.val_set_gen --run_dir RUN --out OUT
        [--times T] [--batch_size 4] [--seed 42] [--multihost]
        [overrides...]
    torchrun --nproc_per_node=N -m magicdrive_tpu_torch.cli.val_set_gen
        --multihost --run_dir RUN --out OUT [...]

Recomposes the run's config (its saved overrides, then these), loads the
run's ``weights/``, and generates every validation sample's 6 views in
batches of ``--batch_size`` (the last batch may be short), ``--times``
times. Each view is written as ``<nuScenes file stem>_gen{rep}.png``, the
names ``cli.fid``'s ``tokens`` mode pairs with the real images
(ref:val_set_gen.py:29-43); the names come from the dataset's index
(``NuScenesDataset.filenames``), not from loading each sample a second time
as the JAX tool does. The model reads the first
``dataset.map_channels_used`` channels of the rasterized map. The latents
of (rep, batch) come from a ``torch.Generator`` seeded from (seed, rep,
batch, process index) by numpy's SeedSequence.

With ``--multihost`` each process joins the job's process group (NCCL,
one card a rank; ``parallel/multihost.py``) and generates every
``process_count``-th sample from its index on (``shard_for_process``),
into the shared ``--out``; alone, or without the flag, it takes every
sample. Process 0's stream is the one process's: the SeedSequence of
(seed, rep, batch, 0) is that of (seed, rep, batch).

The model runs on the card in bf16, as the JAX package's tool builds it;
``main(argv, device="cpu", dtype=torch.float32)`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from magicdrive_tpu_torch.cli.generate import (CONFIG_DIR, collate_config,
                                               load_pipeline)
from magicdrive_tpu_torch.config import preset_from_config
from magicdrive_tpu_torch.config_loader import compose, load_run_overrides
from magicdrive_tpu_torch.data.datasets import build_datasets
from magicdrive_tpu_torch.data.loader import DataLoader, shard_for_process
from magicdrive_tpu_torch.data.nuscenes import ListSetWrapper
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.parallel import multihost
from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline


class ValSet(NamedTuple):
    """What ``main`` made on this process: the output directory, the
    pipeline, this process's samples, and per batch the host-clock seconds
    from asking the loader for it to its last PNG written, every rep
    included (the wait for the loader, the pipeline's calls, the images'
    copy to the host and the PNGs' encoding)."""
    out_dir: str
    pipe: MagicDrivePipeline
    dataset: ListSetWrapper
    seconds: List[float]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m magicdrive_tpu_torch.cli.val_set_gen",
        description="Generate the validation set of a trained run.")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--times", type=int, default=1,
                   help="generations per sample (suffix _gen{i})")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("overrides", nargs="*")
    return p.parse_args(argv)


def batch_generator(seed: int, rep: int, batch: int, device,
                    process: int = 0) -> torch.Generator:
    """The generator of one (rep, batch) of a process: seeded from (seed,
    rep, batch, process) by numpy's SeedSequence, so no two share a
    stream (a trailing 0 leaves SeedSequence's state as it is, so process
    0 draws what the one-process tool drew)."""
    state = np.random.SeedSequence(
        [seed, rep, batch, process]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def main(argv: Optional[Sequence[str]] = None, device=DEFAULT_DEVICE,
         dtype: torch.dtype = torch.bfloat16) -> ValSet:
    args = parse_args(argv)
    device = resolve_device(device)
    if args.multihost:
        multihost.initialize_if_needed(device=device)
        device = multihost.rank_device(device)
    rank, world = multihost.process_index(), multihost.process_count()
    cfg = compose(CONFIG_DIR, overrides=load_run_overrides(args.run_dir)
                  + list(args.overrides))
    preset = preset_from_config(cfg)
    pipe = load_pipeline(preset, os.path.join(args.run_dir, "weights"),
                         device, dtype)
    _, val_ds = build_datasets(cfg)
    ids = shard_for_process(range(len(val_ds)), rank, world)
    ds = ListSetWrapper(val_ds, ids)
    loader = DataLoader(ds, batch_size=args.batch_size,
                        cfg=collate_config(cfg),
                        num_workers=cfg["runner"]["num_workers"])
    n_map = cfg["dataset"]["map_channels_used"]

    os.makedirs(args.out, exist_ok=True)
    made = ValSet(args.out, pipe, ds, [])
    done = 0
    t0 = time.perf_counter()
    for bi, batch in enumerate(loader):
        files = [val_ds.filenames(ids[done + j])
                 for j in range(len(batch["bev_map"]))]
        batch.pop("pixel_values", None)  # generation takes no images
        batch["bev_map"] = batch["bev_map"][..., :n_map]
        for rep in range(args.times):
            latents = pipe.prepare_latents(len(files), batch_generator(
                args.seed, rep, bi, device, rank))
            imgs = pipe(batch, latents=latents).cpu().numpy()
            for b, views in enumerate(files):
                for v, fname in enumerate(views):
                    stem = os.path.splitext(os.path.basename(fname))[0]
                    arr = (np.clip(imgs[b, v], 0, 1) * 255).astype(np.uint8)
                    Image.fromarray(arr).save(
                        os.path.join(args.out, f"{stem}_gen{rep}.png"))
        made.seconds.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        done += len(files)
        print(f"[process {rank}] {done}/{len(ds)} "
              f"({made.seconds[-1]:.3f} s for the batch)")
    multihost.barrier("val_set_gen")
    return made


if __name__ == "__main__":
    main()
    multihost.shutdown()
