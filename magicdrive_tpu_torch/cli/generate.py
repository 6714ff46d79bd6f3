"""Batch generation from a trained run (counterpart of ``tools/generate.py``;
ref:tools/test.py).

    python -m magicdrive_tpu_torch.cli.generate --run_dir RUN [--out OUT]
        [--indices I ...] [--seed S] [--times T] [overrides...]

Recomposes the run's config from the repository's ``configs/`` with the
run's saved overrides and these (config replay, ref:tools/test.py:46-56),
saves it into the output directory, loads the run's weights
(``RUN/weights``, the JAX package's ``params.npz`` + ``manifest.json``),
collates the validation samples ``--indices`` (default
``runner.validation_index``) into one batch and generates ``--times``
variants of it (default ``runner.validation_times``). Each variant's
latents come from a ``torch.Generator`` seeded from ``--seed`` (default the
config's ``seed``) and the variant's index; with ``fix_seed_within_batch``
every sample of the batch starts from the same latent. Writes
``{i}_gen{suffix}.png`` (the 6 views in a row, with the boxes drawn on them
in a second row when ``runner.validation_show_box`` is set) and, with the
first variant, ``{i}_map.png``.

The model runs on the card in bf16, as the JAX package's CLI builds it;
``main(argv, device="cpu", dtype=torch.float32)`` runs it on the CPU in
fp32.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from magicdrive_tpu_torch.config import preset_from_config
from magicdrive_tpu_torch.config_loader import (compose, load_run_overrides,
                                                save_run_config)
from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
from magicdrive_tpu_torch.data.collate import CollateConfig, collate_fn
from magicdrive_tpu_torch.data.datasets import build_datasets
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                    MagicDrivePipeline)
from magicdrive_tpu_torch.utils.serialization import load_params
from magicdrive_tpu_torch.viz import (concat_6_views, draw_boxes_on_views,
                                      visualize_map)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(REPO, "configs")


class Generation(NamedTuple):
    """What ``main`` made: the output directory, the pipeline, the
    validation dataset, the collated batch (numpy, without pixel_values),
    and per variant its latents
    (B, N, h, w, 4), its images (B, N, H, W, 3) in [0, 1] and the host-clock
    seconds of its request (the pipeline's call and the images' copy to
    the host)."""
    out_dir: str
    pipe: MagicDrivePipeline
    dataset: object
    batch: dict
    latents: List[torch.Tensor]
    images: List[np.ndarray]
    seconds: List[float]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m magicdrive_tpu_torch.cli.generate",
        description="Generate the validation samples of a trained run.")
    p.add_argument("--run_dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--indices", type=int, nargs="*", default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="override cfg seed")
    p.add_argument("--times", type=int, default=None,
                   help="variants per sample (default: "
                        "runner.validation_times)")
    p.add_argument("overrides", nargs="*")
    return p.parse_args(argv)


def load_pipeline(preset, weights_dir: str, device,
                  dtype) -> MagicDrivePipeline:
    """The preset's pipeline on ``device`` in ``dtype``, its modules loaded
    strictly from a run's ``weights/``."""
    sds = jax_params_to_state_dicts(load_params(weights_dir))
    modules = MagicDriveModules.create(preset, device=device)
    modules.load_state_dicts(sds).to(device, dtype)
    return MagicDrivePipeline(modules, preset.pipeline)


def variant_generator(seed: Optional[int], variant: int,
                      device) -> torch.Generator:
    """The generator of one variant: seeded from (seed, variant) by numpy's
    SeedSequence, so no two pairs share a stream."""
    state = np.random.SeedSequence(
        [0 if seed is None else seed, variant]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def collate_config(cfg) -> CollateConfig:
    return CollateConfig(
        template=cfg["dataset"]["template"],
        bbox_mode=cfg["model"]["bbox_mode"],
        bbox_max_len=cfg["runner"]["bbox_max_length"],
        canvas_hw=tuple(cfg["dataset"]["image_size"]), is_train=False)


def main(argv: Optional[Sequence[str]] = None, device=DEFAULT_DEVICE,
         dtype: torch.dtype = torch.bfloat16) -> Generation:
    args = parse_args(argv)
    device = resolve_device(device)
    overrides = load_run_overrides(args.run_dir) + list(args.overrides)
    cfg = compose(CONFIG_DIR, overrides=overrides)
    out_dir = args.out or os.path.join(args.run_dir, "generated")
    os.makedirs(out_dir, exist_ok=True)
    save_run_config(cfg, out_dir, overrides)

    preset = preset_from_config(cfg)
    pipe = load_pipeline(preset, os.path.join(args.run_dir, "weights"),
                         device, dtype)
    _, val_ds = build_datasets(cfg)
    indices = args.indices if args.indices is not None else \
        cfg["runner"]["validation_index"]
    seed = args.seed if args.seed is not None else cfg.get("seed")
    fix_within = bool(cfg.get("fix_seed_within_batch", False))
    times = args.times if args.times is not None else \
        int(cfg["runner"].get("validation_times", 1))

    dc = cfg["dataset"]
    samples = [val_ds[i] for i in indices]
    batch = collate_fn(samples, collate_config(cfg))
    batch.pop("pixel_values", None)  # generation takes no camera images
    # the model reads the static map channels (dataset.map_channels_used);
    # a rasterized nuScenes map also holds the object and aux channels
    batch["bev_map"] = batch["bev_map"][..., :dc["map_channels_used"]]
    made = Generation(out_dir, pipe, val_ds, batch, [], [], [])
    for ti in range(times):
        latents = pipe.prepare_latents(
            len(indices), variant_generator(seed, ti, device),
            fix_seed_within_batch=fix_within)
        t0 = time.perf_counter()
        imgs = pipe(batch, latents=latents).cpu().numpy()
        made.seconds.append(time.perf_counter() - t0)
        made.latents.append(latents)
        made.images.append(imgs)
        suffix = f"_t{ti}" if times > 1 else ""
        for bi, i in enumerate(indices):
            sample = samples[bi]
            rows = [concat_6_views(imgs[bi], oneline=True)]
            if cfg["runner"].get("validation_show_box"):
                boxed = draw_boxes_on_views(
                    imgs[bi], np.asarray(sample["boxes"]),
                    np.asarray(sample["labels"]),
                    np.asarray(sample["lidar2image"]),
                    np.asarray(sample["img_aug_matrix"]),
                    classes=dc["object_classes"]) / 255.0
                rows.append(concat_6_views(boxed, oneline=True))
            grid = np.concatenate(rows, axis=0)
            Image.fromarray((np.clip(grid, 0, 1) * 255).astype(np.uint8)
                            ).save(os.path.join(out_dir,
                                                f"{i}_gen{suffix}.png"))
            if ti == 0:
                Image.fromarray(visualize_map(
                    sample["bev_map"], dc["map_classes"],
                    dc["object_classes"])).save(
                    os.path.join(out_dir, f"{i}_map.png"))
            print(f"generated {i}{suffix} -> {out_dir} "
                  f"({made.seconds[-1]:.3f} s for the batch)")
    return made


if __name__ == "__main__":
    main()
