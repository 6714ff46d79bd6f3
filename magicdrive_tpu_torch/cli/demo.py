"""Demo generation without nuScenes (counterpart of ``tools/demo.py``;
ref:demo/run.py + run_cond_on_view.py).

    python -m magicdrive_tpu_torch.cli.demo --weights RUN/weights
    python -m magicdrive_tpu_torch.cli.demo --weights W --given_view 1
    python -m magicdrive_tpu_torch.cli.demo --tiny --steps 4 (on the CPU)

Runs the 224x400 model (or ``tiny_debug``) on the synthetic fixture
scenes: ``sample{i}_gen.png`` is the 2x3 sheet of the 6 generated views
(with ``--given_view V`` the scene's view V is given and the others are
generated from it), ``sample{i}_map.png`` the scene's BEV map.
``--weights`` is a run's ``weights/`` directory; without it the modules
keep PyTorch's initial values. Sample i's latents come from a
``torch.Generator`` seeded from (seed, i) by numpy's SeedSequence.

The model runs in bf16, or fp32 with ``--tiny``, as the JAX package's tool
builds it, on the card unless ``main(argv, device="cpu")``; the kernels
take only bf16, so ``--tiny`` needs the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from magicdrive_tpu_torch.cli.generate import variant_generator
from magicdrive_tpu_torch.config import (ModelPreset, sd15mv_rawbox_224x400,
                                         tiny_debug)
from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
from magicdrive_tpu_torch.data.collate import CollateConfig, collate_fn
from magicdrive_tpu_torch.data.fixtures import (MAP_CLASSES, OBJECT_CLASSES,
                                                make_dataset)
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.pipeline.given_view import GivenViewPipeline
from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
from magicdrive_tpu_torch.utils.serialization import load_params
from magicdrive_tpu_torch.viz import concat_6_views, visualize_map


class Demo(NamedTuple):
    """The output directory, the pipeline and each sample's images
    (1, N, H, W, 3) in [0, 1]."""
    out_dir: str
    pipe: GivenViewPipeline
    images: List[np.ndarray]


def build_pipeline(weights: Optional[str], tiny: bool, steps: Optional[int],
                   device) -> Tuple[ModelPreset, GivenViewPipeline]:
    """The demo's preset and pipeline: the 224x400 preset in bf16 or
    ``tiny_debug`` in fp32, ``steps`` UniPC steps, the modules from a run's
    ``weights/`` or at PyTorch's initial values."""
    preset = tiny_debug() if tiny else sd15mv_rawbox_224x400()
    if steps:
        preset = dataclasses.replace(preset, pipeline=dataclasses.replace(
            preset.pipeline, num_inference_steps=steps))
    dtype = torch.float32 if tiny else torch.bfloat16
    modules = MagicDriveModules.create(preset, device=device)
    if weights:
        modules.load_state_dicts(jax_params_to_state_dicts(
            load_params(weights)))
    return preset, GivenViewPipeline(modules.to(device, dtype),
                                     preset.pipeline)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m magicdrive_tpu_torch.cli.demo",
        description="Generate the synthetic fixture scenes.")
    p.add_argument("--out", default="demo_out")
    p.add_argument("--weights", default=None,
                   help="a run's weights dir (initial values if omitted)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--n_samples", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--given_view", type=int, default=None,
                   help="condition on this view's image")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None, device=DEFAULT_DEVICE) -> Demo:
    args = parse_args(argv)
    device = resolve_device(device)
    preset, pipe = build_pipeline(args.weights, args.tiny, args.steps,
                                  device)
    os.makedirs(args.out, exist_ok=True)
    ccfg = CollateConfig(bbox_max_len=preset.bbox_max_len,
                         canvas_hw=preset.image_size, is_train=False)
    samples = make_dataset(args.n_samples, image_hw=preset.image_size,
                           map_hw=preset.map_hw,
                           map_channels=preset.map_channels,
                           with_images=True)
    made = Demo(args.out, pipe, [])
    for i, sample in enumerate(samples):
        batch = collate_fn([sample], ccfg)
        px = batch.pop("pixel_values")
        given, mask = None, None
        if args.given_view is not None:
            given = pipe.encode_views(px)
            mask = np.zeros(pipe.cfg.n_cam, np.float32)
            mask[args.given_view] = 1.0
        imgs = pipe(batch, given, mask,
                    generator=variant_generator(args.seed, i, device)
                    ).cpu().numpy()
        made.images.append(imgs)
        sheet = concat_6_views(imgs[0])
        Image.fromarray((np.clip(sheet, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(args.out, f"sample{i}_gen.png"))
        Image.fromarray(visualize_map(
            sample["bev_map"], MAP_CLASSES, OBJECT_CLASSES)).save(
            os.path.join(args.out, f"sample{i}_map.png"))
        print(f"sample {i} -> {args.out}")
    return made


if __name__ == "__main__":
    main()
