"""Scene editing and generation (counterpart of ``tools/interactive_gui.py``;
ref:demo/interactive_gui.py).

:class:`InteractiveSession` holds an editable fixture scene: move, rotate,
add or delete its 3D boxes, set its caption, render its BEV map and
generate its 6 views, from a notebook or a REPL. The JAX tool's gradio UI
(``launch_gui``) is not ported: gradio is not installed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from magicdrive_tpu_torch.cli.demo import build_pipeline
from magicdrive_tpu_torch.data.collate import CollateConfig, collate_fn
from magicdrive_tpu_torch.data.fixtures import (MAP_CLASSES, OBJECT_CLASSES,
                                                make_sample)
from magicdrive_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from magicdrive_tpu_torch.viz import visualize_map


class InteractiveSession:
    """Editable scene state and generation (ref:interactive_gui.py:22-103):
    fixture scene 0 of the 224x400 model in bf16 (``tiny``: ``tiny_debug``
    in fp32), its modules from a run's ``weights/`` or at PyTorch's initial
    values, on the card unless ``device="cpu"``."""

    def __init__(self, weights: Optional[str] = None, tiny: bool = False,
                 steps: Optional[int] = None, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.preset, self.pipe = build_pipeline(weights, tiny, steps,
                                                self.device)
        p = self.preset
        self.ccfg = CollateConfig(bbox_max_len=p.bbox_max_len,
                                  canvas_hw=p.image_size, is_train=False)
        self.sample = make_sample(0, image_hw=p.image_size, map_hw=p.map_hw,
                                  map_channels=p.map_channels,
                                  with_images=True)

    # ---- box edits ----
    def move_box(self, idx: int, dx: float = 0.0, dy: float = 0.0,
                 dyaw: float = 0.0):
        b = np.asarray(self.sample["boxes"]).copy()
        b[idx, 0] += dx
        b[idx, 1] += dy
        b[idx, 6] += dyaw
        self.sample["boxes"] = b

    def delete_box(self, idx: int):
        keep = np.arange(len(self.sample["boxes"])) != idx
        self.sample["boxes"] = np.asarray(self.sample["boxes"])[keep]
        self.sample["labels"] = np.asarray(self.sample["labels"])[keep]

    def add_box(self, x, y, yaw=0.0, cls=0, dims=(1.9, 4.5, 1.7)):
        self.sample["boxes"] = np.concatenate(
            [np.asarray(self.sample["boxes"]).reshape(-1, 7),
             [[x, y, -1.5, *dims, yaw]]])
        self.sample["labels"] = np.concatenate(
            [np.asarray(self.sample["labels"]), [cls]])

    def set_caption(self, location: str, description: str):
        self.sample["metas"] = {"location": location,
                                "description": description}

    # ---- render ----
    def map_image(self) -> np.ndarray:
        return visualize_map(self.sample["bev_map"], MAP_CLASSES,
                             OBJECT_CLASSES)

    def generate(self, seed: int = 42) -> np.ndarray:
        """The scene's 6 views, (N, H, W, 3) in [0, 1], from a
        ``torch.Generator`` seeded with ``seed``."""
        batch = collate_fn([self.sample], self.ccfg)
        batch.pop("pixel_values", None)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.pipe(batch, generator=gen)[0].cpu().numpy()
