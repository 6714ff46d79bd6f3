"""Batches with static shapes (counterpart of ``data/collate.py``).

``collate_fn`` turns sample dicts (``fixtures.make_sample``) into the batch
``MagicDrivePipeline`` and the train step take: pixel_values (B, N, H, W, 3)
where the samples hold images, input_ids (B, 77), uncond_ids (1, 77),
camera_param (B, N, 3, 7), bev_map (B, H, W, C), bboxes (B, N, L, 8, 3),
classes (B, N, L) (-1 padding) and masks (B, N, L). Boxes are kept per view
where any corner lies in front of the camera, as 8 corners (the "all-xyz"
mode), padded or clipped to ``bbox_max_len``. Training-time augmentation,
the 4-corner mode, view-shared boxes and the canvas filter come later.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Sequence

import numpy as np

DEFAULT_TEMPLATE = "A driving scene image at {location}. {description}."
MAX_LENGTH = 77
BOS, EOS = 49406, 49407

# mmdet3d corner order of a unit box
_CORNER_NORM = np.array([
    (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
    (1, 1, 0), (1, 1, 1), (1, 0, 1), (1, 0, 0),
], dtype=np.float64)


@dataclasses.dataclass
class CollateConfig:
    template: str = DEFAULT_TEMPLATE
    bbox_max_len: int = 160


def tokenize(texts: Sequence[str]) -> np.ndarray:
    """Offline stand-in for the CLIP tokenizer with its framing: BOS, one
    id per lower-cased word, EOS, EOS padding to 77. Ids are a CRC32 of the
    word, so they are the same in every process."""
    out = np.full((len(texts), MAX_LENGTH), EOS, np.int32)
    for i, t in enumerate(texts):
        words = t.lower().split()[:MAX_LENGTH - 2]
        ids = [BOS] + [zlib.crc32(w.encode()) % 49000 + 300
                       for w in words] + [EOS]
        out[i, :len(ids)] = ids
    return out


def corners_from_boxes(boxes: np.ndarray, origin=(0.5, 0.5, 0.0)
                       ) -> np.ndarray:
    """(N, 7) boxes [x, y, z, dx, dy, dz, yaw] -> (N, 8, 3) corners."""
    center, dims, yaw = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
    corners = (_CORNER_NORM[None] - np.asarray(origin)) * dims[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    x = corners[..., 0] * c - corners[..., 1] * s
    y = corners[..., 0] * s + corners[..., 1] * c
    return np.stack([x, y, corners[..., 2]], axis=-1) + center[:, None]


def _in_front(corners: np.ndarray, lidar2camera: np.ndarray) -> np.ndarray:
    """Any corner with z > 0 in the camera frame."""
    z = corners @ lidar2camera[2, :3] + lidar2camera[2, 3]
    return (z > 0).any(axis=-1)


def _boxes(samples: Sequence[dict], L: int) -> Dict[str, np.ndarray]:
    B, N = len(samples), len(samples[0]["lidar2camera"])
    bboxes = np.zeros((B, N, L, 8, 3), np.float32)
    classes = -np.ones((B, N, L), np.int32)
    masks = np.zeros((B, N, L), np.float32)
    for b, s in enumerate(samples):
        boxes = np.asarray(s["boxes"], np.float64).reshape(-1, 7)
        if not len(boxes):
            continue
        labels = np.asarray(s["labels"]).reshape(-1)
        corners = corners_from_boxes(boxes)
        for v in range(N):
            idx = np.where(_in_front(corners, s["lidar2camera"][v]))[0][:L]
            bboxes[b, v, :len(idx)] = corners[idx]
            classes[b, v, :len(idx)] = labels[idx]
            masks[b, v, :len(idx)] = 1.0
    return {"bboxes": bboxes, "classes": classes, "masks": masks}


def collate_fn(samples: Sequence[dict], cfg: CollateConfig
               ) -> Dict[str, np.ndarray]:
    out = {}
    if "img" in samples[0]:
        out["pixel_values"] = np.stack([np.asarray(s["img"], np.float32)
                                        for s in samples])
    out["bev_map"] = np.stack([np.asarray(s["bev_map"], np.float32)
                               for s in samples])
    # camera_param = K[:3, :3] beside camera2lidar[:3, :4]
    out["camera_param"] = np.stack([np.concatenate(
        [np.asarray(s["camera_intrinsics"], np.float32)[:, :3, :3],
         np.asarray(s["camera2lidar"], np.float32)[:, :3, :4]], axis=-1)
        for s in samples])
    ids = tokenize([cfg.template.format(**s["metas"]) for s in samples]
                   + [""])
    out["input_ids"], out["uncond_ids"] = ids[:-1], ids[-1:]
    out.update(_boxes(samples, cfg.bbox_max_len))
    return out
