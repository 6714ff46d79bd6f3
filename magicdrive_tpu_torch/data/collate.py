"""Batches with static shapes (counterpart of ``data/collate.py``).

``collate_fn`` turns sample dicts (``fixtures.make_sample``, or
``nuscenes.NuScenesDataset`` items) into the batch ``MagicDrivePipeline``
and the train step take: pixel_values (B, N, H, W, 3) where the samples
hold images, input_ids (B, 77), uncond_ids (1, 77), camera_param
(B, N, 3, 7), bev_map (B, H, W, C), bboxes (B, N_out, L, P, 3), classes
(B, N_out, L) (-1 padding) and masks (B, N_out, L).

Boxes (ref:magicdrive/dataset/utils.py:253-352): per view, those any corner
of which lies in front of the camera (``use_3d_filter``) or projects onto
the canvas, or one view-shared set (N_out = 1); as 8 corners ("all-xyz") or
4 ("cxyz"); padded or clipped to a static ``bbox_max_len``. In training
(``is_train``), a sample loses all its boxes with ``bbox_drop_ratio`` and a
view gains up to ``bbox_add_num`` hidden ones with ``bbox_add_ratio``, drawn
from the caller's ``np.random.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

from .bbox import (corners_from_boxes, shift_origin, visible_mask_3d,
                   visible_mask_canvas)
from .caption import DEFAULT_TEMPLATE, HashTokenizer, tokenize_captions


@dataclasses.dataclass
class CollateConfig:
    template: str = DEFAULT_TEMPLATE
    bbox_mode: str = "all-xyz"       # all-xyz (8 pts) | cxyz (4 pts)
    bbox_max_len: int = 160
    bbox_view_shared: bool = False
    use_3d_filter: bool = True
    canvas_hw: tuple = (224, 400)
    is_train: bool = True
    # training augmentation (ref:configs/runner/default.yaml:2-4)
    bbox_drop_ratio: float = 0.0
    bbox_add_ratio: float = 0.0
    bbox_add_num: int = 0


# cxyz mode picks corners [x1y1z1, x1y0z1, x1y1z0, x0y1z1] of the mmdet3d
# order (ref:dataset/utils.py:210-212)
_CXYZ_IDX = (6, 5, 7, 2)


def _select_points(corners: np.ndarray, mode: str) -> np.ndarray:
    if mode == "all-xyz":
        return corners
    if mode == "cxyz":
        return corners[:, list(_CXYZ_IDX)]
    raise ValueError(mode)


def _view_masks(s: dict, boxes7: np.ndarray, cfg: CollateConfig,
                rng: np.random.Generator):
    """One visibility mask per view, filtered on the boxes' corners at the
    gravity-centre-shifted origin (ref box_center_shift)."""
    corners_c = corners_from_boxes(
        shift_origin(boxes7, (0.5, 0.5, 0.0), (0.5, 0.5, 0.0)),
        origin=(0.5, 0.5, 0.0))
    masks = []
    for v in range(len(s["lidar2image"])):
        if cfg.use_3d_filter:
            m = visible_mask_3d(corners_c, s["lidar2camera"][v])
        else:
            m = visible_mask_canvas(corners_c, s["lidar2image"][v],
                                    s["img_aug_matrix"][v], cfg.canvas_hw)
        if cfg.is_train and cfg.bbox_add_ratio > 0 and \
                rng.random() < cfg.bbox_add_ratio:
            hidden = np.where(~m)[0]
            rng.shuffle(hidden)
            m = m.copy()
            m[hidden[:cfg.bbox_add_num]] = True
        masks.append(m)
    return masks


def preprocess_bbox(samples: Sequence[dict], cfg: CollateConfig,
                    rng: Optional[np.random.Generator] = None
                    ) -> Dict[str, np.ndarray]:
    """bboxes (B, N_out, L, P, 3), classes (B, N_out, L) int32 (-1 pad),
    masks (B, N_out, L) float32."""
    rng = rng or np.random.default_rng()
    B = len(samples)
    N_out = 1 if cfg.bbox_view_shared else len(samples[0]["lidar2image"])
    L = cfg.bbox_max_len
    n_pts = 8 if cfg.bbox_mode == "all-xyz" else 4

    bboxes = np.zeros((B, N_out, L, n_pts, 3), np.float32)
    classes = -np.ones((B, N_out, L), np.int32)
    masks = np.zeros((B, N_out, L), np.float32)
    for b, s in enumerate(samples):
        arr = np.asarray(s["boxes"], np.float64)
        boxes7 = (arr.reshape(len(arr), -1)[:, :7] if arr.size
                  else np.zeros((0, 7)))  # velocity columns dropped
        labels = np.asarray(s["labels"], np.int64).reshape(-1)
        if len(boxes7) == 0 or (cfg.is_train and cfg.bbox_drop_ratio > 0
                                and rng.random() < cfg.bbox_drop_ratio):
            continue
        pts = _select_points(corners_from_boxes(boxes7), cfg.bbox_mode)
        view_masks = [np.ones(len(boxes7), bool)] if cfg.bbox_view_shared \
            else _view_masks(s, boxes7, cfg, rng)
        for v, m in enumerate(view_masks):
            idx = np.where(m)[0][:L]
            n = len(idx)
            bboxes[b, v, :n] = pts[idx]
            classes[b, v, :n] = labels[idx]
            masks[b, v, :n] = 1.0
    return {"bboxes": bboxes, "classes": classes, "masks": masks}


def collate_fn(samples: Sequence[dict], cfg: CollateConfig, tokenizer=None,
               rng: Optional[np.random.Generator] = None
               ) -> Dict[str, np.ndarray]:
    """A static-shape batch from per-frame sample dicts: img (N, H, W, 3)
    in [-1, 1] (optional), boxes (Nb, 7+), labels (Nb,), bev_map
    (H_m, W_m, C), camera_intrinsics, camera2lidar, lidar2camera,
    lidar2image and img_aug_matrix (N, 4, 4), metas {location,
    description}. ``tokenizer`` defaults to ``HashTokenizer``."""
    tokenizer = tokenizer or HashTokenizer()
    out: Dict[str, np.ndarray] = {}
    if "img" in samples[0]:
        out["pixel_values"] = np.stack([np.asarray(s["img"], np.float32)
                                        for s in samples])
    out["bev_map"] = np.stack([np.asarray(s["bev_map"], np.float32)
                               for s in samples])
    # camera_param = K[:3, :3] beside camera2lidar[:3, :4]
    # (ref:dataset/utils.py:294-297)
    out["camera_param"] = np.stack([np.concatenate(
        [np.asarray(s["camera_intrinsics"], np.float32)[:, :3, :3],
         np.asarray(s["camera2lidar"], np.float32)[:, :3, :4]], axis=-1)
        for s in samples])
    input_ids, uncond_ids = tokenize_captions(
        [s["metas"] for s in samples], tokenizer, cfg.template)
    out["input_ids"] = np.asarray(input_ids, np.int32)
    out["uncond_ids"] = np.asarray(uncond_ids, np.int32)
    out.update(preprocess_bbox(samples, cfg, rng))
    return out
