"""3D box projection and camera-image overlay (counterpart of
``viz/box_viz.py``; ref:magicdrive/runner/box_visualizer.py:24-114, drawn
with PIL instead of mmdet3d's cv2 visualize_camera).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

from magicdrive_tpu_torch.data.bbox import corners_from_boxes, project_to_image
from .map_viz import MAP_COLORS

# 12 edges of a box in mmdet3d corner order
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 7), (1, 6), (2, 5), (3, 4)]


def trans_boxes_to_view(boxes7: np.ndarray, lidar2image: np.ndarray,
                        img_aug_matrix: Optional[np.ndarray] = None,
                        proj: bool = True) -> Optional[np.ndarray]:
    """(N, 7) boxes -> (N, 8, 3) projected [u, v, sign(z)] for one view
    (ref:box_visualizer.py:24-60)."""
    if boxes7 is None or len(boxes7) == 0:
        return None
    corners = corners_from_boxes(boxes7)
    if not proj:
        return corners
    return project_to_image(corners, lidar2image, img_aug_matrix)


def trans_boxes_to_views(boxes7: np.ndarray,
                         lidar2images: Sequence[np.ndarray],
                         img_aug_matrices: Optional[Sequence] = None,
                         proj: bool = True) -> Optional[List]:
    """Per-view projections (ref:box_visualizer.py:63-87)."""
    if boxes7 is None or len(boxes7) == 0:
        return None
    augs = img_aug_matrices if img_aug_matrices is not None else \
        [None] * len(lidar2images)
    return [trans_boxes_to_view(boxes7, t, a, proj)
            for t, a in zip(lidar2images, augs)]


def draw_box_on_img(img01: np.ndarray, coords: Optional[np.ndarray],
                    labels: Optional[np.ndarray] = None,
                    classes: Optional[Sequence[str]] = None,
                    thickness: int = 2) -> np.ndarray:
    """Draw projected boxes on one (H, W, 3) [0,1] image; returns uint8.

    A box is drawn when any corner is in front of the camera (sign(z) > 0),
    matching the reference's visibility rule.
    """
    out = Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8))
    if coords is None:
        return np.asarray(out)
    draw = ImageDraw.Draw(out)
    for i, c in enumerate(coords):
        if not (c[:, 2] > 0).any():
            continue
        color = (0, 255, 0)
        if labels is not None and classes is not None and labels[i] >= 0:
            color = MAP_COLORS.get(classes[int(labels[i])], color)
        for a, b in _EDGES:
            if c[a, 2] > 0 or c[b, 2] > 0:
                draw.line([tuple(c[a, :2]), tuple(c[b, :2])],
                          fill=tuple(color), width=thickness)
    return np.asarray(out)


def draw_boxes_on_views(imgs01: np.ndarray, boxes7: np.ndarray,
                        labels: np.ndarray,
                        lidar2images: np.ndarray,
                        img_aug_matrices: Optional[np.ndarray] = None,
                        classes: Optional[Sequence[str]] = None) -> np.ndarray:
    """(N_cam, H, W, 3) [0,1] images + boxes -> (N_cam, H, W, 3) uint8."""
    per_view = trans_boxes_to_views(boxes7, lidar2images, img_aug_matrices)
    out = []
    for v in range(len(imgs01)):
        coords = None if per_view is None else per_view[v]
        out.append(draw_box_on_img(imgs01[v], coords, labels, classes))
    return np.stack(out)
