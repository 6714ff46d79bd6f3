"""GlobalRotScaleTrans (counterpart of ``data/rot_scale_trans.py``): a
global rotation about +z, scaling and translation of a sample's 3D frame.

The reference names this op in every training pipeline
(ref:configs/dataset/Nuscenes.yaml:112-116) with identity ranges; its
semantics, as the JAX package reconstructs them from its consumers:
  * the boxes move into the augmented frame: centres rotated, scaled and
    translated, yaw += angle, sizes *= scale;
  * the sample records the 4x4 ``lidar_aug_matrix`` (lidar -> augmented);
    the BEV map is rasterized at ``lidar2global @ inv(lidar_aug_matrix)``
    (ref:magicdrive/dataset/pipeline.py:249-253), so the static layers land
    in the augmented frame too;
  * camera2lidar maps into the augmented frame, and lidar2camera and
    lidar2image follow.

Runs on the sample dicts of ``nuscenes.NuScenesDataset`` before the map is
rasterized.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def rot_scale_trans_matrix(angle: float, scale: float,
                           trans: np.ndarray) -> np.ndarray:
    """4x4 lidar->augmented transform: x' = scale * Rz(angle) x + trans."""
    c, s = np.cos(angle), np.sin(angle)
    m = np.eye(4)
    m[:3, :3] = scale * np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    m[:3, 3] = np.asarray(trans, np.float64)
    return m


def transform_boxes(boxes: np.ndarray, angle: float, scale: float,
                    trans: np.ndarray) -> np.ndarray:
    """Apply rot/scale/trans to (N, 7[+2]) lidar boxes
    (x y z w l h yaw [vx vy])."""
    out = np.asarray(boxes, np.float64).copy()
    if len(out) == 0:
        return out
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    out[:, :2] = out[:, :2] @ rot.T
    out[:, :3] = out[:, :3] * scale + np.asarray(trans, np.float64)
    out[:, 3:6] *= scale
    out[:, 6] += angle
    if out.shape[1] > 7:  # velocities rotate & scale, no translation
        out[:, 7:9] = (out[:, 7:9] @ rot.T) * scale
    return out


def apply_rot_scale_trans(sample: dict, angle: float, scale: float,
                          trans: Sequence[float]) -> dict:
    """Transform one sample dict; returns a new dict (inputs unmodified)."""
    s = dict(sample)
    trans = np.asarray(trans, np.float64)
    aug = rot_scale_trans_matrix(angle, scale, trans)
    if "boxes" in s:
        s["boxes"] = transform_boxes(np.asarray(s["boxes"]), angle, scale,
                                     trans)
    prev = np.asarray(s.get("lidar_aug_matrix", np.eye(4)))
    s["lidar_aug_matrix"] = aug @ prev
    if "camera2lidar" in s:
        # cameras now map into the augmented frame
        c2l = aug[None] @ np.asarray(s["camera2lidar"])
        s["camera2lidar"] = c2l
        l2c = np.linalg.inv(c2l)
        s["lidar2camera"] = l2c
        if "camera_intrinsics" in s:
            s["lidar2image"] = np.asarray(s["camera_intrinsics"]) @ l2c
    return s


class GlobalRotScaleTrans:
    """Callable transform with the reference's config knobs (resize_lim /
    rot_lim / trans_lim, ref:configs/dataset/Nuscenes.yaml:112-116)."""

    def __init__(self, resize_lim: Tuple[float, float] = (1.0, 1.0),
                 rot_lim: Tuple[float, float] = (0.0, 0.0),
                 trans_lim: float = 0.0, is_train: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.resize_lim = tuple(resize_lim)
        self.rot_lim = tuple(rot_lim)
        self.trans_lim = float(trans_lim)
        self.is_train = is_train
        self.rng = rng or np.random.default_rng()

    @property
    def is_identity(self) -> bool:
        return (self.resize_lim == (1.0, 1.0) and self.rot_lim == (0.0, 0.0)
                and self.trans_lim == 0.0)

    def __call__(self, sample: dict) -> dict:
        if not self.is_train or self.is_identity:
            return sample
        angle = float(self.rng.uniform(*self.rot_lim))
        scale = float(self.rng.uniform(*self.resize_lim))
        trans = self.rng.normal(scale=self.trans_lim, size=3) \
            if self.trans_lim > 0 else np.zeros(3)
        return apply_rot_scale_trans(sample, angle, scale, trans)
