"""3D box geometry in numpy (counterpart of ``data/bbox.py``): the mmdet3d
``LiDARInstance3DBoxes`` subset the data path uses — corners, the
camera-frame and canvas visibility filters, projection, the BEV range
filter and the yaw wrap (ref:magicdrive/runner/box_visualizer.py:24-87,
ref:magicdrive/dataset/utils.py:52-74).

Box format: (N, 7+) float arrays ``[x, y, z, dx, dy, dz, yaw(, vx, vy)]`` in
the lidar frame. The origin convention (where (x,y,z) sits inside the box) is
explicit per call; the reference stores boxes with origin (0.5, 0.5, 0)
(bottom center, ref:magicdrive/dataset/nuscenes_dataset.py:236-238).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# mmdet3d corner ordering: unravel_index(arange(8), [2,2,2])[[0,1,3,2,6,7,5,4]]
_CORNER_NORM = np.array([
    (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
    (1, 1, 0), (1, 1, 1), (1, 0, 1), (1, 0, 0),
], dtype=np.float64)


def corners_from_boxes(boxes: np.ndarray,
                       origin: Tuple[float, float, float] = (0.5, 0.5, 0.0)
                       ) -> np.ndarray:
    """(N, 7) boxes -> (N, 8, 3) corners in mmdet3d LiDAR order."""
    boxes = np.asarray(boxes, np.float64)
    if boxes.size == 0:
        return np.zeros((0, 8, 3))
    center, dims, yaw = boxes[:, :3], boxes[:, 3:6], boxes[:, 6]
    corners = (_CORNER_NORM[None] - np.asarray(origin)) * dims[:, None]
    c, s = np.cos(yaw), np.sin(yaw)
    # CCW rotation around z (mmdet3d rotation_3d_in_axis, axis=2)
    x = corners[..., 0] * c[:, None] - corners[..., 1] * s[:, None]
    y = corners[..., 0] * s[:, None] + corners[..., 1] * c[:, None]
    out = np.stack([x, y, corners[..., 2]], axis=-1)
    return out + center[:, None]


def shift_origin(boxes: np.ndarray, src=(0.5, 0.5, 0.0),
                 dst=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Move the box center reference point (ref box_center_shift)."""
    boxes = np.array(boxes, np.float64, copy=True)
    delta = np.asarray(dst) - np.asarray(src)
    # only the z convention differs in practice; the shift is along box axes,
    # but for (0.5,0.5,0)->(0.5,0.5,0.5) it is purely vertical (z is unrotated)
    boxes[:, :3] = boxes[:, :3] + delta * boxes[:, 3:6]
    return boxes


def transform_points(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (..., 3) points."""
    shape = points.shape
    p = points.reshape(-1, 3)
    p = np.concatenate([p, np.ones((len(p), 1))], axis=-1)
    p = p @ np.asarray(matrix, np.float64).T
    return p[:, :3].reshape(shape)


def project_to_image(corners: np.ndarray, lidar2image: np.ndarray,
                     img_aug_matrix: np.ndarray | None = None) -> np.ndarray:
    """(N, 8, 3) lidar corners -> (N, 8, 3) [u, v, sign(z)] image coords.

    Matches ref:box_visualizer.py:49-87: combined transform
    ``aug @ lidar2image``, z clipped to [1e-5, 1e5] before division, third
    component replaced with sign(z).
    """
    trans = np.asarray(lidar2image, np.float64)
    if img_aug_matrix is not None:
        trans = np.asarray(img_aug_matrix, np.float64) @ trans
    p = transform_points(corners, trans)
    z = p[..., 2]
    zc = np.clip(z, 1e-5, 1e5)
    return np.stack([p[..., 0] / zc, p[..., 1] / zc, np.sign(z)], axis=-1)


def visible_mask_3d(corners: np.ndarray, lidar2camera: np.ndarray) -> np.ndarray:
    """Default visibility filter: any corner has z > 0 in the camera frame
    (ref:dataset/utils.py:72-74 with lidar2camera transform, no projection)."""
    cam = transform_points(corners, lidar2camera)
    return (cam[..., 2] > 0).any(axis=-1)


def in_range_bev(boxes: np.ndarray, bev_range) -> np.ndarray:
    """mmdet3d in_range_bev: box center (x, y) within [xmin, ymin, xmax, ymax]
    (ObjectRangeFilterM, ref:magicdrive/dataset/pipeline.py:334-383)."""
    b = np.asarray(boxes)
    if b.size == 0:
        return np.zeros((0,), bool)
    xmin, ymin, xmax, ymax = bev_range
    return ((b[:, 0] > xmin) & (b[:, 1] > ymin)
            & (b[:, 0] < xmax) & (b[:, 1] < ymax))


def limit_yaw(boxes: np.ndarray, offset: float = 0.5,
              period: float = 2 * np.pi) -> np.ndarray:
    """mmdet3d limit_yaw: wrap yaw into [-offset*period, (1-offset)*period)."""
    out = np.array(boxes, copy=True)
    if out.size:
        out[:, 6] = out[:, 6] - np.floor(out[:, 6] / period + offset) * period
    return out


def object_range_filter(sample: dict, point_cloud_range) -> dict:
    """ObjectRangeFilterM on a sample dict: BEV-range filter + yaw wrap,
    consistently applied to boxes/labels/visibility."""
    bev_range = [point_cloud_range[0], point_cloud_range[1],
                 point_cloud_range[3], point_cloud_range[4]]
    mask = in_range_bev(sample["boxes"], bev_range)
    out = dict(sample)
    out["boxes"] = limit_yaw(np.asarray(sample["boxes"])[mask])
    out["labels"] = np.asarray(sample["labels"])[mask]
    if "visibility" in out:
        out["visibility"] = np.asarray(sample["visibility"])[mask]
    return out


def visible_mask_canvas(corners: np.ndarray, lidar2image: np.ndarray,
                        img_aug_matrix: np.ndarray,
                        canvas_hw: Tuple[int, int]) -> np.ndarray:
    """2D filter: any projected corner inside the canvas with z > 0
    (ref:dataset/utils.py:52-69)."""
    h, w = canvas_hw
    # the reference projects boxes shifted to gravity-center origin
    coords = project_to_image(corners, lidar2image, img_aug_matrix)
    c = (coords[..., 2] > 0).any(axis=-1)
    wm = ((coords[..., 0] > 0) & (coords[..., 0] < w)).any(axis=-1)
    hm = ((coords[..., 1] > 0) & (coords[..., 1] < h)).any(axis=-1)
    return c & wm & hm
