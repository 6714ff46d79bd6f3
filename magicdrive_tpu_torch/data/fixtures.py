"""Synthetic scenes for generation requests (counterpart of
``data/fixtures.py``).

Six cameras on a ring in the nuScenes rig order (FL, F, FR, BR, B, BL) with
pinhole intrinsics, labelled boxes scattered around the ego and a blocky BEV
map. ``make_sample(seed, with_images=...)`` draws the same scene as the JAX
package's ``make_sample`` with the same flag: generation needs no images,
training takes (N, H, W, 3) images in [-1, 1], drawn before the boxes.
"""
from __future__ import annotations

from typing import List

import numpy as np

# approximate azimuths (deg) of the nuScenes camera order
VIEW_AZIMUTH_DEG = (55.0, 0.0, -55.0, -110.0, 180.0, 110.0)
OBJECT_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)
MAP_CLASSES = (
    "drivable_area", "ped_crossing", "walkway", "stop_line", "carpark_area",
    "road_divider", "lane_divider", "road_block",
)


def camera_matrices(image_hw=(224, 400)):
    """Per view: (intrinsics K, camera2lidar, lidar2camera, lidar2image),
    each 4x4 float64."""
    h, w = image_hw
    f = 0.25 * 1266.0  # nuScenes focal length at the 0.25 resize
    K = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float64)
    cams = []
    for az in np.deg2rad(VIEW_AZIMUTH_DEG):
        # camera x right, y down, z forward (along the azimuth); lidar x
        # front, y left, z up
        fwd = np.array([np.cos(az), np.sin(az), 0.0])
        right = np.array([np.sin(az), -np.cos(az), 0.0])
        c2l = np.eye(4)
        c2l[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        c2l[:3, 3] = fwd * 1.5 + np.array([0, 0, 1.6])
        l2c = np.linalg.inv(c2l)
        cams.append((K, c2l, l2c, K @ l2c))
    return cams


def make_sample(seed: int = 0, image_hw=(224, 400), map_hw=(200, 200),
                map_channels: int = 8, n_boxes: int = 24,
                with_images: bool = False) -> dict:
    rng = np.random.default_rng(seed)
    cams = camera_matrices(image_hw)
    sample = {
        "camera_intrinsics": np.stack([c[0] for c in cams]),
        "camera2lidar": np.stack([c[1] for c in cams]),
        "lidar2camera": np.stack([c[2] for c in cams]),
        "lidar2image": np.stack([c[3] for c in cams]),
        "img_aug_matrix": np.stack([np.eye(4)] * len(cams)),
        "metas": {"location": "singapore-onenorth",
                  "description": "synthetic fixture scene with parked cars"},
    }
    if with_images:
        sample["img"] = rng.uniform(-1, 1, (len(cams), *image_hw, 3)).astype(
            np.float32)
    # boxes [x, y, z, dx, dy, dz, yaw] on the ground plane around the ego
    xy = rng.uniform(-40, 40, (n_boxes, 2))
    z = np.full((n_boxes, 1), -1.5)
    dims = rng.uniform([1.5, 3.5, 1.4], [2.2, 5.5, 2.2], (n_boxes, 3))
    yaw = rng.uniform(-np.pi, np.pi, (n_boxes, 1))
    sample["boxes"] = np.concatenate([xy, z, dims, yaw], axis=1)
    sample["labels"] = rng.integers(0, len(OBJECT_CLASSES), n_boxes)

    m = np.zeros((*map_hw, map_channels), np.float32)
    for c in range(map_channels):
        for _ in range(4):
            y0 = rng.integers(0, map_hw[0] - 20)
            x0 = rng.integers(0, map_hw[1] - 20)
            hgt, wdt = rng.integers(10, 60), rng.integers(10, 60)
            m[y0:y0 + hgt, x0:x0 + wdt, c] = 1.0
    sample["bev_map"] = m
    return sample


def make_dataset(n: int = 6, **kwargs) -> List[dict]:
    return [make_sample(seed=i, **kwargs) for i in range(n)]
