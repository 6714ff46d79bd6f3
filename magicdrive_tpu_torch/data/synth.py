"""A synthetic mini-nuScenes tree on disk (counterpart of
``data/synth.py``).

Writes the v1.0 JSON tables, a map-expansion JSON and camera JPEGs in the
layout of the real dataset, file for file as the JAX package's
``make_mini_nuscenes`` does: a reproducible stand-in for real nuScenes for
the data-layer tests and the generation CLI's run in ``chip_smoke.py``.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Tuple

import numpy as np
from PIL import Image

from .nuscenes import ORI_CAMERA_ORDER

LOCATION = "singapore-onenorth"


def _yaw_quat(yaw: float):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def make_mini_nuscenes(root, n_samples: int = 3, n_boxes: int = 4,
                       version: str = "v1.0-mini",
                       image_hw: Tuple[int, int] = (900, 1600),
                       location: str = LOCATION,
                       images_per_sample: bool = False) -> Tuple[str, str]:
    """Build the synthetic tree under ``root``; returns (root, version).

    ``images_per_sample=False`` reuses one JPEG per camera across samples
    (enough for correctness tests); ``True`` writes a distinct JPEG per
    (sample, camera) so loader benchmarks see a cold page cache per file.
    """
    root = str(root)
    os.makedirs(os.path.join(root, version), exist_ok=True)
    os.makedirs(os.path.join(root, "maps", "expansion"), exist_ok=True)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)

    # ---- map expansion: one drivable polygon + one divider line ----
    nodes, polys = [], []
    sq = [(900, 900), (1100, 900), (1100, 1100), (900, 1100)]
    for i, (x, y) in enumerate(sq):
        nodes.append({"token": f"n{i}", "x": float(x), "y": float(y)})
    line_pts = [(950, 1000), (1050, 1000)]
    for i, (x, y) in enumerate(line_pts):
        nodes.append({"token": f"ln{i}", "x": float(x), "y": float(y)})
    polys.append({"token": "p0",
                  "exterior_node_tokens": [f"n{i}" for i in range(4)],
                  "holes": []})
    map_json = {
        "node": nodes, "polygon": polys,
        "line": [{"token": "l0", "node_tokens": ["ln0", "ln1"]}],
        "drivable_area": [{"token": "da0", "polygon_tokens": ["p0"]}],
        "ped_crossing": [], "walkway": [], "stop_line": [],
        "carpark_area": [], "road_block": [], "road_segment": [], "lane": [],
        "road_divider": [{"token": "rd0", "line_token": "l0"}],
        "lane_divider": [],
    }
    with open(os.path.join(root, "maps", "expansion",
                           f"{location}.json"), "w") as f:
        json.dump(map_json, f)

    # ---- camera images ----
    def write_jpeg(fn, seed):
        # Low-frequency content (small random field upscaled): compresses to
        # ~150 KB at 1600x900 like real nuScenes camera JPEGs. Pure noise
        # compresses to ~850 KB and makes entropy decode 5x slower than any
        # real image, which would distort the loader throughput bench.
        small = np.random.default_rng(seed).integers(
            0, 255, (max(2, image_hw[0] // 25), max(2, image_hw[1] // 25), 3),
            np.uint8)
        Image.fromarray(small).resize(
            (image_hw[1], image_hw[0]), Image.BICUBIC).save(
                os.path.join(root, fn))

    cam_files = {}
    if not images_per_sample:
        for cam in ORI_CAMERA_ORDER:
            fn = f"samples/{cam}.jpg"
            write_jpeg(fn, 0)
            cam_files[cam] = fn

    # ---- JSON tables ----
    K = [[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]]
    calib = [{"token": "cs_lidar", "rotation": [1, 0, 0, 0],
              "translation": [0.9, 0.0, 1.8], "camera_intrinsic": []}]
    cam_azimuth = {"CAM_FRONT": 0.0, "CAM_FRONT_RIGHT": -55.0,
                   "CAM_FRONT_LEFT": 55.0, "CAM_BACK": 180.0,
                   "CAM_BACK_LEFT": 110.0, "CAM_BACK_RIGHT": -110.0}
    for cam, az in cam_azimuth.items():
        a = np.deg2rad(az)
        fwd = np.array([np.cos(a), np.sin(a), 0.0])
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        R = np.stack([right, down, fwd], axis=1)
        # rotation matrix -> quaternion (w, x, y, z)
        w = np.sqrt(max(0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
        x = (R[2, 1] - R[1, 2]) / (4 * w + 1e-12)
        y = (R[0, 2] - R[2, 0]) / (4 * w + 1e-12)
        z = (R[1, 0] - R[0, 1]) / (4 * w + 1e-12)
        calib.append({"token": f"cs_{cam}", "rotation": [w, x, y, z],
                      "translation": (fwd * 1.5 + [0, 0, 1.6]).tolist(),
                      "camera_intrinsic": K})

    ego_poses, sample_datas, samples, anns = [], [], [], []
    for si in range(n_samples):
        yaw = 0.3 * si
        pos = [1000.0 + 5 * si, 1000.0, 0.0]
        ego_poses.append({"token": f"ep{si}", "rotation": _yaw_quat(yaw),
                          "translation": pos, "timestamp": 1000000 * si})
        sample_datas.append({
            "token": f"sd_lidar{si}", "sample_token": f"s{si}",
            "calibrated_sensor_token": "cs_lidar", "ego_pose_token": f"ep{si}",
            "filename": f"samples/LIDAR_TOP_{si}.bin", "prev": "", "next": ""})
        for cam in ORI_CAMERA_ORDER:
            if images_per_sample:
                fn = f"samples/{cam}_{si}.jpg"
                # a CRC32 seed, the same in every process (the JAX tree
                # seeds with Python's salted hash)
                write_jpeg(fn, si * 100 + zlib.crc32(cam.encode()) % 97)
            else:
                fn = cam_files[cam]
            sample_datas.append({
                "token": f"sd_{cam}{si}", "sample_token": f"s{si}",
                "calibrated_sensor_token": f"cs_{cam}",
                "ego_pose_token": f"ep{si}", "filename": fn,
                "prev": "", "next": ""})
        ann_tokens = []
        for bi in range(n_boxes):
            tok = f"a{si}_{bi}"
            ann_tokens.append(tok)
            anns.append({
                "token": tok, "sample_token": f"s{si}",
                "translation": [1000.0 + 8 + 4 * bi, 1000.0 + 2 * bi, 0.9],
                "size": [1.9, 4.5, 1.7],
                "rotation": _yaw_quat(0.1 * bi),
                "category_token": "cat_car" if bi % 2 == 0 else "cat_ped",
                "num_lidar_pts": 10, "num_radar_pts": 2,
                "visibility_token": "4", "prev": "", "next": "",
            })
        samples.append({"token": f"s{si}", "scene_token": "sc0",
                        "timestamp": 1000000 * si, "anns": ann_tokens,
                        "prev": "", "next": ""})

    tables = {
        "sample": samples,
        "sample_data": sample_datas,
        "calibrated_sensor": calib,
        "ego_pose": ego_poses,
        "scene": [{"token": "sc0", "log_token": "log0", "name": "scene-0001",
                   "description": "synthetic mini scene"}],
        "log": [{"token": "log0", "location": location,
                 "logfile": "n008-2018-08-01-15-16-36-0400"}],
        "sample_annotation": anns,
        "category": [{"token": "cat_car", "name": "vehicle.car"},
                     {"token": "cat_ped",
                      "name": "human.pedestrian.adult"}],
    }
    for name, recs in tables.items():
        with open(os.path.join(root, version, f"{name}.json"), "w") as f:
            json.dump(recs, f)
    return root, version
