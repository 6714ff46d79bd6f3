"""Seeded multi-camera driving scenes in the layout the model reads.

Six cameras on a ring in the nuScenes rig order with pinhole intrinsics,
labelled 3D boxes scattered around the ego, a blocky BEV map of
``map_channels`` semantic layers and a caption of random word ids in the
CLIP framing. Each view keeps the boxes one of whose corners lies in front
of its camera, as 8 corners, padded to ``bbox_max_len`` (MagicDrive's
``use_3d_filter``). Training scenes carry images in [-1, 1].

The geometry follows ``magicdrive_tpu_torch/data/fixtures.py`` and
``data/collate.py``; this copy is the benchmark's, so that a change to the
program's data layer changes no request.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

VIEW_AZIMUTH_DEG = (55.0, 0.0, -55.0, -110.0, 180.0, 110.0)
N_CLASSES = 10
BOS, EOS, CONTEXT = 49406, 49407, 77
# mmdet3d's corner order
_CORNERS = np.array([(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
                     (1, 1, 0), (1, 1, 1), (1, 0, 1), (1, 0, 0)], np.float64)


def cameras(image_hw, n_cam: int = 6):
    """(camera_param (N, 3, 7): K beside camera2lidar[:3], lidar2camera
    (N, 4, 4))."""
    h, w = image_hw
    f = 0.25 * 1266.0 * w / 400.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    params, l2c = [], []
    for az in np.deg2rad(VIEW_AZIMUTH_DEG[:n_cam]):
        fwd = np.array([np.cos(az), np.sin(az), 0.0])
        right = np.array([np.sin(az), -np.cos(az), 0.0])
        c2l = np.eye(4)
        c2l[:3, :3] = np.stack([right, [0.0, 0.0, -1.0], fwd], axis=1)
        c2l[:3, 3] = fwd * 1.5 + np.array([0, 0, 1.6])
        params.append(np.concatenate([K, c2l[:3]], axis=1))
        l2c.append(np.linalg.inv(c2l))
    return np.stack(params).astype(np.float32), np.stack(l2c)


def corners(boxes: np.ndarray) -> np.ndarray:
    """(n, 7) [x, y, z, dx, dy, dz, yaw], bottom-centred -> (n, 8, 3)."""
    c = (_CORNERS[None] - np.array([0.5, 0.5, 0.0])) * boxes[:, None, 3:6]
    cos, sin = np.cos(boxes[:, 6:7]), np.sin(boxes[:, 6:7])
    x = c[..., 0] * cos - c[..., 1] * sin
    y = c[..., 0] * sin + c[..., 1] * cos
    return np.stack([x, y, c[..., 2]], -1) + boxes[:, None, :3]


def scene(rng: np.random.Generator, p: dict) -> Dict[str, np.ndarray]:
    """One sample: camera_param (N, 3, 7), bev_map (H, W, C), bboxes
    (N, L, 8, 3), classes (N, L) (-1 padding), masks (N, L), input_ids
    (77,)."""
    cam, l2c = cameras(p["image_hw"], p["n_cam"])
    n = int(rng.integers(p["boxes"][0], p["boxes"][1] + 1))
    xy = rng.uniform(-50, 50, (n, 2))
    dims = rng.uniform([1.5, 3.5, 1.4], [2.2, 5.5, 2.2], (n, 3))
    boxes = np.concatenate([xy, np.full((n, 1), -1.5), dims,
                            rng.uniform(-np.pi, np.pi, (n, 1))], axis=1)
    labels = rng.integers(0, N_CLASSES, n)
    pts = corners(boxes)
    L = p["bbox_max_len"]
    N = len(cam)
    bboxes = np.zeros((N, L, 8, 3), np.float32)
    classes = -np.ones((N, L), np.int64)
    masks = np.zeros((N, L), np.float32)
    for v in range(N):
        ph = np.concatenate([pts, np.ones((*pts.shape[:2], 1))], -1)
        z = (ph @ l2c[v].T)[..., 2]
        idx = np.where((z > 0).any(-1))[0][:L]
        bboxes[v, :len(idx)] = pts[idx]
        classes[v, :len(idx)] = labels[idx]
        masks[v, :len(idx)] = 1.0
    mh, mw = p["map_hw"]
    m = np.zeros((mh, mw, p["map_channels"]), np.float32)
    for c in range(p["map_channels"]):
        for _ in range(4):
            y0 = rng.integers(0, mh - mh // 10)
            x0 = rng.integers(0, mw - mw // 10)
            hh, ww = rng.integers(mh // 20, mh * 3 // 10, size=2)
            m[y0:y0 + hh, x0:x0 + ww, c] = 1.0
    words = int(rng.integers(p["words"][0], p["words"][1] + 1))
    ids = np.full(CONTEXT, EOS, np.int64)
    ids[0] = BOS
    ids[1:1 + words] = rng.integers(300, 49300, words)
    return {"camera_param": cam, "bev_map": m, "bboxes": bboxes,
            "classes": classes, "masks": masks, "input_ids": ids}


def batch(seed: int, index: int, size: int, p: dict,
          images: bool = False) -> Dict[str, np.ndarray]:
    """Request or step ``index`` of a run seeded ``seed``: ``size`` scenes
    stacked, the null prompt, and with ``images`` (B, N, H, W, 3) in
    [-1, 1]."""
    rng = np.random.default_rng([seed % (1 << 64), index])
    scenes = [scene(rng, p) for _ in range(size)]
    out = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    uncond = np.full((1, CONTEXT), EOS, np.int64)
    uncond[0, 0] = BOS
    out["uncond_ids"] = uncond
    if images:
        h, w = p["image_hw"]
        out["pixel_values"] = rng.uniform(
            -1, 1, (size, p["n_cam"], h, w, 3)).astype(np.float32)
    return out


def shape_params(config: dict, traffic: dict) -> dict:
    """The generator's parameters: sizes from the configuration, counts
    from the traffic mix."""
    return {"image_hw": tuple(config["image_size"]),
            "n_cam": config["pipeline"]["n_cam"],
            "map_hw": tuple(config["map_hw"]),
            "map_channels": config["map_channels"],
            "bbox_max_len": config["bbox_max_len"],
            "boxes": tuple(traffic.get("boxes", (10, 60))),
            "words": tuple(traffic.get("words", (6, 20)))}


def to_tensors(b: Dict[str, np.ndarray], device):
    """The batch on ``device``: ids and classes int64, the rest float32."""
    import torch

    ints = ("input_ids", "uncond_ids", "classes")
    return {k: torch.as_tensor(v, device=device,
                               dtype=torch.long if k in ints
                               else torch.float32)
            for k, v in b.items()}
