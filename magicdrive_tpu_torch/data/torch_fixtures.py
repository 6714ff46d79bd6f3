"""The reference's preprocessed demo fixtures (``.pth`` files) as samples
(counterpart of ``data/torch_fixtures.py``; FolderSetWrapper,
ref:magicdrive/dataset/dataset_wrapper.py:21-56).

Each file is a torch-saved dict in the demo format (ref:demo/readme.md):

    img (6, 3, 224, 400) | gt_bboxes_3d (N, 9) | gt_labels_3d (N,)
    gt_masks_bev (8, 200, 200) | camera_intrinsics / lidar2camera /
    img_aug_matrix (6, 4, 4) | metas {...}

converted to the sample contract of ``data/collate.py``: NHWC images, a
channel-last BEV map, 7-dim boxes, and camera2lidar = inv(lidar2camera),
lidar2image = K @ lidar2camera, as the reference reconstructs them.
"""
from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
import torch


def load_pth_sample(path: str) -> dict:
    raw = torch.load(path, map_location="cpu", weights_only=False)

    def arr(x):
        return x.numpy() if hasattr(x, "numpy") else np.asarray(x)

    K = arr(raw["camera_intrinsics"]).astype(np.float64)
    l2c = arr(raw["lidar2camera"]).astype(np.float64)
    boxes = arr(raw["gt_bboxes_3d"]).astype(np.float64)
    boxes = boxes.reshape(len(boxes), -1)[:, :7] if boxes.size else \
        np.zeros((0, 7))
    metas = dict(raw.get("metas", {}))
    metas.setdefault("location", "singapore-onenorth")
    metas.setdefault("description", "")
    return {
        "img": arr(raw["img"]).transpose(0, 2, 3, 1).astype(np.float32),
        "boxes": boxes,
        "labels": arr(raw["gt_labels_3d"]).astype(np.int64).reshape(-1),
        "bev_map": arr(raw["gt_masks_bev"]).transpose(1, 2, 0).astype(
            np.float32),
        "camera_intrinsics": K,
        "lidar2camera": l2c,
        "camera2lidar": np.linalg.inv(l2c),
        "lidar2image": K @ l2c,
        "img_aug_matrix": arr(raw["img_aug_matrix"]).astype(np.float64),
        "metas": metas,
    }


class FolderSetWrapper:
    """Dataset over a folder of demo ``.pth`` fixtures, in name order."""

    def __init__(self, folder: str):
        self.files: List[str] = sorted(glob.glob(os.path.join(folder,
                                                              "*.pth")))
        if not self.files:
            raise FileNotFoundError(f"no .pth fixtures under {folder}")

    def __len__(self):
        return len(self.files)

    def __getitem__(self, i: int) -> dict:
        return load_pth_sample(self.files[i])
