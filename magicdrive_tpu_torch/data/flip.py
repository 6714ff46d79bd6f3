"""RandomFlip3DwithViews (counterpart of ``data/flip.py``;
ref:magicdrive/dataset/pipeline.py:508-715): one flip of a sample's boxes,
BEV map, images and extrinsics, with the camera reordering that keeps the
view ring consistent.

On the sample dicts of ``nuscenes.NuScenesDataset`` (NHWC images (N, H, W,
3), channel-last bev_map (H, W, C), 7-dim lidar boxes), already in the view
order (FL, F, FR, BR, B, BL). "vertical" flips x (a left-right swap of the
scene), "horizontal" flips y (a front-back swap). The released configs
train with flip_ratio 0.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# the view reorder of a flip, for samples in the view order (the reference
# gives it in the converter's order, ref:pipeline.py:533-535): left<->right
# for vertical, front<->back for horizontal
VERTICAL_ORDER_VIEW = [2, 1, 0, 5, 4, 3]    # FL<->FR, BR<->BL
HORIZONTAL_ORDER_VIEW = [5, 4, 3, 2, 1, 0]  # FL<->BL, F<->B, FR<->BR

IMG_ORI_SIZE = (1600, 900)

_FLIP_X = np.diag([-1.0, 1.0, 1.0, 1.0])
_FLIP_Y = np.diag([1.0, -1.0, 1.0, 1.0])
_FLIP_NEW_Y_ROT180 = np.diag([1.0, -1.0, 1.0, 1.0]) @ np.diag(
    [-1.0, -1.0, 1.0, 1.0])


def _flip_boxes(boxes: np.ndarray, direction: str) -> np.ndarray:
    """mmdet3d LiDARInstance3DBoxes.flip semantics on (N, 7) boxes."""
    out = boxes.copy()
    if len(out) == 0:
        return out
    if direction == "vertical":   # flip x
        out[:, 0] = -out[:, 0]
        out[:, 6] = -out[:, 6] + np.pi
    else:                          # horizontal: flip y
        out[:, 1] = -out[:, 1]
        out[:, 6] = -out[:, 6]
    return out


def _reorder(arr, order):
    if isinstance(arr, list):
        return [arr[i] for i in order]
    return np.asarray(arr)[order]


def flip_sample(sample: dict, direction: str, reorder: bool = True) -> dict:
    """Flip one sample dict; returns a new dict (inputs unmodified)."""
    assert direction in ("vertical", "horizontal")
    s = dict(sample)
    flip_mat = _FLIP_X if direction == "vertical" else _FLIP_Y
    order = VERTICAL_ORDER_VIEW if direction == "vertical" else \
        HORIZONTAL_ORDER_VIEW

    if "boxes" in s:
        s["boxes"] = _flip_boxes(np.asarray(s["boxes"]), direction)
    if "bev_map" in s:
        # channel-last (H, W, C): the reference flips axis 1 (vertical) or
        # 2 (horizontal) of its channel-first canvas (ref:pipeline.py:594,
        # 631), the H or W axis here
        m = np.asarray(s["bev_map"])
        s["bev_map"] = np.ascontiguousarray(
            m[::-1] if direction == "vertical" else m[:, ::-1])

    if "camera2lidar" in s:
        c2l = np.asarray(s["camera2lidar"]).copy()
        c2l = flip_mat[None] @ c2l
        if reorder:
            # moving-axis corrections (ref:pipeline.py:599-615)
            c2l = c2l @ _FLIP_NEW_Y_ROT180[None]
        s["camera2lidar"] = c2l
        K = np.asarray(s["camera_intrinsics"]).copy()
        K[:, 0, 2] = IMG_ORI_SIZE[0] - K[:, 0, 2]
        s["camera_intrinsics"] = K
        l2c = np.linalg.inv(c2l)
        s["lidar2camera"] = l2c
        s["lidar2image"] = K @ l2c

    if "img" in s:
        s["img"] = np.ascontiguousarray(np.asarray(s["img"])[:, :, ::-1])

    if reorder:
        for k in ("img", "camera_intrinsics", "camera2lidar", "lidar2camera",
                  "lidar2image", "img_aug_matrix"):
            if k in s:
                s[k] = _reorder(s[k], order)
    return s


class RandomFlip3DwithViews:
    """Callable transform with the reference's flip_ratio / direction knobs."""

    def __init__(self, flip_ratio: float = 0.0,
                 direction: Optional[str] = "v",
                 rng: Optional[np.random.Generator] = None):
        assert direction in (None, "v", "h", "handv", "horv", "hv")
        self.flip_ratio = flip_ratio
        self.direction = direction
        self.rng = rng or np.random.default_rng()

    def __call__(self, sample: dict) -> dict:
        if self.direction is None or self.rng.random() >= self.flip_ratio:
            return sample
        d = self.direction
        if d == "horv":
            d = "h" if self.rng.random() < 0.5 else "v"
        dirs = {"v": ["vertical"], "h": ["horizontal"],
                "handv": ["horizontal", "vertical"],
                "hv": ["horizontal", "vertical"]}.get(d, [d])
        for dd in dirs:
            sample = flip_sample(sample, dd)
        return sample
