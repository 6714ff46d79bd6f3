"""Image grid assembly (counterpart of ``viz/img_utils.py``;
ref:magicdrive/runner/img_utils.py:5-40)."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def concat_6_views(imgs: np.ndarray, oneline: bool = False) -> np.ndarray:
    """(6, H, W, 3) -> single image: 2x3 grid (front row: FL|F|FR; back row
    mirrored like the reference) or one 1x6 line."""
    if imgs.shape[0] != 6:
        raise ValueError(f"6 views expected, got {imgs.shape}")
    if oneline:
        return np.concatenate(list(imgs), axis=1)
    top = np.concatenate([imgs[0], imgs[1], imgs[2]], axis=1)
    # back views flipped left-right in display order (B-left, B, B-right)
    bottom = np.concatenate([imgs[5], imgs[4], imgs[3]], axis=1)
    return np.concatenate([top, bottom], axis=0)


def img_grid(rows: Sequence[np.ndarray]) -> np.ndarray:
    """Stack equal-width row images vertically, padding widths if needed."""
    w = max(r.shape[1] for r in rows)
    padded = [np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0))) for r in rows]
    return np.concatenate(padded, axis=0)
