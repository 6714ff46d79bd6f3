"""BEV map visualization (counterpart of ``viz/map_viz.py``;
ref:magicdrive/runner/map_visualizer.py).

Same palette (devkit map/color conventions) and priority compositing:
dynamic channels overlay statics; statics composited in STATIC_PRIORITY
order; 90-degree rotation to ego-forward-up; legend strip appended.
Pure numpy/PIL — no torch, no matplotlib dependency at call time.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw

# palette ref:map_visualizer.py:13-45 (devkit colors)
MAP_COLORS = {
    "drivable_area": (166, 206, 227),
    "drivable_area*": (144, 196, 255),
    "lane": (110, 110, 110),
    "road_segment": (90, 90, 90),
    "ped_crossing": (251, 154, 153),
    "walkway": (227, 26, 28),
    "stop_line": (253, 191, 111),
    "carpark_area": (255, 127, 0),
    "road_block": (178, 223, 138),
    "road_divider": (255, 200, 0),
    "lane_divider": (130, 130, 130),
    "car": (255, 158, 0),
    "truck": (255, 99, 71),
    "construction_vehicle": (233, 150, 70),
    "bus": (255, 127, 80),
    "trailer": (255, 140, 0),
    "barrier": (112, 128, 144),
    "motorcycle": (255, 61, 99),
    "bicycle": (220, 20, 60),
    "pedestrian": (0, 0, 230),
    "traffic_cone": (47, 79, 79),
    "nothing": (200, 200, 200),
}

STATIC_PRIORITY = [
    "drivable_area", "drivable_area*", "road_block", "walkway", "stop_line",
    "carpark_area", "ped_crossing", "divider", "road_divider", "lane_divider",
]


def visualize_map(bev_map: np.ndarray,
                  map_classes: Sequence[str],
                  object_classes: Optional[Sequence[str]] = None,
                  target_size: int = 400,
                  channel_last: bool = True,
                  with_legend: bool = True) -> np.ndarray:
    """(H, W, C) [or (C, H, W)] binary map -> uint8 RGB image with legend."""
    m = bev_map if channel_last else bev_map.transpose(1, 2, 0)
    m = np.asarray(m) > 0.5
    H, W = m.shape[:2]
    n_s = len(map_classes)
    object_classes = list(object_classes or [])

    rendered = np.broadcast_to(
        np.uint8(MAP_COLORS["nothing"])[None, None], (H, W, 3)).copy()
    used = []

    # statics painted low->high priority so higher priority wins
    order = sorted(range(n_s),
                   key=lambda i: -STATIC_PRIORITY.index(map_classes[i])
                   if map_classes[i] in STATIC_PRIORITY else 0)
    for i in order:
        ch = m[..., i]
        if ch.any():
            rendered[ch] = MAP_COLORS.get(map_classes[i],
                                          MAP_COLORS["nothing"])
            used.append(map_classes[i])
    # dynamics overlay statics
    for j, name in enumerate(object_classes):
        if n_s + j >= m.shape[-1]:
            break
        ch = m[..., n_s + j]
        if ch.any():
            rendered[ch] = MAP_COLORS.get(name, MAP_COLORS["nothing"])
            used.append(name)

    img = Image.fromarray(rendered)
    ratio = max(target_size / W, target_size / H)
    img = img.resize((int(W * ratio), int(H * ratio)))
    img = img.rotate(90)  # ego-forward up (ref:map_visualizer.py:197)
    out = np.asarray(img)
    if with_legend and used:
        out = _append_legend(out, used)
    return out


def _append_legend(img: np.ndarray, names: Sequence[str],
                   row_h: int = 20, width: int = 150) -> np.ndarray:
    h = img.shape[0]
    legend = Image.new("RGB", (width, h), (255, 255, 255))
    draw = ImageDraw.Draw(legend)
    for i, name in enumerate(dict.fromkeys(names)):  # dedup, keep order
        y = 4 + i * row_h
        if y + row_h > h:
            break
        draw.rectangle([4, y, 18, y + 12], fill=MAP_COLORS.get(name))
        draw.text((24, y), name, fill=(0, 0, 0))
    return np.concatenate([img, np.asarray(legend)], axis=1)
