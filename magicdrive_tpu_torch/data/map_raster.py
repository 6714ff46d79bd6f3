"""BEV semantic-map rasterization from the nuScenes map-expansion JSON
(counterpart of ``data/map_raster.py``).

Stands in for the reference's ``NuScenesMap.get_map_mask`` and the mmdet3d
box classes (ref:magicdrive/dataset/pipeline.py:244-306,
LoadBEVSegmentationM._get_data): reads the map-expansion JSON tables
(node/polygon/line and layer records) and rasterizes an ego-centred
rotated patch, with PIL or with the port's C++ scanline core
(``native/raster.py``), so the data layer needs neither the devkit nor
cv2/shapely.

Geometry (as the reference):
  * patch_box = (global_x, global_y, patch_h, patch_w) centred on the lidar
    origin in the global frame; patch_angle = the lidar yaw in degrees
    (ref:pipeline.py:249-259);
  * get_map_mask returns (C, canvas_h, canvas_w) with row=y col=x in the
    rotated patch frame; the caller transposes to the reference's x-y
    transposed canvas (ref:pipeline.py:288 ``masks.transpose(0, 2, 1)``);
  * polygon layers fill 1 (holes 0); divider (line) layers draw 2-px lines,
    the devkit's ``mask_for_lines`` cv2.polylines thickness=2.

The dynamic-object and aux channels (visibility / center_offset /
center_ohw / height) follow ref:pipeline.py:88-217.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

log = logging.getLogger(__name__)

LOCATIONS = (
    "singapore-onenorth", "singapore-hollandvillage", "singapore-queenstown",
    "boston-seaport",
)


def _native_raster():
    """The native raster module with its library loaded (built with g++ at
    first use), or None where it cannot be built."""
    from magicdrive_tpu_torch.native import raster as nr

    try:
        nr.load()
    except (OSError, RuntimeError) as e:
        log.warning("native raster core unavailable: %s", e)
        return None
    return nr


def resolve_raster_backend(backend: str = "auto") -> str:
    """'pil' (pixel-exact with PIL), 'native' (the C++ scanline core, equal
    pixels on box footprints, a pixel or two apart on long polygon edges)
    or 'auto' (native where its library builds, else pil)."""
    if backend == "auto":
        return "native" if _native_raster() else "pil"
    if backend not in ("pil", "native"):
        raise ValueError(f"raster backend {backend!r}: pil, native or auto")
    if backend == "native" and not _native_raster():
        raise RuntimeError("native raster backend requested but its library "
                           "does not build (g++ on PATH?)")
    return backend


def _fill_polys_pil(canvas: np.ndarray, polys) -> None:
    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    for pts, value in polys:
        draw.polygon(pts.flatten().tolist(), fill=int(value))
    canvas[:] = np.asarray(img)


def _lines2_pil(canvas: np.ndarray, lines) -> None:
    img = Image.fromarray(canvas)
    draw = ImageDraw.Draw(img)
    for pts in lines:
        draw.line([tuple(p) for p in pts], fill=1, width=2)
    canvas[:] = np.asarray(img)


def make_draw_fns(backend: str):
    """Canvas-level draw ops over a (h, w) uint8 array, batched per canvas
    (one PIL image round-trip / one C call sequence per canvas):
      fill_polys(canvas, [(pts_int32, value), ...])
      lines2(canvas, [pts_int32, ...])   # 2-px polylines, value 1
    """
    if backend == "native":
        nr = _native_raster()

        def fill_polys(canvas, polys):
            for pts, value in polys:
                nr.fill_polygon(canvas, pts, int(value))

        def lines2(canvas, lines):
            for pts in lines:
                nr.draw_polyline2(canvas, pts)

        return fill_polys, lines2
    return _fill_polys_pil, _lines2_pil

# layer -> geometry source in the map expansion schema
POLYGON_LAYERS = ("road_segment", "lane", "ped_crossing", "walkway",
                  "stop_line", "carpark_area", "road_block", "drivable_area")
LINE_LAYERS = ("road_divider", "lane_divider")

AUX_DATA_CH = {"visibility": 1, "center_offset": 2, "center_ohw": 4,
               "height": 1}


class MapLayers:
    """Parsed geometry of one location: per-layer polygon/line point lists."""

    def __init__(self, expansion_json: str):
        with open(expansion_json) as f:
            data = json.load(f)
        nodes = {n["token"]: (n["x"], n["y"]) for n in data.get("node", [])}

        def poly_pts(polygon_rec) -> Tuple[np.ndarray, List[np.ndarray]]:
            ext = np.array([nodes[t] for t in
                            polygon_rec["exterior_node_tokens"]])
            holes = [np.array([nodes[t] for t in h["node_tokens"]])
                     for h in polygon_rec.get("holes", [])
                     if h.get("node_tokens")]
            return ext, holes

        polygons = {p["token"]: poly_pts(p) for p in data.get("polygon", [])}
        lines = {}
        for rec in data.get("line", []):
            lines[rec["token"]] = np.array(
                [nodes[t] for t in rec["node_tokens"]])

        self.layers: Dict[str, List] = {}
        for layer in POLYGON_LAYERS:
            geoms = []
            for rec in data.get(layer, []):
                toks = rec.get("polygon_tokens") or (
                    [rec["polygon_token"]] if "polygon_token" in rec else [])
                for t in toks:
                    if t in polygons:
                        geoms.append(polygons[t])
            self.layers[layer] = geoms
        for layer in LINE_LAYERS:
            geoms = []
            for rec in data.get(layer, []):
                t = rec.get("line_token")
                if t in lines:
                    geoms.append(lines[t])
            self.layers[layer] = geoms

        # bbox prefilter per geometry: (n_geom, 4) [xmin, ymin, xmax, ymax]
        self._bounds: Dict[str, np.ndarray] = {}
        for layer, geoms in self.layers.items():
            if not geoms:
                self._bounds[layer] = np.zeros((0, 4))
                continue
            bs = []
            for g in geoms:
                pts = g[0] if isinstance(g, tuple) else g
                bs.append([pts[:, 0].min(), pts[:, 1].min(),
                           pts[:, 0].max(), pts[:, 1].max()])
            self._bounds[layer] = np.asarray(bs)

    def in_patch(self, layer: str, center: np.ndarray, radius: float):
        """Indices of geometries whose bbox intersects the patch circle."""
        b = self._bounds[layer]
        if len(b) == 0:
            return []
        ok = ((b[:, 0] <= center[0] + radius) & (b[:, 2] >= center[0] - radius)
              & (b[:, 1] <= center[1] + radius)
              & (b[:, 3] >= center[1] - radius))
        return np.where(ok)[0]


class NuScenesMapRaster:
    """get_map_mask-compatible rasterizer over the parsed layers."""

    def __init__(self, dataroot: str, location: str, backend: str = "pil"):
        path = os.path.join(dataroot, "maps", "expansion", f"{location}.json")
        self.layers = MapLayers(path)
        self._fill_polys, self._lines2 = make_draw_fns(backend)

    def get_map_mask(self, patch_box, patch_angle: float,
                     layer_names: Sequence[str],
                     canvas_size: Tuple[int, int]) -> np.ndarray:
        """(C, canvas_h, canvas_w) uint8 masks, one channel per layer."""
        px, py, patch_h, patch_w = patch_box
        canvas_h, canvas_w = canvas_size
        center = np.array([px, py])
        radius = float(np.hypot(patch_h, patch_w)) / 2 + 1.0
        a = -np.deg2rad(patch_angle)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        scale = np.array([canvas_w / patch_w, canvas_h / patch_h])
        shift = np.array([patch_w / 2, patch_h / 2])

        def to_canvas(pts: np.ndarray) -> np.ndarray:
            pts = ((pts - center) @ rot.T + shift) * scale
            return np.round(pts).astype(np.int32)

        out = np.zeros((len(layer_names), canvas_h, canvas_w), np.uint8)
        for ci, layer in enumerate(layer_names):
            idx = self.layers.in_patch(layer, center, radius)
            geoms = self.layers.layers[layer]
            if layer in LINE_LAYERS:
                self._lines2(out[ci], [to_canvas(geoms[i]) for i in idx])
            else:
                polys = []
                for i in idx:
                    ext, holes = geoms[i]
                    polys.append((to_canvas(ext), 1))
                    polys.extend((to_canvas(h), 0) for h in holes)
                self._fill_polys(out[ci], polys)
        return out


class BEVRasterizer:
    """Full LoadBEVSegmentationM behavior: static map channels + dynamic
    object channels + aux channels, with the reference's transposed canvas.

    Produces (per frame dict with lidar2global, location, boxes, labels,
    visibility):
      gt_masks_bev_static (C_map, H, W); gt_masks_bev (C_map[+C_obj], H, W);
      gt_aux_bev (8, H, W) when aux_data configured (1+2+4+1).
    """

    def __init__(self, dataset_root: str,
                 xbound=(-50.0, 50.0, 0.5), ybound=(-50.0, 50.0, 0.5),
                 classes: Sequence[str] = (
                     "drivable_area", "ped_crossing", "walkway", "stop_line",
                     "carpark_area", "road_divider", "lane_divider",
                     "road_block"),
                 object_classes: Optional[Sequence[str]] = None,
                 aux_data: Optional[Sequence[str]] = None,
                 locations: Sequence[str] = LOCATIONS,
                 backend: str = "pil"):
        patch_h = ybound[1] - ybound[0]
        patch_w = xbound[1] - xbound[0]
        self.patch_size = (patch_h, patch_w)
        self.canvas_size = (int(patch_h / ybound[2]), int(patch_w / xbound[2]))
        self.classes = tuple(classes)
        self.object_classes = tuple(object_classes) if object_classes else None
        self.aux_data = tuple(aux_data) if aux_data else None
        # ref:pipeline.py:70-75 — note the transposed h/w scaling
        ch, cw = self.canvas_size
        self.lidar2canvas = np.array([
            [ch / patch_h, 0, ch / 2], [0, cw / patch_w, cw / 2], [0, 0, 1]])
        self._dataroot = dataset_root
        self._maps: Dict[str, NuScenesMapRaster] = {}
        self._backend = resolve_raster_backend(backend)
        self._fill_polys, self._lines2 = make_draw_fns(self._backend)

    def map_for(self, location: str) -> NuScenesMapRaster:
        """Lazy per-location map load (the expansion JSONs are ~100 MB)."""
        if location not in self._maps:
            self._maps[location] = NuScenesMapRaster(
                self._dataroot, location, backend=self._backend)
        return self._maps[location]

    # -- mapping of config class names to devkit layers (ref:pipeline.py:261-273)
    @staticmethod
    def _mappings(classes) -> Dict[str, List[str]]:
        m = {}
        for name in classes:
            if name == "drivable_area*":
                m[name] = ["road_segment", "lane"]
            elif name == "divider":
                m[name] = ["road_divider", "lane_divider"]
            else:
                m[name] = [name]
        return m

    def static_masks(self, location: str, lidar2global: np.ndarray) -> np.ndarray:
        map_pose = lidar2global[:2, 3]
        patch_box = (map_pose[0], map_pose[1], *self.patch_size)
        v = lidar2global[:3, :3] @ np.array([1, 0, 0])
        patch_angle = np.arctan2(v[1], v[0]) / np.pi * 180

        mappings = self._mappings(self.classes)
        layer_names = sorted({l for ls in mappings.values() for l in ls})
        masks = self.map_for(location).get_map_mask(
            patch_box, patch_angle, layer_names, self.canvas_size)
        masks = masks.transpose(0, 2, 1).astype(bool)  # ref:pipeline.py:288

        labels = np.zeros((len(self.classes), *self.canvas_size), np.uint8)
        for k, name in enumerate(self.classes):
            for layer in mappings[name]:
                labels[k][masks[layer_names.index(layer)]] = 1
        return labels

    def _bottom_corners_canvas(self, corners: np.ndarray) -> np.ndarray:
        """(N, 8, 3) lidar corners -> (N, 4, 2) bottom corners on canvas.

        mmdet3d bottom corners in draw order are indices [0, 3, 7, 4]
        (ref:pipeline.py:186).
        """
        bc = corners[:, [0, 3, 7, 4], :2]
        p = np.pad(bc, ((0, 0), (0, 0), (0, 1)), constant_values=1.0)
        return (p @ self.lidar2canvas.T)[..., :2]

    def dynamic_masks(self, corners: np.ndarray, labels: np.ndarray) -> np.ndarray:
        """(C_obj, H, W) per-class filled box footprints (ref:pipeline.py:176-217)."""
        ch = len(self.object_classes)
        dyn = np.zeros((ch, *self.canvas_size), np.uint8)
        for cls_id in range(ch):
            sel = labels == cls_id
            if not sel.any():
                continue
            cc = self._bottom_corners_canvas(corners[sel])
            self._fill_polys(dyn[cls_id], [
                (box.round().astype(np.int32), 1) for box in cc])
        return dyn.transpose(0, 2, 1)  # ref:pipeline.py:218

    def aux_masks(self, corners: np.ndarray, box_heights: np.ndarray,
                  visibility: np.ndarray) -> np.ndarray:
        """(8, H, W) class-agnostic aux channels (ref:pipeline.py:88-174).

        Each box footprint is rasterized into its clipped integer bounding
        rect only (a box covers ~10x5 of the 200x200 cells): PIL polygon
        fill with integer vertices is translation-equivariant, so the
        cropped raster is pixel-identical to a full-canvas draw.
        """
        aux_ch = sum(AUX_DATA_CH[k] for k in self.aux_data)
        H, W = self.canvas_size
        aux = np.zeros((H, W, aux_ch), np.float32)
        all_bc = self._bottom_corners_canvas(corners)  # (N, 4, 2)
        if self._backend == "native":
            from magicdrive_tpu_torch.native import raster as nr
            n = len(corners)
            nr.aux_channels(
                aux, all_bc,
                visibility if visibility is not None else np.zeros(n),
                box_heights if box_heights is not None else np.zeros(n),
                [k in self.aux_data for k in
                 ("visibility", "center_offset", "center_ohw", "height")])
            return aux.transpose(2, 1, 0)  # ref:pipeline.py:172-173
        for i in range(len(corners)):
            bc = all_bc[i]                                  # (4, 2) float
            pts = bc.round().astype(np.int32)
            x0 = max(int(pts[:, 0].min()), 0)
            y0 = max(int(pts[:, 1].min()), 0)
            x1 = min(int(pts[:, 0].max()), W - 1)
            y1 = min(int(pts[:, 1].max()), H - 1)
            if x1 < x0 or y1 < y0:
                continue
            w, h = x1 - x0 + 1, y1 - y0 + 1
            render = np.zeros((h, w), np.uint8)
            self._fill_polys(render, [(pts - [x0, y0], 1)])
            m = render > 0                                  # (h, w)
            if not m.any():
                continue
            center = bc.mean(axis=0, keepdims=True)
            front = bc[2:4].mean(axis=0, keepdims=True)  # corners 7,4 midpoint
            left = bc[[0, 3]].mean(axis=0, keepdims=True)  # corners 0,4 mid
            win = aux[y0:y1 + 1, x0:x1 + 1]
            cur = 0
            if "visibility" in self.aux_data:
                win[m, cur:cur + 1] = visibility[i]
                cur += 1
            if "center_offset" in self.aux_data:
                xs, ys = np.meshgrid(np.arange(x0, x1 + 1, dtype=np.float32),
                                     np.arange(y0, y1 + 1, dtype=np.float32))
                win[m, cur:cur + 2] = (
                    np.stack([xs, ys], -1)[m] - center)
                cur += 2
            if "center_ohw" in self.aux_data:
                hgt = np.linalg.norm(front - center)
                wdt = np.linalg.norm(left - center)
                v = ((front - center)
                     / (np.linalg.norm(front - center) + 1e-6))[0]
                win[m, cur:cur + 4] = np.array([hgt, wdt, v[0], v[1]])[None]
                cur += 4
            if "height" in self.aux_data:
                win[m, cur:cur + 1] = box_heights[i]
                cur += 1
        return aux.transpose(2, 1, 0)  # ref:pipeline.py:172-173

    def __call__(self, location: str, lidar2global: np.ndarray,
                 corners: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None,
                 box_heights: Optional[np.ndarray] = None,
                 visibility: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        static = self.static_masks(location, lidar2global)
        out = {"gt_masks_bev_static": static}
        if self.object_classes is not None:
            n = 0 if corners is None else len(corners)
            if n:
                dyn = self.dynamic_masks(corners, labels)
            else:
                dyn = np.zeros((len(self.object_classes), *self.canvas_size),
                               np.uint8)
            out["gt_masks_bev"] = np.concatenate([static, dyn], axis=0)
            if self.aux_data:
                if n:
                    out["gt_aux_bev"] = self.aux_masks(
                        corners, box_heights, visibility)
                else:
                    aux_ch = sum(AUX_DATA_CH[k] for k in self.aux_data)
                    out["gt_aux_bev"] = np.zeros(
                        (aux_ch, *self.canvas_size), np.float32)
        else:
            out["gt_masks_bev"] = static
        return out
