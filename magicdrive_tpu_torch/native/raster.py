"""ctypes binding of the port's C++ raster core (``csrc/raster.cc``).

The library is built with ``g++`` at first use (``gxx.py``);
``python -m magicdrive_tpu_torch.native.raster`` builds it.
``fill_polygon`` is pixel-exact with PIL ``ImageDraw.polygon(fill=...)`` on
box footprints; ``draw_polyline2`` is the 2-px divider-line band of the BEV
map.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import gxx

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)
_I = ctypes.c_int32
_SIGNATURES = {
    "fill_polygon_u8": [_u8p, _I, _I, _i32p, _I, ctypes.c_uint8],
    "draw_polyline2_u8": [_u8p, _I, _I, _i32p, _I, ctypes.c_uint8],
    "aux_channels_f32": [_f32p, _I, _I, _I, _f64p, _f64p, _f64p, _I, _I,
                         _I, _I, _I],
}


def load() -> ctypes.CDLL:
    """The raster library with its C signatures declared (built if
    needed)."""
    return gxx.load("raster.cc", _SIGNATURES)


def _pts(xy: np.ndarray) -> np.ndarray:
    xy = np.ascontiguousarray(np.asarray(xy), np.int32)
    if xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"points must be (n, 2), got {xy.shape}")
    return xy


def _canvas(canvas: np.ndarray) -> None:
    if canvas.dtype != np.uint8 or not canvas.flags.c_contiguous:
        raise ValueError("canvas must be a C-contiguous uint8 array")


def fill_polygon(canvas: np.ndarray, xy: np.ndarray, value: int = 1) -> None:
    """Fill the polygon of integer vertices ``xy`` (n, 2) into the (h, w)
    uint8 ``canvas`` in place."""
    _canvas(canvas)
    xy = _pts(xy)
    load().fill_polygon_u8(canvas.ctypes.data_as(_u8p), canvas.shape[0],
                           canvas.shape[1], xy.ctypes.data_as(_i32p),
                           len(xy), value)


def draw_polyline2(canvas: np.ndarray, xy: np.ndarray,
                   value: int = 1) -> None:
    """Draw a 2-px-wide polyline through the integer points ``xy`` (n, 2)."""
    _canvas(canvas)
    xy = _pts(xy)
    load().draw_polyline2_u8(canvas.ctypes.data_as(_u8p), canvas.shape[0],
                             canvas.shape[1], xy.ctypes.data_as(_i32p),
                             len(xy), value)


def aux_channels(aux: np.ndarray, bottom_corners: np.ndarray,
                 visibility: np.ndarray, heights: np.ndarray,
                 flags) -> None:
    """Write the boxes' aux channels into ``aux`` (h, w, c) float32 in
    place. bottom_corners: (n, 4, 2) canvas coordinates; flags: 4 bools
    (visibility, center_offset, center_ohw, height)."""
    if aux.dtype != np.float32 or not aux.flags.c_contiguous:
        raise ValueError("aux must be a C-contiguous float32 array")
    bc = np.ascontiguousarray(bottom_corners, np.float64)
    vis = np.ascontiguousarray(visibility, np.float64)
    hgt = np.ascontiguousarray(heights, np.float64)
    n = len(bc)
    if bc.shape != (n, 4, 2) or vis.shape != (n,) or hgt.shape != (n,):
        raise ValueError(f"shapes {bc.shape} {vis.shape} {hgt.shape}")
    h, w, c = aux.shape
    load().aux_channels_f32(
        aux.ctypes.data_as(_f32p), h, w, c, bc.ctypes.data_as(_f64p),
        vis.ctypes.data_as(_f64p), hgt.ctypes.data_as(_f64p), n,
        *[int(bool(f)) for f in flags])


if __name__ == "__main__":
    print(gxx.build(gxx.CSRC / "raster.cc"))
