"""ctypes binding of the port's C++ bit-pack codec (``csrc/bitpack.cc``),
the codec of the BEV mask cache (``data/cache.py``).

The library is built with ``g++`` at first use (``gxx.py``); a failed
build raises. ``encode_numpy`` and ``decode_numpy`` are the codec's plain
version (the JAX package's numpy codec, ``data/cache.py``), which the tests
hold the library to; the cache itself always runs the library.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import gxx

MAX_CHANNELS = 30

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "bitpack_encode": [_u8p, ctypes.c_int32, ctypes.c_int64, _i32p],
    "bitpack_decode": [_i32p, ctypes.c_int32, ctypes.c_int64, _u8p],
}


def load() -> ctypes.CDLL:
    return gxx.load("bitpack.cc", _SIGNATURES)


def _check_channels(c: int) -> None:
    if not 0 < c <= MAX_CHANNELS:
        raise ValueError(f"{c} channels: the codec packs 1 to "
                         f"{MAX_CHANNELS}")


def encode(masks: np.ndarray) -> np.ndarray:
    """(C, H, W) masks -> (H, W) int32 with bit c set where channel c is
    non-zero."""
    if masks.ndim != 3:
        raise ValueError(f"masks must be (C, H, W), got {masks.shape}")
    _check_channels(masks.shape[0])
    m = np.ascontiguousarray(masks != 0, np.uint8)
    c, h, w = m.shape
    out = np.empty((h, w), np.int32)
    load().bitpack_encode(m.ctypes.data_as(_u8p), c, h * w,
                          out.ctypes.data_as(_i32p))
    return out


def decode(packed: np.ndarray, channels: int) -> np.ndarray:
    """(H, W) int32 -> (channels, H, W) uint8 in {0, 1}."""
    if packed.ndim != 2:
        raise ValueError(f"packed must be (H, W), got {packed.shape}")
    _check_channels(channels)
    p = np.ascontiguousarray(packed, np.int32)
    h, w = p.shape
    out = np.empty((channels, h, w), np.uint8)
    load().bitpack_decode(p.ctypes.data_as(_i32p), channels, h * w,
                          out.ctypes.data_as(_u8p))
    return out


def encode_numpy(masks: np.ndarray) -> np.ndarray:
    """The plain version of ``encode``."""
    c = masks.shape[0]
    shifts = (1 << np.arange(c, dtype=np.int32))[:, None, None]
    return ((masks > 0).astype(np.int32) * shifts).sum(axis=0,
                                                       dtype=np.int32)


def decode_numpy(packed: np.ndarray, channels: int) -> np.ndarray:
    """The plain version of ``decode``."""
    shifts = np.arange(channels, dtype=np.int32)[:, None, None]
    return ((packed[None] >> shifts) & 1).astype(np.uint8)


if __name__ == "__main__":
    print(gxx.build(gxx.CSRC / "bitpack.cc"))
