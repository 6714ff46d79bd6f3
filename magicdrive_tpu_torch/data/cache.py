"""The BEV mask cache: the bit-pack codec and the h5 store (counterpart of
``data/cache.py``; ref:magicdrive/dataset/pipeline_utils.py:10-49 and
ref:tools/prepare_map_aux.py).

The codec runs the port's C++ library (``native/bitpack.py``), built with
``g++`` at first use; a failed build raises. Its plain numpy version lives
beside it for the tests.

Layout per nuScenes sample token (ref:prepare_map_aux.py:25-29), as the JAX
package writes it:
  gt_masks_bev_static : packed int32 (H, W)        map channels
  gt_masks_bev        : packed int32 (H, W)        map + object channels
  gt_aux_bev          : float32 (8, H, W)          aux channels (optional)

``h5py`` is imported where a cache is read or written, not with this
module.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from magicdrive_tpu_torch.native import bitpack

from .bbox import corners_from_boxes


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the BEV map cache (dataset.cache_file, cli.prepare_cache) "
            "needs the h5py package, which is not installed; set "
            "dataset.cache_file.train=null to rasterize the maps") from e
    return h5py


def one_hot_encode(masks: np.ndarray) -> np.ndarray:
    """(C <= 30, H, W) binary -> (H, W) int32 with bit c = channel c."""
    return bitpack.encode(masks)


def one_hot_decode(packed: np.ndarray, n_channels: int) -> np.ndarray:
    """(H, W) int32 -> (C, H, W) uint8."""
    return bitpack.decode(packed, n_channels)


class BEVCache:
    """The read side of an h5 cache, in the reference's key layout."""

    def __init__(self, path: str, n_map_classes: int,
                 n_object_classes: int = 0, with_aux: bool = True):
        self.f = _h5py().File(path, "r")
        self.n_map = n_map_classes
        self.n_obj = n_object_classes
        self.with_aux = with_aux and "gt_aux_bev" in self.f

    def get(self, token: str) -> Optional[np.ndarray]:
        """(C_total, H, W) float32 (masks, then aux), or None where the
        cache does not hold ``token``."""
        key = "gt_masks_bev" if self.n_obj else "gt_masks_bev_static"
        if token not in self.f.get(key, {}):
            return None
        masks = one_hot_decode(self.f[key][token][:],
                               self.n_map + self.n_obj).astype(np.float32)
        if self.with_aux and self.n_obj:
            aux = self.f["gt_aux_bev"][token][:].astype(np.float32)
            masks = np.concatenate([masks, aux], axis=0)
        return masks

    def close(self):
        self.f.close()


_BUILD_RAS = None  # the rasterizer of build_cache, set before its fork


def _raster_encode_one(info):
    """Rasterize and encode one frame (in a forked worker, or inline)."""
    keep = info.gt_labels >= 0
    boxes = info.gt_boxes[keep]
    labels = info.gt_labels[keep]
    vis = info.visibility[keep].astype(np.float32)
    corners = corners_from_boxes(boxes) if len(boxes) else np.zeros((0, 8, 3))
    out = _BUILD_RAS(info.location, info.lidar2global, corners=corners,
                     labels=labels,
                     box_heights=boxes[:, 5] if len(boxes) else
                     np.zeros((0,)), visibility=vis)
    static = out["gt_masks_bev_static"]
    enc = one_hot_encode(static)
    # the write-time round trip (ref:prepare_map_aux.py:69-70)
    if not (one_hot_decode(enc, static.shape[0]) == (static > 0)).all():
        raise AssertionError(f"bit-pack round trip failed for {info.token}")
    enc_full = one_hot_encode(out["gt_masks_bev"]) \
        if "gt_masks_bev" in out and _BUILD_RAS.object_classes else None
    return info.token, enc, enc_full, out.get("gt_aux_bev")


def build_cache(index, rasterizer, path: str,
                tokens: Optional[Sequence[str]] = None,
                progress: bool = True, workers: int = 0) -> str:
    """Rasterize every frame's static, dynamic and aux BEV layers and
    write the bit-packed h5 (ref:tools/prepare_map_aux.py:60-127).

    ``workers`` > 0 rasterizes in that many forked processes: the parent
    parses each location's map first, so the children share it copy-on-
    write; only the parent writes the file, in the frames' order, so the
    file is the sequential build's."""
    h5py = _h5py()
    global _BUILD_RAS

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    infos = [info for info in index.infos
             if tokens is None or info.token in tokens]
    _BUILD_RAS = rasterizer
    pool = None
    if workers > 0:
        import multiprocessing as mp

        for loc in sorted({info.location for info in infos}):
            rasterizer.map_for(loc)
        bitpack.load()  # built and loaded once, before the fork
        pool = mp.get_context("fork").Pool(workers)
        results = pool.imap(_raster_encode_one, infos, chunksize=8)
    else:
        results = map(_raster_encode_one, infos)
    try:
        with h5py.File(path, "w") as f:
            g_static = f.create_group("gt_masks_bev_static")
            g_full = f.create_group("gt_masks_bev")
            g_aux = f.create_group("gt_aux_bev")
            for i, (token, enc, enc_full, aux) in enumerate(results):
                g_static.create_dataset(token, data=enc, compression="gzip")
                if enc_full is not None:
                    g_full.create_dataset(token, data=enc_full,
                                          compression="gzip")
                if aux is not None:
                    g_aux.create_dataset(token, data=aux, compression="gzip")
                if progress and i % 500 == 0:
                    print(f"cache: {i}/{len(infos)}")
    finally:
        if pool is not None:
            pool.close()
            pool.join()
        _BUILD_RAS = None
    return path
