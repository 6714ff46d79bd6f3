"""The datasets of a composed config (counterpart of ``tools/train.py``
``build_datasets``).

nuScenes where ``dataset.dataset_root`` holds ``dataset.version``, its BEV
maps read from the cache that ``dataset.cache_file.train`` names
(``cache.BEVCache``, written by ``cli.prepare_cache``) or else rasterized
per frame; otherwise the synthetic fixture scenes (the reference's
debug-with-demo-data path).
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)


def build_datasets(cfg):
    """(train, val) datasets of ``cfg``; validation indexes the same split,
    as in the JAX package. The fixture path makes 32 scenes with images, as
    the JAX package's does (the images are drawn before the boxes, so the
    scenes are its scenes)."""
    dc = cfg["dataset"]
    root = dc["dataset_root"]
    if os.path.isdir(os.path.join(root, dc.get("version", ""))):
        from .nuscenes import ImageAugConfig, NuScenesDataset, NuScenesIndex

        index = NuScenesIndex(root, dc["version"],
                              classes=tuple(dc["object_classes"]))
        ras, cache = None, None
        if dc["cache_file"]["train"]:
            from .cache import BEVCache

            cache = BEVCache(dc["cache_file"]["train"],
                             n_map_classes=len(dc["map_classes"]),
                             n_object_classes=len(dc["object_classes"]))
        else:
            from .map_raster import BEVRasterizer

            ras = BEVRasterizer(
                root, xbound=tuple(dc["map_bound"]["x"]),
                ybound=tuple(dc["map_bound"]["y"]),
                classes=tuple(dc["map_classes"]),
                object_classes=tuple(dc["object_classes"]),
                aux_data=tuple(dc["aux_data"]), backend="auto")
        aug = ImageAugConfig(final_hw=tuple(dc["image_size"]),
                             resize_lim=tuple(dc["augment2d"]["resize"]))
        train = NuScenesDataset(index, rasterizer=ras, cache=cache, aug=aug,
                                force_all_boxes=dc["force_all_boxes"])
        return train, train
    log.warning("nuScenes root %s not found — synthetic fixtures", root)
    from .fixtures import make_dataset

    H, W = dc["image_size"]
    n_map, mh, mw = cfg["model"]["controlnet"]["map_size"]
    ds = make_dataset(32, image_hw=(H, W), map_hw=(mh, mw),
                      map_channels=n_map, with_images=True)
    return ds, ds
