"""Build the BEV mask cache of a nuScenes tree (counterpart of
``tools/prepare_cache.py``; ref:tools/prepare_map_aux.py).

    python -m magicdrive_tpu_torch.cli.prepare_cache --dataroot DIR
        --out cache.h5 [--version v1.0-trainval] [--workers N]

Rasterizes every frame with the repository's dataset config
(``configs/dataset``: map bounds, classes, aux channels) and writes the
bit-packed h5 that ``dataset.cache_file.train`` names for training. Host
only; needs ``h5py``.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from magicdrive_tpu_torch.config_loader import compose
from magicdrive_tpu_torch.data.cache import build_cache
from magicdrive_tpu_torch.data.map_raster import BEVRasterizer
from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(
        prog="python -m magicdrive_tpu_torch.cli.prepare_cache",
        description="Write the BEV mask cache of a nuScenes tree.")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--workers", type=int,
                   default=max((os.cpu_count() or 1) - 1, 0),
                   help="parallel rasterization workers (0 = sequential)")
    args = p.parse_args(argv)

    dc = compose(os.path.join(REPO, "configs"))["dataset"]
    index = NuScenesIndex(args.dataroot, args.version,
                          classes=tuple(dc["object_classes"]))
    ras = BEVRasterizer(
        args.dataroot, xbound=tuple(dc["map_bound"]["x"]),
        ybound=tuple(dc["map_bound"]["y"]),
        classes=tuple(dc["map_classes"]),
        object_classes=tuple(dc["object_classes"]),
        aux_data=tuple(dc["aux_data"]), backend="auto")
    build_cache(index, ras, args.out, workers=args.workers)
    print(f"cache written: {args.out}")
    return args.out


if __name__ == "__main__":
    main()
