"""nuScenes index builder (counterpart of ``tools/prepare_data.py``;
ref:tools/create_data.py + nuscenes_converter.py).

The port reads the v1.0 JSON tables directly; this prebuilds and pickles
the per-frame index for a fast start:

    python -m magicdrive_tpu_torch.cli.prepare_data --dataroot data/nuscenes \\
        --version v1.0-trainval --out data/nuscenes_index.pkl
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex


def main(argv: Optional[Sequence[str]] = None) -> str:
    p = argparse.ArgumentParser(
        prog="python -m magicdrive_tpu_torch.cli.prepare_data",
        description="Build and pickle the nuScenes per-frame index.")
    p.add_argument("--dataroot", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    index = NuScenesIndex(args.dataroot, args.version)
    index.save(args.out)
    print(f"indexed {len(index.infos)} samples -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
