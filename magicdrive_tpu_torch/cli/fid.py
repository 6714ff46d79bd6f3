"""FID evaluation CLI (counterpart of ``tools/fid.py``;
ref:tools/fid_score.py).

    # two directories
    python -m magicdrive_tpu_torch.cli.fid paths REAL_DIR GEN_DIR \\
        [--weights pt_inception-2015-12-05.pth]

    # nuScenes-paired: real and generated matched per token and camera
    python -m magicdrive_tpu_torch.cli.fid tokens --dataroot data/nuscenes \\
        --gen_root OUT [--version v1.0-trainval] [--subsample 1.0]

The real images take the train-time resize and top-center crop unless
``--no_crop``. The Inception network runs on the card;
``main(argv, device="cpu")`` runs it on the CPU. Without ``--weights`` it
keeps random initial weights, which serve smoke tests only.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from magicdrive_tpu_torch.device import DEFAULT_DEVICE
from magicdrive_tpu_torch.eval.fid import (ActivationExtractor,
                                           activation_statistics,
                                           calculate_frechet_distance,
                                           fid_between_paths,
                                           pair_real_generated,
                                           top_center_crop)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m magicdrive_tpu_torch.cli.fid",
                                description="FID of generated images.")
    sub = p.add_subparsers(dest="mode", required=True)
    pp = sub.add_parser("paths")
    pp.add_argument("real")
    pp.add_argument("gen")
    pt = sub.add_parser("tokens")
    pt.add_argument("--dataroot", required=True)
    pt.add_argument("--gen_root", required=True)
    pt.add_argument("--version", default="v1.0-trainval")
    pt.add_argument("--subsample", type=float, default=1.0)
    for q in (pp, pt):
        q.add_argument("--weights", default=None,
                       help="pt_inception-2015-12-05 state dict")
        q.add_argument("--batch_size", type=int, default=32)
        q.add_argument("--no_crop", action="store_true",
                       help="skip train-preproc crop on real images")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None,
         device=DEFAULT_DEVICE) -> float:
    args = parse_args(argv)
    real_tf = None if args.no_crop else top_center_crop
    if args.mode == "paths":
        fid = fid_between_paths(args.real, args.gen, args.weights,
                                args.batch_size, real_transform=real_tf,
                                device=device)
    else:
        from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex

        index = NuScenesIndex(args.dataroot, args.version)
        real_files, gen_files = pair_real_generated(
            index, args.gen_root, subsample_ratio=args.subsample)
        print(f"paired {len(real_files)} real/generated images")
        ext = ActivationExtractor(args.weights, args.batch_size,
                                  device=device)
        mu1, s1 = activation_statistics(
            ext.from_files(real_files, transform=real_tf))
        mu2, s2 = activation_statistics(ext.from_files(gen_files))
        fid = calculate_frechet_distance(mu1, s1, mu2, s2)
    print(f"FID: {fid}")
    return fid


if __name__ == "__main__":
    main()
