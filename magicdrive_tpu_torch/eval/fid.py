"""FID evaluation (counterpart of ``eval/fid.py``; ref:tools/fid_score.py).

Two modes, like the reference (ref:fid_score.py:489-498):
  * ``paths``: FID between two image directories;
  * ``tokens``: nuScenes-paired, real and generated images matched per
    sample token and camera, with the train-time resize and top-center
    crop applied to the real images (ref:fid_score.py:297-338, 475-482).

The pool3 activations come from :class:`InceptionV3Pool3` in batches on
the card (the caller may pass ``device="cpu"``); the Fréchet distance is
ref:fid_score.py:159-213 in numpy and scipy's ``sqrtm``, with its eps
retry and its imaginary-part check.
"""
from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from magicdrive_tpu_torch.device import DEFAULT_DEVICE

from .inception import load_inception

IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tiff"}


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2,
                               eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (ref:fid_score.py:159-213)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def top_center_crop(img: Image.Image, back_resize=(896, 1600),
                    back_pad=(0, 4, 0, 0)) -> Image.Image:
    """The train-time preprocessing replayed on a real image
    (ref:fid_score.py:361-368): resize to ``back_resize``, then remove
    ``back_pad`` (left, top, right, bottom)."""
    h, w = back_resize
    img = img.resize((w, h))
    l, t, r, b = back_pad
    return img.crop((l, t, w - r, h - b))


class ActivationExtractor:
    """Pool3 features of PIL images, ``batch_size`` per forward (a short
    last batch runs as it is)."""

    def __init__(self, weights_path: Optional[str] = None,
                 batch_size: int = 32, image_size: int = 299,
                 device=DEFAULT_DEVICE):
        self.model = load_inception(weights_path, device)
        self.device = next(self.model.parameters()).device
        self.batch_size = batch_size
        self.image_size = image_size

    def _prep(self, img: Image.Image) -> np.ndarray:
        img = img.convert("RGB").resize(
            (self.image_size, self.image_size), Image.BILINEAR)
        return np.asarray(img, np.float32) / 255.0

    @torch.no_grad()
    def _features(self, batch: List[np.ndarray]) -> np.ndarray:
        x = torch.from_numpy(np.stack(batch)).to(self.device)
        return self.model(x).float().cpu().numpy()

    def from_images(self, images: Iterable[Image.Image]) -> np.ndarray:
        feats: List[np.ndarray] = []
        batch: List[np.ndarray] = []
        for img in images:
            batch.append(self._prep(img))
            if len(batch) == self.batch_size:
                feats.append(self._features(batch))
                batch.clear()
        if batch:
            feats.append(self._features(batch))
        return np.concatenate(feats) if feats else np.zeros((0, 2048))

    def from_files(self, files: Sequence[str],
                   transform=None) -> np.ndarray:
        def gen():
            for f in files:
                img = Image.open(f)
                yield transform(img) if transform else img

        return self.from_images(gen())


def activation_statistics(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def list_images(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if os.path.splitext(f)[1].lower() in IMG_EXTS:
                out.append(os.path.join(dirpath, f))
    return out


def fid_between_paths(path_real: str, path_gen: str,
                      weights_path: Optional[str] = None,
                      batch_size: int = 32, real_transform=None,
                      device=DEFAULT_DEVICE) -> float:
    ext = ActivationExtractor(weights_path, batch_size, device=device)
    f_real = ext.from_files(list_images(path_real), transform=real_transform)
    f_gen = ext.from_files(list_images(path_gen))
    mu1, s1 = activation_statistics(f_real)
    mu2, s2 = activation_statistics(f_gen)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def pair_real_generated(index, gen_root: str,
                        subsample_ratio: float = 1.0,
                        gen_suffixes: Sequence[str] = ("_gen0",),
                        ) -> Tuple[List[str], List[str]]:
    """(real files, generated files) matched per token and camera: a
    generated file is named after its nuScenes image's stem + _gen{i}
    (ref:fid_score.py:297-321). ``index``: a NuScenesIndex."""
    real_files, gen_files = [], []
    step = max(1, int(round(1.0 / subsample_ratio)))
    gen_index = {}
    for dirpath, _, files in os.walk(gen_root):
        for f in files:
            gen_index[os.path.splitext(f)[0]] = os.path.join(dirpath, f)
    for info in index.infos[::step]:
        for path in info.image_paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            for sfx in gen_suffixes:
                g = gen_index.get(stem + sfx)
                if g is not None:
                    real_files.append(path)
                    gen_files.append(g)
    return real_files, gen_files
