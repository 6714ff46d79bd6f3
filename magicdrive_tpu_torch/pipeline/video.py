"""Multi-view video generation (counterpart of ``pipeline/video.py``; the
MagicDrive-t capability, SURVEY.md §2.5).

The video model is the image model with temporal attention over the frame
axis in every UNet transformer block (``UNetConfig.temporal_frames``).
The pipeline reuses the image pipeline by folding the frames into the
batch: the conditioning (camera, boxes, map, text) is per frame, the UNet
batch is (B*F*N) with the views innermost, and the temporal attention
regroups the frames inside each block.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from magicdrive_tpu_torch.config import PipelineConfig
from magicdrive_tpu_torch.parallel.mesh import Mesh
from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                    MagicDrivePipeline)


class VideoPipeline:
    """F-frame wrapper over :class:`MagicDrivePipeline`.

    Every per-frame tensor of the batch carries the frames folded into its
    leading axis, (B*F, ...): input_ids (B*F, 77), camera_param
    (B*F, N, 3, 7), bev_map (B*F, H, W, C), bboxes (B*F, N, L, P, 3), and so
    on (:meth:`fold_frames`); uncond_ids stays (1, 77). The UNet must be
    built with ``temporal_frames=n_frames``.

    With a ``mesh`` (``parallel.make_mesh`` over ``dp``, ``t`` and
    ``view``) it samples this rank's block of a batch that
    ``parallel.shard_batch(batch, mesh, n_cam, frames=n_frames)`` cut: its
    clips over dp, its F/t frames of each over t (the temporal attention
    exchanges the frames over the t group) and its cameras over view.
    Pass the latents of that ``shard_batch``."""

    def __init__(self, modules: MagicDriveModules, cfg: PipelineConfig,
                 n_frames: int, mesh: Optional[Mesh] = None):
        if modules.unet.cfg.temporal_frames != n_frames:
            raise ValueError(f"the UNet attends over "
                             f"{modules.unet.cfg.temporal_frames} frames, "
                             f"not {n_frames}")
        self.n_frames = n_frames
        self.pipe = MagicDrivePipeline(modules, cfg, mesh=mesh)

    def prepare_latents(self, batch_size: int,
                        generator: Optional[torch.Generator]
                        ) -> torch.Tensor:
        """Independent noise per frame, shared by the views of each frame:
        (B*F, N, h, w, 4) float32."""
        return self.pipe.prepare_latents(batch_size * self.n_frames,
                                         generator)

    def __call__(self, batch: Mapping[str, object],
                 generator: Optional[torch.Generator] = None,
                 latents=None) -> torch.Tensor:
        """Images (B*F, N, H, W, 3) float32 in [0, 1]; the frames of a
        sample are consecutive. Without ``latents`` the image pipeline
        draws them at batch B*F, which is :meth:`prepare_latents`."""
        return self.pipe(batch, generator=generator, latents=latents)

    @staticmethod
    def fold_frames(batch: Mapping[str, object]) -> dict:
        """(B, F, ...) per-frame batch -> (B*F, ...), uncond_ids as it is."""
        return {k: v if k == "uncond_ids" else
                v.reshape(-1, *v.shape[2:]) for k, v in batch.items()}
