"""A configuration file as the system under test's ``ModelPreset``.

The file's ``model`` section holds every field of the preset's unet,
controlnet (with its nested unet and bbox), vae and clip configurations,
``pipeline`` the pipeline's fields, and ``dtype`` the working dtype the
modules are served in.
"""
from __future__ import annotations

import torch


def tuples(v):
    if isinstance(v, list):
        return tuple(tuples(x) for x in v)
    if isinstance(v, dict):
        return {k: tuples(x) for k, x in v.items()}
    return v


def dtype(config: dict) -> torch.dtype:
    return getattr(torch, config["dtype"])


def port_preset(config: dict):
    from magicdrive_tpu_torch import config as pc

    m = tuples(config["model"])
    cn = dict(m["controlnet"])
    cn["unet"] = pc.UNetConfig(**cn["unet"])
    cn["bbox"] = pc.BBoxEmbedderConfig(**cn["bbox"])
    return pc.ModelPreset(
        name=config["name"], unet=pc.UNetConfig(**m["unet"]),
        controlnet=pc.BEVControlNetConfig(**cn),
        vae=pc.VAEConfig(**m["vae"]), clip=pc.CLIPTextConfig(**m["clip"]),
        pipeline=pc.PipelineConfig(**tuples(config["pipeline"]),
                                   dtype=dtype(config)),
        image_size=tuple(config["image_size"]),
        map_hw=tuple(config["map_hw"]),
        map_channels=config["map_channels"],
        bbox_max_len=config["bbox_max_len"])
