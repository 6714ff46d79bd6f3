"""Model presets as plain dataclasses (counterpart of ``config/presets.py``).

Only the fields the ported generation and training paths read are mirrored; values equal
the JAX presets' field for field (``tests/test_torch_port_modules.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# ring neighbours of the 6 nuScenes cameras in view order
# (counterpart of ``models/unet.py`` NUSCENES_NEIGHBORS)
NUSCENES_NEIGHBORS: Tuple[Tuple[int, int], ...] = (
    (5, 1), (0, 2), (1, 3), (2, 4), (3, 5), (4, 0),
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    # cross-view attention ("add" mode, zero_linear connector) when set
    neighboring_view_pair: Optional[Tuple[Tuple[int, int], ...]] = None
    # video: attention over this many frames in every transformer block
    temporal_frames: Optional[int] = None
    # training: the UNet's down, up and mid blocks (the ControlNet's down
    # and mid blocks) recompute their forward in the backward; the UNet's
    # blocks keep the outputs of matrix products and convolutions under
    # remat_policy "dots" (models/unet.py)
    gradient_checkpointing: bool = False
    remat_policy: Optional[str] = None

    @property
    def up_block_has_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_has_attn))


@dataclasses.dataclass(frozen=True)
class BBoxEmbedderConfig:
    n_classes: int = 10
    class_token_dim: int = 768
    embedder_num_freq: int = 4
    proj_dims: Tuple[int, ...] = (768, 512, 512, 768)
    mode: str = "all-xyz"      # all-xyz (8 corners) | cxyz (4 corners)

    @property
    def n_points(self) -> int:
        return {"all-xyz": 8, "cxyz": 4}[self.mode]

    @property
    def pos_dim(self) -> int:
        return 3 * (1 + 2 * self.embedder_num_freq) * self.n_points


@dataclasses.dataclass(frozen=True)
class BEVControlNetConfig:
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    camera_in_dim: int = 189
    camera_out_dim: int = 768
    cam_num_freqs: int = 4
    uncond_cam_in_dim: Tuple[int, int] = (3, 7)
    map_size: Tuple[int, int, int] = (8, 200, 200)  # (C, H, W)
    map_embedder_out_channels: Tuple[int, ...] = (16, 32, 96, 256)
    # the hi-res map embedder: stride 1 at its first stage, then an adaptive
    # average pool to ``map_embedder_plus_size`` (h, w)
    use_map_embedder_plus: bool = False
    map_embedder_plus_size: Tuple[int, int] = (34, 92)
    bbox: BBoxEmbedderConfig = dataclasses.field(
        default_factory=BBoxEmbedderConfig)
    # training: views whose conditioning is dropped lose their boxes too
    drop_cam_with_box: bool = False
    # the unconditional map (ref:unet_addon_rawbox.py:188-202): None |
    # negative1 | random | learnable
    use_uncond_map: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    num_inference_steps: int = 20
    guidance_scale: float = 2.0
    conditioning_scale: float = 1.0
    sampler: str = "unipc"  # unipc | ddim
    use_zero_map_as_unconditional: bool = False
    # ControlNet guess mode (ref:pipeline_bev_controlnet.py:361-405): the
    # ControlNet runs on the conditional CFG branch only, with logspace
    # residual scaling; the unconditional branch gets zero residuals and the
    # uncond token sequence
    guess_mode: bool = False
    latent_height: int = 28
    latent_width: int = 50
    n_cam: int = 6
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    """``map_hw`` and ``map_channels`` are the BEV map a request carries,
    which the fixture data is made at; ``controlnet.map_size`` is the same
    map as the embedder reads it."""
    name: str
    unet: UNetConfig
    controlnet: BEVControlNetConfig
    vae: VAEConfig
    clip: CLIPTextConfig
    pipeline: PipelineConfig
    image_size: Tuple[int, int]  # (H, W)
    map_hw: Tuple[int, int] = (200, 200)
    map_channels: int = 8
    bbox_max_len: int = 160


def sd15mv_rawbox_224x400() -> ModelPreset:
    """The 224x400 model (ref:configs/exp/224x400.yaml)."""
    unet = UNetConfig(neighboring_view_pair=NUSCENES_NEIGHBORS)
    cn = BEVControlNetConfig(
        unet=dataclasses.replace(unet, neighboring_view_pair=None),
        map_size=(8, 200, 200),
        map_embedder_out_channels=(16, 32, 96, 256),
        bbox=BBoxEmbedderConfig(mode="all-xyz"),
    )
    return ModelPreset(
        name="SDv1.5mv-rawbox-224x400", unet=unet, controlnet=cn,
        vae=VAEConfig(), clip=CLIPTextConfig(),
        pipeline=PipelineConfig(latent_height=28, latent_width=50),
        image_size=(224, 400),
    )


def sd15mv_rawbox_272x736() -> ModelPreset:
    """The hi-res model with the Plus map embedder
    (ref:configs/exp/272x736.yaml): latent 34x92, map 200x200."""
    unet = UNetConfig(neighboring_view_pair=NUSCENES_NEIGHBORS)
    cn = BEVControlNetConfig(
        unet=dataclasses.replace(unet, neighboring_view_pair=None),
        map_size=(8, 200, 200),
        use_map_embedder_plus=True,
        map_embedder_plus_size=(34, 92),
        bbox=BBoxEmbedderConfig(mode="all-xyz"),
    )
    return ModelPreset(
        name="SDv1.5mv-rawbox-272x736", unet=unet, controlnet=cn,
        vae=VAEConfig(), clip=CLIPTextConfig(),
        pipeline=PipelineConfig(latent_height=34, latent_width=92),
        image_size=(272, 736),
    )


def sd15mv_rawbox_424x800() -> ModelPreset:
    """The released visualization-quality model
    (ref:configs/exp/424x800.yaml): latent 53x100, a 400x400 map through
    the standard embedder (400x400 -> 53x100)."""
    unet = UNetConfig(neighboring_view_pair=NUSCENES_NEIGHBORS)
    cn = BEVControlNetConfig(
        unet=dataclasses.replace(unet, neighboring_view_pair=None),
        map_size=(8, 400, 400),
        map_embedder_out_channels=(16, 32, 96, 256),
        bbox=BBoxEmbedderConfig(mode="all-xyz"),
    )
    return ModelPreset(
        name="SDv1.5mv-rawbox-424x800", unet=unet, controlnet=cn,
        vae=VAEConfig(), clip=CLIPTextConfig(),
        pipeline=PipelineConfig(latent_height=53, latent_width=100),
        image_size=(424, 800), map_hw=(400, 400),
    )


def sd15mv_rawbox_video_16f() -> ModelPreset:
    """The 16-frame multi-view video model: the 224x400 model with temporal
    attention in every transformer block of the UNet; the ControlNet's
    stays without (SURVEY.md §2.5, the MagicDrive-t capability)."""
    base = sd15mv_rawbox_224x400()
    return dataclasses.replace(
        base, name="SDv1.5mv-rawbox-video16",
        unet=dataclasses.replace(base.unet, temporal_frames=16))


def tiny_debug(n_cam: int = 6) -> ModelPreset:
    """CPU-sized model with the 224x400 geometry, for tests; ``n_cam``
    cameras on a ring."""
    neighbors = NUSCENES_NEIGHBORS if n_cam == 6 else tuple(
        ((i - 1) % n_cam, (i + 1) % n_cam) for i in range(n_cam))
    unet = UNetConfig(
        block_out_channels=(8, 16, 16, 16), num_attention_heads=2,
        cross_attention_dim=16, norm_num_groups=4,
        neighboring_view_pair=neighbors)
    cn = BEVControlNetConfig(
        unet=dataclasses.replace(unet, neighboring_view_pair=None),
        camera_out_dim=16, map_size=(8, 200, 200),
        map_embedder_out_channels=(4, 4, 8, 8),
        bbox=BBoxEmbedderConfig(class_token_dim=16, proj_dims=(16, 8, 8, 16)),
    )
    return ModelPreset(
        name="tiny-debug", unet=unet, controlnet=cn,
        vae=VAEConfig(block_out_channels=(4, 4, 8, 8), layers_per_block=1,
                      norm_num_groups=2),
        clip=CLIPTextConfig(vocab_size=49408, hidden_size=16, num_layers=2,
                            num_heads=2, intermediate_size=32),
        pipeline=PipelineConfig(latent_height=28, latent_width=50,
                                num_inference_steps=4, n_cam=n_cam,
                                dtype=torch.float32),
        image_size=(224, 400), bbox_max_len=8,
    )


def tiny_video_debug(n_frames: int = 4, n_cam: int = 6) -> ModelPreset:
    """CPU-sized video model: ``tiny_debug`` with temporal attention over
    ``n_frames`` frames in the UNet."""
    base = tiny_debug(n_cam=n_cam)
    return dataclasses.replace(
        base, name="tiny-video-debug",
        unet=dataclasses.replace(base.unet, temporal_frames=n_frames))


def small_parity(n_cam: int = 6) -> ModelPreset:
    """Every key pattern of the released checkpoints (4 UNet and 4 VAE
    blocks, CLIP's layout) at narrow widths: the converter's self-test
    architecture (``cli.convert_weights --arch small-test``). The standard
    map embedder maps the 200x200 BEV to the 28x50 latent."""
    unet = UNetConfig(
        block_out_channels=(32, 32, 64, 64), layers_per_block=2,
        num_attention_heads=4, cross_attention_dim=32, norm_num_groups=8,
        neighboring_view_pair=NUSCENES_NEIGHBORS)
    cn = BEVControlNetConfig(
        unet=dataclasses.replace(unet, neighboring_view_pair=None),
        camera_out_dim=32, map_size=(8, 200, 200),
        map_embedder_out_channels=(4, 8, 16, 16),
        bbox=BBoxEmbedderConfig(n_classes=10, class_token_dim=32,
                                proj_dims=(32, 16, 16, 32)),
    )
    return ModelPreset(
        name="small-parity", unet=unet, controlnet=cn,
        vae=VAEConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                      norm_num_groups=8),
        clip=CLIPTextConfig(vocab_size=49408, hidden_size=32, num_layers=2,
                            num_heads=4, intermediate_size=64),
        pipeline=PipelineConfig(latent_height=28, latent_width=50,
                                num_inference_steps=2, n_cam=n_cam,
                                dtype=torch.float32),
        image_size=(224, 400), bbox_max_len=8,
    )


# values of the JAX package's model config that the port implements; a
# config naming another raises rather than building a different model
_PORTED = {
    ("unet", "neighboring_attn_type"): ("add",),
    ("unet", "zero_module_type"): ("zero_linear",),
    ("bbox_embedder_param", "trainable_class_token"): (False,),
    ("bbox_embedder_param", "minmax_normalize"): (False,),
}


def _check_ported(mc) -> None:
    for (section, key), ok in _PORTED.items():
        v = mc[section].get(key, ok[0])
        if v not in ok:
            raise NotImplementedError(
                f"model.{section}.{key}={v!r}: the port implements only "
                f"{ok} (ROADMAP Queue A)")


def preset_from_config(cfg) -> ModelPreset:
    """A ModelPreset from a composed config tree (``config_loader.compose``
    over the repository's ``configs/``), as the JAX package's
    ``preset_from_config`` builds it. The UNet's launch-layout keys and the
    ControlNet's training drop ratios
    (the port's ``TrainConfig``) have no field here; the UNet's
    ``gradient_checkpointing`` and ``remat_policy`` (default "dots") do."""
    mc, dc, rc = cfg["model"], cfg["dataset"], cfg["runner"]
    _check_ported(mc)
    H, W = dc["image_size"]
    neighbors = tuple(tuple(p) for p in dc["neighboring_view_pair"])
    u = mc["unet"]
    unet = UNetConfig(
        block_out_channels=tuple(u["block_out_channels"]),
        layers_per_block=u["layers_per_block"],
        num_attention_heads=u["num_attention_heads"],
        cross_attention_dim=u["cross_attention_dim"],
        norm_num_groups=u["norm_num_groups"],
        neighboring_view_pair=neighbors,
        gradient_checkpointing=bool(u.get("gradient_checkpointing", False)),
        remat_policy=u.get("remat_policy", "dots") or None)
    cn_c = mc["controlnet"]
    be = mc["bbox_embedder_param"]
    cn = BEVControlNetConfig(
        unet=dataclasses.replace(unet, neighboring_view_pair=None),
        camera_in_dim=cn_c["camera_in_dim"],
        camera_out_dim=cn_c["camera_out_dim"],
        cam_num_freqs=cn_c["cam_num_freqs"],
        map_size=tuple(cn_c["map_size"]),
        map_embedder_out_channels=tuple(cn_c["map_embedder_out_channels"]),
        use_map_embedder_plus=bool(cn_c["use_map_embedder_plus"]),
        map_embedder_plus_size=tuple(cn_c["map_embedder_plus_size"])
        if cn_c.get("map_embedder_plus_size") else (34, 92),
        bbox=BBoxEmbedderConfig(
            n_classes=be["n_classes"],
            class_token_dim=be["class_token_dim"],
            embedder_num_freq=be["embedder_num_freq"],
            proj_dims=tuple(be["proj_dims"]),
            mode=mc["bbox_mode"]),
        drop_cam_with_box=cn_c["drop_cam_with_box"],
        use_uncond_map=cn_c.get("use_uncond_map"))
    pp = rc["pipeline_param"]
    pipeline = PipelineConfig(
        num_inference_steps=pp["num_inference_steps"],
        guidance_scale=pp["guidance_scale"],
        conditioning_scale=pp["controlnet_conditioning_scale"],
        sampler=pp["sampler"],
        use_zero_map_as_unconditional=pp["use_zero_map_as_unconditional"],
        guess_mode=bool(pp.get("guess_mode", False)),
        latent_height=H // 8, latent_width=W // 8,
        n_cam=len(neighbors))
    map_c, map_h, map_w = cn_c["map_size"]
    vae_cfg = VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in mc["vae"].items()}) \
        if mc.get("vae") else VAEConfig()
    clip_cfg = CLIPTextConfig(**mc["clip"]) if mc.get("clip") \
        else CLIPTextConfig()
    return ModelPreset(
        name=f"{mc['name']}-{H}x{W}", unet=unet, controlnet=cn,
        vae=vae_cfg, clip=clip_cfg, pipeline=pipeline,
        image_size=(H, W), map_hw=(map_h, map_w), map_channels=map_c,
        bbox_max_len=rc["bbox_max_length"])
