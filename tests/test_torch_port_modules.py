"""The PyTorch port's modules against the JAX modules on the same weights.

Each JAX module is initialised, every floating variable is replaced with
seeded normals (so zero-initialised branches such as the cross-view
connector and the ControlNet zero-convs are live), the tree is converted
with ``magicdrive_tpu_torch.convert`` and loaded strictly into the port's
module. Both run in float32 on the CPU on inputs made with numpy; outputs
agree to atol 2e-4 / rtol 2e-3, the repo's harness tolerance
(tests/test_torch_parity.py). Shapes at or above the kernel threshold
(Lq*Lk >= 90 000) take the port's K1/K2 routes, or K8 and its pair under
MAGICDRIVE_FUSED_MODE=auto, which on the CPU run the kernels' plain
versions.
"""
import dataclasses
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 2e-3


def randomized(tree, rs):
    """Copy of a flax variable tree with every floating leaf replaced by
    seeded normals: fan-in scaled for kernels, 1 + 0.1 N for norm scales,
    0.1 N otherwise."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = randomized(v, rs)
            continue
        a = np.asarray(v)
        if not np.issubdtype(a.dtype, np.floating):
            out[k] = a
            continue
        std = 1.0 / np.sqrt(np.prod(a.shape[:-1])) if k == "kernel" else 0.1
        out[k] = (rs.randn(*a.shape) * std
                  + (1.0 if k == "scale" else 0.0)).astype(np.float32)
    return out


def scaled_kernels(tree, gain):
    """Copy of a variable tree with every ``kernel`` leaf times ``gain``.
    At half the fan-in scale the random network stops amplifying fp32
    rounding: see the files that use it."""
    return {k: scaled_kernels(v, gain) if isinstance(v, Mapping)
            else v * np.float32(gain) if k == "kernel" else v
            for k, v in tree.items()}


def shaped(tree, rs):
    """Seeded normals (``randomized``) on the shapes of an abstract
    variable tree from ``jax.eval_shape``: no forward runs to make them."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    return randomized(zeros, rs)


def init_random(module, seed, *args, **kwargs):
    variables = module.init(jax.random.PRNGKey(0), *args, **kwargs)
    return randomized(variables, np.random.RandomState(seed))


def load(port_module, variables, clip=False):
    from magicdrive_tpu_torch.convert import module_state_dict

    sd = module_state_dict(variables, clip=clip)
    port_module.load_state_dict({k: torch.from_numpy(v)
                                 for k, v in sd.items()}, strict=True)
    return port_module.eval()


def close(port_out, jax_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(
        port_out.detach().numpy() if torch.is_tensor(port_out) else port_out,
        np.asarray(jax_out), atol=atol, rtol=rtol)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_presets_match_jax():
    from magicdrive_tpu.config import presets as jp

    from magicdrive_tpu_torch import config as tp

    for name in ("sd15mv_rawbox_224x400", "sd15mv_rawbox_272x736",
                 "sd15mv_rawbox_424x800", "sd15mv_rawbox_video_16f",
                 "tiny_debug", "tiny_video_debug", "small_parity"):
        j, t = getattr(jp, name)(), getattr(tp, name)()
        for part in ("unet", "vae", "clip"):
            jc, tc = getattr(j, part), getattr(t, part)
            for f in dataclasses.fields(tc):
                assert getattr(tc, f.name) == getattr(jc, f.name), \
                    (name, part, f.name)
        for f in dataclasses.fields(t.controlnet):
            if f.name not in ("unet", "bbox"):
                assert getattr(t.controlnet, f.name) == \
                    getattr(j.controlnet, f.name), (name, f.name)
        for f in dataclasses.fields(t.controlnet.bbox):
            assert getattr(t.controlnet.bbox, f.name) == \
                getattr(j.controlnet.bbox, f.name), (name, f.name)
        for f in dataclasses.fields(t.controlnet.unet):
            assert getattr(t.controlnet.unet, f.name) == \
                getattr(j.controlnet.unet, f.name), (name, f.name)
        assert t.controlnet.unet == dataclasses.replace(
            t.unet, neighboring_view_pair=None,
            temporal_frames=t.controlnet.unet.temporal_frames)
        for f in ("num_inference_steps", "guidance_scale",
                  "conditioning_scale", "sampler",
                  "use_zero_map_as_unconditional", "guess_mode",
                  "latent_height", "latent_width", "n_cam"):
            assert getattr(t.pipeline, f) == getattr(j.pipeline, f), f
        for f in ("name", "image_size", "map_hw", "map_channels",
                  "bbox_max_len"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_embeddings():
    from magicdrive_tpu.core import embeddings as je

    from magicdrive_tpu_torch.core import embeddings as te

    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 3).astype(np.float32) * 3
    close(te.fourier_embed(torch.from_numpy(x), 4), je.fourier_embed(
        jnp.asarray(x), 4), atol=1e-5, rtol=1e-5)
    # sin/cos of fp32 arguments up to 999 rad, where one ulp is 6e-5: the
    # harness tolerance, not the tighter one above
    t = np.array([0, 1, 499, 999], np.int64)
    close(te.get_timestep_embedding(torch.from_numpy(t), 320),
          je.get_timestep_embedding(jnp.asarray(t), 320))


@pytest.mark.parametrize("cin,cout,temb", [(8, 16, 32), (16, 16, None)])
def test_resnet_block(cin, cout, temb):
    from magicdrive_tpu.core.resnet import ResnetBlock2D as J

    from magicdrive_tpu_torch.core.resnet import ResnetBlock2D as T

    rs = np.random.RandomState(1)
    x = rs.randn(2, 12, 10, cin).astype(np.float32)
    te = None if temb is None else rs.randn(2, temb).astype(np.float32)
    jm = J(cout, groups=4)
    args = (jnp.asarray(x),) + (() if te is None else (jnp.asarray(te),))
    v = init_random(jm, 2, *args)
    tm = load(T(cin, cout, temb, groups=4), v)
    with torch.no_grad():
        got = tm(nchw(x), None if te is None else torch.from_numpy(te))
    close(to_nhwc(got), jm.apply(v, *args))


@pytest.mark.parametrize("L,Lk", [(48, 48), (320, 320), (320, 24)])
def test_attention(L, Lk):
    """(48, 48) and (320, 24) take SDPA; (320, 320) the K1 route."""
    from magicdrive_tpu.core.attention import Attention as J

    from magicdrive_tpu_torch.core.attention import Attention as T

    rs = np.random.RandomState(3)
    C, Ck, H, D = 32, 24, 2, 16
    x = rs.randn(3, L, C).astype(np.float32)
    ctx = x if Lk == L else rs.randn(3, Lk, Ck).astype(np.float32)
    cross = None if Lk == L else Ck
    jm = J(C, H, D, cross_attention_dim=cross)
    jargs = (jnp.asarray(x),) + (() if cross is None else (jnp.asarray(ctx),))
    v = init_random(jm, 4, *jargs)
    tm = load(T(C, H, D, cross_attention_dim=cross), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x),
                 None if cross is None else torch.from_numpy(ctx))
    close(got, jm.apply(v, *jargs))


@pytest.mark.parametrize("L", [40, 320])
def test_transformer_block_with_cross_view(L):
    """Self, text-cross and cross-view (ring neighbours, add mode, live
    connector) attention plus the GEGLU FF; L=320 takes the K1/K2/K3
    routes, L=40 the SDPA ones."""
    from magicdrive_tpu.core.transformer import BasicTransformerBlock as J
    from magicdrive_tpu.models.unet import NUSCENES_NEIGHBORS

    from magicdrive_tpu_torch.core.transformer import (
        BasicTransformerBlock as T)

    rs = np.random.RandomState(5)
    C, H, D, Cc = 32, 2, 16, 24
    x = rs.randn(12, L, C).astype(np.float32)
    ctx = rs.randn(12, 7, Cc).astype(np.float32)
    jm = J(C, H, D, cross_attention_dim=Cc,
           neighboring_view_pair=NUSCENES_NEIGHBORS)
    v = init_random(jm, 6, jnp.asarray(x), jnp.asarray(ctx))
    tm = load(T(C, H, D, Cc, NUSCENES_NEIGHBORS), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(ctx)))


@pytest.mark.parametrize("Lk", [320, 300])
def test_attention_auto(Lk):
    """Under MAGICDRIVE_FUSED_MODE=auto: self- and cross-attention above the
    kernel threshold take K8, out-projected in the kernel, bias added
    outside."""
    from magicdrive_tpu.core.attention import Attention as J

    from magicdrive_tpu_torch.core.attention import Attention as T
    from magicdrive_tpu_torch.kernels import dispatch

    rs = np.random.RandomState(7)
    L, C, Ck, H, D = 320, 32, 24, 2, 16
    x = rs.randn(3, L, C).astype(np.float32)
    ctx = x if Lk == L else rs.randn(3, Lk, Ck).astype(np.float32)
    cross = None if Lk == L else Ck
    jm = J(C, H, D, cross_attention_dim=cross)
    jargs = (jnp.asarray(x),) + (() if cross is None else (jnp.asarray(ctx),))
    v = init_random(jm, 8, *jargs)
    tm = load(T(C, H, D, cross_attention_dim=cross), v)
    with dispatch.fused_mode("auto"), torch.no_grad():
        assert dispatch.attention_route(L, Lk, C, D, 4) == "out"
        got = tm(torch.from_numpy(x),
                 None if cross is None else torch.from_numpy(ctx))
    close(got, jm.apply(v, *jargs))


def test_transformer_block_with_cross_view_auto():
    """The block of test_transformer_block_with_cross_view at L=320 under
    MAGICDRIVE_FUSED_MODE=auto: attn1 and the cross-view pair take K8 and
    the K8 pair (bias counted twice), attn2 (L*7 logits) SDPA."""
    from magicdrive_tpu.core.transformer import BasicTransformerBlock as J
    from magicdrive_tpu.models.unet import NUSCENES_NEIGHBORS

    from magicdrive_tpu_torch.core.transformer import (
        BasicTransformerBlock as T)
    from magicdrive_tpu_torch.kernels import dispatch

    rs = np.random.RandomState(9)
    L, C, H, D, Cc = 320, 32, 2, 16, 24
    x = rs.randn(12, L, C).astype(np.float32)
    ctx = rs.randn(12, 7, Cc).astype(np.float32)
    jm = J(C, H, D, cross_attention_dim=Cc,
           neighboring_view_pair=NUSCENES_NEIGHBORS)
    v = init_random(jm, 10, jnp.asarray(x), jnp.asarray(ctx))
    tm = load(T(C, H, D, Cc, NUSCENES_NEIGHBORS), v)
    with dispatch.fused_mode("auto"), torch.no_grad():
        assert dispatch.pair_route(L, C, D, 4) == "out"
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(ctx)))


def test_clip_text():
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.clip_text import CLIPTextModel as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.clip_text import CLIPTextModel as T

    ids = np.zeros((2, 77), np.int32)
    ids[:, 0] = 49406
    ids[0, 1:6] = [320, 1125, 539, 2368, 49407]
    ids[1, 1:3] = [7, 49407]
    jm = J(jtiny().clip)
    v = init_random(jm, 7, jnp.asarray(ids))
    tm = load(T(tiny_debug().clip), v, clip=True)
    with torch.no_grad():
        hidden, pooled = tm(torch.from_numpy(ids.astype(np.int64)))
    jh, jpool = jm.apply(v, jnp.asarray(ids))
    close(hidden, jh)
    close(pooled, jpool)


def test_bbox_embedder_and_camera():
    from magicdrive_tpu.models.embedders import (
        BBoxEmbedderConfig as JC, ContinuousBBoxWithTextEmbedding as J,
        embed_camera as j_embed_camera)

    from magicdrive_tpu_torch.config import BBoxEmbedderConfig as TC
    from magicdrive_tpu_torch.models.embedders import (
        ContinuousBBoxWithTextEmbedding as T, embed_camera)

    rs = np.random.RandomState(8)
    boxes = rs.randn(2, 6, 5, 8, 3).astype(np.float32) * 10
    classes = rs.randint(-1, 10, (2, 6, 5)).astype(np.int32)
    masks = (rs.rand(2, 6, 5) > 0.4).astype(np.float32)
    kw = dict(class_token_dim=16, proj_dims=(16, 8, 8, 16))
    jm = J(JC(**kw))
    jargs = tuple(map(jnp.asarray, (boxes, classes, masks)))
    v = init_random(jm, 9, *jargs)
    # under the ControlNet's scope name, where the class-token buffer's
    # special key ("bbox_embedder._class_tokens") applies
    tm = load(torch.nn.ModuleDict({"bbox_embedder": T(TC(**kw))}),
              {c: {"bbox_embedder": tree} for c, tree in v.items()})
    with torch.no_grad():
        got = tm["bbox_embedder"](torch.from_numpy(boxes),
                                  torch.from_numpy(classes),
                                  torch.from_numpy(masks))
    close(got, jm.apply(v, *jargs))

    cam = rs.randn(2, 6, 3, 7).astype(np.float32)
    close(embed_camera(torch.from_numpy(cam)),
          j_embed_camera(jnp.asarray(cam)), atol=1e-5, rtol=1e-5)


def test_map_embedder():
    from magicdrive_tpu.models.embedders import BEVMapEmbedder as J

    from magicdrive_tpu_torch.models.embedders import BEVMapEmbedder as T

    rs = np.random.RandomState(10)
    bev = (rs.rand(1, 200, 200, 8) > 0.5).astype(np.float32)
    jm = J(block_out_channels=(4, 4, 8, 8), out_channels=8)
    v = init_random(jm, 11, jnp.asarray(bev))
    tm = load(T(8, (4, 4, 8, 8), 8), v)
    with torch.no_grad():
        got = tm(nchw(bev))
    want = jm.apply(v, jnp.asarray(bev))
    assert want.shape == (1, 28, 50, 8)
    close(to_nhwc(got), want)


def _tiny_inputs(rs, L=8):
    return dict(
        x=rs.randn(1, 6, 28, 50, 4).astype(np.float32),
        t=np.array([421], np.int32),
        cam=rs.randn(1, 6, 3, 7).astype(np.float32),
        text=rs.randn(1, 77, 16).astype(np.float32),
        bev=(rs.rand(1, 200, 200, 8) > 0.5).astype(np.float32),
        boxes=rs.randn(1, 6, L, 8, 3).astype(np.float32) * 10,
        classes=rs.randint(-1, 10, (1, 6, L)).astype(np.int32),
        masks=(rs.rand(1, 6, L) > 0.4).astype(np.float32))


def test_unet_tiny_with_residuals():
    """tiny_debug multiview UNet at the 28x50 latent (levels 0/1 take the
    K1/K2/K3 routes) with ControlNet residuals added."""
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.unet import UNet2DConditionModel as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.unet import UNet2DConditionModel as T

    rs = np.random.RandomState(12)
    x = rs.randn(6, 28, 50, 4).astype(np.float32)
    t = np.full((6,), 421, np.int32)
    ctx = rs.randn(6, 86, 16).astype(np.float32)
    chans = [8, 8, 8, 8, 16, 16, 16, 16, 16, 16, 16, 16]
    hw = [(28, 50)] * 3 + [(14, 25)] * 3 + [(7, 13)] * 3 + [(4, 7)] * 3
    down = [rs.randn(6, h, w, c).astype(np.float32) * 0.5
            for (h, w), c in zip(hw, chans)]
    mid = rs.randn(6, 4, 7, 16).astype(np.float32) * 0.5
    jm = J(jtiny().unet)
    v = init_random(jm, 13, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    tm = load(T(tiny_debug().unet), v)
    with torch.no_grad():
        got = tm(nchw(x), torch.from_numpy(t.astype(np.int64)),
                 torch.from_numpy(ctx),
                 down_block_additional_residuals=[nchw(d) for d in down],
                 mid_block_additional_residual=nchw(mid))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                    down_block_additional_residuals=[jnp.asarray(d)
                                                     for d in down],
                    mid_block_additional_residual=jnp.asarray(mid))
    close(to_nhwc(got), want)


def test_controlnet_tiny():
    """tokens, down residuals and the mid residual (zero-convs live)."""
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.controlnet import BEVControlNet as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet as T

    d = _tiny_inputs(np.random.RandomState(14))
    jargs = tuple(jnp.asarray(d[k]) for k in (
        "x", "t", "cam", "text", "bev", "boxes", "classes", "masks"))
    jm = J(jtiny().controlnet)
    v = init_random(jm, 15, *jargs, conditioning_scale=0.7)
    tm = load(T(tiny_debug().controlnet), v)
    with torch.no_grad():
        down, mid, tokens = tm(
            torch.from_numpy(d["x"].transpose(0, 1, 4, 2, 3).copy()),
            torch.from_numpy(d["t"].astype(np.int64)),
            torch.from_numpy(d["cam"]), torch.from_numpy(d["text"]),
            nchw(d["bev"]), torch.from_numpy(d["boxes"]),
            torch.from_numpy(d["classes"]), torch.from_numpy(d["masks"]),
            conditioning_scale=0.7)
    j_down, j_mid, j_tokens = jm.apply(v, *jargs, conditioning_scale=0.7)
    close(tokens, j_tokens)
    close(to_nhwc(mid), j_mid)
    assert len(down) == len(j_down) == 12
    for a, b in zip(down, j_down):
        close(to_nhwc(a), b)


def test_vae_decoder():
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.vae import AutoencoderKL as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.vae import AutoencoderKL as T

    rs = np.random.RandomState(16)
    z = rs.randn(2, 8, 12, 4).astype(np.float32)
    jm = J(jtiny().vae)
    v = init_random(jm, 17, jnp.zeros((1, 64, 96, 3)))
    tm = load(T(tiny_debug().vae), v)  # the encoder side loads too
    with torch.no_grad():
        got = tm.decode(nchw(z))
    close(to_nhwc(got), jm.apply(v, jnp.asarray(z), method=J.decode))


def test_vae_encode_with_explicit_noise():
    """The posterior moments (logvar clipped to [-30, 20]), a scaled sample
    with given noise, and the scaled mean without."""
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.vae import AutoencoderKL as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.vae import AutoencoderKL as T

    rs = np.random.RandomState(18)
    x = rs.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)
    noise = rs.randn(2, 8, 12, 4).astype(np.float32)
    jm = J(jtiny().vae)
    v = init_random(jm, 19, jnp.zeros((1, 64, 96, 3)))
    tm = load(T(tiny_debug().vae), v)
    jx = jnp.asarray(x)
    with torch.no_grad():
        mean, logvar = tm.encode_moments(nchw(x))
        sample = tm.encode(nchw(x), nchw(noise))
        scaled_mean = tm.encode(nchw(x))
    j_mean, j_logvar = jm.apply(v, jx, method=J.encode_moments)
    close(to_nhwc(mean), j_mean)
    close(to_nhwc(logvar), j_logvar)
    close(to_nhwc(sample), jm.apply(v, jx, jnp.asarray(noise),
                                    method=J.encode))
    close(to_nhwc(scaled_mean), jm.apply(v, jx, method=J.encode))
    assert float(np.abs(to_nhwc(sample) - to_nhwc(scaled_mean)).max()) > 0.01


@pytest.mark.parametrize("drop_cam_with_box", [False, True])
def test_controlnet_tokens_with_drop_mask(drop_cam_with_box):
    """The training condition drop: dropped views take the uncond camera
    token and the uncond text (and, with drop_cam_with_box, lose their
    boxes); kept views are unchanged."""
    from magicdrive_tpu.config.presets import tiny_debug as jtiny
    from magicdrive_tpu.models.controlnet import BEVControlNet as J

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet as T

    rs = np.random.RandomState(20)
    d = _tiny_inputs(rs)
    uncond = rs.randn(1, 77, 16).astype(np.float32)
    drop = np.array([[1, 0, 0, 1, 1, 0]], np.float32)
    jcfg = dataclasses.replace(jtiny().controlnet,
                               drop_cam_with_box=drop_cam_with_box)
    tcfg = dataclasses.replace(tiny_debug().controlnet,
                               drop_cam_with_box=drop_cam_with_box)
    jargs = tuple(jnp.asarray(d[k]) for k in (
        "x", "t", "cam", "text", "bev", "boxes", "classes", "masks"))
    jm = J(jcfg)
    v = init_random(jm, 21, *jargs)
    tm = load(T(tcfg), v)
    targs = [torch.from_numpy(d[k]) for k in ("cam", "text", "boxes",
                                                "classes", "masks")]
    with torch.no_grad():
        got = tm.assemble_tokens(*targs, torch.from_numpy(uncond),
                                 torch.from_numpy(drop))
        kept = tm.assemble_tokens(*targs)
    want = jm.apply(v, *(jnp.asarray(d[k]) for k in (
        "cam", "text", "boxes", "classes", "masks")), jnp.asarray(uncond),
        jnp.asarray(drop), method=J.assemble_tokens)
    close(got, want)
    keep = drop[0] == 0
    np.testing.assert_array_equal(got.numpy()[0, keep], kept.numpy()[0, keep])
    assert not np.allclose(got.numpy()[0, ~keep, :78],
                           kept.numpy()[0, ~keep, :78])


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddpm_noise_and_targets(prediction_type):
    from magicdrive_tpu.diffusion import ddpm as jd
    from magicdrive_tpu.diffusion.schedules import NoiseSchedule as JS

    from magicdrive_tpu_torch.diffusion import NoiseSchedule, ddpm

    rs = np.random.RandomState(22)
    x0 = rs.randn(2, 6, 8, 12, 4).astype(np.float32)
    noise = rs.randn(2, 6, 8, 12, 4).astype(np.float32)
    t = np.array([[0, 999, 3, 500, 77, 250], [1, 2, 998, 640, 10, 400]])
    js, ts = JS.create(), NoiseSchedule.create()
    nchw5 = lambda a: torch.from_numpy(a.transpose(0, 1, 4, 2, 3).copy())
    back = lambda t_: t_.numpy().transpose(0, 1, 3, 4, 2)
    close(back(ddpm.add_noise(ts, nchw5(x0), nchw5(noise),
                              torch.from_numpy(t))),
          jd.add_noise(js, jnp.asarray(x0), jnp.asarray(noise),
                       jnp.asarray(t)), atol=1e-5, rtol=1e-5)
    close(back(ddpm.prediction_target(ts, nchw5(x0), nchw5(noise),
                                      torch.from_numpy(t), prediction_type)),
          jd.prediction_target(js, jnp.asarray(x0), jnp.asarray(noise),
                               jnp.asarray(t), prediction_type),
          atol=1e-5, rtol=1e-5)


def test_ddpm_draws_shapes_and_offset():
    """The port's own draws: timesteps in range, and the noise offset is
    one value per (sample, view, channel), shared over space."""
    from magicdrive_tpu_torch.diffusion import ddpm

    g = torch.Generator().manual_seed(0)
    t = ddpm.sample_timesteps(g, 4096, 1000)
    assert t.dtype == torch.long and 0 <= int(t.min()) and \
        int(t.max()) < 1000 and len(t.unique()) > 900
    base = ddpm.noise_with_offset(torch.Generator().manual_seed(1),
                                  (2, 6, 4, 8, 12))
    off = ddpm.noise_with_offset(torch.Generator().manual_seed(1),
                                 (2, 6, 4, 8, 12), noise_offset=0.5)
    d = (off - base).numpy()
    np.testing.assert_allclose(d, np.broadcast_to(d[..., :1, :1], d.shape),
                               atol=1e-6)
    assert np.abs(d).max() > 0.1


def test_unipc_20_steps_fixed_eps():
    """20 UniPC steps on a fixed deterministic eps model; the coefficient
    tables agree too."""
    from magicdrive_tpu.diffusion.samplers import make_unipc_coeffs as jmake
    from magicdrive_tpu.diffusion.schedules import sd15_schedule

    from magicdrive_tpu_torch.diffusion import (NoiseSchedule,
                                                make_unipc_coeffs)

    jc = jmake(sd15_schedule(), 20)
    tc = make_unipc_coeffs(NoiseSchedule.create(), 20)
    np.testing.assert_array_equal(tc.timesteps, jc.timesteps)
    for f in ("cv_a", "cv_b", "use_c", "c_a", "c_b", "c_d", "c_e", "p_a",
              "p_b", "p_c"):
        np.testing.assert_allclose(getattr(tc, f), getattr(jc, f),
                                   rtol=1e-12, atol=1e-12)

    rs = np.random.RandomState(18)
    w = rs.randn(4, 4).astype(np.float32) * 0.5
    x0 = rs.randn(2, 4, 8, 8).astype(np.float32)

    def eps_np(x, t):
        return np.tanh(np.einsum("bchw,cd->bdhw", x, w)) + 1e-4 * float(t)

    xj, sj = jnp.asarray(x0), jc.init_state(x0.shape)
    xt = torch.from_numpy(x0)
    st = tc.init_state(xt)
    for i in range(tc.num_steps):
        xj, sj = jc.step(i, xj, jnp.asarray(eps_np(np.asarray(xj),
                                                   jc.timesteps[i])), sj)
        xt, st = tc.step(i, xt, torch.from_numpy(
            eps_np(xt.numpy(), tc.timesteps[i])), st)
    close(xt, xj, atol=1e-5, rtol=1e-5)
