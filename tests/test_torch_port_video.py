"""Temporal attention and multi-view video generation in the port against
the JAX package.

The temporal block is held to JAX's ``BasicTransformerBlock`` with
``temporal_frames=2`` on converted, randomized weights (its zero-init
``connector_temp`` made non-zero); a fresh port block is the image block
until its connector trains, and mixes frames but not samples. Then
``tiny_video_debug(n_frames=2, n_cam=3)`` (the 224x400 geometry at narrow
widths, temporal attention in every UNet transformer) on randomized JAX
variables converted to the port, on the port's fixture clip: one guided
eps and a 2-step video pipeline from the same numpy latents (images at
atol 2e-3, tests/test_torch_port_slice.py). fp32 on the CPU.

The guided eps is held at atol 2e-3 / rtol 2e-3, the images' tolerance,
not the modules' 2e-4: on this randomized network the fp32 eps itself
strays up to 1.6e-3 from the float64 one (CFG 2.0, |eps| up to 4.5),
JAX's as the port's, so the modules' tolerance would test fp32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modules import close, init_random, load, shaped
from test_torch_port_slice import assert_converts_every_leaf

torch.set_num_threads(1)

N_FRAMES, N_CAM = 2, 3
_RING3 = ((2, 1), (0, 2), (1, 0))


def _port_block(temporal_frames=None, neighbors=_RING3):
    from magicdrive_tpu_torch.core.transformer import BasicTransformerBlock

    return BasicTransformerBlock(16, 2, 8, 16, neighbors, temporal_frames)


def test_temporal_block_matches_jax():
    """B=2 samples of 2 frames of 3 views, (b f n) = 12 sequences: the
    temporal attention regroups them as JAX does."""
    from magicdrive_tpu.core.transformer import BasicTransformerBlock as J

    rs = np.random.RandomState(60)
    x = rs.randn(2 * N_FRAMES * N_CAM, 10, 16).astype(np.float32)
    ctx = rs.randn(2 * N_FRAMES * N_CAM, 7, 16).astype(np.float32)
    jm = J(16, 2, 8, cross_attention_dim=16, neighboring_view_pair=_RING3,
           temporal_frames=N_FRAMES)
    v = init_random(jm, 61, jnp.asarray(x), jnp.asarray(ctx))
    assert np.abs(v["params"]["connector_temp"]["kernel"]).max() > 0
    tm = load(_port_block(N_FRAMES), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got, jm.apply(v, jnp.asarray(x), jnp.asarray(ctx)))


def test_temporal_block_identity_at_init():
    """With the zero-init connector_temp the video block, on the image
    block's weights, is the image block exactly."""
    torch.manual_seed(62)
    img, vid = _port_block(), _port_block(N_FRAMES)
    missing = vid.load_state_dict(img.state_dict(), strict=False)
    assert missing.unexpected_keys == []
    assert {k.split(".")[0] for k in missing.missing_keys} == {
        "norm_temp", "attn_temp", "connector_temp"}
    x = torch.randn(N_FRAMES * N_CAM, 10, 16)
    ctx = torch.randn(N_FRAMES * N_CAM, 7, 16)
    with torch.no_grad():
        assert torch.equal(vid(x, ctx), img(x, ctx))


def test_temporal_mixes_frames_not_samples():
    """A channel of sample 0's frame 1 moves sample 0's frame 0 (through
    the temporal attention alone: one view, no cross-view block) and leaves
    sample 1 as it was."""
    torch.manual_seed(63)
    blk = _port_block(N_FRAMES, neighbors=None)
    torch.nn.init.normal_(blk.connector_temp.weight, std=0.3)
    x = torch.randn(2 * N_FRAMES, 6, 16)  # (b f n), n = 1
    ctx = torch.randn(2 * N_FRAMES, 7, 16)
    x2 = x.clone()
    x2[1, :, 0] += 1.0
    with torch.no_grad():
        y, y2 = blk(x, ctx), blk(x2, ctx)
    assert (y2[0] - y[0]).abs().max() > 1e-4
    assert torch.equal(y2[2:], y[2:])


def _attend_frames_with(fault):
    """``BasicTransformerBlock._attend_frames`` with a planted fault in how
    its runs are put back: the last run's attention "dropped" (zeros in its
    rows) or the runs "shifted" (concatenated one run late)."""
    from magicdrive_tpu_torch.core import transformer

    def attend(self, h):
        runs = [self.attn_temp(r)
                for r in h.split(transformer.TEMPORAL_MAX_SEQUENCES)]
        if fault == "dropped":
            runs[-1] = torch.zeros_like(runs[-1])
        elif fault == "shifted":
            runs = runs[1:] + runs[:1]
        return torch.cat(runs)
    return attend


@pytest.mark.parametrize("fault", [None, "dropped", "shifted"])
def test_temporal_runs_below_the_grid_limit(monkeypatch, fault):
    """The temporal attention hands SDPA at most TEMPORAL_MAX_SEQUENCES
    sequences a call (a CUDA grid axis takes 65,535 blocks; the B=4 video
    has 67,200 at level 0). With the limit cut to 7, the (b n l) = 2 * 3 *
    10 = 60 sequences go in 9 runs, the last one short: ``_temporal`` in
    runs equals it in one call, and both match JAX's ``_temporal``
    (norm_temp, the regrouped attention and connector_temp). A run dropped
    or shifted when the runs are put back fails both comparisons."""
    import flax.linen as nn

    from magicdrive_tpu.core.transformer import BasicTransformerBlock as J
    from magicdrive_tpu_torch.core import transformer

    class JaxTemporal(J):
        """JAX's block with ``_temporal`` as its call (it defines its
        submodules inline, so it runs only inside a compact method)."""

        @nn.compact
        def __call__(self, x):
            return self._temporal(x)

    rs = np.random.RandomState(64)
    x = rs.randn(2 * N_FRAMES * N_CAM, 10, 16).astype(np.float32)
    ctx = rs.randn(2 * N_FRAMES * N_CAM, 7, 16).astype(np.float32)
    kw = dict(cross_attention_dim=16, neighboring_view_pair=_RING3,
              temporal_frames=N_FRAMES)
    v = init_random(J(16, 2, 8, **kw), 65, jnp.asarray(x), jnp.asarray(ctx))
    want = JaxTemporal(16, 2, 8, **kw).apply(v, jnp.asarray(x))
    tm = load(_port_block(N_FRAMES), v)

    def temporal():
        with torch.no_grad():
            xt = torch.from_numpy(x)
            return tm.connector_temp(tm._temporal(tm.norm_temp(xt)))

    assert 2 * N_CAM * 10 > 8 * 7
    whole = temporal()
    monkeypatch.setattr(transformer, "TEMPORAL_MAX_SEQUENCES", 7)
    if fault is not None:
        monkeypatch.setattr(transformer.BasicTransformerBlock,
                            "_attend_frames", _attend_frames_with(fault))
    in_runs = temporal()

    def check():
        torch.testing.assert_close(in_runs, whole, rtol=0, atol=1e-6)
        close(in_runs, want)
        close(whole, want)

    if fault is None:
        check()
    else:
        with pytest.raises(AssertionError):
            check()


@pytest.fixture(scope="module")
def video():
    """(JAX preset, its modules, randomized variables, the port's video
    pipeline on them, a 2-frame three-camera request, initial latents)."""
    from magicdrive_tpu.config import presets as jp

    from magicdrive_tpu_torch import config as tp
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.pipeline.video import VideoPipeline

    jpre, tpre = (dataclasses.replace(p, pipeline=dataclasses.replace(
        p.pipeline, num_inference_steps=2)) for p in (
        jp.tiny_video_debug(N_FRAMES, N_CAM),
        tp.tiny_video_debug(N_FRAMES, N_CAM)))
    assert tpre.unet.temporal_frames == N_FRAMES
    assert tpre.controlnet.unet.temporal_frames is None
    modules = jpre.modules(dtype=jnp.float32)
    params = shaped(jax.eval_shape(
        lambda k: jp.init_params(jpre, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(64))
    flat = jax.tree_util.tree_leaves_with_path(params["controlnet"])
    assert not any("attn_temp" in jax.tree_util.keystr(p) for p, _ in flat)
    sds = assert_converts_every_leaf(params, tpre)
    assert sum("attn_temp" in k for k in sds["unet"]) == 16 * 5
    mods = MagicDriveModules.create(tpre, device="cpu").load_state_dicts(
        sds).to("cpu", torch.float32)
    pipe = VideoPipeline(mods, tpre.pipeline, n_frames=N_FRAMES)
    # the port's data layer (JAX's salts its caption ids per process)
    batch = collate_fn(make_dataset(N_FRAMES),
                       CollateConfig(bbox_max_len=jpre.bbox_max_len))
    for k in ("camera_param", "bboxes", "classes", "masks"):
        batch[k] = np.ascontiguousarray(batch[k][:, :N_CAM])
    lat = np.repeat(np.random.RandomState(65).randn(
        N_FRAMES, 1, 28, 50, 4).astype(np.float32), N_CAM, axis=1)
    return jpre, modules, params, pipe, batch, lat


def _jax_guided_eps(m, params, cfg, x, t, batch):
    """One guided ControlNet + UNet evaluation, JAX ``_generate_fn``'s loop
    body on its default branch (NHWC latents (B, N, h, w, 4))."""
    from einops import rearrange, repeat

    from magicdrive_tpu.models.controlnet import BEVControlNet

    cn = params["controlnet"]
    B, N = x.shape[:2]
    text, _ = m.clip.apply(params["clip"], batch["input_ids"])
    uncond_text, _ = m.clip.apply(params["clip"], batch["uncond_ids"])
    uncond_cam = cn["params"]["uncond_cam"].reshape(3, 7)
    cam2 = jnp.concatenate([jnp.broadcast_to(
        uncond_cam, batch["camera_param"].shape), batch["camera_param"]])
    text2 = jnp.concatenate([jnp.broadcast_to(uncond_text, text.shape), text])
    zero_or = lambda k: jnp.concatenate([jnp.zeros_like(batch[k]), batch[k]])
    boxes2, classes2, masks2 = (zero_or(k) for k in
                                ("bboxes", "classes", "masks"))
    map2 = jnp.concatenate([batch["bev_map"], batch["bev_map"]])
    tokens2 = m.controlnet.apply(cn, cam2, text2, boxes2, classes2, masks2,
                                 method=BEVControlNet.assemble_tokens)
    lat2 = jnp.concatenate([x, x])
    t2 = jnp.full((2 * B,), t)
    down, mid, _ = m.controlnet.apply(
        cn, lat2, t2, cam2, text2, map2, boxes2, classes2, masks2,
        conditioning_scale=cfg.conditioning_scale, tokens=tokens2)
    eps = m.unet.apply(
        params["unet"], rearrange(lat2, "b n h w c -> (b n) h w c"),
        repeat(t2, "b -> (b n)", n=N),
        rearrange(tokens2, "b n l c -> (b n) l c"),
        down_block_additional_residuals=down,
        mid_block_additional_residual=mid)
    eps_u, eps_c = jnp.split(rearrange(eps, "(b n) h w c -> b n h w c",
                                       n=N), 2)
    return eps_u + cfg.guidance_scale * (eps_c - eps_u)


def test_video_guided_eps_matches_jax(video):
    """The eps, and the kernel wrappers called as often as in the image
    model (``chip_smoke.expected_launches``): the temporal attention
    (Lq = Lk = 2) calls none."""
    import chip_smoke
    from magicdrive_tpu_torch.config import tiny_video_debug
    from magicdrive_tpu_torch.kernels import dispatch

    jpre, modules, params, pipe, batch, _ = video
    x = np.random.RandomState(66).randn(N_FRAMES, N_CAM, 28, 50, 4).astype(
        np.float32)
    t = 761
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jax.jit(lambda p, x, b: _jax_guided_eps(
        modules, p, jpre.pipeline, x, t, b))(params, jnp.asarray(x), jb)
    p = pipe.pipe
    cond = p.conditioning(batch)
    with chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        got = p.guided_eps(torch.from_numpy(x).permute(0, 1, 4, 2, 3), t,
                           cond)
    close(got.permute(0, 1, 3, 4, 2), want, atol=2e-3)
    assert calls == chip_smoke.expected_launches(
        tiny_video_debug(N_FRAMES, N_CAM), dispatch.FUSED_MODE, forwards=1,
        esize=4)


def test_video_pipeline_matches_jax(video):
    """2 frames of one clip: (B*F, N, H, W, 3) images from the same
    latents."""
    from magicdrive_tpu.pipeline.video import VideoPipeline as J

    jpre, modules, params, pipe, batch, lat = video
    want = np.asarray(J(modules, params, jpre.pipeline, N_FRAMES)(
        {k: jnp.asarray(v) for k, v in batch.items()},
        latents=jnp.asarray(lat)))
    got = pipe(batch, latents=torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == (N_FRAMES, N_CAM, 224, 400, 3)
    assert 0.1 < want.std()
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_video_latents_fold_and_frames(video):
    """Per-frame noise shared by each frame's views; fold_frames leaves
    uncond_ids; a UNet of another frame count is refused."""
    from magicdrive_tpu_torch.pipeline.video import VideoPipeline

    pipe = video[3]
    lat = pipe.prepare_latents(2, torch.Generator().manual_seed(67))
    assert lat.shape == (2 * N_FRAMES, N_CAM, 28, 50, 4)
    assert torch.equal(lat[:, :1].expand_as(lat), lat)
    assert not torch.equal(lat[0], lat[1])
    per_frame = {"input_ids": np.zeros((2, N_FRAMES, 77), np.int64),
                 "uncond_ids": np.zeros((1, 77), np.int64),
                 "bboxes": np.zeros((2, N_FRAMES, N_CAM, 8, 8, 3))}
    folded = VideoPipeline.fold_frames(per_frame)
    assert folded["input_ids"].shape == (2 * N_FRAMES, 77)
    assert folded["bboxes"].shape == (2 * N_FRAMES, N_CAM, 8, 8, 3)
    assert folded["uncond_ids"] is per_frame["uncond_ids"]
    with pytest.raises(ValueError):
        VideoPipeline(pipe.pipe.m, pipe.pipe.cfg, n_frames=3)
