"""The generation pipeline's options in the port against the JAX package:
the DDIM sampler, guess mode, the zero and the ControlNet's unconditional
maps (negative1, random, learnable), pre-encoded prompt embeddings and a
fixed seed within the batch.

The pipelines run ``tiny_debug(n_cam=3)`` (the 224x400 geometry at narrow
widths, three cameras on a ring) for one UniPC step at B=1 on the port's
fixture request from the same numpy latents on converted weights, every floating JAX variable replaced
by seeded normals first (so the zero-initialised connectors and zero-convs
are live, and the unconditional map is not a constant); the [0, 1] images
agree to atol 2e-3 (tests/test_torch_port_slice.py). Modules agree to atol
2e-4 / rtol 2e-3. fp32 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from magicdrive_tpu_torch.kernels import dispatch
from test_torch_port_modules import close, nchw, shaped, to_nhwc
from test_torch_port_slice import assert_converts_every_leaf

torch.set_num_threads(1)

N_CAM = 3


def _presets(use_uncond_map=None, **pipeline):
    """(JAX preset, port preset): tiny_debug at three cameras, one step,
    with the ControlNet's ``use_uncond_map`` and the pipeline options."""
    from magicdrive_tpu.config import presets as jp

    from magicdrive_tpu_torch import config as tp

    out = []
    for cfg in (jp, tp):
        p = cfg.tiny_debug(n_cam=N_CAM)
        out.append(dataclasses.replace(
            p, controlnet=dataclasses.replace(p.controlnet,
                                              use_uncond_map=use_uncond_map),
            pipeline=dataclasses.replace(p.pipeline, num_inference_steps=1,
                                         **pipeline)))
    return out


def _cn_shapes(preset, controlnet):
    """The abstract variables of a JAX ControlNet at the preset's shapes
    (as ``init_params`` makes them)."""
    p = preset.pipeline
    N, L, h, w = p.n_cam, preset.bbox_max_len, p.latent_height, \
        p.latent_width
    z = jnp.zeros
    return jax.eval_shape(
        controlnet.init, jax.random.PRNGKey(0), z((1, N, h, w, 4)),
        z((1,), jnp.int32), z((1, N, 3, 7)),
        z((1, 77, preset.unet.cross_attention_dim)),
        z((1, *preset.map_hw, preset.map_channels)),
        z((1, N, L, preset.controlnet.bbox.n_points, 3)),
        z((1, N, L), jnp.int32), z((1, N, L)))


@pytest.fixture(scope="module")
def base():
    """Randomized JAX variables of the base preset, a three-camera request
    and its initial latents."""
    from magicdrive_tpu.config.presets import init_params

    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)

    jpre, _ = _presets()
    modules = jpre.modules(dtype=jnp.float32)
    params = shaped(jax.eval_shape(
        lambda k: init_params(jpre, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(40))
    # the port's data layer: JAX's equals it but for the caption ids, which
    # JAX hashes with Python's per-process salt (test_torch_port_slice.py)
    batch = collate_fn(make_dataset(1), CollateConfig(
        bbox_max_len=jpre.bbox_max_len))
    for k in ("camera_param", "bboxes", "classes", "masks"):
        batch[k] = np.ascontiguousarray(batch[k][:, :N_CAM])
    rs = np.random.RandomState(41)
    lat = np.repeat(rs.randn(1, 1, 28, 50, 4).astype(np.float32), N_CAM,
                    axis=1)
    return params, batch, lat


def _port_pipeline(tpre, params):
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)

    mods = MagicDriveModules.create(tpre, device="cpu").load_state_dicts(
        jax_params_to_state_dicts(params)).to("cpu", torch.float32)
    return MagicDrivePipeline(mods, tpre.pipeline)


# each option (or pair: the ControlNet's map takes precedence over the zero
# map) on its own JAX program; prompt embeddings ride with the zero map
_VARIANTS = {
    "guess_mode": (None, dict(guess_mode=True), False),
    "zero_map_prompt_embeds": (
        None, dict(use_zero_map_as_unconditional=True), True),
    "negative1_over_zero_map": (
        "negative1", dict(use_zero_map_as_unconditional=True), False),
    "random": ("random", {}, False),
    "learnable": ("learnable", {}, False),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_pipeline_option_matches_jax(base, variant):
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline as JPipe

    uncond_map, options, embeds = _VARIANTS[variant]
    params, batch, lat = base
    jpre, tpre = _presets(uncond_map, **options)
    modules = jpre.modules(dtype=jnp.float32)
    params = dict(params)
    if uncond_map is not None:
        params["controlnet"] = shaped(
            _cn_shapes(jpre, modules.controlnet), np.random.RandomState(42))
        sds = assert_converts_every_leaf(params, tpre)
        assert sds["controlnet"]["uncond_map"].shape == (8, 200, 200)
    batch = dict(batch)
    if embeds:  # unlike CLIP's output for the ids, which stay in the batch
        rs = np.random.RandomState(43)
        batch["prompt_embeds"] = rs.randn(1, 77, 16).astype(np.float32)
        batch["uncond_embeds"] = rs.randn(1, 77, 16).astype(np.float32)
    want = np.asarray(JPipe(modules, params, jpre.pipeline)(
        {k: jnp.asarray(v) for k, v in batch.items()},
        latents=jnp.asarray(lat)))
    with chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        got = _port_pipeline(tpre, params)(
            batch, latents=torch.from_numpy(lat)).numpy()
    assert got.shape == want.shape == (1, N_CAM, 224, 400, 3)
    assert 0.1 < want.std()
    np.testing.assert_allclose(got, want, atol=2e-3)
    # each option calls the kernel wrappers as the default path does (in
    # guess mode the ControlNet's calls are as many, at half the batch)
    assert calls == chip_smoke.expected_launches(tpre, dispatch.FUSED_MODE,
                                                 forwards=1, esize=4)


def test_uncond_map_modes_at_init():
    """A fresh port ControlNet: negative1 is a buffer of -1, random a buffer
    of normals, learnable a parameter; the strict load takes each."""
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet

    cfg = tiny_debug().controlnet
    got = {}
    for mode in ("negative1", "random", "learnable"):
        cn = BEVControlNet(dataclasses.replace(cfg, use_uncond_map=mode))
        got[mode] = cn.uncond_map
        assert cn.uncond_map.shape == (8, 200, 200)
        assert ("uncond_map" in dict(cn.named_parameters())) == \
            (mode == "learnable")
        cn.load_state_dict(cn.state_dict(), strict=True)
    assert bool((got["negative1"] == -1).all())
    assert 0.9 < float(got["random"].std()) < 1.1
    with pytest.raises(ValueError):
        BEVControlNet(dataclasses.replace(cfg, use_uncond_map="zeros"))


@pytest.fixture(scope="module")
def controlnet_pair():
    """A randomized JAX ControlNet with the negative1 map, the port's on the
    converted variables, and three-camera inputs."""
    from magicdrive_tpu.models.controlnet import BEVControlNet as J

    from magicdrive_tpu_torch.convert import module_state_dict
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet as T

    jpre, tpre = _presets("negative1")
    jm = J(jpre.controlnet, dtype=jnp.float32)
    v = shaped(_cn_shapes(jpre, jm), np.random.RandomState(44))
    tm = T(tpre.controlnet)
    tm.load_state_dict({k: torch.from_numpy(a) for k, a in
                        module_state_dict(v).items()}, strict=True)
    rs = np.random.RandomState(45)
    d = dict(
        x=rs.randn(1, N_CAM, 28, 50, 4).astype(np.float32),
        t=np.array([421], np.int32),
        cam=rs.randn(1, N_CAM, 3, 7).astype(np.float32),
        text=rs.randn(1, 77, 16).astype(np.float32),
        bev=(rs.rand(2, 200, 200, 8) > 0.5).astype(np.float32),
        boxes=rs.randn(1, N_CAM, 8, 8, 3).astype(np.float32) * 10,
        classes=rs.randint(-1, 10, (1, N_CAM, 8)).astype(np.int32),
        masks=(rs.rand(1, N_CAM, 8) > 0.4).astype(np.float32))
    return jm, v, tm.eval(), d


def test_controlnet_guess_mode_residuals(controlnet_pair):
    """The logspace scaling of the residuals, 0.1 to 1 times the
    conditioning scale, against JAX's forward with guess_mode."""
    jm, v, tm, d = controlnet_pair
    keys = ("x", "t", "cam", "text", "bev", "boxes", "classes", "masks")
    jargs = [jnp.asarray(d[k]) for k in keys]
    jargs[4] = jargs[4][:1]
    j_down, j_mid, _ = jax.jit(lambda v, *a: jm.apply(
        v, *a, conditioning_scale=0.7, guess_mode=True))(v, *jargs)
    with torch.no_grad():
        args = (torch.from_numpy(d["x"].transpose(0, 1, 4, 2, 3).copy()),
                torch.from_numpy(d["t"].astype(np.int64)),
                torch.from_numpy(d["cam"]), torch.from_numpy(d["text"]),
                nchw(d["bev"][:1]), torch.from_numpy(d["boxes"]),
                torch.from_numpy(d["classes"]), torch.from_numpy(d["masks"]))
        down, mid, _ = tm(*args, conditioning_scale=0.7, guess_mode=True)
        plain, plain_mid, _ = tm(*args, conditioning_scale=0.7)
    close(to_nhwc(mid), j_mid)
    assert len(down) == len(j_down) == 12
    for a, b in zip(down, j_down):
        close(to_nhwc(a), b)
    scales = np.logspace(-1, 0, 13)
    for a, b, s in zip(down, plain, scales):
        close(a.numpy(), b.numpy() * s, atol=1e-6, rtol=1e-5)
    close(plain_mid.numpy(), mid.numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_substitute_with_uncond_map(controlnet_pair, masked):
    """The maps of the masked samples (all without a mask) become the
    ControlNet's unconditional map, in the port's (C, H, W) layout."""
    from magicdrive_tpu.models.controlnet import BEVControlNet as J

    jm, v, tm, d = controlnet_pair
    mask = np.array([1.0, 0.0], np.float32) if masked else None
    want = jm.apply(v, jnp.asarray(d["bev"]),
                    None if mask is None else jnp.asarray(mask),
                    method=J.substitute_with_uncond_map)
    with torch.no_grad():
        got = tm.substitute_with_uncond_map(
            nchw(d["bev"]), None if mask is None else torch.from_numpy(mask))
    close(to_nhwc(got), want, atol=0, rtol=0)
    if masked:
        np.testing.assert_array_equal(np.asarray(want)[1], d["bev"][1])


def test_controlnet_uncond_tokens(controlnet_pair):
    """Guess mode's negative-branch tokens: uncond camera, uncond text and
    null boxes."""
    from magicdrive_tpu.models.controlnet import BEVControlNet as J

    jm, v, tm, _ = controlnet_pair
    text = np.random.RandomState(46).randn(1, 77, 16).astype(np.float32)
    want = jm.apply(v, jnp.asarray(text), 8, method=J.uncond_tokens)
    with torch.no_grad():
        got = tm.uncond_tokens(torch.from_numpy(text), 8)
    assert got.shape == (1 + 77 + 8, 16)
    close(got, want)


def test_ddim_coeffs_match_jax():
    """The DDIM tables on the default grid and on an overriding one
    (diffusers' "leading" spacing)."""
    from magicdrive_tpu.diffusion.samplers import make_ddim_coeffs as jmake
    from magicdrive_tpu.diffusion.schedules import sd15_schedule

    from magicdrive_tpu_torch.diffusion import (NoiseSchedule,
                                                make_ddim_coeffs,
                                                make_sampler_coeffs)

    leading = np.arange(0, 1000, 50)[::-1] + 1
    for ts in (None, leading):
        jc = jmake(sd15_schedule(), 20, timesteps=ts)
        tc = make_ddim_coeffs(NoiseSchedule.create(), 20, timesteps=ts)
        np.testing.assert_array_equal(tc.timesteps, jc.timesteps)
        for f in ("a", "b"):
            np.testing.assert_allclose(getattr(tc, f), getattr(jc, f),
                                       rtol=0, atol=1e-10)
    assert type(make_sampler_coeffs(NoiseSchedule.create(), 20, "ddim")) \
        is type(tc)
    with pytest.raises(ValueError):
        make_sampler_coeffs(NoiseSchedule.create(), 20, "euler")


def test_ddim_20_steps_fixed_eps():
    """20 DDIM steps on a fixed deterministic eps model."""
    from magicdrive_tpu.diffusion.samplers import make_ddim_coeffs as jmake
    from magicdrive_tpu.diffusion.schedules import sd15_schedule

    from magicdrive_tpu_torch.diffusion import NoiseSchedule, make_ddim_coeffs

    jc = jmake(sd15_schedule(), 20)
    tc = make_ddim_coeffs(NoiseSchedule.create(), 20)
    rs = np.random.RandomState(47)
    w = rs.randn(4, 4).astype(np.float32) * 0.5
    x0 = rs.randn(2, 4, 8, 8).astype(np.float32)

    def eps_np(x, t):
        return np.tanh(np.einsum("bchw,cd->bdhw", x, w)) + 1e-4 * float(t)

    xj, xt = jnp.asarray(x0), torch.from_numpy(x0)
    sj, st = jc.init_state(x0.shape), tc.init_state(xt)
    for i in range(tc.num_steps):
        t = tc.timesteps[i]
        xj, sj = jc.step(i, xj, jnp.asarray(eps_np(np.asarray(xj), t)), sj)
        xt, st = tc.step(i, xt, torch.from_numpy(eps_np(xt.numpy(), t)), st)
    assert np.abs(np.asarray(xj) - x0).max() > 0.1
    close(xt, xj, atol=1e-5, rtol=1e-5)


def test_fix_seed_within_batch():
    """Every sample of the batch gets the same initial latent, shared by its
    views; without the option the samples differ."""
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)

    p = tiny_debug()
    pipe = MagicDrivePipeline(
        MagicDriveModules.create(p, device="cpu"), p.pipeline)
    fixed = pipe.prepare_latents(3, torch.Generator().manual_seed(5),
                                 fix_seed_within_batch=True)
    free = pipe.prepare_latents(3, torch.Generator().manual_seed(5))
    assert fixed.shape == free.shape == (3, 6, 28, 50, 4)
    for lat in (fixed, free):
        assert torch.equal(lat[:, :1].expand_as(lat), lat)
    assert torch.equal(fixed[0], fixed[1]) and torch.equal(fixed[0], fixed[2])
    assert not torch.equal(free[0], free[1])
