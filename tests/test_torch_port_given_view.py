"""Given-view generation in the port against the JAX package.

``tiny_debug(n_cam=3)`` (the 224x400 geometry at narrow widths, three
cameras on a ring) with every floating JAX variable replaced by seeded
normals, converted to the port. The port's fixture request (the JAX
package's but for its per-process caption ids) and its images of the three
views are encoded, view 1 is given, and both pipelines run 2 UniPC steps from the
same numpy latents with the same re-noising draw (JAX's own, from its key),
with ``sub_noise_pred`` off and on; the [0, 1] images agree to atol 2e-3
(tests/test_torch_port_slice.py), the latents to atol 2e-4 / rtol 2e-3.
fp32 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modules import close, shaped

torch.set_num_threads(1)

N_CAM = 3
GIVEN = 1


@pytest.fixture(scope="module")
def setting():
    """(JAX preset, its modules, randomized variables, the port preset, a
    three-camera request, its images in [-1, 1], initial latents, the view
    mask)."""
    from magicdrive_tpu.config import presets as jp

    from magicdrive_tpu_torch import config as tp
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)

    jpre, tpre = (dataclasses.replace(p, pipeline=dataclasses.replace(
        p.pipeline, num_inference_steps=2))
        for p in (jp.tiny_debug(n_cam=N_CAM), tp.tiny_debug(n_cam=N_CAM)))
    modules = jpre.modules(dtype=jnp.float32)
    params = shaped(jax.eval_shape(
        lambda k: jp.init_params(jpre, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(50))
    # the port's data layer (JAX's salts its caption ids per process)
    batch = collate_fn(make_dataset(1, with_images=True),
                       CollateConfig(bbox_max_len=jpre.bbox_max_len))
    px = np.ascontiguousarray(batch.pop("pixel_values")[:, :N_CAM])
    for k in ("camera_param", "bboxes", "classes", "masks"):
        batch[k] = np.ascontiguousarray(batch[k][:, :N_CAM])
    lat = np.repeat(np.random.RandomState(51).randn(1, 1, 28, 50, 4).astype(
        np.float32), N_CAM, axis=1)
    mask = np.zeros(N_CAM, np.float32)
    mask[GIVEN] = 1.0
    return jpre, modules, params, tpre, batch, px, lat, mask


def _port(tpre, params, sub_noise_pred=False):
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.pipeline.given_view import GivenViewPipeline
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    mods = MagicDriveModules.create(tpre, device="cpu").load_state_dicts(
        jax_params_to_state_dicts(params)).to("cpu", torch.float32)
    return GivenViewPipeline(mods, tpre.pipeline,
                             sub_noise_pred=sub_noise_pred)


@pytest.fixture(scope="module")
def given(setting):
    """The JAX pipeline's clean latents of the request's images."""
    from magicdrive_tpu.pipeline.given_view import GivenViewPipeline as J

    jpre, modules, params, _, _, px, _, _ = setting
    return np.array(J(modules, params, jpre.pipeline).encode_views(
        jnp.asarray(px)))


def test_encode_views_matches_jax(setting, given):
    """The posterior mean of each view, (B, N, h, w, 4); with noise, a
    posterior sample."""
    tpre, params, px = setting[3], setting[2], setting[5]
    pipe = _port(tpre, params)
    got = pipe.encode_views(px)
    assert got.shape == given.shape == (1, N_CAM, 28, 50, 4)
    close(got, given)
    noise = np.random.RandomState(52).randn(*given.shape).astype(np.float32)
    sampled = pipe.encode_views(px, noise)
    assert float((sampled - got).abs().max()) > 1e-3


@pytest.mark.parametrize("sub_noise_pred", [False, True])
def test_given_view_pipeline_matches_jax(setting, given, sub_noise_pred):
    """View 1 given: the images of both pipelines on JAX's re-noising
    draw; the given view decodes as the VAE round trip of its latent and
    the others are generated."""
    from magicdrive_tpu.pipeline.given_view import GivenViewPipeline as J

    jpre, modules, params, tpre, batch, _, lat, mask = setting
    key = jax.random.PRNGKey(53)
    want = np.asarray(J(modules, params, jpre.pipeline,
                        sub_noise_pred=sub_noise_pred)(
        {k: jnp.asarray(v) for k, v in batch.items()},
        given_latents=jnp.asarray(given), view_mask=mask, key=key,
        latents=jnp.asarray(lat)))
    # the draw JAX's loop re-noises the given views with
    sub_noise = np.array(jax.random.normal(key, given.shape))
    pipe = _port(tpre, params, sub_noise_pred)
    got = pipe(batch, given_latents=given, view_mask=mask,
               latents=torch.from_numpy(lat), sub_noise=sub_noise).numpy()
    assert got.shape == want.shape == (1, N_CAM, 224, 400, 3)
    assert 0.1 < want.std()
    np.testing.assert_allclose(got, want, atol=2e-3)

    round_trip = pipe.decode(
        torch.from_numpy(given).permute(0, 1, 4, 2, 3)).numpy()
    np.testing.assert_array_equal(got[0, GIVEN], round_trip[0, GIVEN])
    for v in set(range(N_CAM)) - {GIVEN}:
        assert np.abs(got[0, v] - round_trip[0, v]).max() > 1e-3


def test_given_view_without_views_is_the_plain_pipeline(setting):
    """Without given latents or a mask the pipeline is the image pipeline;
    the re-noising draw comes from the generator when not passed."""
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    _, _, params, tpre, batch, _, lat, mask = setting
    tpre = dataclasses.replace(tpre, pipeline=dataclasses.replace(
        tpre.pipeline, num_inference_steps=1))
    pipe = _port(tpre, params)
    plain = MagicDrivePipeline(pipe.m, pipe.cfg)(
        batch, latents=torch.from_numpy(lat))
    np.testing.assert_array_equal(
        pipe(batch, latents=torch.from_numpy(lat)).numpy(), plain.numpy())
    given = pipe.encode_views(setting[5])
    a, b = (pipe(batch, given, mask, torch.Generator().manual_seed(s))
            for s in (1, 1))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
