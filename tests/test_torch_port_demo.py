"""The port's demo CLI and interactive session against the JAX package's
``tools/demo.py`` and ``tools/interactive_gui.py`` (its
``InteractiveSession``; the gradio UI is not ported).

Both load one run's weights: ``tiny_debug``'s JAX init tree as seeded
normals with the kernels halved, written by the JAX package's
``save_params``. JAX's demo runs with its pipeline replaced by one that
encodes the given views with the real pipeline and records each request
(batch, key, given latents, view mask) without generating. The port's
demo, on the CPU in fp32 as ``--tiny`` asks, takes the draws the JAX
pipeline makes from each key (the initial latents, and for a given view
the re-noising draw). One real JAX pipeline of the same weights then
generates from the port's batches and JAX's keys, and the images agree at
atol 2e-3: 6-view generation for two fixture scenes, generation given view
1, and the interactive session's scene after box and caption edits. The
sheets are the port's images as uint8, the map renders and file names
JAX's. fp32 on both sides; one UniPC step.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_modules import close, scaled_kernels, shaped

torch.set_num_threads(1)

STEPS, SEED = 1, 3


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A tiny_debug run's weights/ and the JAX preset, modules and params."""
    from magicdrive_tpu.config.presets import init_params, tiny_debug
    from magicdrive_tpu.utils.serialization import save_params

    preset = tiny_debug()
    preset = dataclasses.replace(preset, pipeline=dataclasses.replace(
        preset.pipeline, num_inference_steps=STEPS))
    modules = preset.modules(dtype=jnp.float32)
    params = scaled_kernels(shaped(jax.eval_shape(
        lambda k: init_params(preset, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(5)), 0.5)
    path = str(tmp_path_factory.mktemp("demo") / "weights")
    save_params(params, path)
    return path, preset, modules, params


@pytest.fixture(scope="module")
def ref(weights):
    """The real JAX pipeline (given-view, as the demo builds it)."""
    from magicdrive_tpu.pipeline.given_view import GivenViewPipeline

    _, preset, modules, params = weights
    return GivenViewPipeline(modules, params, preset.pipeline)


def _argv(weights, out, *extra):
    return ["--tiny", "--steps", str(STEPS), "--seed", str(SEED),
            "--weights", weights[0], "--out", out, *extra]


def _jax_draws(key, given_shape=None):
    """(initial latents, re-noising draw) of the JAX pipeline for ``key``:
    ``_generate_fn``'s draw, or ``GivenViewPipeline``'s split."""
    shape = (1, 1, 28, 50, 4)
    if given_shape is None:
        lat = jax.random.normal(key, shape, jnp.float32)
        return np.broadcast_to(lat, (1, 6, 28, 50, 4)).copy(), None
    k1, k2 = jax.random.split(key)
    lat = jax.random.normal(k1, shape, jnp.float32)
    return (np.broadcast_to(np.asarray(lat), (1, 6, 28, 50, 4)).copy(),
            np.asarray(jax.random.normal(k2, given_shape)))


def _run_demo(weights, ref, tmp_path_factory, *extra):
    """JAX's demo with a recording pipeline, then the port's on JAX's
    draws -> (JAX out, JAX requests, port Demo, port requests)."""
    import magicdrive_tpu.pipeline.given_view as jgv
    from tools import demo as jdemo

    from magicdrive_tpu_torch.cli import demo
    from magicdrive_tpu_torch.pipeline.given_view import GivenViewPipeline

    jax_calls, port_calls = [], []

    class Recording:
        def __init__(self, modules, params, cfg):
            pass

        def encode_views(self, px):
            return ref.encode_views(px)

        def __call__(self, batch, key, **kwargs):
            jax_calls.append((key, {k: np.array(v)
                                    for k, v in kwargs.items()}))
            return jnp.zeros((1, 6, 224, 400, 3))

    real = GivenViewPipeline.__call__

    def call(self, batch, given_latents=None, view_mask=None,
             generator=None, latents=None, sub_noise=None):
        key, kw = jax_calls[len(port_calls)]
        lat, noise = _jax_draws(key, None if given_latents is None
                                else tuple(given_latents.shape))
        out = real(self, batch, given_latents, view_mask,
                   latents=torch.from_numpy(lat), sub_noise=noise)
        port_calls.append((batch, given_latents, view_mask, out.numpy()))
        return out

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jgv, "GivenViewPipeline", Recording)
        jax_out = str(tmp_path_factory.mktemp("jax_demo"))
        jdemo.main(_argv(weights, jax_out, *extra))
        mp.setattr(GivenViewPipeline, "__call__", call)
        made = demo.main(_argv(weights, str(tmp_path_factory.mktemp(
            "port_demo")), *extra), device="cpu")
    finally:
        mp.undo()
    return jax_out, jax_calls, made, port_calls


def _check_files(jax_out, made, port_calls):
    """JAX's file names and map renders; each sheet the port's images."""
    from magicdrive_tpu_torch.viz import concat_6_views

    assert sorted(os.listdir(made.out_dir)) == sorted(os.listdir(jax_out))
    for i, (_, _, _, imgs) in enumerate(port_calls):
        png = np.asarray(Image.open(os.path.join(made.out_dir,
                                                 f"sample{i}_gen.png")))
        want = (np.clip(concat_6_views(imgs[0]), 0, 1) * 255).astype(
            np.uint8)
        np.testing.assert_array_equal(png, want)
        np.testing.assert_array_equal(
            np.asarray(Image.open(os.path.join(made.out_dir,
                                               f"sample{i}_map.png"))),
            np.asarray(Image.open(os.path.join(jax_out,
                                               f"sample{i}_map.png"))))


def test_demo_matches_jax(weights, ref, tmp_path_factory):
    """Two fixture scenes, 6 views generated: the port's images are the
    JAX pipeline's on the port's batch from JAX's key."""
    jax_out, jax_calls, made, port_calls = _run_demo(
        weights, ref, tmp_path_factory, "--n_samples", "2")
    assert len(port_calls) == len(jax_calls) == len(made.images) == 2
    _check_files(jax_out, made, port_calls)
    for (key, kw), (batch, given, mask, got) in zip(jax_calls, port_calls):
        assert kw == {} and given is None and mask is None
        want = np.asarray(ref({k: jnp.asarray(v) for k, v in batch.items()},
                              key=key))
        assert want.std() > 1e-3
        np.testing.assert_allclose(got, want, atol=2e-3)
    assert np.abs(port_calls[0][3] - port_calls[1][3]).max() > 0.1


def test_demo_given_view_matches_jax(weights, ref, tmp_path_factory):
    """View 1 of the scene given: the port's encoded views are JAX's, the
    view mask JAX's, and the images the JAX pipeline's from JAX's key (its
    initial latents and re-noising draw)."""
    jax_out, jax_calls, made, port_calls = _run_demo(
        weights, ref, tmp_path_factory, "--n_samples", "1",
        "--given_view", "1")
    _check_files(jax_out, made, port_calls)
    (key, kw), = jax_calls
    (batch, given, mask, got), = port_calls
    np.testing.assert_array_equal(mask, kw["view_mask"])
    assert mask.tolist() == [0, 1, 0, 0, 0, 0]
    close(given, kw["given_latents"])
    want = np.asarray(ref({k: jnp.asarray(v) for k, v in batch.items()},
                          given_latents=jnp.asarray(kw["given_latents"]),
                          view_mask=kw["view_mask"], key=key))
    np.testing.assert_allclose(got, want, atol=2e-3)
    # the given view decodes as its VAE round trip, the others do not
    rt = made.pipe.decode(given.permute(0, 1, 4, 2, 3)).numpy()
    np.testing.assert_array_equal(got[0, 1], rt[0, 1])
    assert np.abs(got[0, 0] - rt[0, 0]).max() > 1e-3


def _edit(session):
    session.move_box(0, dx=1.5, dy=-2.0, dyaw=0.3)
    session.delete_box(2)
    session.add_box(5.0, 6.0, yaw=0.2, cls=3)
    session.set_caption("boston-seaport", "rain, night")


def test_interactive_session_matches_jax(weights, ref, monkeypatch):
    """The same edits on both sessions give the same scene and map render;
    the port's generation is the JAX pipeline's on its scene from JAX's
    key for the seed."""
    from tools.interactive_gui import InteractiveSession as J

    from magicdrive_tpu_torch.cli.interactive import InteractiveSession
    from magicdrive_tpu_torch.data import collate_fn
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    jsession = J(weights[0], tiny=True, steps=STEPS)
    session = InteractiveSession(weights[0], tiny=True, steps=STEPS,
                                 device="cpu")
    for s in (jsession, session):
        _edit(s)
    assert session.sample.keys() == jsession.sample.keys()
    for k, v in jsession.sample.items():
        if k == "metas":
            assert session.sample[k] == v
        else:
            np.testing.assert_array_equal(session.sample[k], v, err_msg=k)
    assert len(session.sample["boxes"]) == 24 and \
        session.sample["labels"][-1] == 3
    np.testing.assert_array_equal(session.map_image(), jsession.map_image())

    key = jax.random.PRNGKey(11)
    lat, _ = _jax_draws(key)
    monkeypatch.setattr(MagicDrivePipeline, "prepare_latents",
                        lambda self, *a, **k: torch.from_numpy(lat))
    got = session.generate(11)
    batch = collate_fn([session.sample], session.ccfg)
    batch.pop("pixel_values")
    want = np.asarray(ref({k: jnp.asarray(v) for k, v in batch.items()},
                          key=key))[0]
    assert got.shape == (6, 224, 400, 3)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_demo_and_session_default_to_the_card(monkeypatch, tmp_path):
    from magicdrive_tpu_torch.cli import demo
    from magicdrive_tpu_torch.cli.interactive import InteractiveSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        demo.main(["--tiny", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        InteractiveSession(tiny=True)
