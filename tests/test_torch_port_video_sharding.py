"""Frame-sharded video and view-sharded training of the port against the
JAX package's unsharded functions (the counterpart of
``tests/test_video_sharding.py``, whose slow tests hold JAX's sharded
functions to the same unsharded ones, and of ``__graft_entry__.py``'s
``image_chain`` and ``video_chain``).

The model is JAX's ``micro_video_debug(4)`` (``micro_debug`` for the image
step) on seeded weights at half the fan-in scale
(``test_torch_port_train_step``), fp32, 2 clips of 4 frames. Each mesh's
cases run as one job of gloo ranks on the CPU, each rank a process of this
file run as a script and started by ``torchrun``
(``test_torch_port_parallel.torchrun``), while this process computes JAX's
references:
  * (dp, t) = (2, 2), four ranks: a 2-step ``VideoPipeline`` request from
    JAX's latents, each rank its clip's two frames, the images at atol
    2e-3 of JAX's (the tolerance of ``test_torch_port_video.py``); and
    one ``train_step`` fed JAX's draws (``StepDraws.shard``);
  * (dp, t, view) = (2, 2, 2), eight ranks: the step with each rank's
    three cameras as well;
  * (dp, view) = (1, 2), two ranks: ``image_chain``'s image step.
Each step's loss is held to JAX's at rtol 1e-5, and its mean gradient
(Adam's first moment over 1 - b1, the clip off) to JAX's gradient with
``test_torch_port_train_step``'s check (atol min(2e-4, 1e-3 max|g|), rtol
2e-3); the ranks' masters bitwise equal. Every job also runs its cases
with a collective planted wrong, which these checks must catch: the frame
exchange returning a rank's rows in the wrong order, and the gather's
backward dropping the other ranks' share of a camera's gradient.
"""
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_parallel import Background, first_moments, rank_main

F, CLIPS = 4, 2
N_CAM = 6
LR = 1e-3
# mesh shape and axes of each job, and its model
MESHES = {"t": ((2, 2), ("dp", "t"), "video"),
          "tv": ((2, 2, 2), ("dp", "t", "view"), "video"),
          "view": ((1, 2), ("dp", "view"), "image")}
LOSS_RTOL = 1e-5
IMAGE_ATOL = 2e-3


def preset_of(config, model: str):
    """JAX's (or the port's) micro preset of the video or image model, 2
    sampler steps."""
    p = config.micro_video_debug(n_frames=F) if model == "video" else \
        config.micro_debug()
    return dataclasses.replace(p, pipeline=dataclasses.replace(
        p.pipeline, num_inference_steps=2))


def port_draws(d: dict):
    """JAX's draws (NHWC) as the port's ``StepDraws``."""
    from magicdrive_tpu_torch.train.train_step import StepDraws

    return StepDraws(
        vae_noise=torch.tensor(d["vae_noise"].transpose(0, 3, 1, 2)),
        noise=torch.tensor(d["noise"].transpose(0, 1, 4, 2, 3)),
        timesteps=torch.tensor(d["timesteps"], dtype=torch.long),
        drop_mask=torch.tensor(d["drop_mask"]))


# -- the planted faults ---------------------------------------------------


@contextlib.contextmanager
def planted(fault: str):
    """``exchange``: the frame exchange hands each rank its rows in the
    reverse order; ``gather``: the gather's backward keeps this rank's own
    gradient of its cameras and drops the other ranks' share."""
    from magicdrive_tpu_torch.parallel import mesh as pmesh

    name = {"exchange": "_to_frames", "gather": "_scatter_sum"}[fault]
    real = getattr(pmesh, name)
    if fault == "exchange":
        def wrong(x, mesh):
            return real(x, mesh).flip(0)
    else:
        def wrong(g, mesh, m):
            own = g.reshape(-1, mesh.view, m, *g.shape[1:])[
                :, mesh.index("view")]
            return own.reshape(-1, *g.shape[1:])
    setattr(pmesh, name, wrong)
    try:
        yield
    finally:
        setattr(pmesh, name, real)


# -- the ranks ------------------------------------------------------------


def _step(modules, inp, mesh, local, frames):
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import train_step

    cfg = tstate.TrainConfig(**inp["tcfg"])
    state = tstate.create_train_state(modules, cfg, device="cpu",
                                      dtype=torch.float32)
    draws = port_draws(inp["draws"]).shard(mesh, frames)
    m = train_step(modules, state, local, cfg, draws=draws, mesh=mesh)
    return float(m["loss"]), state


def _job(out: str, name: str) -> dict:
    """One rank of mesh ``name``'s job: the step (and on (dp, t) the
    request) as they are and with the mesh's faults planted."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.parallel import (COLLECTIVES, make_mesh,
                                               shard_batch)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.pipeline.video import VideoPipeline

    shape, axes, model = MESHES[name]
    inp = torch.load(os.path.join(out, f"{model}.pt"), weights_only=False)
    preset = preset_of(config, model)
    modules = MagicDriveModules.create(preset, device="cpu")
    modules.load_state_dicts(inp["state_dicts"])
    mesh = make_mesh(shape, axes)
    frames = F if model == "video" else None
    tag = "_".join(map(str, mesh.coords))
    faults = (("gather",) if mesh.view > 1 else ()) + \
        (("exchange",) if mesh.t > 1 else ())
    res = {"coords": list(mesh.coords)}
    if name == "t":
        pipe = VideoPipeline(modules, preset.pipeline, F, mesh=mesh)
        local = shard_batch(dict(inp["sample_batch"],
                                 latents=inp["latents"]), mesh, N_CAM, F)
        lat = torch.from_numpy(local["latents"])
        before = COLLECTIVES["all_to_all"]
        img = pipe(local, latents=lat)
        res["exchanges"] = COLLECTIVES["all_to_all"] - before
        with planted("exchange"):
            bad = pipe(local, latents=lat)
        torch.save({"img": img, "bad": bad},
                   os.path.join(out, f"sample_{tag}.pt"))
    local = shard_batch(inp["batch"], mesh, N_CAM, frames)
    res["loss"], state = _step(modules, inp, mesh, local, frames)
    saved = {"masters": state.masters, "mu": first_moments(state)}
    res["bad_loss"] = {}
    for fault in faults:
        with planted(fault):
            res["bad_loss"][fault], bad = _step(modules, inp, mesh, local,
                                                frames)
        saved[f"mu_{fault}"] = first_moments(bad)
    torch.save(saved, os.path.join(out, f"{name}_{tag}.pt"))
    return res


JOBS = {name: (lambda out, name=name: _job(out, name)) for name in MESHES}


def run_mesh(name: str, out: str) -> list:
    """Job ``name`` as ranks of this file run as a script; -> each rank's
    JSON result."""
    from test_torch_port_parallel import torchrun

    n = int(np.prod(MESHES[name][0]))
    torchrun(os.path.abspath(__file__), [name, out],
             os.path.join(out, f"logs_{name}"), nproc=n)
    res = []
    for r in range(n):
        with open(os.path.join(out, f"{name}_rank{r}.json")) as f:
            res.append(json.load(f))
    return res


# -- JAX's references -----------------------------------------------------


def _jax_case(model: str, out: str, saved) -> dict:
    """JAX's unsharded step (loss, gradients) on seeded weights and a
    fixture batch, with its draws, and for the video model its 2-step
    ``VideoPipeline`` request; the port's inputs are saved to
    out/<model>.pt, and ``saved()`` called, before anything is
    computed."""
    import jax
    import jax.numpy as jnp

    from magicdrive_tpu.config import presets as jconfig
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_dataset
    from magicdrive_tpu.diffusion import ddpm as jddpm
    from magicdrive_tpu.train.state import TrainConfig, create_train_state
    from magicdrive_tpu.train.train_step import (make_drop_mask,
                                                 make_train_step)
    from test_torch_port_modules import randomized, scaled_kernels
    from test_torch_port_train_step import KERNEL_GAIN, _jax_loss_fn

    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.train import state as tstate

    video = model == "video"
    preset = preset_of(jconfig, model)
    modules = preset.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: jconfig.init_params(preset, modules, k),
        jax.random.PRNGKey(0))
    params = scaled_kernels(randomized(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes),
        np.random.RandomState(0)), KERNEL_GAIN)
    tcfg = TrainConfig(learning_rate=LR, lr_warmup_steps=0,
                       drop_cond_ratio=1.0, drop_cam_num=3,
                       max_grad_norm=1e9,
                       frames_per_clip=F if video else None)
    B = CLIPS * F if video else 2
    batch = collate_fn(make_dataset(B, image_hw=preset.image_size,
                                    map_hw=preset.map_hw),
                       CollateConfig(bbox_max_len=preset.bbox_max_len,
                                     canvas_hw=preset.image_size),
                       rng=np.random.default_rng(0))
    rng = jax.random.PRNGKey(1)
    # the draws of loss_fn (train/train_step.py), in its key order
    h, w = modules.vae.latent_hw(preset.image_size)
    k_noise, k_t, k_drop, k_vae = jax.random.split(rng, 4)
    k_drop, _ = jax.random.split(k_drop)
    t = jddpm.sample_timesteps(k_t, B // F if video else B,
                               modules.schedule.num_train_timesteps)
    draws = {
        "vae_noise": jax.random.normal(k_vae, (B * N_CAM, h, w, 4)),
        "timesteps": jnp.repeat(t, F) if video else t,
        "noise": jddpm.noise_with_offset(k_noise, (B, N_CAM, h, w, 4), 0.0),
        "drop_mask": make_drop_mask(k_drop, B, N_CAM, tcfg.drop_cond_ratio,
                                    tcfg.drop_cam_num)}
    inputs = {"state_dicts": jax_params_to_state_dicts(params),
              "batch": batch,
              "draws": {k: np.asarray(v) for k, v in draws.items()},
              "tcfg": {f.name: getattr(tcfg, f.name)
                       for f in dataclasses.fields(tstate.TrainConfig)}}
    sample_batch = {k: v for k, v in batch.items() if k != "pixel_values"}
    if video:
        from magicdrive_tpu.pipeline.video import VideoPipeline

        pipe = VideoPipeline(modules, params, preset.pipeline, n_frames=F)
        latents = np.asarray(pipe.prepare_latents(jax.random.PRNGKey(2),
                                                  CLIPS))
        inputs.update(sample_batch=sample_batch, latents=latents)
    torch.save(inputs, os.path.join(out, f"{model}.pt"))
    saved()
    want = {"params": params, "draws": inputs["draws"]}
    if video:
        want["images"] = np.asarray(pipe(
            {k: jnp.asarray(v) for k, v in sample_batch.items()},
            latents=jnp.asarray(latents)))
    state = create_train_state(params, tcfg)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(
        make_train_step(modules, tcfg))))(
        state.trainable, state.frozen,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    want.update(loss=float(loss),
                grads={k: np.asarray(v) for k, v in grads.items()})
    jax.clear_caches()
    return want


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(JAX's references by model, the ranks' results by mesh, their
    directory). Each model's jobs start, one after another, once its inputs
    are saved, and run while this process computes JAX's references."""
    out = str(tmp_path_factory.mktemp("sharded"))
    torch.set_num_threads(1)
    jobs = {}

    def start(model):
        names = [n for n, m in MESHES.items() if m[2] == model]
        jobs[model] = Background(
            lambda: {n: run_mesh(n, out) for n in names})
    want = {}
    try:
        for model in ("image", "video"):
            want[model] = _jax_case(model, out, lambda: start(model))
    finally:
        res = {}
        for job in jobs.values():
            res.update(job.join())
    return want, res, out


def _assembled_images(out: str) -> tuple:
    """The four (dp, t) ranks' frames put back in (clip, frame) order:
    (images, images under the planted exchange fault)."""
    got = {}
    for key in ("img", "bad"):
        clips = []
        for i in range(2):
            parts = [torch.load(os.path.join(out, f"sample_{i}_{j}.pt"),
                                weights_only=True)[key] for j in range(2)]
            clips.append(torch.cat(parts))
        got[key] = torch.cat(clips).numpy()
    return got["img"], got["bad"]


def test_frame_sharded_sampling_matches_jax(sharded):
    """The (dp, t) = (2, 2) request, the four ranks' frames put back in
    order, at atol 2e-3 of JAX's unsharded ``VideoPipeline``; two
    all-to-alls (there and back) a temporal block and step a rank. With the
    exchange's rows out of order the images are not JAX's."""
    want, res, out = sharded
    got, bad = _assembled_images(out)
    ref = want["video"]["images"]
    assert got.shape == ref.shape == (CLIPS * F, N_CAM, 32, 64, 3)
    assert ref.std() > 0.05
    np.testing.assert_allclose(got, ref, atol=IMAGE_ATOL)
    assert [r["exchanges"] for r in res["t"]] == [2 * 7 * 2] * 4
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(bad, ref, atol=IMAGE_ATOL)


def _grads(mu: dict) -> dict:
    """The mean gradient from Adam's first moment after one step."""
    return {k: (m / 0.1).numpy() for k, m in mu.items()}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sharded_step_matches_jax(sharded, name):
    """One sharded step fed JAX's draws: every rank's loss (the mean over
    the mesh) at rtol 1e-5 of JAX's unsharded loss, the mean gradient with
    ``test_torch_port_train_step``'s check, the ranks' masters bitwise
    equal. With a collective planted wrong the gradient fails that check
    (and the exchange's fault the loss too)."""
    from test_torch_port_train_step import _check_grads

    want, res, out = sharded
    shape, _, model = MESHES[name]
    w = want[model]
    ranks = res[name]
    assert len(ranks) == int(np.prod(shape))
    saved = [torch.load(os.path.join(out, "{}_{}.pt".format(
        name, "_".join(map(str, r["coords"])))), weights_only=True)
        for r in ranks]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], w["loss"], rtol=LOSS_RTOL)
    for s in saved[1:]:
        for k, t in saved[0]["masters"].items():
            assert torch.equal(s["masters"][k], t), k
    _check_grads(w, {"grads": _grads(saved[0]["mu"])})
    faults = set(ranks[0]["bad_loss"])
    assert faults == {"t": {"exchange"}, "tv": {"exchange", "gather"},
                      "view": {"gather"}}[name]
    for fault in faults:
        with pytest.raises(AssertionError):
            _check_grads(w, {"grads": _grads(saved[0][f"mu_{fault}"])})
    if "exchange" in faults:
        assert abs(ranks[0]["bad_loss"]["exchange"] - w["loss"]) > \
            LOSS_RTOL * w["loss"]


@pytest.mark.parametrize("shape,clips", [((2, 2), 2), ((1, 4), 1),
                                         ((2, 2), 4)])
def test_frame_rows_cut_clips_over_dp_and_frames_over_t(shape, clips):
    """Each rank's rows of a (clip, frame) axis of 4-frame clips: its dp
    block's clips, its t index's contiguous frames of each; the ranks
    together hold every row once. Where the clips equal dp this is JAX's
    ``P(("dp", "t"))``, the contiguous block of rank i t + j."""
    from magicdrive_tpu_torch.parallel.mesh import (Mesh, coords_of,
                                                    frame_rows)

    n, seen = clips * F, []
    for r in range(int(np.prod(shape))):
        mesh = Mesh(shape, ("dp", "t"), coords_of(r, shape))
        rows = frame_rows(mesh, n, F)
        seen.extend(rows.tolist())
        i, j = mesh.coords
        per = clips // shape[0]
        want = [c * F + f for c in range(i * per, (i + 1) * per)
                for f in range(j * F // shape[1], (j + 1) * F // shape[1])]
        assert rows.tolist() == want
        if clips == shape[0]:
            m = n // (shape[0] * shape[1])
            assert rows.tolist() == list(range(r * m, (r + 1) * m))
    assert sorted(seen) == list(range(n))


def test_step_draws_shard_cuts_rows_and_cameras():
    """``StepDraws.shard`` on a (dp, t, view) = (1, 2, 2) mesh: the rank's
    frames of the per-sample draws and, of the camera-major ones (noise,
    drop mask, the VAE noise a row per view), its cameras; a view-shared
    noise stays whole on its camera axis."""
    from magicdrive_tpu_torch.parallel.mesh import Mesh
    from magicdrive_tpu_torch.train.train_step import StepDraws

    B, N = 8, 6
    d = StepDraws(vae_noise=torch.arange(B * N * 2.).reshape(B * N, 2),
                  noise=torch.arange(B * N * 1.).reshape(B, N, 1),
                  timesteps=torch.arange(B), drop_mask=torch.rand(B, N),
                  map_drop_mask=torch.rand(B))
    mesh = Mesh((1, 2, 2), ("dp", "t", "view"), (0, 1, 0))
    got = d.shard(mesh, frames=8)
    rows, cams = slice(4, 8), slice(0, 3)
    assert torch.equal(got.timesteps, d.timesteps[rows])
    assert torch.equal(got.map_drop_mask, d.map_drop_mask[rows])
    assert torch.equal(got.noise, d.noise[rows, cams])
    assert torch.equal(got.drop_mask, d.drop_mask[rows, cams])
    assert torch.equal(got.vae_noise, d.vae_noise.reshape(B, N, 2)[
        rows, cams].reshape(-1, 2))
    same = dataclasses.replace(d, noise=d.noise[:, :1])
    assert torch.equal(same.shard(mesh, 8).noise, d.noise[rows, :1])


def test_unsupported_meshes_raise():
    """A mesh the port cannot run raises, never runs unsharded: unknown or
    repeated axes, a t axis on the image model (the pipeline, the step and
    a batch without frames), a t axis that does not divide the frames."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.parallel.mesh import Mesh, make_mesh, \
        shard_batch
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)
    from magicdrive_tpu_torch.pipeline.video import VideoPipeline
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import train_step

    for axes in (("dp", "frames"), ("dp", "dp")):
        with pytest.raises(ValueError, match="each of"):
            make_mesh((1, 1), axes)
    t2 = Mesh((1, 2), ("dp", "t"), (0, 1))
    image = MagicDriveModules.create(config.micro_debug(), device="cpu")
    with pytest.raises(ValueError, match="t axis of 2 ranks does not divide"):
        MagicDrivePipeline(image, config.micro_debug().pipeline, mesh=t2)
    cfg = tstate.TrainConfig()
    state = tstate.create_train_state(image, cfg, device="cpu",
                                      dtype=torch.float32)
    with pytest.raises(ValueError, match="model without frames"):
        train_step(image, state, {}, cfg, mesh=t2)
    with pytest.raises(ValueError, match="no frame axis"):
        shard_batch({"input_ids": np.zeros((4, 77))}, t2)
    video = MagicDriveModules.create(config.micro_video_debug(3),
                                     device="cpu")
    with pytest.raises(ValueError, match="does not divide the UNet's 3"):
        VideoPipeline(video, config.micro_video_debug(3).pipeline, 3,
                      mesh=t2)
    with pytest.raises(ValueError, match="2 ranks do not divide 3"):
        shard_batch({"input_ids": np.zeros((6, 77))}, t2, frames=3)


def test_60_frame_step_shapes():
    """The released 60-frame model's train step (JAX
    ``test_60_frame_graph_shapes_validate``) at the micro widths, forward
    and backward in one process on the CPU (the kernels' wrappers take no
    ``meta`` tensor): one clip of 60 frames, 360 images; a finite scalar
    loss and a gradient of each trainable tensor's shape, the temporal
    attention's among them (its zero connector's gradient is its output,
    the attention over the 60 frames)."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import (batch_tensors,
                                                       loss_and_grads,
                                                       sample_draws)

    torch.set_num_threads(4)
    preset = config.micro_video_debug(n_frames=60)
    modules = MagicDriveModules.create(preset, device="cpu")
    cfg = tstate.TrainConfig(lr_warmup_steps=1, frames_per_clip=60,
                             drop_cond_ratio=0.0)
    state = tstate.create_train_state(modules, cfg, device="cpu",
                                      dtype=torch.float32)
    batch = batch_tensors(collate_fn(
        make_dataset(60, image_hw=preset.image_size, map_hw=preset.map_hw,
                     with_images=True),
        CollateConfig(bbox_max_len=preset.bbox_max_len,
                      canvas_hw=preset.image_size),
        rng=np.random.default_rng(0)), "cpu")
    schedule = NoiseSchedule.create()
    draws = sample_draws(cfg, schedule, 60, N_CAM, (4, 8),
                         torch.Generator().manual_seed(1))
    assert len(set(draws.timesteps.tolist())) == 1  # one clip
    loss, grads = loss_and_grads(modules, state, batch, draws, cfg,
                                 schedule)
    assert loss.shape == () and torch.isfinite(loss)
    assert {k: g.shape for k, g in grads.items()} == \
        {k: t.shape for k, t in state.masters.items()}
    assert any(".connector_temp." in k and g.abs().max() > 0
               for k, g in grads.items())


if __name__ == "__main__":  # a rank of run_mesh's job
    rank_main(*sys.argv[1:], jobs=JOBS)
