"""The train step's modes against the JAX train step: one noise per sample
(``train_with_same_noise``), one timestep per clip (``frames_per_clip``)
with the temporal modules training, and gradient checkpointing, on
``tiny_video_debug(2, 3)`` (the 224x400 geometry at narrow widths, three
cameras, temporal attention in every UNet transformer). ``train_with_same_t
=False`` raises in both packages.

One JAX step, jitted once, holds all three modes at once: a clip of 2
frames of 3 views, the same noise for a frame's views, one timestep for the
clip, and the JAX package's remat (``gradient_checkpointing`` with "dots"
in the UNet, full recompute in the ControlNet), whose values are its plain
step's. The port is fed the JAX step's draws (its key splits repeated
here). Its loss and every trainable gradient, the temporal ones included,
agree with JAX's at the tolerances of ``test_torch_port_train_step.py``
(rtol 2e-3; atol min(2e-4, 1e-3 * the tensor's max|g|)), without
checkpointing and with it under both policies; with checkpointing, the
port's gradients equal its own without at atol 1e-6. The weight matrices
are seeded at half the fan-in scale, as in that file. With checkpointing
every forward kernel call of the step runs twice (the recompute), the
count ``chip_smoke.expected_launches`` derives; under "attn" the UNet's
attentions run once (``test_torch_port_remat_attn.py`` holds "attn"
against JAX).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modules import scaled_kernels, shaped
from test_torch_port_train_step import _as_port, _jax_loss_fn

torch.set_num_threads(1)

N_FRAMES, N_CAM = 2, 3
RTOL, ATOL, GRAD_TOL = 2e-3, 2e-4, 1e-3


def _remat(preset, policy):
    """``preset`` with gradient checkpointing in the UNet (``policy``) and
    the ControlNet."""
    unet = dataclasses.replace(preset.unet, gradient_checkpointing=True,
                               remat_policy=policy)
    cn_unet = dataclasses.replace(preset.controlnet.unet,
                                  gradient_checkpointing=True,
                                  remat_policy=policy)
    return dataclasses.replace(preset, unet=unet, controlnet=dataclasses.
                               replace(preset.controlnet, unet=cn_unet))


def _batch():
    """A 2-frame, 3-camera clip with images, from the port's data layer
    (JAX's stand-in tokenizer salts its word ids per process)."""
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)

    batch = collate_fn(make_dataset(N_FRAMES, with_images=True),
                       CollateConfig(bbox_max_len=8),
                       rng=np.random.default_rng(0))
    for k in ("pixel_values", "camera_param", "bboxes", "classes", "masks"):
        batch[k] = np.ascontiguousarray(batch[k][:, :N_CAM])
    return batch


@pytest.fixture(scope="module")
def jax_step():
    from magicdrive_tpu.config import presets as jp
    from magicdrive_tpu.diffusion import ddpm as jddpm
    from magicdrive_tpu.train.state import TrainConfig, create_train_state
    from magicdrive_tpu.train.train_step import (make_drop_mask,
                                                 make_train_step)

    preset = _remat(jp.tiny_video_debug(N_FRAMES, N_CAM), "dots")
    modules = preset.modules(dtype=jnp.float32)
    params = scaled_kernels(shaped(jax.eval_shape(
        lambda k: jp.init_params(preset, modules, k), jax.random.PRNGKey(0)),
        np.random.RandomState(70)), 0.5)
    tcfg = TrainConfig(learning_rate=1e-3, lr_warmup_steps=0,
                       drop_cond_ratio=1.0, drop_cam_num=2,
                       train_with_same_noise=True, frames_per_clip=N_FRAMES)
    batch = _batch()
    rng = jax.random.PRNGKey(3)

    # the draws of loss_fn (train/train_step.py), in its key order
    B, N = N_FRAMES, N_CAM
    h, w = modules.vae.latent_hw(preset.image_size)
    k_noise, k_t, k_drop, k_vae = jax.random.split(rng, 4)
    k_drop, _ = jax.random.split(k_drop)
    t = jddpm.sample_timesteps(k_t, B // N_FRAMES,
                               modules.schedule.num_train_timesteps)
    draws = {
        "vae_noise": jax.random.normal(k_vae, (B * N, h, w, 4)),
        "timesteps": jnp.repeat(t, N_FRAMES),
        "noise": jddpm.noise_with_offset(k_noise, (B, 1, h, w, 4), 0.0),
        "drop_mask": make_drop_mask(k_drop, B, N, tcfg.drop_cond_ratio,
                                    tcfg.drop_cam_num),
    }
    state = create_train_state(params, tcfg)
    loss_fn = _jax_loss_fn(make_train_step(modules, tcfg))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        state.trainable, state.frozen,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return dict(params=params, batch=batch, tcfg=tcfg, loss=float(loss),
                draws={k: np.asarray(v) for k, v in draws.items()},
                grads=_as_port({k: np.asarray(v) for k, v in grads.items()}))


def _port_grads(j, policy=None, remat=False):
    """The port's loss and gradients on JAX's weights, batch and draws."""
    from magicdrive_tpu_torch import config as tp
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import (StepDraws,
                                                       batch_tensors,
                                                       loss_and_grads)

    preset = tp.tiny_video_debug(N_FRAMES, N_CAM)
    if remat:
        preset = _remat(preset, policy)
    modules = MagicDriveModules.create(preset, device="cpu").load_state_dicts(
        jax_params_to_state_dicts(j["params"]))
    cfg = tstate.TrainConfig(**dataclasses.asdict(j["tcfg"]))
    state = tstate.create_train_state(modules, cfg, device="cpu",
                                      dtype=torch.float32)
    d = j["draws"]
    draws = StepDraws(
        vae_noise=torch.tensor(d["vae_noise"].transpose(0, 3, 1, 2)),
        noise=torch.tensor(d["noise"].transpose(0, 1, 4, 2, 3)),
        timesteps=torch.tensor(d["timesteps"], dtype=torch.long),
        drop_mask=torch.tensor(d["drop_mask"]))
    loss, grads = loss_and_grads(modules, state,
                                 batch_tensors(j["batch"], "cpu"), draws,
                                 cfg, NoiseSchedule.create())
    return float(loss), {k: g.numpy() for k, g in grads.items()}


@pytest.fixture(scope="module")
def port_plain(jax_step):
    return _port_grads(jax_step)


def _check_against_jax(j, loss, grads):
    assert np.isfinite(j["loss"]) and j["loss"] > 0.1
    np.testing.assert_allclose(loss, j["loss"], rtol=RTOL)
    assert grads.keys() == j["grads"].keys()
    for k, want in j["grads"].items():
        tol = min(ATOL, GRAD_TOL * float(np.abs(want).max()))
        np.testing.assert_allclose(grads[k], want, rtol=RTOL, atol=tol,
                                   err_msg=k)


def test_same_noise_clip_step_matches_jax(jax_step, port_plain):
    """One noise per frame for its views, one timestep for the clip: the
    loss and every trainable gradient against JAX's; the temporal modules
    (norm_temp, attn_temp, connector_temp of every UNet transformer)
    train, and their gradients are JAX's."""
    loss, grads = port_plain
    _check_against_jax(jax_step, loss, grads)
    d = jax_step["draws"]
    assert d["noise"].shape[1] == 1 and d["drop_mask"].sum() == 2 * N_FRAMES
    assert len(set(d["timesteps"].tolist())) == 1
    temporal = [k for k in grads if "_temp." in k]
    # 16 transformers: norm (2), q, k, v, out (2) and connector (2)
    assert len(temporal) == 16 * 9
    assert all(np.abs(grads[k]).max() > 0 for k in temporal
               if "norm_temp" not in k)


@pytest.mark.parametrize("policy", [None, "dots"])
def test_gradient_checkpointing_matches(jax_step, port_plain, policy):
    """The port with gradient checkpointing (the UNet's remat policy None
    or "dots") gives its own gradients without, at atol 1e-6, and JAX's
    with its remat."""
    loss, grads = _port_grads(jax_step, policy, remat=True)
    loss0, grads0 = port_plain
    assert abs(loss - loss0) <= 1e-6
    for k in grads0:
        np.testing.assert_allclose(grads[k], grads0[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    _check_against_jax(jax_step, loss, grads)


def test_same_t_false_raises():
    """JAX's step with ``train_with_same_t=False`` hands its ControlNet
    timesteps of shape (B, N) and fails while tracing; the port raises
    NotImplementedError rather than invent its meaning."""
    from magicdrive_tpu.config import presets as jp
    from magicdrive_tpu.train.state import TrainConfig as JCfg
    from magicdrive_tpu.train.state import create_train_state
    from magicdrive_tpu.train.train_step import make_train_step

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import (TrainConfig, create_train_state
                                            as port_state, train_step)

    preset = jp.tiny_debug()
    modules = preset.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jp.init_params(preset, modules, k),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                    shapes)
    jcfg = JCfg(train_with_same_t=False)
    batch = collate_fn([make_sample(i, with_images=True) for i in range(2)],
                       CollateConfig(bbox_max_len=8))
    step = make_train_step(modules, jcfg)
    with pytest.raises(Exception, match="dim"):
        jax.eval_shape(step, create_train_state(params, jcfg),
                       {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(0))
    pm = MagicDriveModules.create(tiny_debug(), device="cpu")
    cfg = TrainConfig(train_with_same_t=False)
    with pytest.raises(NotImplementedError, match="train_with_same_t"):
        train_step(pm, port_state(pm, cfg, device="cpu",
                                  dtype=torch.float32), batch, cfg,
                   generator=torch.Generator().manual_seed(0))


def _counted_step(preset, mode):
    """The kernel calls of one ``tiny_debug``-sized train step of
    ``preset`` under the fused ``mode``, under ``dispatch.LAUNCHES``'
    names (K6's wrapper call counted as its two launches)."""
    import chip_smoke
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import (TrainConfig, create_train_state,
                                            train_step)

    torch.manual_seed(0)
    modules = MagicDriveModules.create(preset, device="cpu")
    cfg = TrainConfig(lr_warmup_steps=1)
    state = create_train_state(modules, cfg, device="cpu",
                               dtype=torch.float32)
    batch = collate_fn([make_sample(0, with_images=True)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    names = set(chip_smoke.training_calls("kvstat")) | \
        set(chip_smoke.training_calls("auto"))
    with chip_smoke.counted_calls(names) as calls, dispatch.fused_mode(mode):
        train_step(modules, state, batch, cfg,
                   generator=torch.Generator().manual_seed(0))
    bwd = calls.pop("flash_attention_bwd")
    return {**dict.fromkeys(dispatch.LAUNCHES, 0), **calls,
            "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd}


@pytest.mark.parametrize("mode", ["kvstat", "auto"])
@pytest.mark.parametrize("remat", [False, True, "attn"])
def test_step_calls_with_recompute_match_derived(remat, mode):
    """The kernel calls of one tiny_debug train step, with and without
    gradient checkpointing, in both fused modes, against
    ``chip_smoke.expected_launches``: under "dots" (True) the recompute
    runs every forward call (K1/K2, or K8 and its pair, and K3/K4) once
    more, the backward's (K5, K6, K7) do not change; under "attn" the
    UNet's units keep their attentions' outputs, so only the ControlNet's
    attentions and every FF run again."""
    import chip_smoke
    from magicdrive_tpu_torch.config import tiny_debug

    policy = {True: "dots", "attn": "attn"}.get(remat)
    preset = _remat(tiny_debug(), policy) if remat else tiny_debug()
    got = _counted_step(preset, mode)
    want = chip_smoke.expected_launches(preset, mode, steps=1, esize=4,
                                        recompute=remat)
    assert got == want
    fwd = "kvstat_attention" if mode == "kvstat" else \
        "fused_qkv_out_attention"
    n_fwd = {False: 21, True: 42, "attn": 27}[remat]
    assert want[fwd] == n_fwd
    assert want["flash_attention_fwd"] == 40


def test_call_checker_under_remat_keeps_what_the_step_keeps(monkeypatch):
    """``chip_smoke``'s per-call check on a remat "dots" step under "auto":
    it sees every kernel call, the recompute's of K8 and its pair included,
    and runs its plain versions outside the selective-checkpoint modes, so
    the step saves the same products as unchecked (the video's fp32 logits
    would not fit the card otherwise) and its gradients are bitwise the
    same."""
    import chip_smoke
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.models import unet as unet_mod
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state
    from magicdrive_tpu_torch.train.train_step import (batch_tensors,
                                                       loss_and_grads,
                                                       sample_draws)

    saved = []
    policy = unet_mod._dots_policy

    def counting(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if out == unet_mod.CheckpointPolicy.MUST_SAVE:
            saved.append(op)
        return out

    monkeypatch.setattr(unet_mod, "_dots_policy", counting)
    preset = _remat(tiny_debug(N_CAM), "dots")
    torch.manual_seed(0)
    modules = MagicDriveModules.create(preset, device="cpu")
    cfg = TrainConfig(drop_cam_num=1)
    state = create_train_state(modules, cfg, device="cpu",
                               dtype=torch.float32)
    batch = batch_tensors({k: v[:1] for k, v in _batch().items()}, "cpu")
    schedule = NoiseSchedule.create()
    draws = sample_draws(cfg, schedule, 1, N_CAM, (28, 50),
                         torch.Generator().manual_seed(0))

    def step():
        saved.clear()
        return loss_and_grads(modules, state, batch, draws, cfg, schedule)

    stats = {}
    with dispatch.fused_mode("auto"):
        loss0, grads0 = step()
        n_saved = len(saved)
        with chip_smoke.patched_kernels(chip_smoke._call_checker(stats),
                                        chip_smoke.training_calls("auto")):
            loss, grads = step()
    assert n_saved and len(saved) == n_saved
    want = chip_smoke.expected_launches(preset, "auto", steps=1, esize=4,
                                        recompute=True)
    bwd = stats.pop("flash_attention_bwd")[0]
    assert want["fused_qkv_out_attention"] == 42
    assert {**dict.fromkeys(want, 0), **{n: st[0] for n, st in stats.items()},
            "flash_attention_bwd_dq": bwd,
            "flash_attention_bwd_dkv": bwd} == want
    assert all(st[1] == 0.0 for st in stats.values())  # the CPU's plain
    assert torch.equal(loss, loss0)
    assert all(torch.equal(grads[k], g) for k, g in grads0.items())


def test_unknown_remat_policy_raises():
    """A remat policy other than "dots", "attn" and None is refused, as
    JAX's UNet refuses it; without checkpointing no policy is read."""
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models.unet import UNet2DConditionModel

    with pytest.raises(ValueError, match="remat_policy"):
        UNet2DConditionModel(_remat(tiny_debug(), "all").unet)
    UNet2DConditionModel(_remat(tiny_debug(), "attn").unet)
    UNet2DConditionModel(dataclasses.replace(tiny_debug().unet,
                                             remat_policy="all"))


def test_sample_draws_follow_the_modes():
    """The port's own draws: one noise per sample with
    ``train_with_same_noise``, one timestep per clip of ``frames_per_clip``
    frames, and a batch that is no whole number of clips refused."""
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.train import TrainConfig
    from magicdrive_tpu_torch.train.train_step import sample_draws

    sched = NoiseSchedule.create()
    gen = torch.Generator().manual_seed(0)
    d = sample_draws(TrainConfig(train_with_same_noise=True,
                                 frames_per_clip=4), sched, 8, 6, (28, 50),
                     gen)
    assert d.noise.shape == (8, 1, 4, 28, 50)
    assert d.timesteps.shape == (8,)
    t = d.timesteps.reshape(2, 4)
    assert (t == t[:, :1]).all() and t[0, 0] != t[1, 0]
    d = sample_draws(TrainConfig(), sched, 3, 6, (28, 50), gen)
    assert d.noise.shape == (3, 6, 4, 28, 50)
    with pytest.raises(ValueError, match="frames_per_clip"):
        sample_draws(TrainConfig(frames_per_clip=4), sched, 6, 6, (28, 50),
                     gen)
