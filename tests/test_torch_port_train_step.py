"""One tiny_debug train step of the port against the JAX train step.

Both packages start from the same weights (seeded normals on the JAX tree's
shapes, converted into the port's modules) and the same batch, and the port
is fed the JAX step's random draws: the test repeats the key splits of the
JAX loss (VAE posterior noise, timesteps, latent noise, drop mask) and hands
the numbers to the port. The loss, the gradient of every trainable weight and
the move of every weight in the update must agree in fp32 on the CPU: the
loss to rtol 2e-3; each gradient to rtol 2e-3 with atol min(2e-4, 1e-3 * its
tensor's max|g|), since many gradients are far smaller than 2e-4 and a plain
atol would pass them unseen; each move to 0.05 of the learning rate wherever
the gradient's sign is settled (see UPDATE_TOL).

The weight matrices are seeded at half the fan-in scale. At full scale the
random network amplifies rounding: the two frameworks' fp32 gradients of
the weights deepest in backpropagation (the ControlNet's map embedder and
first down block) then differ by 1e-3 to 7.5e-3 of the tensor's max from
run to run of the same code, and the port's own K1 and SDPA routes by 4e-4.
At half scale the worst tensor agrees to 3e-5 of its max.

At this size the UNet's 28x50 and 14x25 levels (Lq*Lk >= 90 000) take the
port's K1/K2 routes, so their backward runs the plain K5/K6; the JAX package
computes the same gradients by XLA autodiff of its plain attention. The
``_auto`` tests repeat the port's step under MAGICDRIVE_FUSED_MODE=auto
(K8, the K8 pair and K7's recompute for dWout) against the same JAX step.

One JAX tree (``jax.eval_shape`` of ``init_params``, then numpy values)
and one jit keep the file near two minutes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_modules import randomized, scaled_kernels

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 2e-3
GRAD_TOL = 1e-3  # * max|g| of each tensor (see above)
KERNEL_GAIN = 0.5
# The first AdamW step moves a weight by -LR * (g / (|g| + eps) + wd * w),
# g the clipped gradient: about -LR * sign(g). Where |g| is over twice its
# tensor's gradient limit the sign is settled, and the port's move must
# equal JAX's to UPDATE_TOL * LR; elsewhere the two may differ by 2 * LR.
LR = 1e-3
UPDATE_TOL = 0.05


def _jax_loss_fn(train_step_fn):
    """The loss closed over by the JAX ``train_step``."""
    cells = dict(zip(train_step_fn.__code__.co_freevars,
                     (c.cell_contents for c in train_step_fn.__closure__)))
    return cells["loss_fn"]


@pytest.fixture(scope="module")
def jax_step():
    from magicdrive_tpu.config.presets import init_params, tiny_debug
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_dataset
    from magicdrive_tpu.diffusion import ddpm as jddpm
    from magicdrive_tpu.train.state import TrainConfig, create_train_state
    from magicdrive_tpu.train.train_step import (make_drop_mask,
                                                 make_train_step)

    preset = tiny_debug()
    modules = preset.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: init_params(preset, modules, k),
                            jax.random.PRNGKey(0))
    params = scaled_kernels(randomized(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes),
        np.random.RandomState(0)), KERNEL_GAIN)
    # drop 3 of the 6 views' conditioning, so both sides of the blend run;
    # no warm-up, so the first update moves the weights
    tcfg = TrainConfig(learning_rate=LR, lr_warmup_steps=0,
                       drop_cond_ratio=1.0, drop_cam_num=3)
    batch = collate_fn(make_dataset(1), CollateConfig(
        bbox_max_len=preset.bbox_max_len, canvas_hw=preset.image_size),
        rng=np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)

    # the draws of loss_fn (train/train_step.py), in its key order
    B, N = batch["pixel_values"].shape[:2]
    h, w = modules.vae.latent_hw(preset.image_size)
    k_noise, k_t, k_drop, k_vae = jax.random.split(rng, 4)
    k_drop, _ = jax.random.split(k_drop)
    draws = {
        "vae_noise": jax.random.normal(k_vae, (B * N, h, w, 4)),
        "timesteps": jddpm.sample_timesteps(
            k_t, B, modules.schedule.num_train_timesteps),
        "noise": jddpm.noise_with_offset(k_noise, (B, N, h, w, 4), 0.0),
        "drop_mask": make_drop_mask(k_drop, B, N, tcfg.drop_cond_ratio,
                                    tcfg.drop_cam_num),
    }

    state = create_train_state(params, tcfg)
    loss_fn = _jax_loss_fn(make_train_step(modules, tcfg))

    @jax.jit
    def step(state, batch, rng):
        # the body of the JAX train_step, with its gradients kept
        loss, grads = jax.value_and_grad(loss_fn)(
            state.trainable, state.frozen, batch, rng)
        return loss, grads, state.apply_gradients(grads).trainable

    loss, grads, updated = step(state, jbatch, rng)
    np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}
    return dict(params=params, batch=batch, tcfg=tcfg,
                draws={k: np.asarray(v) for k, v in draws.items()},
                loss=float(loss), grads=np_(grads), updated=np_(updated))


def _port_key(flat_key):
    """'controlnet/params/a/b/kernel' -> ('controlnet.<torch key>', path)."""
    from magicdrive_tpu_torch.convert import torch_key

    module, _, *path = flat_key.split("/")
    return f"{module}.{torch_key(tuple(path))}", tuple(path)


def _as_port(flat):
    from magicdrive_tpu_torch.convert import _transform

    out = {}
    for k, v in flat.items():
        key, path = _port_key(k)
        out[key] = _transform(v, path)
    return out


def _port_step(jax_step, mode):
    """The port's step on the JAX step's weights, batch and draws, under
    the fused ``mode``."""
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import (StepDraws,
                                                       batch_tensors,
                                                       loss_and_grads,
                                                       train_step)
    from magicdrive_tpu_torch.diffusion import NoiseSchedule

    j = jax_step
    modules = MagicDriveModules.create(tiny_debug(),
                                       device="cpu").load_state_dicts(
        jax_params_to_state_dicts(j["params"]))
    cfg = tstate.TrainConfig(**{f.name: getattr(j["tcfg"], f.name)
                                for f in dataclasses.fields(
                                    tstate.TrainConfig)})
    state = tstate.create_train_state(modules, cfg, device="cpu",
                                      dtype=torch.float32)
    d = j["draws"]
    draws = StepDraws(
        vae_noise=torch.tensor(d["vae_noise"].transpose(0, 3, 1, 2)),
        noise=torch.tensor(d["noise"].transpose(0, 1, 4, 2, 3)),
        timesteps=torch.tensor(d["timesteps"], dtype=torch.long),
        drop_mask=torch.tensor(d["drop_mask"]))
    schedule = NoiseSchedule.create()
    with dispatch.fused_mode(mode):
        loss, grads = loss_and_grads(modules, state,
                                     batch_tensors(j["batch"], "cpu"), draws,
                                     cfg, schedule)
        metrics = train_step(modules, state, j["batch"], cfg, draws=draws,
                             schedule=schedule)
    return dict(loss=float(loss), step_loss=float(metrics["loss"]),
                grads={k: g.numpy() for k, g in grads.items()},
                updated={k: t.numpy() for k, t in state.masters.items()},
                step=state.step)


@pytest.fixture(scope="module")
def port_step(jax_step):
    return _port_step(jax_step, "kvstat")


@pytest.fixture(scope="module")
def port_step_auto(jax_step):
    """Under MAGICDRIVE_FUSED_MODE=auto the 28x50 and 14x25 attentions take
    K8 and the K8 pair, whose backward recomputes o with K7 for dWout."""
    return _port_step(jax_step, "auto")


def _check_loss(jax_step, port_step):
    assert np.isfinite(jax_step["loss"]) and jax_step["loss"] > 0.1
    np.testing.assert_allclose(port_step["loss"], jax_step["loss"],
                               rtol=RTOL)
    assert port_step["step_loss"] == port_step["loss"]
    assert jax_step["draws"]["drop_mask"].sum() == 3


def test_tiny_train_step_loss_matches_jax(jax_step, port_step):
    _check_loss(jax_step, port_step)


def test_tiny_train_step_loss_matches_jax_auto(jax_step, port_step_auto):
    _check_loss(jax_step, port_step_auto)


def _check_grads(jax_step, port_step):
    want = _as_port(jax_step["grads"])
    got = port_step["grads"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k,
                                   atol=min(ATOL, GRAD_TOL * np.abs(w).max()))
    # the loss reaches nearly every trainable weight (the boxes fill every
    # slot, so the null box features get none)
    live = sum(np.abs(w).max() > 0 for w in want.values())
    assert live >= len(want) - 2, (live, len(want))


def test_tiny_train_step_grads_match_jax(jax_step, port_step):
    _check_grads(jax_step, port_step)


def test_tiny_train_step_grads_match_jax_auto(jax_step, port_step_auto):
    _check_grads(jax_step, port_step_auto)


def test_tiny_train_step_loop_route_matches_jax(jax_step, monkeypatch):
    """ROADMAP A11: the step with attn4 "add" forced onto the per-neighbour
    K1 route (``kvstat_loop``) where the pair takes K2, as a view-sharded
    step takes it: one K1 a neighbour list in the forward and K1's
    backward, held to JAX's loss and gradients."""
    import chip_smoke
    from magicdrive_tpu_torch.kernels import dispatch

    real = dispatch.pair_route
    monkeypatch.setattr(dispatch, "pair_route", lambda *a: {
        "kvstat": "kvstat_loop"}.get(real(*a), real(*a)))
    with chip_smoke.counted_calls(dispatch.LAUNCHES) as calls:
        got = _port_step(jax_step, "kvstat")
    assert calls["kvstat_attention_pair"] == 0
    assert calls["kvstat_attention"] > 0
    _check_loss(jax_step, got)
    _check_grads(jax_step, got)


def _check_update(jax_step, port_step):
    want = _as_port(jax_step["updated"])
    before = _as_port(_flat_trainable(jax_step["params"]))
    grads = _as_port(jax_step["grads"])
    assert port_step["step"] == 1
    moved = settled = size = 0
    for k, w in want.items():
        got_move, want_move = port_step["updated"][k] - before[k], w - before[k]
        g = np.abs(grads[k])
        sure = g > 2 * min(ATOL, GRAD_TOL * g.max())
        np.testing.assert_allclose(got_move[sure], want_move[sure], rtol=0,
                                   atol=UPDATE_TOL * LR, err_msg=k)
        assert np.abs(got_move - want_move).max() <= 2.1 * LR, k
        moved += np.abs(got_move).max() > 0.5 * LR
        settled += sure.sum()
        size += g.size
    # the port moves nearly every tensor, and the settled elements are most
    assert moved > 0.9 * len(want), (moved, len(want))
    assert settled > 0.5 * size, (settled, size)


def test_tiny_train_step_update_matches_jax(jax_step, port_step):
    _check_update(jax_step, port_step)


def test_tiny_train_step_update_matches_jax_auto(jax_step, port_step_auto):
    _check_update(jax_step, port_step_auto)


def _flat_trainable(params):
    from magicdrive_tpu.train.state import split_params

    return {k: np.asarray(v) for k, v in split_params(params)[0].items()}


# C3: the map drop under ``use_uncond_map``. tiny_debug(n_cam=3) at B=2,
# drop_cond_ratio 0.5 and a JAX key whose map draw is MAP_DROP: sample 0
# trains on the unconditional map, sample 1 on its own. The JAX ControlNet
# reads ``use_uncond_map`` only where it creates the map, a parameter for
# learnable and a buffer for the others; its forward substitutes whatever
# map it is given. So one jit of the learnable step serves every mode, each
# with its own map: -1 (negative1) or seeded normals; the map's own
# gradient is compared where it trains (learnable).
C3_MODES = ("negative1", "random", "learnable")
MAP_DROP = (1.0, 0.0)


def _c3_presets(mode):
    from magicdrive_tpu.config import presets as jp

    from magicdrive_tpu_torch import config as tp

    return tuple(dataclasses.replace(p, controlnet=dataclasses.replace(
        p.controlnet, use_uncond_map=mode))
        for p in (jp.tiny_debug(n_cam=3), tp.tiny_debug(n_cam=3)))


def _c3_key(ratio, B):
    """The first PRNGKey(i) whose map draw in the JAX loss is MAP_DROP."""
    for i in range(1000):
        k_drop = jax.random.split(jax.random.PRNGKey(i), 4)[2]
        k_map = jax.random.split(k_drop)[1]
        if tuple(np.asarray(jax.random.bernoulli(k_map, ratio, (B,)),
                            np.float32)) == MAP_DROP:
            return jax.random.PRNGKey(i)
    raise AssertionError("no key draws MAP_DROP")


@pytest.fixture(scope="module")
def c3_jax():
    """{mode: (JAX params in the mode's layout, loss, grads)}, the batch,
    the step's draws and its TrainConfig."""
    from magicdrive_tpu.config.presets import init_params
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_dataset
    from magicdrive_tpu.diffusion import ddpm as jddpm
    from magicdrive_tpu.train.state import TrainConfig, create_train_state
    from magicdrive_tpu.train.train_step import (make_drop_mask,
                                                 make_train_step)

    batch = collate_fn(make_dataset(2), CollateConfig(bbox_max_len=8),
                       rng=np.random.default_rng(0))
    # the first three cameras
    batch = {k: np.ascontiguousarray(v[:, :3]) if v.ndim > 1 and
             v.shape[1] == 6 else v for k, v in batch.items()}
    jpre, _ = _c3_presets("learnable")
    modules = jpre.modules(dtype=jnp.float32)
    learnable = scaled_kernels(randomized(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(
            lambda k: init_params(jpre, modules, k), jax.random.PRNGKey(0))),
        np.random.RandomState(3)), KERNEL_GAIN)
    tcfg = TrainConfig(learning_rate=LR, lr_warmup_steps=0,
                       drop_cond_ratio=0.5, drop_cam_num=2)
    B, N = batch["pixel_values"].shape[:2]
    rng = _c3_key(tcfg.drop_cond_ratio, B)
    h, w = modules.vae.latent_hw(jpre.image_size)
    k_noise, k_t, k_drop, k_vae = jax.random.split(rng, 4)
    k_drop, k_map = jax.random.split(k_drop)
    draws = {
        "vae_noise": jax.random.normal(k_vae, (B * N, h, w, 4)),
        "timesteps": jddpm.sample_timesteps(
            k_t, B, modules.schedule.num_train_timesteps),
        "noise": jddpm.noise_with_offset(k_noise, (B, N, h, w, 4), 0.0),
        "drop_mask": make_drop_mask(k_drop, B, N, tcfg.drop_cond_ratio,
                                    tcfg.drop_cam_num),
        "map_drop_mask": jax.random.bernoulli(
            k_map, tcfg.drop_cond_ratio, (B,)).astype(jnp.float32),
    }
    step = jax.jit(jax.value_and_grad(_jax_loss_fn(
        make_train_step(modules, tcfg))))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    um = learnable["controlnet"]["params"]["uncond_map"]
    out = {}
    for mode in C3_MODES:
        params = jax.tree_util.tree_map(np.copy, learnable)
        params["controlnet"]["params"]["uncond_map"] = -np.ones_like(um) \
            if mode == "negative1" else np.random.RandomState(4).randn(
                *um.shape).astype(np.float32)
        state = create_train_state(params, tcfg)
        loss, grads = step(state.trainable, state.frozen, jbatch, rng)
        if mode != "learnable":  # the mode's own layout: a buffer
            cn = params["controlnet"]
            cn.setdefault("buffers", {})["uncond_map"] = \
                cn["params"].pop("uncond_map")
            grads = {k: v for k, v in grads.items()
                     if k != "controlnet/params/uncond_map"}
        out[mode] = (params, float(loss),
                     {k: np.asarray(v) for k, v in grads.items()})
    return dict(out, batch=batch, tcfg=tcfg,
                draws={k: np.asarray(v) for k, v in draws.items()})


def _c3_port(c3_jax, mode):
    """The port's loss and grads on the JAX step's weights and draws."""
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import (StepDraws,
                                                       batch_tensors,
                                                       loss_and_grads)

    j = c3_jax
    _, tpre = _c3_presets(mode)
    modules = MagicDriveModules.create(tpre, device="cpu").load_state_dicts(
        jax_params_to_state_dicts(j[mode][0]))
    cfg = tstate.TrainConfig(**{f.name: getattr(j["tcfg"], f.name)
                                for f in dataclasses.fields(
                                    tstate.TrainConfig)})
    state = tstate.create_train_state(modules, cfg, device="cpu",
                                      dtype=torch.float32)
    d = j["draws"]
    draws = StepDraws(
        vae_noise=torch.tensor(d["vae_noise"].transpose(0, 3, 1, 2)),
        noise=torch.tensor(d["noise"].transpose(0, 1, 4, 2, 3)),
        timesteps=torch.tensor(d["timesteps"], dtype=torch.long),
        drop_mask=torch.tensor(d["drop_mask"]),
        map_drop_mask=torch.tensor(d["map_drop_mask"]))
    loss, grads = loss_and_grads(modules, state,
                                 batch_tensors(j["batch"], "cpu"), draws, cfg,
                                 NoiseSchedule.create())
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def _check_c3(jax_loss, jax_grads, loss, grads):
    """Loss to rtol 2e-3, every trainable gradient as ``_check_grads``."""
    np.testing.assert_allclose(loss, jax_loss, rtol=RTOL)
    want = _as_port(jax_grads)
    assert set(grads) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, rtol=RTOL, err_msg=k,
                                   atol=min(ATOL, GRAD_TOL * np.abs(w).max()))


@pytest.mark.parametrize("mode", C3_MODES)
def test_train_step_map_drop_matches_jax(c3_jax, mode):
    """Each uncond-map mode with the map drop MAP_DROP: the port's loss and
    every trainable gradient equal JAX's; the learnable map's gradient is
    nonzero (the substituted sample reaches it)."""
    assert tuple(c3_jax["draws"]["map_drop_mask"]) == MAP_DROP
    loss, grads = _c3_port(c3_jax, mode)
    _check_c3(*c3_jax[mode][1:], loss, grads)
    if mode == "learnable":
        assert np.abs(grads["controlnet.uncond_map"]).max() > 0
    else:
        assert "controlnet.uncond_map" not in grads


def test_train_step_ignored_map_drop_fails(c3_jax, monkeypatch):
    """A planted fault, the map drop ignored, fails the check above."""
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet

    monkeypatch.setattr(BEVControlNet, "substitute_with_uncond_map",
                        lambda self, cond, mask=None: cond)
    loss, grads = _c3_port(c3_jax, "learnable")
    assert not grads["controlnet.uncond_map"].any()
    with pytest.raises(AssertionError):
        _check_c3(*c3_jax["learnable"][1:], loss, grads)


@pytest.mark.parametrize("ratio", [0.0, 0.5])
@pytest.mark.parametrize("mode", [None, "negative1"])
def test_sample_draws_draws_a_map_mask_when_jax_does(ratio, mode,
                                                     monkeypatch):
    """``sample_draws`` draws the map drop exactly where the JAX step's
    loss draws its (B,) Bernoulli: with drop_cond_ratio > 0 and a
    ControlNet with ``use_uncond_map`` (traced on micro_debug)."""
    from magicdrive_tpu.config.presets import init_params, micro_debug
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_dataset
    from magicdrive_tpu.train.state import TrainConfig as JCfg
    from magicdrive_tpu.train.state import create_train_state
    from magicdrive_tpu.train.train_step import make_train_step

    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.train.state import TrainConfig
    from magicdrive_tpu_torch.train.train_step import sample_draws

    jpre = micro_debug()
    jpre = dataclasses.replace(jpre, controlnet=dataclasses.replace(
        jpre.controlnet, use_uncond_map=mode))
    modules = jpre.modules(dtype=jnp.float32)
    tcfg = JCfg(drop_cond_ratio=ratio)
    batch = collate_fn(make_dataset(2, image_hw=jpre.image_size,
                                    map_hw=jpre.map_hw),
                       CollateConfig(bbox_max_len=8,
                                     canvas_hw=jpre.image_size),
                       rng=np.random.default_rng(0))
    shapes = []
    real = jax.random.bernoulli
    monkeypatch.setattr(jax.random, "bernoulli", lambda k, p, shape: (
        shapes.append(tuple(shape)), real(k, p, shape))[1])
    state = jax.eval_shape(lambda k: create_train_state(
        init_params(jpre, modules, k), tcfg), jax.random.PRNGKey(0))
    jax.eval_shape(_jax_loss_fn(make_train_step(modules, tcfg)),
                   state.trainable, state.frozen,
                   {k: jnp.asarray(v) for k, v in batch.items()},
                   jax.random.PRNGKey(1))
    jax_draws = (2,) in shapes
    draws = sample_draws(TrainConfig(drop_cond_ratio=ratio),
                         NoiseSchedule.create(), 2, 6, (4, 8),
                         torch.Generator().manual_seed(0), "cpu", mode)
    assert (draws.map_drop_mask is not None) == jax_draws
    assert jax_draws == (ratio > 0 and mode is not None)
    if jax_draws:
        assert draws.map_drop_mask.shape == (2,)
