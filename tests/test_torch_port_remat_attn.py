"""Gradient checkpointing under ``remat_policy: "attn"`` against the JAX
package's ``save_only_these_names("attn_out")``.

JAX tags every attention's output ``attn_out`` and its remat units keep
those alone; the port's "attn" policy keeps the output of every
attention's core (the kernels' ``mdk::*`` ops and the SDPA calls), so its
recompute runs no attention of the UNet's units again. Held here, in fp32
on the CPU:
  * JAX's ``test_remat_policy_attn_identity`` configuration through both
    packages on the same weights: the port under "attn" against JAX under
    "attn" (output and every gradient, atol 2e-4 / rtol 2e-3), and against
    the port without remat (output bitwise, gradients within 1e-5, the
    bound of JAX's test);
  * a ``micro_debug`` train step with the UNet under "attn" (the
    ControlNet recomputes everything, as in JAX) against JAX's step on the
    same weights, batch and draws (one jit), and against the port's own
    step without remat;
  * the recompute's SDPA calls in that UNet: as many as without remat;
    its kernel calls in a ``tiny_debug`` step, which
    ``test_torch_port_train_modes.py`` holds to
    ``chip_smoke.expected_launches(recompute="attn")`` (the UNet's
    attentions run once, the ControlNet's and the feed-forwards again): a
    policy that keeps nothing, a planted fault, fails that count;
  * ``cli.train`` with the UNet's checkpointing under "attn" trains.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_port_modules import (load, nchw, randomized, scaled_kernels,
                                     shaped, to_nhwc)
from test_torch_port_train_modes import _counted_step, _remat
from test_torch_port_train_step import KERNEL_GAIN, _as_port, _jax_loss_fn

torch.set_num_threads(1)

ATOL, RTOL = 2e-4, 2e-3
GRAD_TOL = 1e-3  # * max|g| of each tensor (test_torch_port_train_step.py)
SELF_TOL = 1e-5  # the port under "attn" against itself without remat


class _SdpaCalls(TorchDispatchMode):
    """Counts the SDPA forward calls that run (a call a selective
    checkpoint answers from what it kept does not reach this mode)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.startswith("_scaled_dot_product") and \
                "backward" not in func.__name__:
            self.n += 1
        return func(*args, **(kwargs or {}))


# ---------------------------------------------------------------------------
# JAX's test_remat_policy_attn_identity, through both packages
# ---------------------------------------------------------------------------

def _identity_cfgs():
    from magicdrive_tpu.models import unet as junet

    from magicdrive_tpu_torch.config import NUSCENES_NEIGHBORS, UNetConfig

    kw = dict(block_out_channels=(8, 16), layers_per_block=1,
              num_attention_heads=2, cross_attention_dim=12,
              norm_num_groups=4, down_block_has_attn=(True, True),
              neighboring_view_pair=NUSCENES_NEIGHBORS)
    remat = dict(gradient_checkpointing=True, remat_policy="attn")
    return (junet.UNetConfig(**kw), junet.UNetConfig(**kw, **remat),
            UNetConfig(**kw), UNetConfig(**kw, **remat))


def test_unet_remat_attn_matches_jax_and_no_remat():
    from magicdrive_tpu.models.unet import UNet2DConditionModel as J

    from magicdrive_tpu_torch.models.unet import UNet2DConditionModel as T

    jcfg, jcfg_r, tcfg, tcfg_r = _identity_cfgs()
    rs = np.random.RandomState(0)
    x = rs.randn(6, 8, 8, 4).astype(np.float32)
    t = np.zeros((6,), np.int32)
    ctx = rs.randn(6, 9, 12).astype(np.float32)
    jx, jt, jctx = map(jnp.asarray, (x, t, ctx))
    jm_r = J(jcfg_r)
    init = lambda m: jax.eval_shape(m.init, jax.random.PRNGKey(0), jx, jt,
                                    jctx)
    v = shaped(init(jm_r), np.random.RandomState(3))
    assert jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(
        init(J(jcfg)))
    want, vjp = jax.vjp(lambda p: jm_r.apply(p, jx, jt, jctx), v)
    # d mean(y^2) / dy, as JAX's test takes the gradient of the mean square
    dy = 2.0 * np.asarray(want) / want.size
    (jgrads,) = vjp(jnp.asarray(dy))

    tx = nchw(x)
    tt = torch.from_numpy(t.astype(np.int64))
    tctx = torch.from_numpy(ctx)
    outs, grads = {}, {}
    for name, cfg in (("plain", tcfg), ("attn", tcfg_r)):
        m = load(T(cfg), v).train()
        with _SdpaCalls() as sdpa:
            y = m(tx, tt, tctx)
            (y ** 2).mean().backward()
        outs[name], grads[name] = y.detach(), {
            k: p.grad for k, p in m.named_parameters()}
        outs[name + " sdpa"] = sdpa.n
    # the recompute ran no attention: as many SDPA calls as without remat
    assert outs["attn sdpa"] == outs["plain sdpa"] > 0
    assert torch.equal(outs["attn"], outs["plain"])
    for k, g in grads["plain"].items():
        assert (grads["attn"][k] - g).abs().max().item() <= SELF_TOL, k
    np.testing.assert_allclose(to_nhwc(outs["attn"]), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    from magicdrive_tpu_torch.convert import module_state_dict

    want_g = module_state_dict(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(want_g) == set(grads["attn"])
    for k, g in grads["attn"].items():
        np.testing.assert_allclose(g.numpy(), want_g[k], atol=ATOL,
                                   rtol=RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# a micro_debug train step under "attn" against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    from magicdrive_tpu.config import presets as jp
    from magicdrive_tpu.data.collate import CollateConfig, collate_fn
    from magicdrive_tpu.data.fixtures import make_dataset
    from magicdrive_tpu.diffusion import ddpm as jddpm
    from magicdrive_tpu.train.state import TrainConfig, create_train_state
    from magicdrive_tpu.train.train_step import (make_drop_mask,
                                                 make_train_step)

    preset = _remat(jp.micro_debug(), "attn")
    modules = preset.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: jp.init_params(preset, modules, k),
                            jax.random.PRNGKey(0))
    params = scaled_kernels(randomized(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes),
        np.random.RandomState(0)), KERNEL_GAIN)
    tcfg = TrainConfig(learning_rate=1e-3, lr_warmup_steps=0,
                       drop_cond_ratio=1.0, drop_cam_num=3)
    B, N = 2, 6
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
    draws = {
        "vae_noise": jax.random.normal(k_vae, (B * N, h, w, 4)),
        "timesteps": jddpm.sample_timesteps(
            k_t, B, modules.schedule.num_train_timesteps),
        "noise": jddpm.noise_with_offset(k_noise, (B, N, h, w, 4), 0.0),
        "drop_mask": make_drop_mask(k_drop, B, N, tcfg.drop_cond_ratio,
                                    tcfg.drop_cam_num)}
    state = create_train_state(params, tcfg)
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss_fn(
        make_train_step(modules, tcfg))))(
        state.trainable, state.frozen,
        {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    return dict(params=params, batch=batch, tcfg=tcfg, loss=float(loss),
                draws={k: np.asarray(v) for k, v in draws.items()},
                grads=_as_port({k: np.asarray(v) for k, v in grads.items()}))


def _port_grads(j, policy):
    """The port's loss and gradients on JAX's weights, batch and draws;
    ``policy`` False: no checkpointing."""
    from magicdrive_tpu_torch import config as tp
    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import (StepDraws,
                                                       batch_tensors,
                                                       loss_and_grads)

    preset = tp.micro_debug()
    if policy is not False:
        preset = _remat(preset, policy)
    modules = MagicDriveModules.create(preset, device="cpu").load_state_dicts(
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
    loss, grads = loss_and_grads(modules, state,
                                 batch_tensors(j["batch"], "cpu"), draws,
                                 cfg, NoiseSchedule.create())
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def test_micro_train_step_remat_attn_matches_jax(jax_step):
    """The loss and every trainable gradient of the step under "attn"
    against JAX's under "attn" (rtol 2e-3; atol min(2e-4, 1e-3 * the
    tensor's max|g|)), and against the port's own step without remat
    (loss bitwise, gradients within 1e-5)."""
    loss, grads = _port_grads(jax_step, "attn")
    loss0, grads0 = _port_grads(jax_step, False)
    assert loss == loss0
    for k, g in grads0.items():
        np.testing.assert_allclose(grads[k], g, atol=SELF_TOL, rtol=0,
                                   err_msg=k)
    assert np.isfinite(jax_step["loss"]) and jax_step["loss"] > 0.1
    np.testing.assert_allclose(loss, jax_step["loss"], rtol=RTOL)
    assert grads.keys() == jax_step["grads"].keys()
    for k, want in jax_step["grads"].items():
        tol = min(ATOL, GRAD_TOL * float(np.abs(want).max()))
        np.testing.assert_allclose(grads[k], want, rtol=RTOL, atol=tol,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# what the recompute runs
# ---------------------------------------------------------------------------

def test_remat_attn_count_fails_a_policy_that_keeps_nothing(monkeypatch):
    """The planted fault: with the "attn" policy keeping nothing, a
    ``tiny_debug`` step recomputes every attention, and its kernel calls
    are the "dots" count, not ``expected_launches(recompute="attn")``'s
    (which ``test_step_calls_with_recompute_match_derived`` holds the
    step to)."""
    import chip_smoke
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.models import unet as unet_mod

    monkeypatch.setattr(unet_mod, "_attn_policy",
                        lambda ctx, op, *a, **k:
                        unet_mod.CheckpointPolicy.PREFER_RECOMPUTE)
    preset = _remat(tiny_debug(), "attn")
    faulty = _counted_step(preset, "kvstat")
    want = chip_smoke.expected_launches(preset, "kvstat", steps=1, esize=4,
                                        recompute="attn")
    dots = chip_smoke.expected_launches(preset, "kvstat", steps=1, esize=4,
                                        recompute=True)
    assert faulty != want and faulty == dots


def test_cli_train_with_remat_attn(tmp_path):
    """``cli.train`` with the UNet's gradient checkpointing under "attn"
    (``+model.unet.remat_policy``: the model YAML names no policy) runs a
    step, with the policy in the modules it built."""
    from magicdrive_tpu_torch.cli import train

    run = train.main([
        "model=tiny_debug", "runner=debug", "runner.mixed_precision=no",
        "parallel.mesh_shape=[1,1]", "dataset.dataset_root=/nonexistent",
        "runner.max_train_steps=1", "runner.checkpointing_steps=1",
        "runner.validation_before_run=false", "runner.validation_steps=10",
        "runner.num_workers=1", "model.unet.gradient_checkpointing=true",
        "+model.unet.remat_policy=attn", f"log_root_prefix={tmp_path}"],
        device="cpu")
    unet = run.runner.modules.unet
    assert unet.cfg.remat_policy == "attn" and unet.cfg.gradient_checkpointing
    assert run.state.step == 1
    with open(f"{run.run_dir}/metrics.jsonl") as f:
        assert '"loss"' in f.readline()
