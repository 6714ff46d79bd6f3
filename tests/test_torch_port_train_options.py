"""The port's training options against the JAX package's optimizer chain,
schedules and config reader: the learning-rate schedules against optax,
gradient accumulation against ``optax.MultiSteps``, the 8-bit moments'
codec bitwise and three 8-bit AdamW updates against JAX's chain,
``reset_lr_schedule``, the noise schedule's betas, and
``train_config_from_cfg`` on the runner configs. fp32; the optimizer at
atol 1e-7 / rtol 1e-5 (both sides do the same few fp32 operations per
element), the 8-bit masters at atol 1e-6.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(**kw):
    from magicdrive_tpu.train.state import TrainConfig as JCfg

    from magicdrive_tpu_torch.train.state import TrainConfig

    kw = dict(dict(learning_rate=1e-2, lr_warmup_steps=1, max_train_steps=5,
                   max_grad_norm=1.0), **kw)
    return JCfg(**kw), TrainConfig(**kw)


def _problem(seed=0, scales=(0.05, 0.05, 3.0)):
    """Two parameter tensors (one not a whole number of 256-blocks) and a
    gradient per update: the norms below and above max_grad_norm 1."""
    rs = np.random.RandomState(seed)
    params = {"a": rs.randn(7, 50).astype(np.float32),
              "b": rs.randn(613).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in scales]
    return params, grads


def _jax_updates(tx, params, grads):
    """Params after each update of the optax ``tx``."""
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    out = []
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        out.append({k: np.asarray(v) for k, v in jp.items()})
    return out, st


@pytest.mark.parametrize("schedule, warm, total",
                         [("constant_with_warmup", 0, 20),
                          ("constant_with_warmup", 3, 20),
                          ("cosine", 0, 12), ("cosine", 4, 12),
                          ("cosine", 1, 2)])
def test_lr_schedules_match_optax(schedule, warm, total):
    """Both schedules at every count 0..total+3 against optax's (the
    cosine past its end stays at 0)."""
    from magicdrive_tpu.train.state import make_lr_schedule as jschedule

    from magicdrive_tpu_torch.train.state import make_lr_schedule

    jcfg, tcfg = _configs(lr_schedule=schedule, lr_warmup_steps=warm,
                          max_train_steps=total)
    fn, port = jschedule(jcfg), make_lr_schedule(tcfg)
    for count in range(total + 4):
        np.testing.assert_allclose(port(count), float(fn(count)), rtol=1e-5,
                                   atol=1e-6 * tcfg.learning_rate,
                                   err_msg=count)
    assert port(0) == (0.0 if warm else tcfg.learning_rate)


def test_cosine_schedule_needs_decay_steps():
    from magicdrive_tpu_torch.train.state import make_lr_schedule

    with pytest.raises(ValueError, match="max_train_steps"):
        make_lr_schedule(_configs(lr_schedule="cosine", lr_warmup_steps=5,
                                  max_train_steps=5)[1])


@pytest.mark.parametrize("use_8bit", [False, True])
def test_accumulation_matches_optax_multisteps(use_8bit):
    """Eight micro-steps of 4-step accumulation against optax.MultiSteps
    over the clip and AdamW (or the 8-bit chain): the parameters move only
    on the 4th and 8th call, to JAX's values; the mini-step and gradient
    counts follow optax's, and the inner counts advance only on updates."""
    from magicdrive_tpu.train.state import make_optimizer

    from magicdrive_tpu_torch.train.state import MultiSteps, make_optimizer \
        as port_optimizer

    params, grads = _problem(1, scales=(0.3, 0.2, 0.5, 0.4) * 2)
    jcfg, tcfg = _configs(gradient_accumulation_steps=4, lr_warmup_steps=0,
                          use_8bit_adam=use_8bit)
    want, jstate = _jax_updates(make_optimizer(jcfg), params, grads)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = port_optimizer(tp, tcfg)
    assert isinstance(opt, MultiSteps)
    prev = {k: t.clone() for k, t in tp.items()}
    for i, g in enumerate(grads):
        opt.step(tp, {k: torch.tensor(v) for k, v in g.items()})
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), want[i][k],
                                       atol=1e-6 if use_8bit else 1e-7,
                                       rtol=1e-5, err_msg=(i, k))
            assert torch.equal(tp[k], prev[k]) == (i % 4 != 3), (i, k)
        prev = {k: t.clone() for k, t in tp.items()}
    assert opt.mini_step == int(jstate.mini_step) == 0
    assert opt.gradient_step == int(jstate.gradient_step) == 2
    assert opt.inner.count == opt.inner.schedule_count == 2


def test_quantize_matches_jax_bitwise():
    """The 8-bit codec: codes and scales bitwise JAX's (blocks of 256,
    absmax / 127, round half to even, the all-zero block's scale 1), and the
    dequantized tensor bitwise JAX's."""
    from magicdrive_tpu.train.adam8bit import _dequantize, _quantize

    from magicdrive_tpu_torch.train.adam8bit import dequantize, quantize

    rs = np.random.RandomState(3)
    x = (rs.randn(3, 333) * np.exp(rs.randn(3, 1) * 3)).astype(np.float32)
    x[0, :300] = 0.0  # an all-zero block
    # exact halves: 127 * k / 2 of the block's absmax land on .5 codes
    x[2, :8] = np.float32(127.0) * np.arange(8, dtype=np.float32) / 2
    x[2, 8] = 127.0
    want = _quantize(jnp.asarray(x))
    q, s = quantize(torch.tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want.scale))
    assert q.dtype == torch.int8 and q.shape == (4, 256)
    np.testing.assert_array_equal(
        dequantize(q, s, x.shape).numpy(),
        np.asarray(_dequantize(want, x.shape)))
    assert (np.abs(q.numpy()) <= 127).all()


def test_adamw8bit_matches_jax_chain():
    """Three updates of JAX's clip + ``adamw_8bit`` chain against the
    port's 8-bit AdamW: the first at lr 0 (warm-up), the second below the
    clip's norm, the third above it. The masters within atol 1e-6; the
    int8 codes of both moments differ by at most 1, in at most 0.1 % of
    the entries (the bias corrections' fp32 powers may differ by an
    ulp)."""
    from magicdrive_tpu.train.state import make_optimizer

    from magicdrive_tpu_torch.train.adam8bit import AdamW8bit
    from magicdrive_tpu_torch.train.state import make_optimizer as port_opt

    params, grads = _problem(2)
    jcfg, tcfg = _configs(use_8bit_adam=True)
    want, jstate = _jax_updates(make_optimizer(jcfg), params, grads)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = port_opt(tp, tcfg)
    assert isinstance(opt, AdamW8bit)
    for i, g in enumerate(grads):
        opt.step(tp, {k: torch.tensor(v) for k, v in g.items()})
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), want[i][k], atol=1e-6,
                                       rtol=0, err_msg=(i, k))
        if i == 0:
            for k in tp:
                np.testing.assert_array_equal(tp[k].numpy(), params[k])
    jadam = jstate[1][0]  # chain(clip, chain(adam8bit, decay, lr))
    for name in ("mu", "nu"):
        for k in tp:
            got = getattr(opt, name)[k][0].numpy().astype(np.int32)
            ref = np.asarray(getattr(jadam, name)[k].q).astype(np.int32)
            diff = np.abs(got - ref)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (name, k)
    assert opt.count == int(jadam.count) == 3
    # 2 x (1 + 4/256) bytes per parameter (and the last block's padding),
    # against fp32 AdamW's 8
    nbytes = sum(t.numel() * t.element_size() for m in (opt.mu, opt.nu)
                 for qs in m.values() for t in qs)
    assert nbytes == 2 * sum(-(-v.size // 256) * (256 + 4)
                             for v in params.values())


def _counts(node):
    """The ``count`` of every optax state in a (nested) chain state."""
    if hasattr(node, "_fields"):
        return ([int(node.count)] if "count" in node._fields else []) + [
            c for v in node for c in _counts(v)]
    if isinstance(node, (tuple, list)):
        return [c for v in node for c in _counts(v)]
    return []


@pytest.mark.parametrize("use_8bit", [False, True])
def test_reset_lr_schedule_matches_jax(use_8bit):
    """After three updates, ``reset_lr_schedule`` zeroes the schedule's
    count and keeps Adam's (optax's ScaleByScheduleState against
    ScaleByAdamState), as JAX's does; the next update, at lr 0 again under
    the warm-up, leaves the masters where they were, as JAX's does."""
    from magicdrive_tpu.train.state import (create_train_state,
                                            reset_lr_schedule)

    from magicdrive_tpu_torch.train import state as port

    params, grads = _problem(4)
    grads.append(grads[0])
    jcfg, tcfg = _configs(lr_warmup_steps=2, use_8bit_adam=use_8bit)
    jstate = create_train_state(
        {"controlnet": {"params": {k: jnp.asarray(v)
                                   for k, v in params.items()}}}, jcfg)
    masters = {k: torch.tensor(v) for k, v in params.items()}
    pstate = port.TrainState(step=0, masters=masters,
                             opt=port.make_optimizer(masters, tcfg))
    flat = lambda g: {f"controlnet/params/{k}": jnp.asarray(v)
                      for k, v in g.items()}
    for i, g in enumerate(grads):
        if i == 3:
            jstate = reset_lr_schedule(jstate)
            pstate = port.reset_lr_schedule(pstate)
            assert sorted(_counts(jstate.opt_state)) == [0, 3]
            assert pstate.opt.schedule_count == 0 and pstate.opt.count == 3
            before = {k: t.clone() for k, t in masters.items()}
        jstate = jstate.apply_gradients(flat(g))
        pstate.apply_gradients({k: torch.tensor(v) for k, v in g.items()})
        for k in masters:
            np.testing.assert_allclose(
                masters[k].numpy(),
                np.asarray(jstate.trainable[f"controlnet/params/{k}"]),
                atol=1e-6 if use_8bit else 1e-7, rtol=1e-5, err_msg=(i, k))
    assert pstate.step == 4 and pstate.opt.count == 4
    for k in masters:  # lr 0 at the restarted schedule's count 0
        assert torch.equal(masters[k], before[k])


@pytest.mark.parametrize("beta_schedule", ["linear", "squaredcos_cap_v2",
                                           "scaled_linear"])
def test_noise_schedule_betas_match_jax(beta_schedule):
    from magicdrive_tpu.diffusion.schedules import NoiseSchedule as J

    from magicdrive_tpu_torch.diffusion import NoiseSchedule

    got = NoiseSchedule.create(beta_schedule=beta_schedule)
    want = J.create(beta_schedule=beta_schedule)
    np.testing.assert_allclose(got.betas, want.betas, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got.alphas_cumprod, want.alphas_cumprod,
                               rtol=1e-12, atol=0)
    with pytest.raises(ValueError, match="beta_schedule"):
        NoiseSchedule.create(beta_schedule="sigmoid")


@pytest.mark.parametrize("runner", ["default", "debug"])
def test_train_config_from_cfg_matches_jax(runner):
    """Every field of JAX's TrainConfig exists in the port's, and the
    runner configs read into equal values."""
    from magicdrive_tpu.config.loader import compose as jcompose
    from magicdrive_tpu.train.runner import train_config_from_cfg as jread
    from magicdrive_tpu.train.state import TrainConfig as JCfg

    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.train.runner import train_config_from_cfg
    from magicdrive_tpu_torch.train.state import TrainConfig

    assert [f.name for f in dataclasses.fields(JCfg)] == \
        [f.name for f in dataclasses.fields(TrainConfig)]
    for extra in ([], ["+runner.use_8bit_adam=true",
                       "runner.lr_schedule=cosine",
                       "runner.gradient_accumulation_steps=2",
                       "runner.train_with_same_noise=true",
                       "+runner.frames_per_clip=16"]):
        ov = [f"runner={runner}", *extra]
        want = jread(jcompose(os.path.join(REPO, "configs"),
                              overrides=ov)["runner"])
        got = train_config_from_cfg(compose(os.path.join(REPO, "configs"),
                                            overrides=ov)["runner"])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), ov
    assert got.use_8bit_adam and got.frames_per_clip == 16
