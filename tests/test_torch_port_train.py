"""The port's training state, optimizer, draws and runner, against the JAX
package where it has a counterpart (optax's chain, the LR schedule, the
trainable partition), and on their own where the port's behaviour is its own
(the deferred NaN guard before checkpoints, resume, the kernel calls of a
step). fp32 unless stated; the optimizer at atol 1e-7 / rtol 1e-5, since
both sides do the same few fp32 operations per element.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _configs():
    from magicdrive_tpu.train.state import TrainConfig as JCfg

    from magicdrive_tpu_torch.train.state import TrainConfig

    kw = dict(learning_rate=1e-2, lr_warmup_steps=1, max_train_steps=5,
              max_grad_norm=1.0)
    return JCfg(**kw), TrainConfig(**kw)


def test_learning_rate_matches_optax_schedule():
    """The recipe's constant_with_warmup (the only schedule the configs
    use) against optax's join of linear and constant schedules."""
    from magicdrive_tpu.train.state import make_lr_schedule

    from magicdrive_tpu_torch.train.state import make_lr_schedule as port

    for warm in (0, 1, 4):
        jcfg, tcfg = _configs()
        jcfg = dataclasses.replace(jcfg, lr_warmup_steps=warm,
                                   max_train_steps=20)
        tcfg = dataclasses.replace(tcfg, lr_warmup_steps=warm,
                                   max_train_steps=20)
        fn, learning_rate = make_lr_schedule(jcfg), port(tcfg)
        for count in range(25):
            # optax evaluates in fp32, the port in float64
            np.testing.assert_allclose(learning_rate(count),
                                       float(fn(count)), rtol=1e-5,
                                       atol=1e-6 * tcfg.learning_rate,
                                       err_msg=(warm, count))
    assert learning_rate(0) == 0.0  # warm-up starts from lr 0


def test_adamw_matches_optax_chain():
    """Three updates of optax.chain(clip_by_global_norm, adamw) against the
    port's AdamW: the first at lr 0 (warm-up), the second with a gradient
    norm below max_grad_norm, the third above it, so the clip acts."""
    from magicdrive_tpu.train.state import make_optimizer

    from magicdrive_tpu_torch.train.state import AdamW

    rs = np.random.RandomState(0)
    params = {"a": rs.randn(7, 5).astype(np.float32),
              "b": rs.randn(13).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.05, 0.05, 3.0)]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values()))
             for gs in grads]
    assert norms[1] < 1.0 < norms[2]
    jcfg, tcfg = _configs()
    tx = make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = AdamW(tp, tcfg)
    for i, g in enumerate(grads):
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        norm = opt.step(tp, {k: torch.tensor(v) for k, v in g.items()})
        np.testing.assert_allclose(float(norm), norms[i], rtol=1e-5)
        for k in tp:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=1e-7, rtol=1e-5, err_msg=(i, k))
        if i == 0:  # lr 0 on the first update
            for k in tp:
                np.testing.assert_array_equal(tp[k].numpy(), params[k])
    assert opt.count == 3


def test_drop_mask_semantics():
    from magicdrive_tpu_torch.train import make_drop_mask

    g = torch.Generator().manual_seed(0)
    m = make_drop_mask(g, 512, 6, drop_cond_ratio=0.25, drop_cam_num=6)
    assert m.shape == (512, 6) and m.dtype == torch.float32
    per_sample = m.sum(-1)
    assert set(per_sample.unique().tolist()) <= {0.0, 6.0}
    assert 0.15 < (per_sample > 0).float().mean().item() < 0.35
    m2 = make_drop_mask(g, 512, 6, drop_cond_ratio=1.0, drop_cam_num=2)
    assert (m2.sum(-1) == 2).all()
    assert len({tuple(r) for r in m2.tolist()}) > 5  # cameras vary


@pytest.fixture(scope="module")
def jax_tree():
    """The tiny_debug JAX parameter tree (shapes from jax.eval_shape, zero
    values: only the names and the collections matter here)."""
    from magicdrive_tpu.config.presets import init_params, tiny_debug

    preset = tiny_debug()
    modules = preset.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(lambda k: init_params(preset, modules, k),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def test_trainable_keys_match_jax_partition(jax_tree):
    """convert.trainable_keys (the port's is_trainable over converted keys)
    names exactly the JAX is_trainable leaves, mapped through the
    converter's key map, and exactly the port modules' trainable
    parameters."""
    from magicdrive_tpu.train.state import split_params

    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.convert import torch_key, trainable_keys
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train.state import trainable_parameters

    got = trainable_keys(jax_tree)
    jax_trainable, _ = split_params(jax_tree)
    want = {n: set() for n in got}
    for k in jax_trainable:
        module, _, *path = k.split("/")
        want[module].add(torch_key(tuple(path)))
    assert got == want
    assert got["vae"] == got["clip"] == set()
    assert len(got["unet"]) > 20 and len(got["controlnet"]) > 100
    port = trainable_parameters(MagicDriveModules.create(tiny_debug(),
                                                         device="cpu"))
    assert set(port) == {f"{n}.{k}" for n, ks in got.items() for k in ks}


def _tiny_setup(dtype=torch.float32):
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state

    torch.manual_seed(0)
    preset = tiny_debug()
    modules = MagicDriveModules.create(preset, device="cpu")
    cfg = TrainConfig(learning_rate=1e-3, lr_warmup_steps=1)
    state = create_train_state(modules, cfg, device="cpu", dtype=dtype)
    batch = collate_fn([make_sample(0, with_images=True)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    return modules, cfg, state, batch


def _tiny_runner(run_dir, mixed_precision, checkpointing_steps):
    """A config-driven Runner of ``model=tiny_debug runner=debug`` on the
    CPU (lr 1e-3 after a one-step warm-up, no validation), its state and
    one fixture batch; the steps are driven through ``Runner.train``."""
    from magicdrive_tpu_torch.cli.train import CONFIG_DIR
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.data import make_dataset
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import Runner

    cfg = compose(CONFIG_DIR, overrides=[
        "model=tiny_debug", "runner=debug", "runner.learning_rate=1e-3",
        "runner.lr_warmup_steps=1",
        f"runner.mixed_precision={mixed_precision}",
        f"runner.checkpointing_steps={checkpointing_steps}"])
    preset = preset_from_config(cfg)
    torch.manual_seed(0)
    modules = MagicDriveModules.create(preset, device="cpu")
    data = make_dataset(1, with_images=True)
    runner = Runner(cfg, preset, modules, data, run_dir=run_dir,
                    device="cpu")
    batch = next(iter(runner.loader))
    return runner, runner.init_state(), batch


def test_runner_nan_guard_blocks_checkpoint(tmp_path, monkeypatch):
    """A NaN loss stops training before the state that produced it is
    checkpointed: the deferred check is drained ahead of every save."""
    import magicdrive_tpu_torch.train.runner as runner_mod

    real = runner_mod.train_step

    def poisoned(*args, **kwargs):
        metrics = real(*args, **kwargs)
        return dict(metrics, loss=metrics["loss"] * float("nan"))

    monkeypatch.setattr(runner_mod, "train_step", poisoned)
    runner, state, batch = _tiny_runner(str(tmp_path / "nanrun"), "no", 1)
    with pytest.raises(RuntimeError, match="NaN/inf loss at step 1"):
        runner.train(state, [batch] * 3)
    assert runner.checkpoints() == []


def test_runner_checkpoint_and_resume(tmp_path):
    """Two bf16 steps over fp32 masters with a checkpoint at step 2; a fresh
    state resumes from it with the step, the masters, both moments and both
    counts, and the run goes on to step 3. Frozen weights never move."""
    run_dir = str(tmp_path / "run")
    runner, state, batch = _tiny_runner(run_dir, "bf16", 2)
    modules = runner.modules
    frozen = {k: t.clone() for k, t in modules.vae.state_dict().items()}
    init = {k: t.clone() for k, t in state.masters.items()}
    runner.train(state, [batch] * 2)
    assert state.step == 2
    records = [json.loads(line) for line in
               open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert any(not torch.equal(init[k], t) for k, t in state.masters.items())
    for k, t in modules.vae.state_dict().items():
        assert torch.equal(t, frozen[k]), k

    runner2, fresh, _ = _tiny_runner(run_dir, "bf16", 2)
    assert runner2.restore(fresh)
    assert fresh.step == 2 and fresh.opt.count == 2
    assert fresh.opt.schedule_count == 2
    for a, b in ((fresh.masters, state.masters), (fresh.opt.mu, state.opt.mu),
                 (fresh.opt.nu, state.opt.nu)):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    runner2.train(fresh, [batch])
    runner2.save(fresh)
    assert fresh.step == 3
    assert [s for s, _ in runner2.checkpoints()] == [2, 3]


def _step_calls(mode):
    """The kernel calls of one tiny_debug train step under the fused
    ``mode``, counted at every wrapper the model can reach (K6 is one call
    here for its two launches), against chip_smoke.py's derivation."""
    import chip_smoke
    from magicdrive_tpu_torch.config import tiny_debug
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.train import train_step

    modules, cfg, state, batch = _tiny_setup()
    names = set(chip_smoke.training_calls("kvstat")) | \
        set(chip_smoke.training_calls("auto"))
    with chip_smoke.counted_calls(names) as calls, dispatch.fused_mode(mode):
        train_step(modules, state, batch, cfg,
                   generator=torch.Generator().manual_seed(0))
    bwd = calls.pop("flash_attention_bwd")
    got = {**dict.fromkeys(dispatch.LAUNCHES, 0), **calls,
           "flash_attention_bwd_dq": bwd, "flash_attention_bwd_dkv": bwd}
    # fp32 on the CPU: the routing rules see 4-byte elements
    return got, chip_smoke.expected_launches(tiny_debug(), mode, steps=1,
                                             esize=4)


def test_training_calls_match_derived_counts():
    """Under "kvstat": every K1 but the UNet's first attn1 runs a backward,
    and every K2 runs two."""
    got, want = _step_calls("kvstat")
    assert got == want
    assert want["flash_attention_fwd"] == 40
    assert want["fused_qkv_out_attention"] == want["fused_qkv_attention"] == 0


def test_training_calls_match_derived_counts_auto():
    """Under "auto" the tiny preset routes every kernel attention to K8 or
    its pair; K7 recomputes o for dWout in the backward of the ControlNet's
    K8 calls and of each pair branch, and K1/K2 never run."""
    got, want = _step_calls("auto")
    assert got == want
    assert want["flash_attention_fwd"] == 40
    assert want["kvstat_attention"] == want["kvstat_attention_pair"] == 0
    assert want["fused_qkv_out_attention"] == 21
    assert want["fused_qkv_out_attention_pair"] == 10
    assert want["fused_qkv_attention"] == 26


def test_training_calls_match_derived_counts_projected(monkeypatch):
    """With the fused kernels' fit rules made to fail, every kernel
    attention takes the projected route and every cross-view pair its
    per-neighbour loop: K5 runs once per forward call (twice a pair), and
    the backward runs K6 alone on the forward's o and lse, so K5 does not
    run again; K1, K2, K7 and K8 never run."""
    from magicdrive_tpu_torch.kernels import dispatch

    monkeypatch.setattr(dispatch, "fused_mode_for", lambda *a: None)
    assert dispatch.attention_route(1400, 1400, 8, 4, 4) == "projected"
    assert dispatch.pair_route(1400, 8, 4, 4) == "projected_loop"
    got, want = _step_calls("kvstat")
    assert got == want
    assert want["kvstat_attention"] == want["kvstat_attention_pair"] == \
        want["fused_qkv_out_attention"] == want["fused_qkv_attention"] == 0
    assert want["flash_attention_fwd"] == 41
    assert want["flash_attention_bwd_dq"] == 40
