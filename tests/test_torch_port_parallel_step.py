"""One data-parallel train step of the port against the JAX package's
train step.

JAX's step runs at the global batch of 2 on one device (its ``Runner``
shards that batch over a dp mesh, and XLA's all-reduce computes the same
step). The port's step runs as a job of two gloo ranks on the CPU
(``test_torch_port_parallel.torchrun`` of this file as a script), each
rank its row of the batch and of JAX's draws, fp32. Both start from
``test_torch_port_train_step``'s seeded weights on the small
``tiny_debug`` of the sampling tests (112x200 images, the Plus map
embedder) and are held to that file's checks: the loss, the gradient (the
port's is read from Adam's first moment, with the clip off) and the
update. A rank that stepped on its own half-batch gradient, or on the
ranks' sum, fails them.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from test_torch_port_parallel import (Background, first_moments, rank_main,
                                      run_job, sampling_preset)


def _job_jaxstep(out: str) -> dict:
    """One dp=2 ``train_step`` on the weights, batch and draws that the
    ``jax_dp`` fixture saved, this rank's row of each."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.parallel import make_mesh, shard_batch
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import state as tstate
    from magicdrive_tpu_torch.train.train_step import StepDraws, train_step

    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    modules = MagicDriveModules.create(
        sampling_preset(config, "add"), device="cpu").load_state_dicts(
        inp["state_dicts"])
    cfg = tstate.TrainConfig(**inp["tcfg"])
    state = tstate.create_train_state(modules, cfg, device="cpu",
                                      dtype=torch.float32)
    mesh = make_mesh((2, 1))
    d = inp["draws"]
    draws = StepDraws(
        vae_noise=torch.tensor(d["vae_noise"].transpose(0, 3, 1, 2)),
        noise=torch.tensor(d["noise"].transpose(0, 1, 4, 2, 3)),
        timesteps=torch.tensor(d["timesteps"], dtype=torch.long),
        drop_mask=torch.tensor(d["drop_mask"]))
    m = train_step(modules, state, shard_batch(inp["batch"], mesh), cfg,
                   draws=draws.rows(mesh.index("dp"), 2), mesh=mesh)
    torch.save({"masters": state.masters, "mu": first_moments(state)},
               os.path.join(out, f"jaxstep_{mesh.index('dp')}.pt"))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "step": state.step}


JOBS = {"jaxstep": _job_jaxstep}


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """JAX's train step at the global batch of 2 (on one device: XLA's dp
    over a mesh computes this batch's step) of the sampling tests' small
    ``tiny_debug`` (112x200 images) on ``test_torch_port_train_step``'s
    seeded weights, with the clip off so Adam's first moment is the
    gradient's tenth, and a dp=2 job of the port's ``train_step`` fed
    JAX's draws, each rank its row; -> (JAX's step, the ranks' results,
    their directory)."""
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
    from test_torch_port_train_step import KERNEL_GAIN, LR, _jax_loss_fn

    from magicdrive_tpu_torch.convert import jax_params_to_state_dicts
    from magicdrive_tpu_torch.train import state as tstate

    preset = sampling_preset(jconfig, "add")
    modules = preset.modules(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: jconfig.init_params(preset, modules, k),
        jax.random.PRNGKey(0))
    params = scaled_kernels(randomized(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes),
        np.random.RandomState(0)), KERNEL_GAIN)
    tcfg = TrainConfig(learning_rate=LR, lr_warmup_steps=0,
                       drop_cond_ratio=1.0, drop_cam_num=3,
                       max_grad_norm=1e9)
    batch = collate_fn(make_dataset(2, image_hw=preset.image_size),
                       CollateConfig(bbox_max_len=preset.bbox_max_len,
                                     canvas_hw=preset.image_size),
                       rng=np.random.default_rng(0))
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
                                    tcfg.drop_cam_num)}
    out = str(tmp_path_factory.mktemp("jaxdp"))
    torch.save({"state_dicts": jax_params_to_state_dicts(params),
                "batch": batch,
                "draws": {k: np.asarray(v) for k, v in draws.items()},
                "tcfg": {f.name: getattr(tcfg, f.name)
                         for f in dataclasses.fields(tstate.TrainConfig)}},
               os.path.join(out, "inputs.pt"))
    ranks = Background(lambda: run_job("jaxstep", out,
                                       os.path.abspath(__file__)))
    try:
        state = create_train_state(params, tcfg)
        loss_fn = _jax_loss_fn(make_train_step(modules, tcfg))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            state.trainable, state.frozen,
            {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        updated = state.apply_gradients(grads).trainable
        np_ = lambda t: {k: np.asarray(v) for k, v in t.items()}
        want = dict(params=params, loss=float(loss), grads=np_(grads),
                    updated=np_(updated), norm=float(np.sqrt(sum(
                        np.square(np.asarray(g, np.float64)).sum()
                        for g in grads.values()))))
        jax.clear_caches()
    finally:
        res = ranks.join()
    return want, res, out


def test_dp2_step_matches_jax(jax_dp):
    """The dp=2 step against JAX's step at the global batch, with
    ``test_torch_port_train_step``'s checks: the loss (the dp mean) and the
    gradient norm at rtol 2e-3, the mean gradient (Adam's first moment
    over 1 - b1) of every tensor at its atol/rtol, and every weight's move
    where the gradient's sign is settled; the ranks' weights bitwise
    equal."""
    from test_torch_port_train_step import (RTOL, _check_grads,
                                            _check_update)

    want, ranks, out = jax_dp
    s0, s1 = (torch.load(os.path.join(out, f"jaxstep_{r}.pt"),
                         weights_only=True) for r in range(2))
    for k, t in s0["masters"].items():
        assert torch.equal(t, s1["masters"][k]), k
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_allclose(r["grad_norm"], want["norm"], rtol=RTOL)
    _check_grads(want, {"grads": {k: (m / 0.1).numpy()
                                  for k, m in s0["mu"].items()}})
    _check_update(want, {"step": ranks[0]["step"], "updated": {
        k: t.numpy() for k, t in s0["masters"].items()}})


if __name__ == "__main__":  # a rank of run_job's job
    rank_main(*sys.argv[1:], jobs=JOBS)
