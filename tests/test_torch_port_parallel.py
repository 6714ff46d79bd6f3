"""The port's parallelism (``magicdrive_tpu_torch/parallel``) against the
JAX package's ``parallel/`` and against one process.

Jobs of two ranks run on the CPU under gloo, each rank a process of this
file run as a script (``rank_main``) and started by ``torchrun``
(``python -m torch.distributed.run --standalone``) with a time limit,
fp32, ``tiny_debug``:
  * the process utilities: ``all_gather_objects`` with payloads of
    different sizes, ``barrier``, the mesh's groups (the counterpart of
    ``tests/test_multihost.py``), and the one-process fast paths here;
  * ``make_mesh``'s layouts and ``shard_batch``'s blocks against JAX's
    ``shard_batch`` on a 2-device virtual CPU mesh (a subprocess with
    ``--xla_force_host_platform_device_count=2``), and the JAX rule's
    hazard (parallel/mesh.py:67: any axis 1 of size n_cam taken for the
    camera axis);
  * training at dp=2 through ``cli.train`` (``parallel.mesh_shape=[2,1]``,
    ``parallel.multihost=true``; 112x200 images, a 14x25 latent through
    the Plus map embedder), B=1 a rank, 2 steps, against one process
    at the global batch of 2 (the same draws): the logged losses and the
    trainable weights at atol 2e-4 / rtol 2e-3, the logged gradient norms,
    the update and Adam's first moment at limits set from their readings,
    and the two ranks' weights bitwise equal, with fp32 AdamW, 8-bit AdamW
    and gradient accumulation 2 (``test_torch_port_parallel_step.py``
    holds one such step to JAX's);
  * a 2-step tiny pipeline at B=2 on a (dp=1, view=2) and a (dp=2, view=1)
    mesh against the unsharded port at atol 2e-4 / rtol 2e-3 (the JAX
    package's tolerance in ``test_sampling_view_sharded_matches_unsharded``)
    and against JAX's unsharded pipeline at 2e-3, for the cross-view forms
    "add", "concat" and "self". The sampling model is ``tiny_debug`` at a
    14x25 latent (112x200 images, the Plus map embedder), where level 0
    (L = 350) takes the kernel routes, on seeded weights made alike in
    every process.
The ranks' work runs while this process computes the references.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
RANK_TIMEOUT = 600

FORMS = ("add", "concat", "self")
MESHES = ((1, 2), (2, 1))
LATENT = (14, 25)
SAMPLE_B = 2
OPTIONS = {"adamw": (), "8bit": ("+runner.use_8bit_adam=true",),
           "accum2": ("runner.gradient_accumulation_steps=2",),
           # the collate's box draws (ROADMAP C4): each rank's boxes are
           # the global batch's
           "boxaug": ("runner.bbox_add_ratio=0.5",
                      "runner.bbox_drop_ratio=0.5")}
# dp=2 against one process (fp32 on the CPU): the relative L2 of the
# update (weights minus those as built) and of Adam's first moment, and
# the logged gradient norms' relative error. Read: updates 9.4e-4 (fp32
# AdamW), 1.05e-3 (8-bit), 8.8e-3 (accumulation 2: its one update is
# Adam's first, about lr * sign(g), where a small g's rounding flips the
# sign); moments 2.7e-5, 5.2e-4, 5.7e-5; norms at most 3.4e-5.
UPDATE_TOL, MOMENT_TOL, NORM_RTOL = 2e-2, 2e-3, 1e-4
TRAIN = ("model=tiny_debug", "runner=debug", "runner.mixed_precision=no",
         "dataset.dataset_root=/nonexistent", "runner.max_train_steps=2",
         "runner.checkpointing_steps=100", "runner.validation_steps=100",
         "runner.validation_before_run=false", "runner.num_workers=1",
         "runner.lr_warmup_steps=0", "dataset.image_size=[112,200]",
         "model.controlnet.use_map_embedder_plus=true",
         "model.controlnet.map_embedder_plus_size=[14,25]")


# -- what both the ranks and this process build --------------------------


def randomize(modules, seed: int, gain: float = 0.5) -> None:
    """Seeded normals for every floating parameter and buffer, alike in
    every process: gain / sqrt(fan_in) for weights of rank >= 2, 1 + 0.1 N
    for norm weights, 0.1 N otherwise."""
    gen = torch.Generator().manual_seed(seed)
    norms = (torch.nn.GroupNorm, torch.nn.LayerNorm)
    with torch.no_grad():
        for _, mod in modules.items():
            for sub in mod.modules():
                for name, p in list(sub.named_parameters(recurse=False)) + \
                        list(sub.named_buffers(recurse=False)):
                    if not p.is_floating_point():
                        continue
                    z = torch.randn(p.shape, generator=gen)
                    if isinstance(sub, norms):
                        z = 1.0 + 0.1 * z if name == "weight" else 0.1 * z
                    elif p.dim() >= 2:
                        z = z * (gain * p[0].numel() ** -0.5)
                    else:
                        z = 0.1 * z
                    p.copy_(z)


def sampling_preset(config, form: str):
    """``config.tiny_debug()`` (the JAX package's or the port's) with the
    cross-view ``form`` at the LATENT size, 2 sampler steps."""
    p = config.tiny_debug()
    unet = dataclasses.replace(p.unet, neighboring_attn_type=form)
    cn = dataclasses.replace(
        p.controlnet, use_map_embedder_plus=True,
        map_embedder_plus_size=LATENT,
        unet=dataclasses.replace(unet, neighboring_view_pair=None))
    return dataclasses.replace(
        p, unet=unet, controlnet=cn,
        image_size=(8 * LATENT[0], 8 * LATENT[1]),
        pipeline=dataclasses.replace(
            p.pipeline, latent_height=LATENT[0], latent_width=LATENT[1],
            num_inference_steps=2))


def sampling_modules(form: str):
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    preset = sampling_preset(config, form)
    mods = MagicDriveModules.create(preset, device="cpu")
    randomize(mods, seed=5)
    return preset, mods.to("cpu", torch.float32)


def sampling_batch(preset):
    """A B=SAMPLE_B request with a latent per view (a cross-view fault
    would show), as numpy."""
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)

    batch = collate_fn(make_dataset(SAMPLE_B, image_hw=preset.image_size),
                       CollateConfig(bbox_max_len=preset.bbox_max_len,
                                     canvas_hw=preset.image_size,
                                     is_train=False))
    batch.pop("pixel_values", None)
    rs = np.random.RandomState(11)
    lat = rs.randn(SAMPLE_B, 6, *LATENT, 4).astype(np.float32)
    return batch, lat


# the trainable weights as built, before any step (alike in every process)
INIT = {}


def randomized_cli(seed: int = 3):
    """``cli.train.build_modules`` with ``randomize``'s weights; the first
    build's trainable weights go to INIT."""
    from magicdrive_tpu_torch.cli import train as train_cli
    from magicdrive_tpu_torch.train.state import trainable_parameters

    real = train_cli.build_modules

    def build(preset, device):
        mods = real(preset, device)
        randomize(mods, seed)
        INIT.setdefault("masters", {
            k: p.detach().float().clone()
            for k, p in trainable_parameters(mods).items()})
        return mods
    train_cli.build_modules = build


def first_moments(state) -> dict:
    """Adam's first moment of every trainable tensor in fp32 (the 8-bit
    optimizer's dequantized): (1 - b1) times the first update's gradient
    and so on, so unlike the update it keeps the gradient's scale."""
    from magicdrive_tpu_torch.train.adam8bit import AdamW8bit, dequantize

    opt = getattr(state.opt, "inner", state.opt)  # MultiSteps' AdamW
    if isinstance(opt, AdamW8bit):
        return {k: dequantize(*opt.mu[k], t.shape)
                for k, t in state.masters.items()}
    return dict(opt.mu)


def rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want|| over every tensor of the dicts."""
    num = sum(float((got[k].double() - w.double()).square().sum())
              for k, w in want.items())
    den = sum(float(w.double().square().sum()) for w in want.values())
    return (num / den) ** 0.5


def train_args(option: str, root: str, *more):
    return [*TRAIN, *OPTIONS[option], f"log_root_prefix={root}/{option}",
            *more]


def logged(run_dir: str, key: str = "loss") -> dict:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return {r["step"]: r[key] for r in map(json.loads, f)}


# -- the ranks ----------------------------------------------------------


def _job_basic(out: str) -> dict:
    import torch.distributed as dist

    from magicdrive_tpu_torch.parallel import mesh as pmesh
    from magicdrive_tpu_torch.parallel import multihost

    r = multihost.process_index()
    got = multihost.all_gather_objects({"rank": r, "pad": "x" * (7 + 5000 *
                                                                 r)})
    multihost.barrier("objects")
    sums = {}
    for shape in MESHES:
        m = pmesh.make_mesh(shape)
        for axis in ("dp", "view"):
            t = torch.tensor([float(r + 1)])
            dist.all_reduce(t, group=m.group(axis))
            sums[f"{shape} {axis}"] = [list(m.coords), float(t)]
    return {"objects": got, "sums": sums,
            "count": multihost.process_count(),
            "backend": multihost.backend()}


def _job_train(out: str) -> dict:
    from magicdrive_tpu_torch.cli import train as train_cli

    randomized_cli()
    res = {}
    for option in OPTIONS:
        run = train_cli.main(train_args(
            option, out, "parallel.mesh_shape=[2,1]",
            "parallel.multihost=true"), device="cpu")
        r = run.runner.mesh.index("dp")
        torch.save({"masters": run.state.masters,
                    "mu": first_moments(run.state)},
                   os.path.join(out, f"{option}_{r}.pt"))
        res[option] = {"run_dir": run.run_dir, "step": run.state.step,
                       "loader": len(run.runner.loader),
                       "rows": len(next(iter(run.runner.loader))[
                           "input_ids"])}
    return res


def _job_sample(out: str) -> dict:
    from magicdrive_tpu_torch.parallel import (COLLECTIVES, make_mesh,
                                               shard_batch)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    res = {}
    for form in FORMS:
        preset, mods = sampling_modules(form)
        batch, lat = sampling_batch(preset)
        for shape in MESHES:
            mesh = make_mesh(shape)
            local = shard_batch(dict(batch, latents=lat), mesh,
                                n_cam=preset.pipeline.n_cam)
            pipe = MagicDrivePipeline(mods, preset.pipeline, mesh=mesh)
            before = COLLECTIVES["all_gather"]
            img = pipe(local, latents=torch.from_numpy(local["latents"]))
            torch.save(img, os.path.join(
                out, f"{form}_{shape[0]}x{shape[1]}_{list(mesh.coords)}.pt"))
            res[f"{form} {shape}"] = COLLECTIVES["all_gather"] - before
        res[f"{form} blocks"] = sum(
            getattr(b, "cross_view", False) for b in mods.unet.modules())
    return res


JOBS = {"basic": _job_basic, "train": _job_train, "sample": _job_sample}


def rank_main(job: str, out: str, jobs=None) -> None:
    """One rank of ``job`` (of ``jobs``, by default this file's JOBS):
    joins the gloo group from the environment, runs the job, writes its
    result as JSON."""
    from magicdrive_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    assert multihost.initialize_if_needed(device="cpu")
    res = (jobs or JOBS)[job](out)
    with open(os.path.join(out, f"{job}_rank{multihost.process_index()}"
                                ".json"), "w") as f:
        json.dump(res, f)
    multihost.barrier()


def torchrun(script: str, args, log_dir: str, nproc: int = 2,
             timeout: float = RANK_TIMEOUT) -> list:
    """``python -m torch.distributed.run --standalone`` of ``script args``
    as ``nproc`` ranks, each rank's output under ``log_dir``; -> each
    rank's stdout. A rank that fails fails the job, and so this call, with
    every rank's stderr; at ``timeout`` the launcher is told to stop its
    ranks (SIGTERM, as at a user's Ctrl-C), then killed."""
    import glob
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "--redirects", "3", "--log-dir",
           log_dir, script, *args]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        text, late = proc.communicate(timeout=timeout)[0], False
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)
        try:
            text = proc.communicate(timeout=60)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            text = proc.communicate()[0]
        late = True

    def rank_log(r, name):
        paths = glob.glob(os.path.join(log_dir, "*", "attempt_*", str(r),
                                       name))
        if not paths:
            return ""
        with open(paths[0]) as f:
            return f.read()
    if late or proc.returncode:
        raise AssertionError(
            (f"stopped at {timeout} s; " if late else "") +
            f"exit {proc.returncode}: {text[-2000:]}" +
            "".join(f"\n-- rank {r}: {rank_log(r, 'stderr.log')[-3000:]}"
                    for r in range(nproc)))
    return [rank_log(r, "stdout.log") for r in range(nproc)]


def run_job(job: str, out: str, script: str = os.path.abspath(__file__)):
    """``job`` as 2 ranks of ``script`` (this file) run as a script; ->
    each rank's JSON result."""
    torchrun(script, [job, out], os.path.join(out, "logs"))
    out_of = []
    for r in range(2):
        with open(os.path.join(out, f"{job}_rank{r}.json")) as f:
            out_of.append(json.load(f))
    return out_of


class Background:
    """``fn()`` in a thread (a job of ranks), while this process computes
    the references; ``join`` returns its result or raises its error."""

    def __init__(self, fn):
        self.res, self.err = None, None
        self.t = threading.Thread(target=self._run, args=(fn,))
        self.t.start()

    def _run(self, fn):
        try:
            self.res = fn()
        except BaseException as e:  # re-raised in the test's thread
            self.err = e

    def join(self):
        self.t.join()
        if self.err is not None:
            raise self.err
        return self.res


# -- process utilities and the mesh ---------------------------------------


def test_single_process_fast_paths():
    """Alone: no process group, [obj] back, barrier a no-op, rank 0 of 1,
    and the one-rank mesh without groups."""
    from magicdrive_tpu_torch.parallel import mesh as pmesh
    from magicdrive_tpu_torch.parallel import multihost

    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR", "MASTER_PORT")
           if k in os.environ}
    try:
        assert not multihost.initialize_if_needed(device="cpu")
        obj = {"a": np.arange(3)}
        got = multihost.all_gather_objects(obj)
        assert len(got) == 1 and got[0] is obj
        multihost.barrier("alone")
        assert (multihost.process_index(), multihost.process_count()) == \
            (0, 1)
        assert multihost.rank_device("cpu") == torch.device("cpu")
        m = pmesh.make_mesh()
        assert (m.shape, m.coords, dict(m.groups)) == ((1, 1), (0, 0), {})
    finally:
        os.environ.update(env)


@pytest.fixture(scope="module")
def basic(tmp_path_factory):
    return run_job("basic", str(tmp_path_factory.mktemp("basic")))


def test_all_gather_objects_and_barrier(basic):
    """Payloads of different sizes come back whole, in rank order, on
    both ranks (JAX's pads to the longest)."""
    want = [{"rank": r, "pad": "x" * (7 + 5000 * r)} for r in range(2)]
    for res in basic:
        assert res["objects"] == want
        assert (res["count"], res["backend"]) == (2, "gloo")


def test_mesh_groups(basic):
    """Rank-major coordinates, and each axis's group holds exactly the
    ranks that differ along it: a sum over the group of rank + 1."""
    for r, res in enumerate(basic):
        s = res["sums"]
        assert s["(1, 2) dp"] == [[0, r], r + 1.0]
        assert s["(1, 2) view"] == [[0, r], 3.0]
        assert s["(2, 1) dp"] == [[r, 0], 3.0]
        assert s["(2, 1) view"] == [[r, 0], r + 1.0]


@pytest.mark.parametrize("shape,rank,coords", [
    ((4, 2), 5, (2, 1)), ((2, 4), 5, (1, 1)), ((8, 1), 5, (5, 0)),
    ((1, 8), 5, (0, 5))])
def test_mesh_layout_is_rank_major(shape, rank, coords):
    """JAX's ``reshape(shape)`` of the device list, rank for device."""
    from magicdrive_tpu_torch.parallel.mesh import coords_of

    assert coords_of(rank, shape) == coords
    assert np.arange(8).reshape(shape)[coords] == rank


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_mesh_larger_than_the_job_raises(shape):
    from magicdrive_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="needs 2 ranks, the job has 1"):
        make_mesh(shape)


def test_view_mesh_is_per_thread():
    """``sharded_views`` sets the cross-view attention's mesh for the
    calling thread alone: an unsharded forward in another thread meanwhile
    sees none; a view axis of 1 gathers nothing."""
    from magicdrive_tpu_torch.parallel.mesh import (Mesh, sharded_views,
                                                    view_mesh)

    mesh, seen = Mesh((1, 2), coords=(0, 1)), {}
    with sharded_views(mesh):
        t = threading.Thread(target=lambda: seen.update(other=view_mesh()))
        t.start()
        t.join()
        seen["own"] = view_mesh()
    assert seen == {"other": None, "own": mesh} and view_mesh() is None
    with sharded_views(Mesh((2, 1))):
        assert view_mesh() is None


def test_sdpa_backends_of_the_card():
    """The port's plain attention on the card chooses among flash,
    memory-efficient and math SDPA (cuDNN's did not repeat across
    processes, so rank 0's images differed from one process's): the list
    is one ``sdpa_kernel`` takes, and under it SDPA gives what it gives
    unrestricted here."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from magicdrive_tpu_torch.core.attention import CUDA_SDPA_BACKENDS

    assert SDPBackend.CUDNN_ATTENTION not in CUDA_SDPA_BACKENDS
    q, k, v = torch.randn(3, 2, 4, 91, 16).unbind(0)
    with sdpa_kernel(CUDA_SDPA_BACKENDS):
        got = F.scaled_dot_product_attention(q, k, v)
    assert torch.equal(got, F.scaled_dot_product_attention(q, k, v))


def _host_batch(L: int = 8, n_cam: int = 6, view_shared: bool = False):
    rs = np.random.RandomState(0)
    nb = 1 if view_shared else n_cam
    return {"camera_param": rs.randn(4, n_cam, 3, 7).astype(np.float32),
            "bev_map": rs.randn(4, 10, 12, 8).astype(np.float32),
            "bboxes": rs.randn(4, nb, L, 8, 3).astype(np.float32),
            "classes": rs.randint(0, 9, (4, nb, L)).astype(np.int32),
            "masks": rs.rand(4, nb, L).astype(np.float32),
            "input_ids": rs.randint(0, 99, (4, 77)).astype(np.int32),
            "uncond_ids": rs.randint(0, 99, (1, 77)).astype(np.int32),
            "latents": rs.randn(4, n_cam, 3, 5, 4).astype(np.float32)}


_JAX_SHARDS = """
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from magicdrive_tpu.parallel.mesh import make_mesh, shard_batch
host = dict(np.load(sys.argv[1]))
out = {}
for shape in ((2, 1), (1, 2)):
    mesh = make_mesh(shape)
    got = shard_batch(host, mesh, n_cam=int(sys.argv[3]))
    for k, v in got.items():
        for s in v.addressable_shards:
            r = mesh.devices.reshape(-1).tolist().index(s.device)
            out[f"{shape[0]}x{shape[1]} {k} {r}"] = np.asarray(s.data)
np.savez(sys.argv[2], **out)
"""


def _jax_shards(tmp_path, host, n_cam=6):
    np.savez(tmp_path / "host.npz", **host)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_JAX_SHARDS),
         str(tmp_path / "host.npz"), str(tmp_path / "jax.npz"), str(n_cam)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(tmp_path / "jax.npz"))


def _port_shards(host, n_cam=6):
    from magicdrive_tpu_torch.parallel.mesh import Mesh, coords_of, shard_batch

    out = {}
    for shape in ((2, 1), (1, 2)):
        for r in range(2):
            m = Mesh(shape, coords=coords_of(r, shape))
            for k, v in shard_batch(host, m, n_cam=n_cam).items():
                out[f"{shape[0]}x{shape[1]} {k} {r}"] = v
    return out


def test_shard_batch_matches_jax(tmp_path):
    """Every rank's block of every key, dp and view, against the shard JAX
    places on the device of the same index."""
    host = _host_batch()
    want = _jax_shards(tmp_path, host)
    got = _port_shards(host)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    assert got["1x2 camera_param 1"].shape == (4, 3, 3, 7)
    assert got["2x1 uncond_ids 1"].shape == (1, 77)


def test_shard_batch_names_its_camera_keys(tmp_path):
    """JAX's hazard (parallel/mesh.py:67): with view-shared boxes given
    without their view axis, (B, L, ...), and bbox_max_len = n_cam, JAX
    takes the box axis for the camera axis and cuts the boxes; the port
    shards its named camera keys alone and keeps them whole. A map whose
    height is n_cam fares the same in JAX."""
    host = _host_batch(L=6, view_shared=True)
    for k in ("bboxes", "classes", "masks"):
        host[k] = host[k][:, 0]  # (B, L, ...)
    host["bev_map"] = host["bev_map"][:, :6]  # height n_cam
    want = _jax_shards(tmp_path, host)
    got = _port_shards(host)
    for k in ("bboxes", "classes", "masks", "bev_map"):
        assert want[f"1x2 {k} 0"].shape[1] == 3  # cut by JAX's rule
        assert np.array_equal(got[f"1x2 {k} 1"], host[k])
    assert got["1x2 camera_param 1"].shape[1] == 3


def test_shard_batch_rejects_uneven_blocks():
    from magicdrive_tpu_torch.parallel.mesh import Mesh, shard_batch

    with pytest.raises(ValueError, match="2 ranks do not divide 3"):
        shard_batch({"input_ids": np.zeros((3, 77))}, Mesh((2, 1)))
    with pytest.raises(ValueError, match="4 ranks do not divide 6"):
        shard_batch({"camera_param": np.zeros((1, 6, 3, 7))},
                    Mesh((1, 4)), n_cam=6)
    with pytest.raises(ValueError, match="neither"):
        shard_batch({"bboxes": np.zeros((1, 3, 8, 8, 3))}, Mesh((1, 2)),
                    n_cam=6)


# -- data-parallel training -----------------------------------------------


def test_dp_loader_draws_the_global_batch_boxes():
    """ROADMAP C4: at ``bbox_add_ratio`` and ``bbox_drop_ratio`` 0.5 each
    dp rank's loader gives its rows of the batch one process collates at
    the global batch, boxes, classes and masks included (the rank draws
    the global batch's boxes from the global batch's generator and keeps
    its rows), in a shuffled order over two epochs and a short tail; the
    draws act (the masks differ from those drawn with the ratios at 0)."""
    from magicdrive_tpu_torch.data import CollateConfig, make_dataset
    from magicdrive_tpu_torch.data.loader import DataLoader

    ds = make_dataset(7)
    cfg = CollateConfig(bbox_max_len=24, bbox_drop_ratio=0.5,
                        bbox_add_ratio=0.5, bbox_add_num=3)

    def batches(c, b, shard=(0, 1)):
        loader = DataLoader(ds, b, c, shuffle=True, seed=3, num_workers=2,
                            shard=shard)
        return [x for _ in range(2) for x in loader]
    one = batches(cfg, 4)
    ranks = [batches(cfg, 2, (i, 2)) for i in range(2)]
    assert [len(r) for r in ranks] == [len(one), len(one)] == [4, 4]
    for b, batch in enumerate(one):
        for i, r in enumerate(ranks):
            assert r[b].keys() == batch.keys()
            for k, v in batch.items():
                want = v if k == "uncond_ids" else v[2 * i:2 * i + 2]
                assert np.array_equal(r[b][k], want), (b, i, k)
    plain = batches(dataclasses.replace(cfg, bbox_drop_ratio=0.0,
                                        bbox_add_ratio=0.0), 4)
    assert any(not np.array_equal(p["masks"], x["masks"])
               for p, x in zip(plain, one))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(the ranks' results, one process's runs at the global batch, the
    ranks' output directory)."""
    from magicdrive_tpu_torch.cli import train as train_cli

    out = str(tmp_path_factory.mktemp("dp"))
    ranks = Background(lambda: run_job("train", out))
    real = train_cli.build_modules
    try:
        randomized_cli()
        torch.set_num_threads(1)
        ref = {o: train_cli.main(train_args(
            o, str(tmp_path_factory.mktemp("one")),
            "runner.train_batch_size=2"), device="cpu") for o in OPTIONS}
    finally:
        train_cli.build_modules = real
        res = ranks.join()
    return res, ref, out


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_dp2_training_matches_one_process(trained, option):
    """dp=2 at B=1 a rank against one process at B=2: the logged (dp
    mean) losses and the trainable weights at atol 2e-4 / rtol 2e-3, the
    ranks' weights bitwise equal; each rank loaded one row a step. The
    update itself (weights minus those as built, far below that atol at lr
    8e-5), Adam's first moment and the logged gradient norms, which keep
    the gradient's scale where AdamW's update does not, within the limits
    above, which a rank stepping on one row's gradient or a summed
    gradient exceed many times over."""
    ranks, ref, out = trained
    one = ref[option]
    res = [r[option] for r in ranks]
    assert res[0]["run_dir"] == res[1]["run_dir"]
    assert [r["step"] for r in res] == [2, 2] and one.state.step == 2
    assert [r["rows"] for r in res] == [1, 1]
    assert res[0]["loader"] == len(one.runner.loader)
    got_loss, want_loss = logged(res[0]["run_dir"]), logged(one.run_dir)
    assert list(got_loss) == list(want_loss) == [1, 2]
    np.testing.assert_allclose(list(got_loss.values()),
                               list(want_loss.values()), atol=2e-4,
                               rtol=2e-3)
    np.testing.assert_allclose(
        list(logged(res[0]["run_dir"], "grad_norm").values()),
        list(logged(one.run_dir, "grad_norm").values()), rtol=NORM_RTOL)
    s0, s1 = (torch.load(os.path.join(out, f"{option}_{r}.pt"),
                         weights_only=True) for r in range(2))
    m0, init = s0["masters"], INIT["masters"]
    moved = 0
    for k, t in one.state.masters.items():
        assert torch.equal(m0[k], s1["masters"][k]), k
        np.testing.assert_allclose(m0[k].numpy(), t.numpy(), atol=2e-4,
                                   rtol=2e-3, err_msg=k)
        moved += not torch.equal(m0[k], t)
    assert moved > 0.25 * len(m0)  # both sides trained
    delta = {k: m0[k] - init[k] for k in init}
    want = {k: t - init[k] for k, t in one.state.masters.items()}
    assert rel_l2(delta, want) <= UPDATE_TOL
    assert rel_l2(s0["mu"], first_moments(one.state)) <= MOMENT_TOL
    files = set(os.listdir(res[0]["run_dir"])) - {"tb"}
    assert files == {"checkpoints", "metrics.jsonl", "overrides.yaml",
                     "run_config.yaml", "train.log", "train_rank1.log",
                     "weights"}


# -- sharded sampling -----------------------------------------------------


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    """(the ranks' results and directory, per form the unsharded port's
    images, JAX's images)."""
    import jax
    import jax.numpy as jnp

    from magicdrive_tpu.config import presets as jconfig
    from magicdrive_tpu.pipeline.pipeline import MagicDrivePipeline as JPipe

    from magicdrive_tpu_torch.convert import modules_to_jax_params
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    out = str(tmp_path_factory.mktemp("sample"))
    ranks = Background(lambda: run_job("sample", out))
    torch.set_num_threads(1)
    port, jax_imgs = {}, {}
    try:
        for form in FORMS:
            preset, mods = sampling_modules(form)
            batch, lat = sampling_batch(preset)
            port[form] = MagicDrivePipeline(mods, preset.pipeline)(
                batch, latents=torch.from_numpy(lat)).numpy()
            jp = sampling_preset(jconfig, form)
            jpipe = JPipe(jp.modules(dtype=jnp.float32),
                          modules_to_jax_params(mods), jp.pipeline)
            jax_imgs[form] = np.asarray(jpipe(
                {k: jnp.asarray(v) for k, v in batch.items()},
                latents=jnp.asarray(lat)))
            jax.clear_caches()
    finally:
        res = ranks.join()
    return res, out, port, jax_imgs


def _assembled(out, form, shape):
    """The two ranks' blocks put back in sample and camera order."""
    blocks = {r: torch.load(os.path.join(
        out, f"{form}_{shape[0]}x{shape[1]}_{list(c)}.pt"),
        weights_only=True).numpy()
        for r, c in enumerate(((0, 0), (0, 1)) if shape == (1, 2)
                              else ((0, 0), (1, 0)))}
    return np.concatenate([blocks[0], blocks[1]],
                          axis=1 if shape == (1, 2) else 0)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("form", FORMS)
def test_sharded_sampling_matches_unsharded(sampled, form, shape):
    """The ranks' blocks put together are the unsharded port's images;
    the view-sharded run gathered once a cross-view attention and step."""
    ranks, out, port, _ = sampled
    got = _assembled(out, form, shape)
    assert got.shape == port[form].shape == (SAMPLE_B, 6, 112, 200, 3)
    np.testing.assert_allclose(got, port[form], atol=2e-4, rtol=2e-3)
    gathers = [r[f"{form} {shape}"] for r in ranks]
    # one gather a UNet block with attn4 and sampler step; none at view 1
    want = ranks[0][f"{form} blocks"] * 2 if shape == (1, 2) else 0
    assert ranks[0][f"{form} blocks"] > 0 and gathers == [want, want]


@pytest.mark.parametrize("form", FORMS)
def test_unsharded_port_matches_jax(sampled, form):
    """The unsharded reference above is JAX's pipeline at 2e-3, so the
    sharded runs are too."""
    _, out, port, jax_imgs = sampled
    assert jax_imgs[form].std() > 0.05
    np.testing.assert_allclose(port[form], jax_imgs[form], atol=2e-3)
    for shape in MESHES:
        np.testing.assert_allclose(_assembled(out, form, shape),
                                   jax_imgs[form], atol=2e-3)


if __name__ == "__main__":  # a rank of run_job's job
    rank_main(*sys.argv[1:])
