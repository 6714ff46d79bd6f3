"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each raising on failure: the script then prints one line,
``chip_smoke FAILED in <phase>: <type>: <message>``, exits non-zero and
prints no result line. Each phase logs its wall seconds as it ends
(``phase <name> s``).
  1. environment: a CUDA device, the torch/CUDA versions, the card's name
     and power limit from nvidia-smi;
  2. build: the hand-written kernels (magicdrive_tpu_torch/kernels/csrc),
     compiled from this checkout, with ptxas's registers and spills; any
     spill in a wgmma kernel (K3, K4, the out-projection: SPILL_GATED)
     fails the run;
  3. kernel checks: K1-K4, K8 and the K8 pair at every shape the 224x400
     generation path gives them in either fused mode (bf16, B=1 with CFG:
     12 views), K1-K4 at the 16-frame video's (192 views, _video_cases),
     K2 and the K8 pair also over the neighbour tables of TABLE_CASES (the
     nuScenes ring in another camera order, two 3-camera triangles) at
     L=1400 and 350, their ring rows printed beside their times under the
     ring shift (log_pair_tables),
     and at the shapes the hi-res paths add (_hires_cases: K1 at
     L=5300 and 3128, one neighbour's call of the 424x800 K1 loop among
     them, K2 at L=3128 and 1350, K3 at M=12*5300 and 12*3128, K4 at
     M=12*1350, K8 at L=782 in attn1 and attn2 and its pair at L=782), and
     K5, both launches of K6, the whole K6 and K7 at the shapes the
     training path gives them (6 views of 8 heads), K5 and K6 also at one
     ragged shape (keys masked past kv_len < Lk) and at the projected
     route's forced shape, against their plain versions in fp32 with TF32
     off, max|kernel - ref| <= 1e-2 * max|ref|, with CUDA-event times of
     the kernel, of the plain version on the same inputs and, where one
     PyTorch call computes the same function (the flash SDPA forward for
     K5, its backward for the whole K6), of that call, beside the kernel's
     bound (the larger of its operations at the bf16 tensor peak and its
     bytes at the memory rate); K1-K4, K7, K8 and the K8 pair also beside
     their composition of library calls (COMPOSED: F.linear projections
     and F.scaled_dot_product_attention, one per neighbour for the pairs,
     F.linear by Wout for K8; F.linear, the exact GELU and F.linear for
     K3/K4: composed_ms), K1 with its kv projection timed alone (the
     kv_project sub-row), K8 and its pair with their last launch, the
     out-projection, checked against its plain version and timed alone
     beside F.linear (the out_project sub-row), and the host cost of one
     TMA tensor-map encoding (K3, K4 and the out-projection encode theirs
     on every call); two calls of K1-K4, K7, K8 and the pair (REDESIGNED),
     of the out-projection and of the whole K6 on the same inputs must be
     bitwise equal; K5 and the whole K6 (FLASH_DEPTHS) and K1, K2, K7, K8
     and the K8 pair (ATTENTION_DEPTHS, the pairs under both ring-shift
     sets, K8 and its pair out-projected to OUT_WIDTH = 72 columns) also
     at one head depth for each of their template instances, and K3 and K4
     at the widths of FF_WIDTHS (one per K3 instance), at small ragged
     shapes, against the plain versions; then the autograd of K1-K4, K8
     and the K8 pair at the training shapes: every input and weight
     gradient through the kernel route against the plain backward in fp32,
     within 1e-2 * max|ref| or the plain bf16 backward's own error, which
     is printed beside it (GRAD_TOL);
  4. the routes no bf16 preset reaches, at forced bf16 shapes: the
     projected route through an Attention (PROJECTED_SHAPE: K5, and K6 in
     the backward) and the per-neighbour K8 loop through a
     BasicTransformerBlock under "auto" (OUT_LOOP_SHAPE), each with its
     launch counts, the per-call check of phase 5 and its output against
     the same module through the plain versions (KERNEL_TOL);
     then generation, once per fused mode ("kvstat", then "auto", which
     routes every kernel attention to K8 and its pair): the full-width
     sd15mv_rawbox_224x400 pipeline (20 UniPC steps, CFG 2.0, bf16, B=1) on
     seeded random weights with every floating parameter non-zero, for 2
     requests; the launch counts of that run equal the counts derived from
     the block structure and the routing rules (expected_launches: the
     loops call their kernel once per neighbour);
  5. path checks, per mode: in one guided UNet+ControlNet step, every kernel
     call is held against its plain version in fp32 on the same inputs (the
     tolerance of phase 3), and the guided eps with kernels agrees with the
     eps through the plain versions to relative L2 <= 2e-2. The eps
     comparison is a smoke test, not a gate: bf16 noise of the whole network
     sits near 1.1e-2, and planted faults in K2 and K4 passed it while the
     per-call check and phase 3 caught both (PERF.md); then one guided step
     under torch.profiler prints its kernels' device time beside its host
     clock time, with the device time of the mode's attention (K1+K2, or
     K8+pair: the heads' kernel and the out-projection, which is also
     printed alone), of their k/v projection, and of K3 and K4 (PROFILED
     names the kernels); then the hi-res presets (HIRES) at full width:
     sd15mv_rawbox_272x736 (2 requests under "kvstat", 1 under "auto") and
     sd15mv_rawbox_424x800 (2 under "kvstat", its level-0 cross-view pair
     the per-neighbour K1 loop), on fixture batches at their image and map
     sizes, each run's launch counts equal to the derived ones, with the
     per-call check and a profiled guided step of each preset and mode;
     before them, on the 224x400 weights under "kvstat", the pipeline's
     options (run_options: a guess-mode request with the per-call check of
     its step, a DDIM request, a request from the port's own CLIP output
     as prompt embeddings bitwise equal to the one from the ids, a B=2
     request from one latent, one guided step with the negative1
     unconditional map and its per-call check), given-view generation
     (run_given_view: view 1 of a request's encoded images given, with
     sub_noise_pred off and on; the given view bitwise its VAE round trip,
     the others generated; the per-call check) and the other cross-view
     forms and box-embedder options (run_cross_view_forms, the variants of
     CROSS_VIEW_VARIANTS: "add" over the permuted ring with the gated
     connector, trainable class tokens and min-max boxes; "add" over the
     triangles; "concat" without a connector; "self": one request per
     fused mode, "add" over the triangles under "kvstat" alone, with its
     launch counts, the per-call check of a guided step per mode, a
     profiled guided step, one training step with its launches, loss,
     the trained set moved and every frozen weight bitwise unchanged, and
     its per-call check); after them the 16-frame
     video, sd15mv_rawbox_video_16f at full width (run_video: B=1, 16
     frames of 6 views, N_REQUESTS requests under "kvstat", the peak
     memory, the per-call check at the UNet batch of 192, a profiled guided
     step with the temporal attention's SDPA time); K1-K4 are also checked
     and timed at the video's shapes in phase 3 (_video_cases), and every
     path's launch counts equal the derived ones; between the 224x400
     paths and the hi-res ones, the evaluation chain as a user runs it
     (run_evaluation, in a temporary directory): the full-width 224x400
     model on seeded weights written as the released SD-v1.5 and
     MagicDrive trees and converted by ``cli.convert_weights`` into a run
     directory (every leaf bitwise the modules'); on that run the
     generation CLI (run_generate_cli: ``cli.generate.main`` under
     "kvstat" on 2 samples of a synthetic nuScenes tree with the default
     runner, 20 UniPC steps, 2 variants, boxes drawn: the PNGs decode to
     their shapes and hold the images, the images are finite and in
     [0, 1], the launch counts equal the derived ones, the per-call check
     of one guided step, and the CLI's batch through a MagicDrivePipeline
     on the script's own modules from the CLI's latents gives the CLI's
     images, KERNEL_TOL); ``cli.val_set_gen`` at B=4 on an 8-sample tree
     (its PNGs, launch counts, the per-call check of a B=4 guided step and
     its first batch against a MagicDrivePipeline); ``cli.fid`` in both
     modes with a random Inception file; and a B=2 training step with a
     learnable unconditional map and the map drop (its launch counts,
     the per-call check, the map's gradient through the kernels within
     EPS_TOL of the plain versions' in bf16 and in fp32, and exactly zero
     without the drop).
     The trees' sizes,
     the write and convert seconds, the npz's load seconds, each CLI
     request's and val-set batch's seconds, 6-view frames/s at B=4, the
     peak memory, FID seconds and Inception images/s are printed with the
     card;
  6. training, per mode: the full-width model in bf16 over fp32 masters
     (the recipe's AdamW, clip 1.0, drop_cond_ratio 0.25), one fixture
     batch with images at B=1 (6 views), N_TRAIN_STEPS steps through the
     port's Runner with a one-step warm-up. Every loss is finite, the
     masters are unchanged after step 1 (lr 0) and nearly all moved after
     the last, every frozen weight is bitwise unchanged, and the launch
     counts equal the derived ones; under "kvstat" one step with an
     all-ones drop mask follows. Warm s/step and peak memory are printed;
  7. training path checks, per mode: in one training step every kernel
     call, forward and backward, is held against its plain version in fp32
     on the inputs the path gave it (the tolerance of phase 3). The
     ControlNet gradient, kernels against plain versions, is printed as a
     smoke test;
  8. profile_train_step, per mode: after one more step to warm up, one
     training step under torch.profiler prints its host-clock time, the
     device-busy share (the kernels' summed device time over it), the 8
     kernels that take the most and the device time of K5, of K6, of the
     attention heads (K7 among them under "auto"), of the out-projection
     and of the k/v projection in the step;
  9. the training entry point as users run it (run_train_cli, under
     "kvstat", in a temporary directory with a synthetic nuScenes tree):
     ``cli.train.main`` at full width on this script's seeded weights with
     the recipe's batch (TRAIN_CLI_ARGS: B=3, 4 steps, a checkpoint every
     2 with 1 kept, validation at step 4 on 2 samples, step 3 profiled),
     gated on its launch counts (the derived ones for its steps and the
     validator's forwards), the kept checkpoint, the two PNGs, K1 in the
     profiler's trace, weights/ read by the generation loader equal to the
     masters (trainable) and the weights as built (frozen), the frozen
     weights as built; then phase 7's per-call check on one step of its
     own batch (B=3) and on one guided step of its Validator, both with
     the plain version at the kernel's bf16 casts as a floor (bf16_floor:
     the nuScenes camera tokens put K1's plain bf16 version near
     KERNEL_TOL from fp32); a second CLI
     run resumed from its checkpoints to step 6, whose state before step 5
     is the checkpoint's bitwise; ``cli.generate`` on the first run,
     bitwise a pipeline on its masters and frozen weights; the TrainConfig
     options at B=3, 2 steps each (8-bit AdamW with its moments' bytes,
     gradient accumulation 2, the cosine schedule) and gradient
     checkpointing ("dots" under both fused modes, K8 and its pair
     recomputed under "auto", and None: loss and trainable gradient
     against the same weights without it, the activation peaks, the
     launches with the recompute; phase 7's check on a "dots" step in
     each mode, the recompute's calls included); 16-frame video training
     (96 images, remat "dots", 2 steps: the temporal weights move, the
     frozen do not; phase 7's check on one more step); and, where h5py
     imports, ``cli.prepare_cache`` and a training step on the cached maps
     (bitwise the rasterized ones). Phase 7's comparisons run outside the
     remat modes (``outside_remat``), so a checked step keeps what it
     keeps unchecked.
     The seconds of the build, each step, checkpoint write, validation and
     export, and the peak memory are printed with the card;
 10. multi-GPU (run_multi_gpu), across processes on the one card, each
     child under a time limit (RANK_TIMEOUT) and any child's failure the
     phase's: ``python -m magicdrive_tpu_torch.cli.train`` as an NCCL job
     of one rank (the backend and the all-reduces from its train.log, its
     losses against the same run without a process group); then two gloo
     ranks (``python chip_smoke.py --rank ...``, loading the library the
     build phase made): dp=2 training in both fused modes against one
     process at B=2 on the same draws (EPS_TOL), the ranks' masters
     bitwise equal after every step, a rank-0 step's kernel calls against
     their plain versions; a (dp=1, view=2) request against the unsharded
     one from the same latents (EPS_TOL), with the launches of
     view-sharded attn4 (K1 a neighbour list over the gathered cameras) and
     a sharded guided step's kernel calls checked; ``cli.val_set_gen
     --multihost`` on the evaluation phase's run and tree: the one-process
     run's PNG names, and rank 0's first sample within KERNEL_TOL of that
     run's (bitwise equality logged).
The line before the last is {"kernels": [...]}, one entry per kernel (K6's
two launches as two entries, K8 and its pair as two) at the shape where its
error was largest, with every shape under "shapes"; "launches" sums the
path runs of phases 4-6, 9 and 10 (the forced routes, the generation
paths, the options, given-view, generation CLI, val-set, map-drop and video
paths, training, the training CLI's runs, its generation, the options,
remat, video training and the cache step, and the gloo ranks' training,
view-sharded request and val_set_gen) and "launches_by_path" gives each. The
whole K6's rows (time, bound, library time) are logged on a line of their
own before it. The last line is {"ok": true, "device": {...}}.

``compare_trees(other)`` (not run by ``main``) times the REDESIGNED kernels
(K1-K4, K7, K8 and the pair; K8's out-projection alone where the tree has
it) and warm requests in both fused modes of another checkout and of this
one in turns, for a kernel change measured against its parent on one card.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_REQUESTS = 2
N_TRAIN_STEPS = 3
KERNEL_TOL = 1e-2   # max|kernel - ref| <= KERNEL_TOL * max|ref|
# Each gradient of K1-K4, K8 and the K8 pair through the kernels is within
# GRAD_TOL * max|ref| of fp32, or no farther from fp32 than the plain bf16
# backward on the same inputs (the kernels then add nothing to what bf16
# costs): measured on an H100, the plain bf16 backward of K8's dx_kv at
# L=1400 is itself 1.012e-2 * max|ref| from fp32, from the bf16 products
# and casts the kernel route shares with it (PERF.md).
GRAD_TOL = 1e-2
# Relative L2 of a whole-network bf16 result through the kernels against the
# plain versions: the guided eps, and the unconditional map's gradient of a
# training step. Measured on an H100, that gradient through the plain bf16
# versions is itself 1.05e-2 from the plain fp32 one: bf16's floor there,
# not the kernels', and a larger gain of the map embedder does not lower it.
EPS_TOL = 2e-2
# Scale of the random weights of rank >= 2 (times 1/sqrt(fan_in)). At full
# width with random weights the bf16 network amplifies rounding: measured
# on an H100, at gain 1.0 a 1e-3 relative perturbation of the latent moves
# the guided eps by 10 % (so any two bf16 evaluations differ by that much,
# kernels or not); at 0.2 by 1.2 %, under EPS_TOL.
WEIGHT_GAIN = 0.2


def log(*args) -> None:
    print(*args, flush=True)


def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    log(smi)
    for name, use in (("scipy", "FID's sqrtm"),
                      ("h5py", "the BEV map cache"),
                      ("tensorboard", "the trainer's tensorboard scalars")):
        try:
            mod = __import__(name)
            log(f"{name} {mod.__version__} ({use})")
        except ImportError:
            log(f"{name}: not importable ({use} needs it)")
    torch.cuda.set_device(0)  # the autograd engine's thread finds it set
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def spills(compiler_log: str, source: str) -> dict:
    """{kernel: (spill store bytes, spill load bytes)} from ptxas's lines for
    every entry function of ``source`` (a file name under csrc/)."""
    import re

    out, section, entry = {}, None, None
    for line in compiler_log.splitlines():
        if line.startswith("== "):
            section = line[3:].strip()
        elif section == source:
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry is not None:
                out[entry] = (int(m.group(1)), int(m.group(2)))
                entry = None
    return out


# the wgmma kernels' sources and their entry functions' count: K3's five
# instances and K4 (geglu.cu), the out-projection of K8 and its pair
SPILL_GATED = {"geglu.cu": 6, "fused_out_attention.cu": 1}


def build_kernels(spill_gate: bool = True) -> None:
    """Build the kernels, print ptxas's registers and spills, and (with
    ``spill_gate``) fail if an entry function of SPILL_GATED's sources
    spills or is missing."""
    from magicdrive_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path, compiler_log = build.build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in compiler_log.splitlines():  # ptxas: registers, spills
        if line.startswith("ptxas info") or "bytes spill" in line or \
                "warning" in line:
            log("  " + line.strip())
    build.load()
    if spill_gate and compiler_log:  # empty when already built
        for source, entries in SPILL_GATED.items():
            got = spills(compiler_log, source)
            log(f"{source} spills (store, load bytes): {got}")
            if len(got) != entries or any(st or ld for st, ld in got.values()):
                raise AssertionError(f"{source}: entry functions spill or are "
                                     f"missing: {got}")


QUEUE_FILL_CYCLES = 20_000_000  # about 11 ms of an H100's clock


def cuda_ms(fn, iters: int = 10) -> float:
    """Device ms per call of ``fn`` by CUDA events around ``iters`` calls.
    The events are queued behind a spin kernel that keeps the card busy
    while the host enqueues the calls, so a call whose host side (Python,
    ctypes, the launch) takes longer than its kernels is timed on the
    device, not at the host's enqueue rate."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(QUEUE_FILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# kernel -> (source, TPU kernel replaced); K6's two launches and K8's single
# and pair forms are separate entries. The whole K6 (both launches) is timed
# beside them but is not a kernel of its own, so it stays out of this table
_FA = "magicdrive_tpu/kernels/flash_attention.py"
_FU = "magicdrive_tpu/kernels/fused_attention.py"
_FA_CU = "magicdrive_tpu_torch/kernels/csrc/flash_attention.cu"
_K1_CU = "magicdrive_tpu_torch/kernels/csrc/kvstat_attention.cu"
_OUT_CU = "magicdrive_tpu_torch/kernels/csrc/fused_out_attention.cu"
KERNELS = {
    "kvstat_attention": (_K1_CU, f"{_FU}:211"),
    "kvstat_attention_pair": (
        "magicdrive_tpu_torch/kernels/csrc/kvstat_pair_attention.cu",
        f"{_FU}:467"),
    "fused_ff": ("magicdrive_tpu_torch/kernels/csrc/geglu.cu",
                 "magicdrive_tpu/kernels/geglu.py:221"),
    "fused_geglu": ("magicdrive_tpu_torch/kernels/csrc/geglu.cu",
                    "magicdrive_tpu/kernels/geglu.py:70"),
    "flash_attention_fwd": (_FA_CU, f"{_FA}:75"),
    "flash_attention_bwd_dq": (_FA_CU, f"{_FA}:222"),
    "flash_attention_bwd_dkv": (_FA_CU, f"{_FA}:252"),
    "fused_qkv_attention": (_K1_CU, f"{_FU}:77"),
    "fused_qkv_out_attention": (_OUT_CU, f"{_FU}:83"),
    "fused_qkv_out_attention_pair": (_OUT_CU, f"{_FU}:104"),
}
# the kernel wrappers the model calls (``dispatch`` attributes), per fused
# mode; K7 and the flash pair run only in backwards
_ATTENTION_CALLS = {
    "kvstat": ("kvstat_attention", "kvstat_attention_pair"),
    "auto": ("fused_qkv_out_attention", "fused_qkv_out_attention_pair")}


def training_calls(mode: str, preset=None):
    """The kernel wrappers a 224x400 training step calls under ``mode``;
    with ``preset``, those ``expected_launches`` derives for one of its
    steps (K6's two launches go through ``flash_attention_bwd``)."""
    if preset is not None:
        n = expected_launches(preset, mode, steps=1)
        return tuple(k for k, v in n.items()
                     if v and not k.startswith("flash_attention_bwd_")) + (
            ("flash_attention_bwd",) if n["flash_attention_bwd_dq"] else ())
    k7 = ("fused_qkv_attention",) if mode == "auto" else ()
    return _ATTENTION_CALLS[mode] + ("fused_ff", "fused_geglu") + k7 + (
        "flash_attention_fwd", "flash_attention_bwd")


# Neighbour tables besides the nuScenes ring (NUSCENES_NEIGHBORS): the ring
# listed in another camera order, as a rig that numbers its cameras another
# way gives it (0-1-4-3-5-2), and two 3-camera triangles, which is not a
# permutation (view 2 is no view's first neighbour, view 0 that of two).
# Phase 3 holds K2 and the K8 pair to their plain versions under each, and
# the cross-view phase runs them through the model.
PERMUTED_RING = ((1, 2), (4, 0), (0, 5), (5, 4), (3, 1), (2, 3))
TRIANGLES = ((1, 2), (0, 2), (0, 1), (4, 5), (3, 5), (3, 4))
TABLE_CASES = {"permuted table": PERMUTED_RING,
               "table not a permutation": TRIANGLES}


def view_table(pairs) -> torch.Tensor:
    """The (2, n) int32 neighbour table of neighbour pairs, on the card, as
    a BasicTransformerBlock holds it (row i: every view's i-th neighbour).
    Made here, not by the block's ``neighbour_table``, so that
    ``compare_trees`` can time a tree that has none."""
    return torch.tensor(pairs, dtype=torch.int32).t().contiguous().cuda()


def ring_table() -> torch.Tensor:
    """The nuScenes ring's table on the card: (v + 5) % 6, (v + 1) % 6."""
    from magicdrive_tpu_torch.config import NUSCENES_NEIGHBORS

    return view_table(NUSCENES_NEIGHBORS)


def _rnd(gen: torch.Generator):
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(torch.bfloat16)
    return rnd


def kernel_cases(gen: torch.Generator):
    """(kernel, shape label, args) at every shape the 224x400 paths give
    each kernel: 12 views (generation) or 6 (K7, which runs only in the
    training backward), 8 heads; text context 1 + 77 + 160 tokens; K2 and
    the K8 pair over the nuScenes ring's table and over TABLE_CASES."""
    rnd = _rnd(gen)
    cases = []
    for L, C in ((1400, 320), (350, 640)):
        x = rnd(12, L, C)
        w = [rnd(C, C, scale=C ** -0.5) for _ in range(3)]
        cases.append(("kvstat_attention", f"attn1 L={L} C={C}",
                      (x, x, *w, 8, (C // 8) ** -0.5)))
        cases.append(("kvstat_attention_pair", f"attn4 L={L} C={C}",
                      (x, *w, 8, (C // 8) ** -0.5, ring_table())))
        for what, pairs in TABLE_CASES.items():
            cases.append(("kvstat_attention_pair", f"attn4 L={L} C={C} {what}",
                          (x, *w, 8, (C // 8) ** -0.5, view_table(pairs))))
    x, ctx = rnd(12, 1400, 320), rnd(12, 238, 768)
    cases.append(("kvstat_attention", "attn2 L=1400 Lk=238 C=320",
                  (x, ctx, rnd(320, 320, scale=320 ** -0.5),
                   rnd(320, 768, scale=768 ** -0.5),
                   rnd(320, 768, scale=768 ** -0.5), 8, 40 ** -0.5)))
    cases.append(("fused_ff", "ff M=12*1400 C=320",
                  (rnd(12 * 1400, 320), rnd(2560, 320, scale=320 ** -0.5),
                   rnd(2560, scale=0.1), rnd(320, 1280, scale=1280 ** -0.5))))
    for L, C in ((350, 640), (91, 1280), (28, 1280)):
        cases.append(("fused_geglu", f"geglu M=12*{L} C={C}",
                      (rnd(12 * L, C), rnd(8 * C, C, scale=C ** -0.5),
                       rnd(8 * C, scale=0.1))))
    return cases + _out_cases(rnd) + _hires_cases(rnd) + _video_cases(rnd)


VIDEO_VIEWS = 2 * 16 * 6  # the 16-frame video's UNet batch: CFG, frames, views


def _video_cases(rnd):
    """K1-K4 at the shapes of the 16-frame video path (VIDEO_VIEWS
    sequences, 8 heads): K1 at attn1 of levels 0 and 1 and attn2 of level
    0, K2 at both levels, K3 at level 0 and K4 at levels 1-3."""
    V, cases = VIDEO_VIEWS, []
    for L, C in ((1400, 320), (350, 640)):
        x = rnd(V, L, C)
        w = [rnd(C, C, scale=C ** -0.5) for _ in range(3)]
        cases.append(("kvstat_attention", f"video attn1 {V}x L={L} C={C}",
                      (x, x, *w, 8, (C // 8) ** -0.5)))
        cases.append(("kvstat_attention_pair",
                      f"video attn4 {V}x L={L} C={C}",
                      (x, *w, 8, (C // 8) ** -0.5, ring_table())))
    x = rnd(V, 1400, 320)
    cases.append(("kvstat_attention", f"video attn2 {V}x L=1400 Lk=238",
                  (x, rnd(V, 238, 768), rnd(320, 320, scale=320 ** -0.5),
                   rnd(320, 768, scale=768 ** -0.5),
                   rnd(320, 768, scale=768 ** -0.5), 8, 40 ** -0.5)))
    cases.append(("fused_ff", f"video ff M={V}*1400 C=320",
                  (x.reshape(-1, 320), rnd(2560, 320, scale=320 ** -0.5),
                   rnd(2560, scale=0.1), rnd(320, 1280, scale=1280 ** -0.5))))
    for L, C in ((350, 640), (91, 1280), (28, 1280)):
        cases.append(("fused_geglu", f"video geglu M={V}*{L} C={C}",
                      (rnd(V * L, C), rnd(8 * C, C, scale=C ** -0.5),
                       rnd(8 * C, scale=0.1))))
    return cases


def _hires_cases(rnd):
    """The shapes the hi-res generation paths add (12 views, 8 heads): K1 at
    the 424x800 level 0 (L=5300: attn1, attn2, and one neighbour's call of
    the attn4 loop, whose x_kv is the neighbours' views) and the 272x736
    attn1 (L=3128), K2 at the 272x736 level 0 and the 424x800 level 1
    (L=1350), K3 at both level 0s, K4 at the 424x800 level 1, and K8 (attn1
    and attn2) and its pair at the 272x736 level 1 (L=782) under "auto"."""
    cases = []
    w = [rnd(320, 320, scale=320 ** -0.5) for _ in range(3)]
    x, x3 = rnd(12, 5300, 320), rnd(12, 3128, 320)
    # the loop's first neighbour of each view: view (v + 5) % 6 of its sample
    x_kv = x.unflatten(0, (-1, 6)).roll(-5, 1).flatten(0, 1)
    cases += [
        ("kvstat_attention", "attn1 L=5300 C=320", (x, x, *w, 8, 40 ** -0.5)),
        ("kvstat_attention", "attn4 one neighbour L=5300 C=320",
         (x, x_kv, *w, 8, 40 ** -0.5)),
        ("kvstat_attention", "attn2 L=5300 Lk=238 C=320",
         (x, rnd(12, 238, 768), w[0], rnd(320, 768, scale=768 ** -0.5),
          rnd(320, 768, scale=768 ** -0.5), 8, 40 ** -0.5)),
        ("kvstat_attention", "attn1 L=3128 C=320",
         (x3, x3, *w, 8, 40 ** -0.5)),
        ("kvstat_attention_pair", "attn4 L=3128 C=320",
         (x3, *w, 8, 40 ** -0.5, ring_table()))]
    x1 = rnd(12, 1350, 640)
    w6 = [rnd(640, 640, scale=640 ** -0.5) for _ in range(3)]
    cases += [("kvstat_attention_pair", "attn4 L=1350 C=640",
               (x1, *w6, 8, 80 ** -0.5, ring_table())),
              ("fused_geglu", "geglu M=12*1350 C=640",
               (x1.reshape(-1, 640), rnd(5120, 640, scale=640 ** -0.5),
                rnd(5120, scale=0.1)))]
    for L in (5300, 3128):
        cases.append(("fused_ff", f"ff M=12*{L} C=320",
                      (rnd(12 * L, 320), rnd(2560, 320, scale=320 ** -0.5),
                       rnd(2560, scale=0.1),
                       rnd(320, 1280, scale=1280 ** -0.5))))
    x7 = rnd(12, 782, 640)
    *w7, wo = _attention_weights(rnd, 640)
    *w2, wo2 = _attention_weights(rnd, 640, 768)
    return cases + [
        ("fused_qkv_out_attention", "attn1 L=782 C=640",
         (x7, x7, *w7, wo, 8, 80 ** -0.5)),
        ("fused_qkv_out_attention", "attn2 L=782 Lk=238 C=640",
         (x7, rnd(12, 238, 768), *w2, wo2, 8, 80 ** -0.5)),
        ("fused_qkv_out_attention_pair", "attn4 L=782 C=640",
         (x7, *w7, wo, 8, 80 ** -0.5, ring_table()))]


def _attention_weights(rnd, C, Ck=None):
    """wq (C, C), wk and wv (C, Ck), wout (C, C): 8 heads of C / 8."""
    Ck = Ck or C
    return (rnd(C, C, scale=C ** -0.5), rnd(C, Ck, scale=Ck ** -0.5),
            rnd(C, Ck, scale=Ck ** -0.5), rnd(C, C, scale=C ** -0.5))


def _out_cases(rnd):
    """K8 and its pair at the generation shapes (12 views; the pair also
    over TABLE_CASES), K7 at the training shapes (6 views)."""
    cases = []
    for L, C in ((1400, 320), (350, 640)):
        x = rnd(12, L, C)
        *w, wo = _attention_weights(rnd, C)
        sc = (C // 8) ** -0.5
        cases += [
            ("fused_qkv_out_attention", f"attn1 L={L} C={C}",
             (x, x, *w, wo, 8, sc)),
            ("fused_qkv_out_attention_pair", f"attn4 L={L} C={C}",
             (x, *w, wo, 8, sc, ring_table())),
            ("fused_qkv_attention", f"6 views attn1 L={L} C={C}",
             (x[:6], x[:6], *w, 8, sc))]
        cases += [("fused_qkv_out_attention_pair", f"attn4 L={L} C={C} {what}",
                   (x, *w, wo, 8, sc, view_table(pairs)))
                  for what, pairs in TABLE_CASES.items()]
    x, ctx = rnd(12, 1400, 320), rnd(12, 238, 768)
    *w, wo = _attention_weights(rnd, 320, 768)
    return cases + [
        ("fused_qkv_out_attention", "attn2 L=1400 Lk=238 C=320",
         (x, ctx, *w, wo, 8, 40 ** -0.5)),
        ("fused_qkv_attention", "6 views attn2 L=1400 Lk=238 C=320",
         (x[:6], ctx[:6], *w, 8, 40 ** -0.5))]


def _f32(a):
    """A floating tensor in fp32; integer tensors (a neighbour table) and
    other arguments as they are."""
    return a.float() if torch.is_tensor(a) and a.is_floating_point() else a


def _outputs(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _worst(got, ref):
    """(max|got - ref|, max|ref|) of the output with the largest error
    relative to its own max|ref|."""
    pairs = [((g.float() - r.float()).abs().max().item(),
              r.float().abs().max().item())
             for g, r in zip(_outputs(got), _outputs(ref))]
    return max(pairs, key=lambda p: p[0] / max(p[1], 1e-30))


# Published peaks of one H100 SXM (NVIDIA's data sheet): dense bf16 tensor
# operations and HBM3 bandwidth, at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
_FLASH_FLOPS_PER_LQ_LK_D = {"flash_attention_fwd": 4,  # q k^T, p v
                            "flash_attention_bwd_dq": 6,  # s, dp, dq
                            "flash_attention_bwd_dkv": 8,  # s, dp, dv, dk
                            # s, dp, dv, dk and dq once each: the two
                            # launches' recompute of s and dp is a choice
                            "flash_attention_bwd": 10}


def _flops(name, args) -> int:
    """The matrix-product operations the function needs on these inputs
    (the softmax's elementwise work is left out)."""
    if name == "kv_project":  # (x_kv, wk, wv): k and v of every head
        x, wk, wv = args
        return 2 * x.numel() * (wk.shape[0] + wv.shape[0])
    if name == "out_project":  # (o, wout): K8's product by Wout
        o, wout = args
        return 2 * o.numel() * wout.shape[0]
    if name in ("fused_ff", "fused_geglu"):
        x, w1 = args[0], args[1]
        M, K = x.numel() // x.shape[-1], x.shape[-1]
        f = 2 * M * K * w1.shape[0]
        if name == "fused_ff":
            f += 2 * M * (w1.shape[0] // 2) * args[3].shape[0]
        return f
    if name.startswith("flash"):
        # the wrappers' last argument is kv_len: keys past it need no work
        q, kv_len = args[0], args[-1]
        BH, Lq, D = q.shape
        return _FLASH_FLOPS_PER_LQ_LK_D[name] * BH * Lq * kv_len * D
    pair = name.endswith("_pair")
    x_q, x_kv = args[0], args[0] if pair else args[1]
    wq = args[1] if pair else args[2]
    B, Lq, C = x_q.shape
    Lk, Ck = x_kv.shape[1:]
    HD = wq.shape[0]
    # q, k and v projected once (the pair's two neighbours share k and v),
    # q k^T and p v per neighbour, the out-projection for K8
    f = 2 * B * (Lq * C + 2 * Lk * Ck) * HD + \
        (2 if pair else 1) * 4 * B * Lq * Lk * HD
    if "_out_" in name:
        f += 2 * B * Lq * HD * args[4 if pair else 5].shape[0]
    return f


def _bytes(name, args, out) -> int:
    """Each distinct input tensor read once, each output written once; the
    flash kernels read the rows of k and v below kv_len (their last
    argument) and no others."""
    if name.startswith("flash"):
        kv_len = args[-1]
        args = (args[0], args[1][:, :kv_len], args[2][:, :kv_len], *args[3:])
    seen = {}
    for t in (*args, *_outputs(out)):
        if torch.is_tensor(t):
            seen[t.data_ptr(), t.numel()] = t.numel() * t.element_size()
    return sum(seen.values())


def bound(name, args, out):
    """(bound_ms, bound_by): the least time the card could take for the
    same work, from this call's shapes."""
    by_ops = _flops(name, args) / PEAK_BF16_FLOPS * 1e3
    by_bytes = _bytes(name, args, out) / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else \
        (by_bytes, "bytes")


def _gate(name, label, err, scale, tol, row=None, note=""):
    ok = np.isfinite(err) and err <= tol * scale
    if row is not None:
        lib = row["library_ms"]
        kvp = row.get("kv_project") or row.get("out_project")
        sub = "kv_project" if "kv_project" in row else "out_project"
        note = (f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})" +
                ("" if lib is None else f" library {lib:.4f} ms") +
                ("" if "composed_ms" not in row else
                 f" composed {row['composed_ms']:.4f} ms") +
                ("" if kvp is None else
                 f" ({sub} {kvp['ms']:.4f} ms, bound "
                 f"{kvp['bound_ms']:.4f} ms {kvp['bound_by']})") +
                (f"; {note}" if note else ""))
    log(f"  {name:28s} {label:34s} max_abs_err {err:.3e} (max|ref| "
        f"{scale:.3e}) {note} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {label}: max abs err {err} > {tol} * "
                             f"{scale}")


def _row(rows, name, label, args, out, err, kern, plain, library=None):
    """Time the kernel, its plain version and the library call, and file
    the row under the kernel's name."""
    bound_ms, bound_by = bound(name, args, out)
    row = {"shape": label, "max_abs_err": err, "ms": cuda_ms(kern),
           "plain_ms": cuda_ms(plain), "bound_ms": bound_ms,
           "bound_by": bound_by,
           "library_ms": None if library is None else cuda_ms(library)}
    rows.setdefault(name, []).append(row)
    return row


def _heads(t, heads):
    """(B, L, H*D) -> (B, H, L, D)"""
    return t.unflatten(-1, (heads, -1)).transpose(1, 2)


def _merge_heads(t):
    """(B, H, L, D) -> (B, L, H*D)"""
    return t.transpose(1, 2).flatten(2)


def composed_kvstat_attention(x_q, x_kv, wq, wk, wv, heads, scale):
    """K1's function as a composition of library calls, the yardstick of
    ``composed_ms`` (the port never calls it): three F.linear projections,
    then F.scaled_dot_product_attention over the heads."""
    import torch.nn.functional as F

    q, k, v = (_heads(F.linear(x, w), heads)
               for x, w in ((x_q, wq), (x_kv, wk), (x_kv, wv)))
    return _merge_heads(F.scaled_dot_product_attention(q, k, v, scale=scale))


def composed_kvstat_attention_pair(x, wq, wk, wv, heads, scale, table):
    """K2's function as library calls: the projections once, then one
    F.scaled_dot_product_attention per neighbour list on the k/v gathered
    by the table, the two outputs summed in fp32 and cast once."""
    import torch.nn.functional as F
    from magicdrive_tpu_torch.kernels.reference import take_views

    n = table.shape[1]
    q, k, v = (F.linear(x, w) for w in (wq, wk, wv))
    o = sum(F.scaled_dot_product_attention(
        _heads(q, heads), _heads(take_views(k, idx, n), heads),
        _heads(take_views(v, idx, n), heads), scale=scale).float()
        for idx in table)
    return _merge_heads(o.to(x.dtype))


def composed_fused_qkv_out_attention(x_q, x_kv, wq, wk, wv, wout, heads,
                                     scale):
    """K8's function as library calls: K1's composition, then F.linear by
    Wout (no bias)."""
    import torch.nn.functional as F

    return F.linear(composed_kvstat_attention(x_q, x_kv, wq, wk, wv, heads,
                                              scale), wout)


def composed_fused_qkv_out_attention_pair(x, wq, wk, wv, wout, heads, scale,
                                          table):
    """The K8 pair's function as library calls: K2's composition, then
    F.linear by Wout (no bias)."""
    import torch.nn.functional as F

    return F.linear(composed_kvstat_attention_pair(x, wq, wk, wv, heads,
                                                   scale, table), wout)


def _composed_gated(x, w1, b1):
    import torch.nn.functional as F

    hv, hg = F.linear(x, w1, b1).chunk(2, dim=-1)
    return (hv * F.gelu(hg)).to(x.dtype)


def composed_fused_geglu(x, w1, b1):
    """K4's function as library calls: F.linear by W1 with its bias, the
    exact GELU of the gate half times the value half, cast to x's type."""
    return _composed_gated(x, w1, b1)


def composed_fused_ff(x, w1, b1, w2):
    """K3's function as library calls: K4's composition, then F.linear by
    W2 (no bias)."""
    import torch.nn.functional as F

    return F.linear(_composed_gated(x, w1, b1), w2)


# Each kernel's function as a composition of library calls that the port
# never calls: the yardstick of ``composed_ms``. K7 computes K1's function.
COMPOSED = {"kvstat_attention": composed_kvstat_attention,
            "kvstat_attention_pair": composed_kvstat_attention_pair,
            "fused_ff": composed_fused_ff,
            "fused_geglu": composed_fused_geglu,
            "fused_qkv_attention": composed_kvstat_attention,
            "fused_qkv_out_attention": composed_fused_qkv_out_attention,
            "fused_qkv_out_attention_pair":
                composed_fused_qkv_out_attention_pair}
# the kernels whose two calls on the same inputs must be bitwise equal in
# ``check_kernels``, and which ``compare_trees`` times against another tree
REDESIGNED = ("kvstat_attention", "kvstat_attention_pair", "fused_ff",
              "fused_geglu", "fused_qkv_attention", "fused_qkv_out_attention",
              "fused_qkv_out_attention_pair")
_OUT_KERNELS = ("fused_qkv_out_attention", "fused_qkv_out_attention_pair")


def _kv_project(args):
    """K1's first launch alone on K1's arguments: -> (the call, its
    arguments as the bound counts them)."""
    from magicdrive_tpu_torch.kernels import build, dispatch

    _, x_kv, _, wk, wv, heads, _ = args
    lib = build.load()
    return (lambda: dispatch._project_kv(lib, x_kv, wk, wv, heads),
            (x_kv, wk, wv))


def _kv_project_row(args):
    """The time and bound of K1's kv projection at K1's shape."""
    run, kv_args = _kv_project(args)
    bound_ms, bound_by = bound("kv_project", kv_args, run())
    return {"ms": cuda_ms(run), "bound_ms": bound_ms, "bound_by": bound_by}


def _out_project(name, args):
    """The last launch of K8 (or its pair) alone on its arguments, from the
    heads' output that K1's (K2's) launches give: -> (the call, its
    arguments as the bound counts them)."""
    from magicdrive_tpu_torch.kernels import build, dispatch

    if name == "fused_qkv_out_attention":
        x_q, x_kv, wq, wk, wv, wout, heads, scale = args
        o = dispatch.kvstat_attention(x_q, x_kv, wq, wk, wv, heads, scale)
    else:
        x, wq, wk, wv, wout, heads, scale, table = args
        o = dispatch.kvstat_attention_pair(x, wq, wk, wv, heads, scale,
                                           table)
    lib = build.load()
    return lambda: dispatch._out_project(lib, o, wout), (o, wout)


def _out_project_row(name, label, args):
    """The out-projection of K8 (or its pair) alone at its shape against its
    plain version in fp32, with its time, bound, plain time and the time of
    F.linear on the same inputs; gated as a kernel."""
    import torch.nn.functional as F
    from magicdrive_tpu_torch.kernels import reference

    run, (o, wout) = _out_project(name, args)
    got = run()
    err, scale = _worst(got, reference.out_projection(o.float(),
                                                      wout.float()))
    bound_ms, bound_by = bound("out_project", (o, wout), got)
    row = {"max_abs_err": err, "ms": cuda_ms(run),
           "plain_ms": cuda_ms(lambda: reference.out_projection(o, wout)),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": cuda_ms(lambda: F.linear(o, wout))}
    if not torch.equal(got, run()):
        raise AssertionError(f"out_project {label}: two calls on the same "
                             "inputs differ")
    _gate("out_project", label, err, scale, KERNEL_TOL,
          note=f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
          f"bound {bound_ms:.4f} ms ({bound_by}) library "
          f"{row['library_ms']:.4f} ms; two calls bitwise equal")
    return row


def check_kernels():
    """Every kernel of the path at its path shapes against its plain version
    in fp32, each also timed beside its library composition
    (``composed_ms``), K1 with its kv projection timed alone, K8 and its
    pair with their out-projection checked and timed alone, and two calls
    of each of REDESIGNED on the same inputs bitwise equal."""
    from magicdrive_tpu_torch.kernels import build, dispatch, reference

    log(f"tensor-map encoding on the host (K3 encodes three a call, K4 and "
        f"the out-projection two): "
        f"{build.load().mdk_tensor_map_encode_us(1000):.3f} us each")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, label, args in kernel_cases(gen):
        kern, plain = getattr(dispatch, name), getattr(reference, name)
        got = kern(*args)
        err, scale = _worst(got, plain(*map(_f32, args)))
        row = _row(rows, name, label, args, got, err, lambda: kern(*args),
                   lambda: plain(*args))
        row["composed_ms"] = cuda_ms(lambda: COMPOSED[name](*args))
        if name in REDESIGNED and not torch.equal(got, kern(*args)):
            raise AssertionError(f"{name} {label}: two calls on the same "
                                 "inputs differ")
        if name == "kvstat_attention":
            row["kv_project"] = _kv_project_row(args)
        if name in _OUT_KERNELS:
            row["out_project"] = _out_project_row(name, label, args)
        _gate(name, label, err, scale, KERNEL_TOL, row,
              "two calls bitwise equal" if name in REDESIGNED else "")
    return rows


# (BH, Lq, Lk, D, kv_len) of the flash kernels: on the training path the
# backward of K1/K8 at attn1 on levels 0 and 1 and at attn2 on level 0, and
# of each K2/K8-pair branch (6 views of 8 heads); then one shape that is on
# no path, keys masked past kv_len < Lk, which the wrappers take; last the
# projected route at the bf16 shape the routing sends there, PROJECTED_SHAPE
# (2 views of 8 heads, Lq = Lk = 8000), whose gradient K6 is.
FLASH_SHAPES = ((48, 1400, 1400, 40, 1400), (48, 350, 350, 80, 350),
                (48, 1400, 238, 40, 238), (48, 1400, 256, 40, 238),
                (16, 8000, 8000, 40, 8000))


def _sdpa_calls(q, k, v, do):
    """The flash SDPA forward, and its backward as one autograd call, on
    (BH, L, D) inputs viewed as BH batches of one head; q is pre-scaled."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)

    def fwd():
        with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)

    def bwd():
        torch.autograd.grad(o4, (q4, k4, v4), do.unsqueeze(1),
                            retain_graph=True)
    return fwd, bwd


def check_flash_kernels():
    """K5, the two launches of K6 and the whole K6 against their plain
    versions in fp32 on the same inputs at FLASH_SHAPES; K6 takes K5's o and
    lse, its second launch the first launch's delta. The library times are
    the flash SDPA forward (K5) and backward (the whole K6) on the keys
    below kv_len; no single call computes one launch of K6. Two whole K6
    calls on the same inputs must be bitwise equal."""
    from magicdrive_tpu_torch.kernels import dispatch, reference

    rnd = _rnd(torch.Generator(device="cuda").manual_seed(1))
    rows = {}
    for BH, Lq, Lk, D, kv_len in FLASH_SHAPES:
        label = f"BH={BH} Lq={Lq} Lk={Lk} D={D}" + \
            (f" kv_len={kv_len}" if kv_len < Lk else "")
        q = rnd(BH, Lq, D, scale=D ** -0.5)
        k, v = rnd(BH, Lk, D), rnd(BH, Lk, D)
        do = rnd(BH, Lq, D)
        fwd_args = (q, k, v, kv_len)
        o, lse = dispatch.flash_attention_fwd(*fwd_args)
        bwd_args = (q, k, v, o, lse, do, kv_len)
        plain_bwd = reference.flash_attention_bwd(*map(_f32, bwd_args))
        _, delta = dispatch.flash_attention_bwd_dq(*bwd_args)
        lib_fwd, lib_bwd = _sdpa_calls(q, k[:, :kv_len].contiguous(),
                                       v[:, :kv_len].contiguous(), do)
        runs = {
            "flash_attention_fwd": (
                fwd_args, reference.flash_attention_fwd(*map(_f32, fwd_args)),
                lib_fwd),
            "flash_attention_bwd_dq": (
                bwd_args, (plain_bwd[0], reference.flash_delta(o.float(),
                                                               do.float())),
                None),
            "flash_attention_bwd_dkv": (
                (q, k, v, lse, delta, do, kv_len), plain_bwd[1:], None),
            "flash_attention_bwd": (bwd_args, plain_bwd, lib_bwd),
        }
        for name, (args, ref, lib) in runs.items():
            kern = functools.partial(getattr(dispatch, name), *args)
            plain = functools.partial(getattr(reference, name), *args)
            got = kern()
            err, scale = _worst(got, ref)
            row = _row(rows, name, label, args, got, err, kern, plain, lib)
            _gate(name, label, err, scale, KERNEL_TOL, row)
        again = dispatch.flash_attention_bwd(*bwd_args)
        same = all(torch.equal(a, b) for a, b in
                   zip(dispatch.flash_attention_bwd(*bwd_args), again))
        log(f"  flash_attention_bwd {label}: two calls bitwise "
            f"{'equal ok' if same else 'DIFFERENT FAIL'}")
        if not same:
            raise AssertionError(f"K6 {label}: two calls on the same inputs "
                                 "differ")
    return rows


# one head depth for each instance of the flash kernels (the depth padded to
# a multiple of 16: 16, 32, ..., 128), four of them padded; the path takes
# 40 and 80 only, and DP 96-128 run the dk/dv kernel's second branch (K and
# V fragments reloaded from shared memory)
FLASH_DEPTHS = (8, 32, 40, 64, 80, 88, 104, 128)


def check_flash_depths() -> None:
    """K5 and the whole K6 at every depth of FLASH_DEPTHS, at a small shape
    with ragged q and key tails, against their plain versions in fp32."""
    from magicdrive_tpu_torch.kernels import dispatch, reference

    rnd = _rnd(torch.Generator(device="cuda").manual_seed(3))
    BH, Lq, Lk, kv_len = 4, 200, 192, 150
    for D in FLASH_DEPTHS:
        label = f"BH={BH} Lq={Lq} Lk={Lk} D={D} kv_len={kv_len}"
        q = rnd(BH, Lq, D, scale=D ** -0.5)
        k, v, do = rnd(BH, Lk, D), rnd(BH, Lk, D), rnd(BH, Lq, D)
        fwd_args = (q, k, v, kv_len)
        o, lse = dispatch.flash_attention_fwd(*fwd_args)
        err, scale = _worst((o, lse), reference.flash_attention_fwd(
            *map(_f32, fwd_args)))
        _gate("flash_attention_fwd", label, err, scale, KERNEL_TOL)
        bwd_args = (q, k, v, o, lse, do, kv_len)
        err, scale = _worst(dispatch.flash_attention_bwd(*bwd_args),
                            reference.flash_attention_bwd(*map(_f32, bwd_args)))
        _gate("flash_attention_bwd", label, err, scale, KERNEL_TOL)


# one head depth for each instance of K1's and K2's launcher (the depth
# padded to a multiple of 16: 16, 32, ..., 128), four of them padded; the
# path takes 40 and 80 only. K7, K8 and the K8 pair run the same launcher.
ATTENTION_DEPTHS = (8, 32, 40, 64, 80, 88, 104, 128)
# the rings of the depth checks: the nuScenes shifts (5, 1) and (1, 2), which
# is not symmetric
RING_SHIFTS = ((5, 1), (1, 2))
# the out-projection's width in the depth checks: not a multiple of its
# 64-column tile; at two heads of D=40 its depth H*D = 80 is not a multiple
# of its 64-deep chunk either
OUT_WIDTH = 72


def check_attention_depths() -> None:
    """K1, K2, K7, K8 and the K8 pair at every depth of ATTENTION_DEPTHS, at
    a small shape with ragged q and key tails (200 and 150 rows against
    64-row tiles) and a C that is not a multiple of the projection's
    32-column chunk, K2 and the K8 pair over both rings' tables, K8 and
    its pair out-projected to OUT_WIDTH columns, against their plain
    versions in fp32; the plain bf16 version's own distance from fp32 is
    printed beside each. The
    hidden states are drawn at 0.5 (logits of std 0.25): at 1.0 and D=8 the
    contract's own bf16 q and k casts put the plain bf16 version up to
    1.1e-2 * max|ref| from fp32 (CPU, PERF.md), so the gate would measure
    that rounding rather than the kernel; at 0.5 it stays under 4.5e-3."""
    from magicdrive_tpu_torch.kernels import dispatch, reference

    rnd = _rnd(torch.Generator(device="cuda").manual_seed(4))
    rings = {s: reference.ring_table(s, 6).cuda() for s in RING_SHIFTS}
    B, Lq, Lk, C, Ck, H = 2, 200, 150, 72, 40, 2

    def gate(name, label, args):
        ref = getattr(reference, name)(*map(_f32, args))
        err, scale = _worst(getattr(dispatch, name)(*args), ref)
        bf_err, _ = _worst(getattr(reference, name)(*args), ref)
        _gate(name, label, err, scale, KERNEL_TOL,
              note=f"plain bf16 {bf_err / scale:.3e} * max|ref|")

    for D in ATTENTION_DEPTHS:
        HD, scale = H * D, D ** -0.5
        label = f"B={B} Lq={Lq} Lk={Lk} C={C} Ck={Ck} H={H} D={D}"
        args = (rnd(B, Lq, C, scale=0.5), rnd(B, Lk, Ck, scale=0.5),
                rnd(HD, C, scale=C ** -0.5), rnd(HD, Ck, scale=Ck ** -0.5),
                rnd(HD, Ck, scale=Ck ** -0.5))
        wout = rnd(OUT_WIDTH, HD, scale=HD ** -0.5)
        gate("kvstat_attention", label, (*args, H, scale))
        gate("fused_qkv_attention", label, (*args, H, scale))
        gate("fused_qkv_out_attention", f"{label} C_out={OUT_WIDTH}",
             (*args, wout, H, scale))
        x = rnd(6, Lk, C, scale=0.5)
        w = [rnd(HD, C, scale=C ** -0.5) for _ in range(3)]
        for shifts, table in rings.items():
            label = f"6 views L={Lk} C={C} H={H} D={D} ring {shifts}"
            gate("kvstat_attention_pair", label, (x, *w, H, scale, table))
            gate("fused_qkv_out_attention_pair", f"{label} C_out={OUT_WIDTH}",
                 (x, *w, wout, H, scale, table))


# The widths C of check_ff_widths: K3 (in C, inner 4C, out C) at one C for
# each instance of its launcher (ff_instance) up to the largest C that
# ff_full_fusion_fits sends it at bf16, C = 8 (not a multiple of 16) and
# 16 among them; K4 (in C, inner 4C) at the path's two widths and one that
# is not a multiple of 64.
FF_WIDTHS = {"fused_ff": (8, 16, 64, 128, 192, 256, 320, 576),
             "fused_geglu": (200, 640, 1280)}
FF_ROWS = 200  # ragged against the kernels' 128-row blocks


def ff_instance(C: int) -> int:
    """The instance (64-column output tiles a block) of K3's launcher that
    an output width C takes: tiles of 64 spread evenly over the fewest
    blocks of at most 5 (``mdk_ff`` in csrc/geglu.cu)."""
    tiles = -(-C // 64)
    n_ct = -(-tiles // 5)
    return -(-tiles // n_ct)


def check_ff_widths() -> None:
    """K3 and K4 at every width of FF_WIDTHS, at FF_ROWS rows, with and
    without the W1 bias, against their plain versions in fp32; the plain
    bf16 version's own distance from fp32 is printed beside each."""
    from magicdrive_tpu_torch.kernels import dispatch, reference

    rnd = _rnd(torch.Generator(device="cuda").manual_seed(5))
    for name, widths in FF_WIDTHS.items():
        for C in widths:
            x = rnd(FF_ROWS, C)
            w1 = rnd(8 * C, C, scale=C ** -0.5)
            w2 = (rnd(C, 4 * C, scale=(4 * C) ** -0.5),) \
                if name == "fused_ff" else ()
            for b1 in (rnd(8 * C, scale=0.1), None):
                args = (x, w1, b1, *w2)
                ref = getattr(reference, name)(*map(_f32, args))
                err, scale = _worst(getattr(dispatch, name)(*args), ref)
                bf_err, _ = _worst(getattr(reference, name)(*args), ref)
                inst = f" instance {ff_instance(C)}" if w2 else ""
                _gate(name, f"M={FF_ROWS} C={C} bias={b1 is not None}{inst}",
                      err, scale, KERNEL_TOL,
                      note=f"plain bf16 {bf_err / scale:.3e} * max|ref|")


def autograd_cases(gen: torch.Generator):
    """(kernel, shape label, differentiable inputs, other arguments) at the
    shapes the training path gives K1-K4, K8 and the K8 pair: 6 views of 8
    heads; K2 and the K8 pair also over TABLE_CASES."""
    rnd = _rnd(gen)
    cases = []
    for L, C in ((1400, 320), (350, 640)):
        x = rnd(6, L, C)
        w = [rnd(C, C, scale=C ** -0.5) for _ in range(3)]
        sc = (C // 8) ** -0.5
        cases.append(("kvstat_attention", f"attn1 L={L} C={C}",
                      (x, x.clone(), *w), (8, sc)))
        cases.append(("kvstat_attention_pair", f"attn4 L={L} C={C}",
                      (x, *w), (8, sc, ring_table())))
        cases += [("kvstat_attention_pair", f"attn4 L={L} C={C} {what}",
                   (x, *w), (8, sc, view_table(pairs)))
                  for what, pairs in TABLE_CASES.items()]
    cases.append(("kvstat_attention", "attn2 L=1400 Lk=238 C=320",
                  (rnd(6, 1400, 320), rnd(6, 238, 768),
                   rnd(320, 320, scale=320 ** -0.5),
                   rnd(320, 768, scale=768 ** -0.5),
                   rnd(320, 768, scale=768 ** -0.5)), (8, 40 ** -0.5)))
    cases.append(("fused_ff", "ff M=6*1400 C=320",
                  (rnd(6, 1400, 320), rnd(2560, 320, scale=320 ** -0.5),
                   rnd(2560, scale=0.1), rnd(320, 1280, scale=1280 ** -0.5)),
                  ()))
    for L, C in ((350, 640), (91, 1280), (28, 1280)):
        cases.append(("fused_geglu", f"geglu M=6*{L} C={C}",
                      (rnd(6, L, C), rnd(8 * C, C, scale=C ** -0.5),
                       rnd(8 * C, scale=0.1)), ()))
    for L, C in ((1400, 320), (350, 640)):
        x = rnd(6, L, C)
        w = _attention_weights(rnd, C)
        sc = (C // 8) ** -0.5
        cases.append(("fused_qkv_out_attention", f"attn1 L={L} C={C}",
                      (x, x.clone(), *w), (8, sc)))
        cases.append(("fused_qkv_out_attention_pair", f"attn4 L={L} C={C}",
                      (x, *w), (8, sc, ring_table())))
        cases += [("fused_qkv_out_attention_pair", f"attn4 L={L} C={C} {what}",
                   (x, *w), (8, sc, view_table(pairs)))
                  for what, pairs in TABLE_CASES.items()]
    cases.append(("fused_qkv_out_attention", "attn2 L=1400 Lk=238 C=320",
                  (rnd(6, 1400, 320), rnd(6, 238, 768),
                   *_attention_weights(rnd, 320, 768)), (8, 40 ** -0.5)))
    return cases


def check_autograd():
    """The gradients of K1-K4, K8 and the K8 pair through the kernel route
    (every input and weight) against the plain backward in fp32 on the same
    inputs. The plain backward in bf16 is printed beside it: its own
    distance from fp32 is what bf16 costs the gradient."""
    from magicdrive_tpu_torch.kernels import autograd, reference

    def bwd(fn):
        return lambda ins, extra, dy, ops: fn(*ins, *extra, dy, ops=ops)

    def ff_bwd(fn):
        return lambda ins, extra, dy, ops: fn(*ins, dy)

    fns = {
        "kvstat_attention": (autograd.kvstat_attention,
                             bwd(autograd.kvstat_attention_bwd),
                             ("dx_q", "dx_kv", "dwq", "dwk", "dwv")),
        "kvstat_attention_pair": (autograd.kvstat_attention_pair,
                                  bwd(autograd.kvstat_attention_pair_bwd),
                                  ("dx", "dwq", "dwk", "dwv")),
        "fused_qkv_out_attention": (
            autograd.fused_qkv_out_attention,
            bwd(autograd.fused_qkv_out_attention_bwd),
            ("dx_q", "dx_kv", "dwq", "dwk", "dwv", "dwout")),
        "fused_qkv_out_attention_pair": (
            autograd.fused_qkv_out_attention_pair,
            bwd(autograd.fused_qkv_out_attention_pair_bwd),
            ("dx", "dwq", "dwk", "dwv", "dwout")),
        "fused_ff": (autograd.fused_ff, ff_bwd(autograd.fused_ff_bwd),
                     ("dx", "dw1", "db1", "dw2")),
        "fused_geglu": (autograd.fused_geglu,
                        ff_bwd(autograd.fused_geglu_bwd),
                        ("dx", "dw1", "db1")),
    }
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for name, label, inputs, extra in autograd_cases(gen):
        fn, plain_bwd, grad_names = fns[name]
        leaves = [t.clone().requires_grad_() for t in inputs]
        y = fn(*leaves, *extra)
        dy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
        y.backward(dy)
        ref = plain_bwd([t.float() for t in inputs], extra, dy.float(),
                        reference)
        bf16 = plain_bwd(inputs, extra, dy, reference)
        for g_name, leaf, r, b in zip(grad_names, leaves, ref, bf16):
            err, scale = _worst(leaf.grad, r)
            bf_err, _ = _worst(b, r)
            _gate(f"{name} {g_name}", label, err, scale,
                  max(GRAD_TOL, bf_err / scale),
                  note=f"plain bf16 {bf_err / scale:.3e} * max|ref|")
            w = worst.setdefault(name, [0.0, 0.0])
            w[0], w[1] = max(w[0], err / scale), max(w[1], bf_err / scale)
    log("autograd, worst gradient error / max|ref| (kernel route; plain "
        "bf16): " + ", ".join(f"{n} {k:.3e}; {b:.3e}"
                              for n, (k, b) in worst.items()))


def init_weights(modules, seed: int) -> None:
    """Seeded normals for every floating parameter and buffer, none zero:
    WEIGHT_GAIN / sqrt(fan_in) for weights of rank >= 2, 1 + 0.1 N for norm
    weights, 0.1 N otherwise."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    norms = (torch.nn.GroupNorm, torch.nn.LayerNorm)
    with torch.no_grad():
        for _, mod in modules.items():
            for sub in mod.modules():
                for pname, p in list(sub.named_parameters(recurse=False)) + \
                        list(sub.named_buffers(recurse=False)):
                    if not p.is_floating_point():
                        continue
                    z = torch.randn(p.shape, generator=gen, device=p.device)
                    if isinstance(sub, norms):
                        z = 1.0 + 0.1 * z if pname == "weight" else 0.1 * z
                    elif p.dim() >= 2:
                        z = z * (WEIGHT_GAIN * p[0].numel() ** -0.5)
                    else:
                        z = 0.1 * z
                    p.copy_(z)


@contextlib.contextmanager
def patched_kernels(make, names):
    """The model's kernel calls ``names`` replaced by
    ``make(name, kernel, plain)``; the autograd Functions look the wrappers
    up at call time, so this reaches every forward and backward call."""
    from magicdrive_tpu_torch.kernels import dispatch, reference

    saved = {n: getattr(dispatch, n) for n in names}
    try:
        for n, fn in saved.items():
            setattr(dispatch, n, make(n, fn, getattr(reference, n)))
        yield
    finally:
        for n, fn in saved.items():
            setattr(dispatch, n, fn)


@contextlib.contextmanager
def counted_calls(names):
    """``patched_kernels`` that counts: {wrapper: calls} of the wrappers
    ``names`` in the block, each call passed on to the wrapper."""
    calls = dict.fromkeys(names, 0)

    def make(name, kernel, plain):
        def call(*args):
            calls[name] += 1
            return kernel(*args)
        return call

    with patched_kernels(make, names):
        yield calls


def _new_modules(preset):
    """The preset's modules on the card (the entry point's default) in fp32
    with seeded weights."""
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules

    modules = MagicDriveModules.create(preset)
    init_weights(modules, seed=0)
    return modules


def set_up(preset_name: str = "sd15mv_rawbox_224x400"):
    """The full-width pipeline of a preset on seeded weights and N_REQUESTS
    fixture request batches at its image and map sizes."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    preset = getattr(config, preset_name)()
    t0 = time.perf_counter()
    modules = _new_modules(preset).to("cuda", preset.pipeline.dtype)
    pipe = MagicDrivePipeline(modules, preset.pipeline)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, m in modules.items()
                   for p in m.parameters())
    log(f"slice: {preset.name}, {n_params / 1e6:.1f} M parameters, set up "
        f"in {time.perf_counter() - t0:.1f} s")
    ccfg = CollateConfig(bbox_max_len=preset.bbox_max_len)
    batches = [collate_fn([s], ccfg) for s in make_dataset(
        N_REQUESTS, image_hw=preset.image_size, map_hw=preset.map_hw,
        map_channels=preset.map_channels)]
    return preset, pipe, batches


def _transformers(preset):
    """(in the UNet, index in its model, L, C, D) of every transformer of
    the ControlNet, then of the UNet, mid blocks included."""
    u = preset.unet
    h, w = preset.pipeline.latent_height, preset.pipeline.latent_width
    lengths = []
    for _ in u.block_out_channels:
        lengths.append(h * w)
        h, w = -(-h // 2), -(-w // 2)
    top = len(u.block_out_channels) - 1
    down = [i for i, a in enumerate(u.down_block_has_attn) if a
            for _ in range(u.layers_per_block)]
    up = [top - i for i, a in enumerate(u.up_block_has_attn) if a
          for _ in range(u.layers_per_block + 1)]
    for unet, levels in ((False, down + [top]), (True, down + [top] + up)):
        for j, lvl in enumerate(levels):
            C = u.block_out_channels[lvl]
            yield unet, j, lengths[lvl], C, C // u.num_attention_heads


# The kernel wrapper an attention calls in one forward by its route
_CALLS_OF = {"kvstat": "kvstat_attention", "out": "fused_qkv_out_attention",
             "projected": "flash_attention_fwd"}
_PAIR_CALLS_OF = {"kvstat": "kvstat_attention_pair",
                  "out": "fused_qkv_out_attention_pair"}


def attention_calls(route, neighbours: int = 0):
    """(kernel wrapper, calls in one forward, branches in its backward) of
    an attention that takes ``route``, None for SDPA. ``neighbours`` > 0
    marks the cross-view "add" form over that many neighbour lists: the
    pairs (K2, the K8 pair) call their kernel once for two branches, the
    loops (``*_loop``) theirs once per list."""
    if route is None:
        return None
    if neighbours and route in _PAIR_CALLS_OF:
        return _PAIR_CALLS_OF[route], 1, 2
    if neighbours:
        return _CALLS_OF[route[:-len("_loop")]], neighbours, neighbours
    return _CALLS_OF[route], 1, 1


def cross_view_calls(unet_cfg, L: int, C: int, D: int, esize: int,
                     view: int = 1):
    """``attention_calls`` of a UNet transformer's cross-view attention at
    latent length L, by its form: "add" takes ``pair_route``'s over its k
    neighbour lists, "concat" ``attention_route``'s with the k lists' views
    end to end (Lk = k L) and "self" ``attention_route``'s over the (n l)
    tokens of a sample. Over ``view`` > 1 ranks (a view-sharded pipeline)
    the pairs take their per-neighbour loops, and "self"'s queries are the
    rank's n / view cameras."""
    from magicdrive_tpu_torch.kernels import dispatch

    pairs = unet_cfg.neighboring_view_pair
    n, k = len(pairs), len(pairs[0])
    kind = unet_cfg.neighboring_attn_type
    if kind == "add":
        route = dispatch.pair_route(L, C, D, esize, k)
        if view > 1 and route in _PAIR_CALLS_OF:
            route += "_loop"
        return attention_calls(route, k)
    lq, lk = (L, k * L) if kind == "concat" else (n // view * L, n * L)
    return attention_calls(dispatch.attention_route(lq, lk, C, D, esize))


def expected_launches(preset, mode: str, forwards: int = 0, steps: int = 0,
                      esize: int = 2, recompute: bool = False,
                      view: int = 1):
    """Kernel launches (``dispatch.LAUNCHES``' keys) of ``forwards`` guided
    ControlNet+UNet evaluations and ``steps`` train steps under the fused
    ``mode``, derived from the block structure and the routing rules: per
    transformer at latent length L and width C, attn1 and attn2 (context
    1 + 77 + boxes, width max(C, 768)) take ``attention_route``'s kernel,
    attn4 (UNet only) that of its form (``cross_view_calls``), and the FF
    takes K3 where ``ff_full_fusion_fits`` holds, else K4. In a train step
    the backward of each K1 or K8 call, and of each branch of a pair or a
    loop, runs K5 and K6 once, that of a projected attention K6 alone (on
    its forward's o and lse), and K7 runs once per call or branch of a K8
    whose Wout trains (the ControlNet's and attn4's). The only attention
    without a backward is attn1 of the UNet's first transformer, whose
    input comes from frozen weights alone (the trainable tokens enter at
    its attn2). With ``recompute`` (gradient checkpointing) every
    transformer sits in a remat unit (the UNet's down, mid and up blocks,
    the ControlNet's down and mid blocks), whose forward runs again in the
    backward: each forward kernel call of a train step launches twice,
    that attn1 included; the backward's K5, K6 and K7 do not change.
    ``view`` > 1: the forwards of a rank of a view-sharded pipeline
    (``cross_view_calls``)."""
    from magicdrive_tpu_torch.kernels import dispatch

    n = dict.fromkeys(dispatch.LAUNCHES, 0)
    calls = forwards + steps * (2 if recompute else 1)
    ctx = 1 + 77 + preset.bbox_max_len
    ctx_dim = preset.unet.cross_attention_dim
    with dispatch.fused_mode(mode):
        for unet, j, L, C, D in _transformers(preset):
            # (its calls, no backward, Wout trains)
            attentions = [
                (attention_calls(dispatch.attention_route(L, L, C, D, esize)),
                 unet and j == 0, not unet),
                (attention_calls(dispatch.attention_route(
                    L, ctx, max(C, ctx_dim), D, esize)), False, not unet)]
            if unet:
                attentions.append((cross_view_calls(preset.unet, L, C, D,
                                                    esize, view), False,
                                   True))
            for call, no_backward, wout_trains in attentions:
                if call is None:
                    continue
                kernel, per_forward, branches = call
                n[kernel] += per_forward * calls
                if no_backward:
                    continue
                if kernel != "flash_attention_fwd":
                    n["flash_attention_fwd"] += steps * branches
                n["flash_attention_bwd_dq"] += steps * branches
                n["flash_attention_bwd_dkv"] += steps * branches
                if kernel.startswith("fused_qkv_out") and wout_trains:
                    n["fused_qkv_attention"] += steps * branches
            ff = "fused_ff" if dispatch.ff_full_fusion_fits(
                C, 4 * C, C, esize) else "fused_geglu"
            n[ff] += calls
    return n


def path_calls(preset, mode: str):
    """The kernel wrappers one guided step of ``preset`` calls under the
    fused ``mode`` (bf16), by ``expected_launches``."""
    return tuple(k for k, v in expected_launches(preset, mode,
                                                 forwards=1).items() if v)


def _check_launches(what, want):
    """The launch counts since the last reset, which must equal ``want``
    (every kernel of the path launched, every other one not)."""
    from magicdrive_tpu_torch.kernels import dispatch

    launches = dict(dispatch.LAUNCHES)
    log(f"{what} launches: { {k: v for k, v in launches.items() if v} }")
    if launches != want or not any(launches.values()):
        raise AssertionError(f"{what} launches {launches}, derived {want}")
    return launches


def check_images(img, batch, preset) -> str:
    """The images of a request: (B or B*F, N, H, W, 3) for the batch's
    leading size, finite, in [0, 1]; -> their statistics."""
    want = (len(batch["camera_param"]), preset.pipeline.n_cam,
            *preset.image_size, 3)
    if tuple(img.shape) != want:
        raise AssertionError(f"image shape {tuple(img.shape)}, not {want}")
    if not torch.isfinite(img).all():
        raise AssertionError("non-finite image values")
    lo, hi = img.min().item(), img.max().item()
    if lo < 0.0 or hi > 1.0:
        raise AssertionError(f"image values outside [0, 1]: {lo} {hi}")
    return (f"image min {lo:.3f} max {hi:.3f} mean {img.mean().item():.4f} "
            f"std {img.std().item():.4f}")


def _timed(fn):
    """(fn(), host-clock seconds to a sync)"""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_slice(preset, pipe, batches, mode):
    """One request per batch through ``pipe`` (a MagicDrivePipeline or a
    VideoPipeline), the images checked and the launch counts equal to the
    derived ones."""
    from magicdrive_tpu_torch.kernels import dispatch

    dispatch.reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(42)
    seconds = []
    for b in batches:
        img, s = _timed(lambda: pipe(b, generator=gen))
        seconds.append(s)
        log(f"  request: {s:.3f} s, {check_images(img, b, preset)}")
    what = f"generation {preset.name} ({mode})"
    launches = _check_launches(what, expected_launches(
        preset, mode,
        forwards=len(batches) * preset.pipeline.num_inference_steps))
    log(f"{what}: seconds per request {seconds} (the first includes one-time "
        f"setup such as cuDNN algorithm choice)")
    return launches, seconds


def outside_remat(fn):
    """``fn`` run with the active dispatch modes set aside: in a remat unit
    under a selective policy ("dots") those keep the output of every matrix
    product until the backward, and a plain version's fp32 logits are not
    the path's to keep (the 16-frame video's would not fit the card). The
    recompute then runs ``fn`` again instead of replaying it."""
    from torch.utils._python_dispatch import _disable_current_modes

    @functools.wraps(fn)
    def call(*args):
        with _disable_current_modes():
            return fn(*args)
    return call


def _relative(got, want, ref) -> float:
    """The largest max|got - want| / max|ref| over the outputs, each output
    held to its own ref's scale (a backward's dq, dk and dv apart)."""
    return max((g.float() - w.float()).abs().max().item() /
               max(r.float().abs().max().item(), 1e-30)
               for g, w, r in zip(_outputs(got), _outputs(want),
                                  _outputs(ref)))


def _call_checker(stats, bf16_floor: bool = False):
    """``make`` for ``patched_kernels``: each call runs the kernel, then
    the plain version in fp32 on the same inputs, and raises if an output
    is off by more than KERNEL_TOL * its max|ref|. With ``bf16_floor`` the
    plain version also runs on the kernel's own inputs, at the cast points
    it shares with the JAX kernels: the kernel must be within KERNEL_TOL of
    that, and within KERNEL_TOL of fp32 or no farther from fp32 than that
    plain bf16 version is (GRAD_TOL's rule for the forward: the kernel then
    adds nothing to what its bf16 casts cost). The comparison runs
    ``outside_remat``, so a checkpointed path keeps what it would keep
    unchecked."""
    def make(name, kern, plain):
        def call(*args):
            out = kern(*args)
            check(name, args, out)
            return out

        @outside_remat
        def check(name, args, out):
            ref = plain(*map(_f32, args))
            err, scale = _worst(out, ref)
            rel, limit = _relative(out, ref, ref), KERNEL_TOL
            s = stats.setdefault(name, [0, 0.0] + [0.0, 0.0] * bf16_floor)
            s[0], s[1] = s[0] + 1, max(s[1], rel)
            if bf16_floor:
                bf = plain(*args)
                cast = _relative(bf, ref, ref)
                own = _relative(out, bf, ref)
                s[2], s[3] = max(s[2], own), max(s[3], cast)
                limit = max(KERNEL_TOL, cast)
                if not (np.isfinite(own) and own <= KERNEL_TOL):
                    raise AssertionError(
                        f"{name} on the path, input {tuple(args[0].shape)}: "
                        f"{own:.3e} * max|ref| from its plain bf16 version "
                        f"> {KERNEL_TOL}")
            if not (np.isfinite(rel) and rel <= limit):
                raise AssertionError(
                    f"{name} on the path, input {tuple(args[0].shape)}: max "
                    f"abs err {err:.3e} = {rel:.3e} * max|ref| > "
                    f"{limit:.3e}")
        return call
    return make


def _report_calls(what, stats, names):
    log(f"path calls of {what}, kernel vs fp32 plain version: " +
        ", ".join(f"{n} {st[0]} calls, worst {st[1]:.3e} * max|ref|" + (
            f" (vs plain bf16 {st[2]:.3e}; plain bf16 vs fp32 {st[3]:.3e})"
            if len(st) > 2 else "") for n, st in stats.items()))
    if set(stats) != set(names):
        raise AssertionError(f"kernels not called in {what}: "
                             f"{set(names) - set(stats)}")


def _step_inputs(pipe, batch):
    """A latent drawn per view: with the shared initial latent of a first
    step the views differ only by their conditioning, and a cross-view
    fault that mixes up neighbours would hardly show."""
    c = pipe.cfg
    x = torch.randn((len(batch["camera_param"]), c.n_cam, 4, c.latent_height,
                     c.latent_width),
                    generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    return x, int(pipe.coeffs.timesteps[0]), pipe.conditioning(batch)


def check_path_calls(preset, pipe, batch, mode, bf16_floor: bool = False,
                     what: str = "") -> None:
    """Every kernel call of one guided step against its plain version in
    fp32 on the inputs the path gave it (``bf16_floor``: see
    ``_call_checker``); ``what`` names the path in the log."""
    x, t, cond = _step_inputs(pipe, batch)
    # kernel -> [calls, worst max|err| / max|ref|], with bf16_floor then the
    # worst against the plain bf16 version and the plain bf16's own
    stats = {}
    names = path_calls(preset, mode)
    with patched_kernels(_call_checker(stats, bf16_floor), names):
        pipe.guided_eps(x, t, cond)
    _report_calls(f"one guided step of {what or preset.name} ({mode})",
                  stats, names)


# What the profiled steps sum by kernel name: each part is the name of a
# __global__ function of kernels/csrc. The attention heads of K1, K2, K7,
# K8 and the K8 pair all run kvstat_kernel; K8 and its pair add
# out_project_kernel.
PROFILED = {"heads": ("kvstat_kernel",),
            "out_project": ("out_project_kernel",),
            "kv_project": ("kv_project_kernel",),
            "K3": ("ff_kernel",), "K4": ("geglu_kernel",),
            "K5": ("flash_fwd_kernel",),
            "K6": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")}


def _device_ms(rows, part):
    """The summed device ms of the port's kernels that PROFILED's ``part``
    names, as the profiler prints them: in namespace mdk (or an anonymous
    namespace inside it), a template's arguments or the call's after the
    name."""
    names = PROFILED[part]
    return sum(ms for ms, _, k in rows if "mdk::" in k and any(
        f"::{n}{c}" in k for n in names for c in "<("))


def _kernel_parts(rows, parts):
    return ", ".join(f"{p} {_device_ms(rows, p):.2f} ms" for p in parts)


def profile_guided_step(preset, pipe, batch, mode, top: int = 8) -> None:
    """One guided step under torch.profiler: its host-clock time, the sum of
    its kernels' device times (one stream, so the sum is the busy time), the
    device time of the mode's attention (the heads, with the out-projection
    under ``auto``), of the out-projection alone, of the k/v projection, of
    K3 and K4, and the kernels that take the most; for the video model, the
    device time of the temporal attention's SDPA calls in one more step."""
    x, t, cond = _step_inputs(pipe, batch)
    step = lambda: pipe.guided_eps(x, t, cond)
    wall, rows = _profiled(step)
    busy = sum(r[0] for r in rows)
    attention = {"kvstat": "K1+K2", "auto": "K8+pair"}[mode]
    attn_ms = _device_ms(rows, "heads") + _device_ms(rows, "out_project")
    frames = preset.unet.temporal_frames
    temporal = "" if not frames else (
        f"temporal SDPA (Lq = Lk = {frames}) "
        f"{_sdpa_ms(step, frames):.2f} ms, ")
    log(f"guided step of {preset.name} ({mode}) under the profiler: "
        f"{wall:.1f} ms host "
        f"clock, kernels {busy:.1f} ms (device idle "
        f"{100 * (1 - busy / wall):.1f} %); {attention} {attn_ms:.2f} ms (" +
        _kernel_parts(rows, ("heads", "out_project")) + "), " +
        _kernel_parts(rows, ("K3", "K4", "kv_project")) + ", " + temporal +
        "top kernels: " +
        "; ".join(f"{k[:60]} x{c} {ms:.2f} ms" for ms, c, k in rows[:top]))


def _sdpa_ms(fn, length: int) -> float:
    """The device ms, in one call of ``fn`` under torch.profiler with the
    operators' shapes recorded, of the F.scaled_dot_product_attention calls
    whose queries (B, H, L, D) have L = ``length``, the kernels of every
    backend counted."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total / 1e3
               for e in prof.key_averages(group_by_input_shape=True)
               if e.key == "aten::scaled_dot_product_attention"
               and e.input_shapes and len(e.input_shapes[0]) == 4
               and e.input_shapes[0][2] == length)


def _profiled(fn):
    """(host-clock ms, kernel rows) of one call of ``fn`` after a warm-up
    call, under torch.profiler; the rows are (self device ms, count, name)
    of every kernel, largest first, the ``aten::`` operator rows (which
    repeat their kernels' time) left out. One stream, so the sum of the
    rows is the device's busy time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return wall, sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0
                         and not e.key.startswith("aten::")), reverse=True)


def profile_train_step(setup, mode, top: int = 8) -> None:
    """One warm training step under torch.profiler: its host-clock time,
    the device-busy share, the kernels that take the most, and the device
    time of K5 and K6 (the port's flash kernels, named mdk::flash_*), of
    the attention heads (K1/K2, or K8, its pair and K7 in their backward),
    of the out-projection and of the k/v projection."""
    from magicdrive_tpu_torch.train import train_step

    modules, cfg, state, batch = setup
    draws = _fixed_draws(cfg, batch, 11)
    wall, rows = _profiled(
        lambda: train_step(modules, state, batch, cfg, draws=draws))
    busy = sum(r[0] for r in rows)
    k5, k6 = _device_ms(rows, "K5"), _device_ms(rows, "K6")
    log(f"training step ({mode}) under the profiler: {wall:.1f} ms host "
        f"clock, kernels {busy:.1f} ms (device busy "
        f"{100 * busy / wall:.1f} %); K5 {k5:.2f} ms, K6 {k6:.2f} ms, K5+K6 "
        f"{k5 + k6:.2f} ms ({100 * (k5 + k6) / busy:.1f} % of kernel time), " +
        _kernel_parts(rows, ("heads", "out_project", "kv_project")) +
        "; top kernels: " +
        "; ".join(f"{k[:60]} x{c} {ms:.2f} ms" for ms, c, k in rows[:top]))


def check_eps(preset, pipe, batch, mode) -> None:
    """The guided eps of one step through the kernels against the same step
    through the plain versions."""
    x, t, cond = _step_inputs(pipe, batch)
    eps_k = pipe.guided_eps(x, t, cond)
    with patched_kernels(lambda name, kern, plain: plain,
                         path_calls(preset, mode)):
        eps_p = pipe.guided_eps(x, t, cond)
        noise = torch.randn(x.shape, device=x.device,
                            generator=torch.Generator("cuda").manual_seed(8))
        eps_n = pipe.guided_eps(x * (1 + 1e-3 * noise), t, cond)
    rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    sens = ((eps_n - eps_p).norm() / eps_p.norm()).item()
    log(f"guided eps ({mode}), kernels vs plain versions: relative L2 "
        f"{rel:.3e} (|eps| rms {eps_p.pow(2).mean().sqrt().item():.3e}; "
        f"plain vs plain on a latent perturbed by 1e-3: {sens:.3e})")
    if not (np.isfinite(rel) and rel <= EPS_TOL):
        raise AssertionError(f"eps relative L2 {rel} > {EPS_TOL}")


# ---------------------------------------------------------------------------
# the routes no bf16 preset reaches, and the hi-res presets
# ---------------------------------------------------------------------------

# (batch, L, C, heads) of a bf16 self-attention that the routing sends to
# the projected route (neither fused kernel's rule holds at Lq = Lk = 8000,
# C = 320, D = 40), and (views, L, C, heads) of a cross-view block whose
# pair it sends to the per-neighbour K8 loop under "auto" (K8 fits at
# L = 1050, C = 640, D = 80; the K8 pair does not)
PROJECTED_SHAPE = (2, 8000, 320, 8)
OUT_LOOP_SHAPE = (12, 1050, 640, 8)
CTX_TOKENS, CTX_DIM = 1 + 77 + 160, 768


def _module_check(what, module, inputs, want, names, dy=None):
    """``module(*inputs)`` on the card, with the backward of ``dy`` when
    given: the launch counts equal ``want``, every call of the kernel
    wrappers ``names`` is within KERNEL_TOL of its plain version in fp32 on
    its inputs (the per-call check), and the output is within KERNEL_TOL *
    max|ref| of the same module's through the plain versions."""
    from magicdrive_tpu_torch.kernels import dispatch

    dispatch.reset_launches()
    stats = {}
    with patched_kernels(_call_checker(stats), names):
        y = module(*inputs)
        if dy is not None:
            y.backward(dy)
    launches = _check_launches(what, want)
    _report_calls(what, stats, names)
    with torch.no_grad(), patched_kernels(lambda n, kern, plain: plain,
                                          names):
        ref = module(*inputs)
    err, scale = _worst(y.detach(), ref)
    _gate(what, "module vs its plain versions", err, scale, KERNEL_TOL)
    return launches


def check_forced_routes(by_path) -> None:
    """The projected route, forward and backward, through an ``Attention``
    at PROJECTED_SHAPE, and the per-neighbour K8 loop through a
    ``BasicTransformerBlock`` at OUT_LOOP_SHAPE under "auto", on the card in
    bf16 against their plain versions; their launch counts go into
    ``by_path``."""
    from magicdrive_tpu_torch.config import NUSCENES_NEIGHBORS
    from magicdrive_tpu_torch.core.attention import Attention
    from magicdrive_tpu_torch.core.transformer import BasicTransformerBlock
    from magicdrive_tpu_torch.kernels import dispatch

    rnd = _rnd(torch.Generator(device="cuda").manual_seed(12))
    B, L, C, H = PROJECTED_SHAPE
    route = dispatch.attention_route(L, L, C, C // H, 2)
    if route != "projected":
        raise AssertionError(f"PROJECTED_SHAPE takes the route {route}")
    attn = Attention(C, H, C // H).to("cuda")
    init_weights({"attn": attn}, seed=13)
    attn.to(torch.bfloat16)
    x = rnd(B, L, C).requires_grad_()
    want = dict.fromkeys(dispatch.LAUNCHES, 0)
    want.update(flash_attention_fwd=1, flash_attention_bwd_dq=1,
                flash_attention_bwd_dkv=1)
    by_path["projected_route"] = _module_check(
        f"Attention B={B} L={L} C={C} (projected route)", attn, (x,), want,
        ("flash_attention_fwd", "flash_attention_bwd"), dy=rnd(B, L, C))
    del attn, x

    V, L, C, H = OUT_LOOP_SHAPE
    with dispatch.fused_mode("auto"):
        route = dispatch.pair_route(L, C, C // H, 2)
        if route != "out_loop":
            raise AssertionError(f"OUT_LOOP_SHAPE takes the route {route}")
        want = dict.fromkeys(dispatch.LAUNCHES, 0)
        for call in (attention_calls(dispatch.attention_route(
                         L, L, C, C // H, 2)),
                     attention_calls(dispatch.attention_route(
                         L, CTX_TOKENS, CTX_DIM, C // H, 2)),
                     attention_calls(route, 2)):
            if call is not None:
                want[call[0]] += call[1]
        want["fused_ff" if dispatch.ff_full_fusion_fits(C, 4 * C, C)
             else "fused_geglu"] += 1
        blk = BasicTransformerBlock(C, H, C // H, CTX_DIM,
                                    NUSCENES_NEIGHBORS).to("cuda")
        init_weights({"block": blk}, seed=14)
        blk.to(torch.bfloat16)
        with torch.no_grad():
            by_path["out_loop"] = _module_check(
                f"BasicTransformerBlock views={V} L={L} C={C} (auto, K8 "
                "loop)", blk, (rnd(V, L, C), rnd(V, CTX_TOKENS, CTX_DIM)),
                want, tuple(k for k, v in want.items() if v))
    del blk
    torch.cuda.empty_cache()


# the hi-res presets and the fused modes their smoke paths run (272x736's
# "auto" path reaches K8 and the K8 pair at L=782; 424x800's differs from
# its "kvstat" one only at the level-1 attn2)
HIRES = {"sd15mv_rawbox_272x736": ("kvstat", "auto"),
         "sd15mv_rawbox_424x800": ("kvstat",)}


def run_hires(by_path, timing) -> None:
    """Each hi-res preset at full width: N_REQUESTS requests under "kvstat"
    and one under each other mode of HIRES, every run's launch counts equal
    to the derived ones; then, in each mode, the per-call check of one
    guided step and one profiled guided step."""
    from magicdrive_tpu_torch.kernels import dispatch

    for name, modes in HIRES.items():
        preset, pipe, batches = set_up(name)
        tag = name.rsplit("_", 1)[1]
        for mode in modes:
            with dispatch.fused_mode(mode):
                runs = batches if mode == "kvstat" else batches[:1]
                by_path[f"generation_{tag}_{mode}"], \
                    timing[f"s/request {tag} {mode}"] = run_slice(
                        preset, pipe, runs, mode)
                check_path_calls(preset, pipe, batches[0], mode)
                profile_guided_step(preset, pipe, batches[0], mode)
        del pipe
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the pipeline's options, given-view generation and 16-frame video
# ---------------------------------------------------------------------------


def _option_request(what, preset, pipe, batch, by_path, timing, **kwargs):
    """One request through ``pipe`` under "kvstat", its images checked and
    its launch counts equal to the derived ones (filed under ``what``)."""
    from magicdrive_tpu_torch.kernels import dispatch

    dispatch.reset_launches()
    img, s = _timed(lambda: pipe(batch, **kwargs))
    log(f"  {what}: {s:.3f} s, {check_images(img, batch, preset)}")
    by_path[what] = _check_launches(what, expected_launches(
        preset, "kvstat", forwards=preset.pipeline.num_inference_steps))
    timing[f"s/request {what}"] = [s]
    return img


def run_options(preset, pipe, batches, by_path, timing) -> None:
    """The pipeline's options at full width under "kvstat" on the 224x400
    pipeline's weights: a guess-mode request (its ControlNet at batch B on
    the cond branch) with the per-call check of its guided step, a DDIM
    request, a request from pre-encoded prompt embeddings (the port's own
    CLIP output) bitwise equal to the one from the ids on the same latents,
    a B=2 request whose samples start from one latent
    (``fix_seed_within_batch``), and one guided step of a ControlNet with
    the negative1 unconditional map, with the per-call check."""
    import dataclasses

    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    cfg, batch = pipe.cfg, batches[0]
    gen = torch.Generator(device="cuda").manual_seed(31)
    with dispatch.fused_mode("kvstat"):
        for what, option in (("options_guess_mode", {"guess_mode": True}),
                             ("options_ddim", {"sampler": "ddim"})):
            p = MagicDrivePipeline(pipe.m, dataclasses.replace(cfg, **option))
            _option_request(what, preset, p, batch, by_path, timing,
                            generator=gen)
            if option.get("guess_mode"):
                check_path_calls(preset, p, batch, "kvstat")

        with torch.no_grad():
            text, uncond = pipe.encode_text(batch)
        lat = pipe.prepare_latents(1, gen)
        by_ids = pipe(batch, latents=lat)
        by_embeds = _option_request(
            "options_prompt_embeds", preset, pipe,
            dict(batch, prompt_embeds=text, uncond_embeds=uncond),
            by_path, timing, latents=lat)
        if not torch.equal(by_ids, by_embeds):
            raise AssertionError("the request from prompt embeddings differs "
                                 "from the one from their ids")
        log("  the request from prompt embeddings is bitwise equal to the "
            "one from the ids")

        batch2 = collate_fn(make_dataset(2, image_hw=preset.image_size,
                                         map_hw=preset.map_hw),
                            CollateConfig(bbox_max_len=preset.bbox_max_len))
        lat = pipe.prepare_latents(2, gen, fix_seed_within_batch=True)
        if not torch.equal(lat[0], lat[1]):
            raise AssertionError("fix_seed_within_batch: the samples' "
                                 "initial latents differ")
        img = _option_request("options_fixed_seed_b2", preset, pipe, batch2,
                              by_path, timing, latents=lat)
        log(f"  B=2 from one initial latent: the two samples' images differ "
            f"by {(img[0] - img[1]).abs().max().item():.3f} at most (their "
            f"scenes differ)")

        with torch.device("cuda"):
            cn = BEVControlNet(dataclasses.replace(
                preset.controlnet, use_uncond_map="negative1"))
        got = cn.load_state_dict(pipe.m.controlnet.state_dict(), strict=False)
        if got.missing_keys != ["uncond_map"] or got.unexpected_keys:
            raise AssertionError(f"uncond-map ControlNet: {got}")
        cn.to(dtype=pipe.dtype).eval().requires_grad_(False)
        if not bool((cn.uncond_map == -1).all()):
            raise AssertionError("the negative1 map is not -1")
        p = MagicDrivePipeline(dataclasses.replace(pipe.m, controlnet=cn),
                               cfg)
        x, t, cond = _step_inputs(p, batch)
        if torch.equal(cond.cond_feat[:1], cond.cond_feat[1:]):
            raise AssertionError("the uncond branch did not take the map")
        dispatch.reset_launches()
        p.guided_eps(x, t, cond)
        by_path["options_uncond_map_step"] = _check_launches(
            "options: one guided step with the negative1 map",
            expected_launches(preset, "kvstat", forwards=1))
        check_path_calls(preset, p, batch, "kvstat")
    del cn, p


def run_given_view(preset, pipe, batches, by_path, timing) -> None:
    """Given-view generation at full width under "kvstat": one request's
    images encoded, view 1 given and the other five generated, with
    sub_noise_pred off and on; the given view's images are bitwise those of
    the VAE round trip of its latent, the generated ones finite, in
    [0, 1], and not the round trip's; the launch counts equal the derived
    ones; then the per-call check of one guided step."""
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.pipeline.given_view import GivenViewPipeline

    batch, n = batches[0], pipe.cfg.n_cam
    gen = torch.Generator(device="cuda").manual_seed(41)
    with dispatch.fused_mode("kvstat"):
        gv = GivenViewPipeline(pipe.m, pipe.cfg)
        given = gv.encode_views(pipe(batch, generator=gen) * 2 - 1)
        round_trip = gv.decode(given.permute(0, 1, 4, 2, 3))
        mask = torch.zeros(n, device="cuda")
        mask[1] = 1.0
        dispatch.reset_launches()
        seconds = []
        for sub in (False, True):
            gv = GivenViewPipeline(pipe.m, pipe.cfg, sub_noise_pred=sub)
            img, s = _timed(lambda: gv(batch, given, mask, generator=gen))
            seconds.append(s)
            stats = check_images(img, batch, preset)
            if not torch.equal(img[0, 1], round_trip[0, 1]):
                raise AssertionError("the given view is not its VAE round "
                                     "trip")
            moved = min((img[0, v] - round_trip[0, v]).abs().max().item()
                        for v in range(n) if v != 1)
            if not moved > 1e-3:
                raise AssertionError(f"a generated view is its round trip "
                                     f"({moved})")
            log(f"  given view 1, sub_noise_pred {sub}: {s:.3f} s, {stats}; "
                f"view 1 bitwise its round trip, the others at least "
                f"{moved:.3f} from theirs")
        by_path["given_view"] = _check_launches(
            "given view (kvstat)", expected_launches(
                preset, "kvstat", forwards=2 * pipe.cfg.num_inference_steps))
        timing["s/request given view"] = seconds
        check_path_calls(preset, gv, batch, "kvstat")


# The variants of run_cross_view_forms: (form, neighbour pairs, connector,
# trainable class tokens, min-max boxes, the fused modes of its requests).
# None of the pairs stands for the nuScenes ring.
CROSS_VIEW_VARIANTS = {
    "a_add_permuted": ("add", PERMUTED_RING, "gated", True, True,
                       ("kvstat", "auto")),
    "b_add_not_a_permutation": ("add", TRIANGLES, "zero_linear", False,
                                False, ("kvstat",)),
    "c_concat": ("concat", None, "none", False, False, ("kvstat", "auto")),
    "d_self": ("self", None, "zero_linear", False, False, ("kvstat", "auto")),
}


def cross_view_preset(name: str):
    """sd15mv_rawbox_224x400 in the cross-view variant ``name`` of
    CROSS_VIEW_VARIANTS."""
    import dataclasses

    from magicdrive_tpu_torch.config import sd15mv_rawbox_224x400

    form, pairs, connector, tokens, minmax, _ = CROSS_VIEW_VARIANTS[name]
    p = sd15mv_rawbox_224x400()
    unet = dataclasses.replace(
        p.unet, neighboring_view_pair=pairs or p.unet.neighboring_view_pair,
        neighboring_attn_type=form, zero_module_type=connector)
    cn = dataclasses.replace(
        p.controlnet, unet=dataclasses.replace(unet,
                                               neighboring_view_pair=None),
        bbox=dataclasses.replace(p.controlnet.bbox,
                                 trainable_class_token=tokens,
                                 minmax_normalize=minmax))
    return dataclasses.replace(p, name=f"{p.name} {name}", unet=unet,
                               controlnet=cn)


def run_cross_view_forms(pipe, batches, by_path, timing, card: str) -> None:
    """Each variant of CROSS_VIEW_VARIANTS at full width (the 224x400
    model, bf16, seeded weights; the VAE and CLIP of ``pipe``, a UNet and a
    ControlNet of the variant): one request per fused mode of the variant
    (the images checked, the launch counts equal to the derived ones), the
    per-call check of a guided step in each mode (KERNEL_TOL), a profiled
    guided step under "kvstat"; then one training step under "kvstat" from
    the recipe's optimizer without warm-up, on a fixture batch with images
    (B=1): its launch counts, its loss finite, every trainable weight of the
    UNet (norm4, attn4 and the connector, if any) and the trainable class
    tokens moved, every frozen weight bitwise unchanged (snapshot after the
    state casts the modules), and the per-call check of one more step."""
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.models.controlnet import BEVControlNet
    from magicdrive_tpu_torch.models.unet import UNet2DConditionModel
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)
    from magicdrive_tpu_torch.train import (TrainConfig, create_train_state,
                                            train_step)

    train_batch = None
    for name, (form, _, connector, tokens, minmax, modes) in \
            CROSS_VIEW_VARIANTS.items():
        t0 = time.perf_counter()
        preset = cross_view_preset(name)
        log(f"cross-view {name}: {form} over "
            f"{preset.unet.neighboring_view_pair}, connector {connector}, "
            f"class tokens {'trained' if tokens else 'frozen'}, min-max "
            f"boxes {minmax}")
        with torch.device("cuda"):
            new = {"unet": UNet2DConditionModel(preset.unet),
                   "controlnet": BEVControlNet(preset.controlnet)}
        init_weights(new, seed=0)
        modules = MagicDriveModules(vae=pipe.m.vae, clip=pipe.m.clip, **new)
        modules.to("cuda", torch.bfloat16)
        vpipe = MagicDrivePipeline(modules, preset.pipeline)
        for mode in modes:
            with dispatch.fused_mode(mode):
                by_path[f"cross_view_{name}_{mode}"], timing[
                    f"s/request cross-view {name} {mode}"] = run_slice(
                        preset, vpipe, batches[:1], mode)
                check_path_calls(preset, vpipe, batches[0], mode,
                                 what=f"cross-view {name}")
                if mode == "kvstat":
                    profile_guided_step(preset, vpipe, batches[0], mode)
        del vpipe

        if train_batch is None:
            train_batch = collate_fn(
                [make_sample(0, with_images=True)],
                CollateConfig(bbox_max_len=preset.bbox_max_len))
        cfg = TrainConfig(lr_warmup_steps=0)
        state = create_train_state(modules, cfg)
        frozen = _frozen(modules)  # at the dtype the state cast them to
        masters0 = {k: t.clone() for k, t in state.masters.items()}
        own = [k for k in masters0 if k.startswith("unet.") or
               k.endswith("_class_tokens")]
        what = f"cross-view {name} training step"
        dispatch.reset_launches()
        with dispatch.fused_mode("kvstat"):
            metrics, s = _timed(lambda: train_step(
                modules, state, train_batch, cfg,
                generator=torch.Generator("cuda").manual_seed(13)))
            by_path[f"cross_view_{name}_training"] = _check_launches(
                f"{what} (kvstat)", expected_launches(preset, "kvstat",
                                                      steps=1))
        loss = float(metrics["loss"])
        moved = _moved(masters0, state.masters, own)
        changed = frozen_changed(modules, frozen)
        log(f"{what} (kvstat): {s:.3f} s, loss {loss:.5f}, {moved} of "
            f"{len(own)} trainable UNet and class-token weights moved, "
            f"{_moved(masters0, state.masters)} of {len(masters0)} "
            f"trainable weights in all; frozen weights changed: "
            f"{len(changed)} of {len(frozen)}")
        if not np.isfinite(loss) or not own or moved != len(own) or \
                any(k.endswith("_class_tokens") for k in own) != tokens or \
                any(".connector." in k for k in own) != (connector != "none"):
            raise AssertionError(f"{what}: loss {loss}, trainable {own[:8]}, "
                                 f"{moved} of {len(own)} moved")
        if changed:
            raise AssertionError(f"{what}: {len(changed)} frozen weights "
                                 f"changed, e.g. {changed[:5]}")
        with dispatch.fused_mode("kvstat"):
            check_training_calls((modules, cfg, state, train_batch), "kvstat",
                                 f"a {what}", preset=preset)
        timing[f"s cross-view {name}"] = [time.perf_counter() - t0]
        log(f"cross-view {name}: {timing[f's cross-view {name}'][0]:.1f} s "
            f"({card})")
        del modules, new, state, masters0, frozen
        torch.cuda.empty_cache()


CLI_INDICES = (0, 1)


def run_generate_cli(by_path, timing, card: str, tmp: str, run_dir: str,
                     modules) -> None:
    """The generation CLI as a user runs it, at full width under "kvstat":
    a synthetic nuScenes-format tree (the port's make_mini_nuscenes) in
    ``tmp`` and ``run_dir``, the 224x400 run that run_evaluation converted
    from the released trees of this script's seeded ``modules``; then
    ``cli.generate.main`` on samples CLI_INDICES of the tree with the
    default runner (20 UniPC steps, runner.validation_times = 2 variants of
    the batch, boxes drawn). Gates: the samples came from the nuScenes
    dataset, their unsliced maps with the object channels filled; every
    PNG exists and decodes to its shape, its generated row equal to the
    variant's quantized images; the images finite and in [0, 1]; the launch
    counts equal to the derived ones for the variants' steps; every kernel
    call of one guided step of the CLI's own pipeline on its batch (B=2,
    24 UNet images) within KERNEL_TOL of its plain version at its own bf16
    casts, and of fp32 or no farther than that plain bf16 version; the
    CLI's batch through a MagicDrivePipeline on ``modules`` (not loaded
    from the run directory; left in bf16) from the CLI's latents within
    KERNEL_TOL * max|ref| of the CLI's images. Prints the npz's size and
    the seconds to load it, each CLI request's seconds (the first cold) and
    the peak memory, with the card."""
    from PIL import Image

    from magicdrive_tpu_torch.cli import generate
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.convert import iter_leaves
    from magicdrive_tpu_torch.data.nuscenes import NuScenesDataset
    from magicdrive_tpu_torch.data.synth import make_mini_nuscenes
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline
    from magicdrive_tpu_torch.utils.serialization import load_params

    root, version = make_mini_nuscenes(os.path.join(tmp, "nuscenes_cli"))
    cfg = compose(generate.CONFIG_DIR, overrides=["exp=224x400"])
    preset = preset_from_config(cfg)
    weights = os.path.join(run_dir, "weights")
    size = os.path.getsize(os.path.join(weights, "params.npz"))
    t0 = time.perf_counter()
    n_leaves = len(list(iter_leaves(load_params(weights))))
    load_s = time.perf_counter() - t0
    log(f"generate CLI: run weights {size / 2**30:.3f} GiB "
        f"({size} bytes, {n_leaves} arrays), loaded in {load_s:.1f} s "
        f"({card})")

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    # the overrides go before --indices, which takes all that follows it
    argv = ["--run_dir", run_dir, f"dataset.dataset_root={root}",
            f"dataset.version={version}", "--indices",
            *map(str, CLI_INDICES)]
    with dispatch.fused_mode("kvstat"):
        t0 = time.perf_counter()
        made = generate.main(argv)
        main_s = time.perf_counter() - t0
    steps = preset.pipeline.num_inference_steps
    times = cfg["runner"]["validation_times"]
    by_path["generate_cli"] = _check_launches(
        "generate CLI (kvstat)", expected_launches(
            preset, "kvstat", forwards=times * steps))
    peak = torch.cuda.max_memory_allocated() / 2**30
    timing["s/request generate CLI"] = made.seconds
    log(f"generate CLI: main {main_s:.1f} s, requests (B="
        f"{len(CLI_INDICES)}, {steps} steps) {made.seconds} s (the "
        f"first cold), peak memory {peak:.2f} GiB ({card})")

    # the samples came through the nuScenes index, raster and collate,
    # not the fixture scenes that build_datasets falls back to
    if not isinstance(made.dataset, NuScenesDataset):
        raise AssertionError(f"the CLI read {type(made.dataset)}")
    dc = cfg["dataset"]
    n_static, n_obj = len(dc["map_classes"]), len(dc["object_classes"])
    maps = [made.dataset[i]["bev_map"] for i in CLI_INDICES]
    n_map = n_static + n_obj + 8  # and the 8 aux channels
    if any(m.shape != (*preset.map_hw, n_map) for m in maps) or not any(
            m[..., n_static:n_static + n_obj].any() for m in maps):
        raise AssertionError("the nuScenes maps hold no object channel: "
                             f"{[m.shape for m in maps]}")
    batch = made.batch
    # nuScenes' intrinsics make context tokens of |x| ~ 95, where K1's
    # plain version at its bf16 casts is itself 1.1e-2 * max|ref| from
    # fp32 (PERF.md): hence the bf16 floor
    with dispatch.fused_mode("kvstat"):
        check_path_calls(preset, made.pipe, batch, "kvstat",
                         bf16_floor=True)
    if tuple(batch["bev_map"].shape) != (len(CLI_INDICES),
                                         *preset.map_hw,
                                         preset.map_channels):
        raise AssertionError(f"CLI batch map {batch['bev_map'].shape}")
    if not batch["masks"].any():
        raise AssertionError("no box of the tree is in the CLI batch")
    H, W = preset.image_size
    n = preset.pipeline.n_cam
    rows = 2 if cfg["runner"]["validation_show_box"] else 1
    for ti, imgs in enumerate(made.images):
        suffix = f"_t{ti}" if times > 1 else ""
        log(f"  variant {ti}: "
            f"{check_images(torch.from_numpy(imgs), batch, preset)}")
        for bi, i in enumerate(CLI_INDICES):
            name = f"{i}_gen{suffix}.png"
            png = np.asarray(Image.open(os.path.join(made.out_dir, name)))
            if png.shape != (rows * H, n * W, 3):
                raise AssertionError(f"{name} {png.shape}")
            want = (np.clip(np.concatenate(list(imgs[bi]), axis=1), 0, 1)
                    * 255).astype(np.uint8)
            if not np.array_equal(png[:H], want):
                raise AssertionError(f"{name} is not the variant's "
                                     "images")
    for i in CLI_INDICES:
        png = np.asarray(Image.open(os.path.join(made.out_dir,
                                                 f"{i}_map.png")))
        if png.ndim != 3 or png.shape[2] != 3 or png.shape[0] < 400:
            raise AssertionError(f"{i}_map.png {png.shape}")

    direct = MagicDrivePipeline(
        modules.to("cuda", preset.pipeline.dtype), preset.pipeline)
    for ti, (lat, imgs) in enumerate(zip(made.latents, made.images)):
        got = direct(batch, latents=lat)
        err, scale = _worst(torch.from_numpy(imgs).cuda(), got)
        _gate("generate CLI images", f"variant {ti}", err, scale,
              KERNEL_TOL, note="vs MagicDrivePipeline on the script's "
              f"modules; bitwise equal: "
              f"{torch.equal(got.cpu(), torch.from_numpy(imgs))}")
    del made, direct
    torch.cuda.empty_cache()


EVAL_SAMPLES = 8     # the val-set tree: two batches of 4
EVAL_BATCH = 4       # val_set_gen's default batch, the North star's B
OLD_VAE_NAMES = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
                 ".to_out.0.": ".proj_attn."}
POOL3_TOL = 1e-3     # card vs CPU pool3, * max|CPU| (fp32, TF32 off)


def _write_safetensors(sd, path) -> None:
    """A ``.safetensors`` file (an 8-byte little-endian header length, the
    JSON header, the raw buffers) of numpy arrays."""
    names = {np.dtype(np.float32): "F32", np.dtype(np.int64): "I64"}
    header, offset = {}, 0
    for k, a in sd.items():
        header[k] = {"dtype": names[a.dtype], "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(len(h).to_bytes(8, "little"))
        f.write(h)
        for a in sd.values():
            f.write(np.ascontiguousarray(a).data)


def write_released_trees(modules, root) -> dict:
    """The script's modules as the two released trees, in the layouts a
    user downloads: SD-v1.5 (``unet/`` safetensors without the multiview
    modules, ``vae/`` .bin under the old attention names,
    ``text_encoder/`` .bin with transformers' ``position_ids``) and
    MagicDrive (``controlnet/`` .bin, ``unet/`` safetensors); -> {tree:
    bytes}."""
    from magicdrive_tpu_torch.cli.convert_weights import MULTIVIEW

    sds = {n: {k: v.detach().cpu().numpy() for k, v in m.state_dict().items()}
           for n, m in modules.items()}
    vae = {}
    for k, v in sds["vae"].items():
        if ".attentions." in k:
            for new, old in OLD_VAE_NAMES.items():
                k = k.replace(new, old)
        vae[k] = v
    clip = dict(sds["clip"])
    clip["text_model.embeddings.position_ids"] = np.arange(77)[None]
    files = {
        "sd15/unet/diffusion_pytorch_model.safetensors":
            {k: v for k, v in sds["unet"].items()
             if not any(m in k for m in MULTIVIEW)},
        "sd15/vae/diffusion_pytorch_model.bin": vae,
        "sd15/text_encoder/pytorch_model.bin": clip,
        "magicdrive/controlnet/diffusion_pytorch_model.bin":
            sds["controlnet"],
        "magicdrive/unet/diffusion_pytorch_model.safetensors": sds["unet"],
    }
    sizes = {}
    for rel, sd in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if path.endswith(".safetensors"):
            _write_safetensors(sd, path)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        tree = rel.split("/")[0]
        sizes[tree] = sizes.get(tree, 0) + os.path.getsize(path)
    return sizes


@contextlib.contextmanager
def recorded_requests(calls, seconds=None):
    """Each ``MagicDrivePipeline`` call in the block appended to ``calls``
    as (batch, latents, images), and its host-clock seconds to the card's
    end to ``seconds`` where given."""
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    real = MagicDrivePipeline.__call__

    def call(self, batch, generator=None, latents=None):
        t0 = time.perf_counter()
        out = real(self, batch, generator, latents)
        if seconds is not None:
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        calls.append((dict(batch), latents, out))
        return out

    MagicDrivePipeline.__call__ = call
    try:
        yield calls
    finally:
        MagicDrivePipeline.__call__ = real


def write_inception_weights(path: str, seed: int = 0) -> None:
    """A random Inception in pytorch-fid's file layout: convolutions
    N(0, 2 / fan_in), so that the features stay of order 1 and differ from
    image to image; random batch-norm affines and statistics; the unused
    ``fc`` layer."""
    from magicdrive_tpu_torch.eval.inception import (FrozenBatchNorm,
                                                     load_inception)

    model = load_inception(device="cpu")
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.weight.normal_(0.0, (2 / m.weight[0].numel()) ** 0.5,
                             generator=g)
        elif isinstance(m, FrozenBatchNorm):
            m.weight.uniform_(0.7, 1.3, generator=g)
            m.bias.uniform_(-0.1, 0.1, generator=g)
            m.running_mean.uniform_(-0.2, 0.2, generator=g)
            m.running_var.uniform_(0.6, 1.4, generator=g)
    sd = dict(model.state_dict())
    sd["fc.weight"] = torch.zeros(1008, 2048)
    sd["fc.bias"] = torch.zeros(1008)
    torch.save(sd, path)


@contextlib.contextmanager
def _scratch(path=None):
    """``path``, or a temporary directory removed after the block."""
    if path is not None:
        yield path
        return
    with tempfile.TemporaryDirectory() as tmp:
        yield tmp


def run_evaluation(by_path, timing, card: str, keep: str = None) -> dict:
    """The evaluation chain as a user runs it, at full width (224x400), in
    a temporary directory:
      1. weight conversion: the script's seeded modules written as the
         SD-v1.5 and MagicDrive release trees (write_released_trees), then
         ``cli.convert_weights.main`` in sd15 mode and in magicdrive mode
         with --sd15, into a run directory. Gate: every leaf of the run's
         weights equals ``modules_to_jax_params`` of the script's modules,
         bitwise. The generation CLI's phase (run_generate_cli) runs on
         that run directory;
      2. ``cli.val_set_gen.main`` on a synthetic nuScenes tree of
         EVAL_SAMPLES samples with a JPEG per camera, at its default batch
         of EVAL_BATCH, 20 UniPC steps, under "kvstat". Gates: every
         ``<stem>_gen0.png`` of every sample and camera at (224, 400, 3);
         the launch counts equal the derived ones; every kernel call of one
         guided step of its pipeline on its first batch (B=4, 48 UNet
         images) within KERNEL_TOL of its plain version at its own bf16
         casts and of fp32 or no farther than that (``bf16_floor``:
         nuScenes camera tokens, as in run_generate_cli); the first batch's
         images within KERNEL_TOL of a MagicDrivePipeline on the script's
         modules (in bf16 since run_generate_cli) from the same latents;
         one guided step of that batch under the profiler;
      3. ``cli.fid.main`` (random Inception weights in pytorch-fid's
         layout, write_inception_weights) in tokens mode, the
         generated tree against the tree's JPEGs, and in paths mode, the
         generated tree against itself. Gates: the pair count is samples x
         6, the FIDs finite and the self FID about 0; the pool3 features of
         8 images on the card within POOL3_TOL of the same module on the CPU;
      4. the map drop (Queue C's C3) on the card (run_map_drop_step).
    Prints the trees' sizes and the seconds to write and to convert them,
    the seconds per batch from asking the loader to the last PNG (the first
    cold), 6-view frames/s at B=4, the peak memory above what the script
    holds, FID seconds and Inception images/s, with the card.
    With ``keep`` (a directory) the run, the tree and the generated set stay
    there for the multi-GPU phase (the released trees do not); -> their
    paths."""
    from PIL import Image

    from magicdrive_tpu_torch.cli import convert_weights, fid, val_set_gen
    from magicdrive_tpu_torch.cli.generate import CONFIG_DIR
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose, save_run_config
    from magicdrive_tpu_torch.convert import iter_leaves, modules_to_jax_params
    from magicdrive_tpu_torch.data.nuscenes import NuScenesIndex
    from magicdrive_tpu_torch.data.synth import make_mini_nuscenes
    from magicdrive_tpu_torch.eval.fid import (ActivationExtractor,
                                               list_images,
                                               pair_real_generated)
    from magicdrive_tpu_torch.eval.inception import load_inception
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline
    from magicdrive_tpu_torch.utils.serialization import load_params

    with _scratch(keep) as tmp:
        overrides = ["exp=224x400"]
        cfg = compose(CONFIG_DIR, overrides=overrides)
        preset = preset_from_config(cfg)
        modules = _new_modules(preset)
        t0 = time.perf_counter()
        sizes = write_released_trees(modules, os.path.join(tmp, "released"))
        write_s = time.perf_counter() - t0
        run_dir = os.path.join(tmp, "run")
        save_run_config(cfg, run_dir, overrides)
        weights = os.path.join(run_dir, "weights")
        t0 = time.perf_counter()
        convert_weights.main(["sd15", "--src", os.path.join(
            tmp, "released", "sd15"), "--out", os.path.join(tmp, "sd15")])
        sd15_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        convert_weights.main(["magicdrive", "--src", os.path.join(
            tmp, "released", "magicdrive"), "--sd15",
            os.path.join(tmp, "sd15"), "--out", weights])
        md_s = time.perf_counter() - t0
        want = dict(iter_leaves(modules_to_jax_params(modules)))
        got = dict(iter_leaves(load_params(weights)))
        if got.keys() != want.keys() or any(
                not np.array_equal(got[k], w) for k, w in want.items()):
            raise AssertionError("the converted run's weights are not the "
                                 "script's modules")
        del got, want
        log(f"evaluation: released trees {sizes} bytes written in "
            f"{write_s:.1f} s; converted sd15 in {sd15_s:.1f} s, magicdrive "
            f"--sd15 in {md_s:.1f} s; every leaf of the run bitwise the "
            f"modules' ({card})")
        timing["s convert sd15, magicdrive"] = [sd15_s, md_s]
        log("the generation CLI (kvstat) on the converted run:")
        run_generate_cli(by_path, timing, card, tmp, run_dir, modules)

        root, version = make_mini_nuscenes(os.path.join(tmp, "nuscenes"),
                                           n_samples=EVAL_SAMPLES,
                                           images_per_sample=True)
        out = os.path.join(tmp, "generated")
        calls, pipe_s = [], []
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # the script's own modules
        dispatch.reset_launches()
        with dispatch.fused_mode("kvstat"), recorded_requests(calls, pipe_s):
            t0 = time.perf_counter()
            made = val_set_gen.main(
                ["--run_dir", run_dir, "--out", out,
                 f"dataset.dataset_root={root}", f"dataset.version={version}"])
            main_s = time.perf_counter() - t0
        steps = preset.pipeline.num_inference_steps
        n_batches = -(-EVAL_SAMPLES // EVAL_BATCH)
        by_path["val_set_gen"] = _check_launches(
            "val_set_gen (kvstat)", expected_launches(
                preset, "kvstat", forwards=n_batches * steps))
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        warm = made.seconds[1:]
        timing["s/batch val_set_gen B=4"] = made.seconds
        log(f"val_set_gen: main {main_s:.1f} s, s/batch (B={EVAL_BATCH}, "
            f"{steps} steps, from asking the loader to the last PNG) "
            f"{made.seconds} (the first cold; the pipeline's calls "
            f"{pipe_s}), {EVAL_BATCH / np.mean(warm):.3f} 6-view frames/s "
            f"warm, peak "
            f"memory {peak:.2f} GiB above the script's own {held / 2**30:.2f}"
            f" GiB ({card})")
        if len(made.dataset) != EVAL_SAMPLES:
            raise AssertionError(f"val_set_gen read {len(made.dataset)}")
        for i in range(len(made.dataset)):
            for f in made.dataset[i]["metas"]["filename"]:
                stem = os.path.splitext(os.path.basename(f))[0]
                png = np.asarray(Image.open(os.path.join(
                    out, f"{stem}_gen0.png")))
                if png.shape != (*preset.image_size, 3):
                    raise AssertionError(f"{stem}_gen0.png {png.shape}")
        batch, latents, imgs = calls[0]
        log(f"  first batch: {check_images(imgs, batch, preset)}")
        # nuScenes camera tokens, as in run_generate_cli: hence the floor
        with dispatch.fused_mode("kvstat"):
            check_path_calls(preset, made.pipe, batch, "kvstat",
                             bf16_floor=True)
            log(f"  a guided step at B={EVAL_BATCH} ({EVAL_BATCH * 12} UNet "
                "images):")
            profile_guided_step(preset, made.pipe, batch, "kvstat")
            direct = MagicDrivePipeline(modules, preset.pipeline)
            ref = direct(batch, latents=latents)
        err, scale = _worst(imgs, ref)
        _gate("val_set_gen images", "first batch", err, scale, KERNEL_TOL,
              note="vs MagicDrivePipeline on the script's modules; bitwise "
              f"equal: {torch.equal(imgs, ref)}")
        del made, direct, modules, calls, imgs, ref
        torch.cuda.empty_cache()

        inception = os.path.join(tmp, "pt_inception.pth")
        write_inception_weights(inception)
        t0 = time.perf_counter()
        fid_tokens = fid.main(["tokens", "--dataroot", root, "--version",
                               version, "--gen_root", out, "--weights",
                               inception])
        tokens_s = time.perf_counter() - t0
        fid_self = fid.main(["paths", out, out, "--no_crop", "--weights",
                             inception])
        gen_files = list_images(out)
        pairs = pair_real_generated(NuScenesIndex(root, version), out)
        if len(gen_files) != EVAL_SAMPLES * 6 or \
                len(pairs[0]) != EVAL_SAMPLES * 6:
            raise AssertionError(f"{len(gen_files)} generated images, "
                                 f"{len(pairs[0])} pairs")
        if not (np.isfinite(fid_tokens) and fid_tokens > 0 and
                abs(fid_self) <= 1e-3 * fid_tokens):
            raise AssertionError(f"FID tokens {fid_tokens}, self {fid_self}")
        ext = ActivationExtractor(inception)
        ext.from_files(gen_files[:ext.batch_size])  # cuDNN's first choices
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = ext.from_files(gen_files)
        torch.cuda.synchronize()
        rate = len(gen_files) / (time.perf_counter() - t0)
        cpu = load_inception(inception, device="cpu")
        x = torch.from_numpy(np.stack([ext._prep(Image.open(f))
                                       for f in gen_files[:8]]))
        with torch.no_grad():
            want = cpu(x)
        err, scale = _worst(torch.from_numpy(feats[:8]), want)
        _gate("Inception pool3", "8 images, card vs CPU", err, scale,
              POOL3_TOL)
        log(f"FID: tokens mode {fid_tokens:.4f} over {len(pairs[0])} pairs "
            f"in {tokens_s:.1f} s, paths mode self {fid_self:.3e}; "
            f"Inception {rate:.1f} images/s at batch {ext.batch_size}, the "
            f"files' decode and resize included ({card})")
        timing["s FID tokens"] = [tokens_s]
        for d in ("released", "sd15"):
            shutil.rmtree(os.path.join(tmp, d))
        kept = {"run_dir": run_dir, "root": root, "version": version,
                "out": out}
    run_map_drop_step(by_path)
    return kept


def run_map_drop_step(by_path) -> None:
    """C3 on the card: a full-width training step at B=2 with a learnable
    unconditional map and the map drop [1, 0] (sample 0 takes the
    unconditional map) under "kvstat"; its launches counted. The same step
    with every kernel call held to its plain version, then through the
    plain versions alone in bf16 and in fp32: the map's gradient through
    the kernels within EPS_TOL (relative L2) of both. With the map drop
    [0, 0] the map's gradient is exactly zero: it arrives by the drop's
    route alone."""
    import dataclasses

    from magicdrive_tpu_torch.config import sd15mv_rawbox_224x400
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state
    from magicdrive_tpu_torch.train.train_step import (batch_tensors,
                                                       loss_and_grads)

    preset = sd15mv_rawbox_224x400()
    preset = dataclasses.replace(preset, controlnet=dataclasses.replace(
        preset.controlnet, use_uncond_map="learnable"))
    modules = _new_modules(preset)
    cfg = TrainConfig()
    state = create_train_state(modules, cfg, dtype=torch.bfloat16)
    batch = collate_fn([make_sample(i, with_images=True) for i in range(2)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    draws = _fixed_draws(cfg, batch, 11)
    draws.map_drop_mask = torch.tensor([1.0, 0.0], device="cuda")
    tensors = batch_tensors(batch, "cuda")
    schedule = NoiseSchedule.create()
    key = "controlnet.uncond_map"
    with dispatch.fused_mode("kvstat"):
        dispatch.reset_launches()
        loss, grads = loss_and_grads(modules, state, tensors, draws, cfg,
                                     schedule)
        by_path["train_map_drop"] = _check_launches(
            "map-drop training step (kvstat)",
            expected_launches(preset, "kvstat", steps=1))
        g = grads[key]
        names = training_calls("kvstat")
        stats = {}
        with patched_kernels(_call_checker(stats), names):
            loss_and_grads(modules, state, tensors, draws, cfg, schedule)
        _report_calls("the map-drop training step (kvstat)", stats, names)
        draws.map_drop_mask = torch.zeros(2, device="cuda")
        _, grads_0 = loss_and_grads(modules, state, tensors, draws, cfg,
                                    schedule)
        g0 = grads_0[key].abs().max().item()
        draws.map_drop_mask = torch.tensor([1.0, 0.0], device="cuda")
        plain = {}  # the fp32 state runs the modules in fp32 from here
        with patched_kernels(lambda name, kern, plain: plain, names):
            loss_p, plain["bf16"] = loss_and_grads(modules, state, tensors,
                                                   draws, cfg, schedule)
            fp32 = create_train_state(modules, cfg, dtype=torch.float32)
            plain["fp32"] = loss_and_grads(modules, fp32, tensors, draws, cfg,
                                           schedule)[1]
        plain = {k: v[key] for k, v in plain.items()}
        rel = {k: ((g - v).norm() / v.norm()).item()
               for k, v in plain.items()}
        floor = ((plain["bf16"] - plain["fp32"]).norm()
                 / plain["fp32"].norm()).item()
    log(f"map drop step (B=2, learnable uncond map, mask [1, 0]): loss "
        f"{float(loss):.5f} (plain versions {float(loss_p):.5f}), uncond "
        f"map grad max|g| {g.abs().max().item():.3e} (plain fp32 "
        f"{plain['fp32'].abs().max().item():.3e}); kernels vs plain bf16 "
        f"relative L2 {rel['bf16']:.3e}, vs plain fp32 {rel['fp32']:.3e} "
        f"(limit {EPS_TOL}; plain bf16 vs plain fp32 {floor:.3e}); mask "
        f"[0, 0]: max|g| {g0:.3e}")
    if not np.isfinite(float(loss)) or not g.abs().max() > 0:
        raise AssertionError("the map drop step's loss or the uncond "
                             "map's gradient")
    if not all(np.isfinite(r) and r <= EPS_TOL for r in rel.values()):
        raise AssertionError(f"the uncond map's gradient through the "
                             f"kernels: relative L2 {rel}")
    if g0 != 0:
        raise AssertionError(f"the uncond map's gradient without the map "
                             f"drop: max|g| {g0:.3e}")
    del modules, state, fp32, grads, plain, grads_0
    torch.cuda.empty_cache()


def video_set_up():
    """The full-width 16-frame video pipeline on seeded weights and
    N_REQUESTS requests of one 16-frame clip each (B=1, the frames folded
    into the batch)."""
    from magicdrive_tpu_torch.config import sd15mv_rawbox_video_16f
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.pipeline.video import VideoPipeline

    preset = sd15mv_rawbox_video_16f()
    frames = preset.unet.temporal_frames
    t0 = time.perf_counter()
    modules = _new_modules(preset).to("cuda", preset.pipeline.dtype)
    pipe = VideoPipeline(modules, preset.pipeline, n_frames=frames)
    torch.cuda.synchronize()
    log(f"video: {preset.name}, {frames} frames, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    clip = collate_fn(make_dataset(frames, image_hw=preset.image_size,
                                   map_hw=preset.map_hw),
                      CollateConfig(bbox_max_len=preset.bbox_max_len))
    return preset, pipe, [clip] * N_REQUESTS


def run_video(by_path, timing) -> None:
    """The 16-frame video at full width under "kvstat": N_REQUESTS requests
    (the first cold) with their launch counts (the temporal blocks launch
    none of K1-K8), the peak memory, the per-call check and a profiled
    guided step."""
    from magicdrive_tpu_torch.kernels import dispatch

    preset, pipe, batches = video_set_up()
    torch.cuda.reset_peak_memory_stats()
    with dispatch.fused_mode("kvstat"):
        by_path["video_16f_kvstat"], timing["s/request video 16f"] = \
            run_slice(preset, pipe, batches, "kvstat")
        log(f"video: peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            f" GiB")
        check_path_calls(preset, pipe.pipe, batches[0], "kvstat")
        profile_guided_step(preset, pipe.pipe, batches[0], "kvstat")
    del pipe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_set_up(batch_size: int):
    """The full-width model in bf16 over fp32 masters of its trainable
    partition, the recipe's optimizer with a one-step warm-up, and one
    fixture batch with images."""
    from magicdrive_tpu_torch.config import sd15mv_rawbox_224x400
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_sample)
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state

    preset = sd15mv_rawbox_224x400()
    t0 = time.perf_counter()
    modules = _new_modules(preset)
    cfg = TrainConfig(lr_warmup_steps=1)
    state = create_train_state(modules, cfg, dtype=torch.bfloat16)
    batch = collate_fn([make_sample(i, with_images=True)
                        for i in range(batch_size)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    torch.cuda.synchronize()
    n_train = sum(t.numel() for t in state.masters.values())
    log(f"training: {preset.name}, B={batch_size} ({6 * batch_size} views), "
        f"{n_train / 1e6:.1f} M trainable parameters, set up in "
        f"{time.perf_counter() - t0:.1f} s")
    return preset, modules, cfg, state, batch


def _frozen(modules):
    from magicdrive_tpu_torch.train.state import is_trainable

    params = {(n, k) for n, m in modules.items()
              for k, _ in m.named_parameters()}
    return {f"{n}.{k}": t.detach().clone() for n, m in modules.items()
            for k, t in m.state_dict().items()
            if not ((n, k) in params and is_trainable(n, k))}


def frozen_changed(modules, frozen) -> list:
    """The keys of ``_frozen(modules)`` that differ bitwise from the
    snapshot ``frozen``; a snapshot taken at another dtype than the modules
    hold now (before ``create_train_state`` casts them, say) raises, as its
    every weight would differ."""
    now = _frozen(modules)
    cast = sorted(k for k, t in now.items() if t.dtype != frozen[k].dtype)
    if cast:
        raise AssertionError(
            f"the frozen snapshot holds {len(cast)} weights at another dtype "
            f"than the modules, e.g. {cast[0]}: {frozen[cast[0]].dtype} "
            f"against {now[cast[0]].dtype}")
    return [k for k, t in now.items() if not torch.equal(t, frozen[k])]


def run_training(batch_size: int = 1, steps: int = N_TRAIN_STEPS,
                 mode: str = "kvstat"):
    """``steps`` optimizer steps through the port's Runner, one at a time,
    with the checks of the training slice; returns the set-up, the launch
    counts and the run's numbers."""
    from magicdrive_tpu_torch.cli.train import CONFIG_DIR
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.data import make_dataset
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.train import Runner

    preset, modules, cfg, state, batch = train_set_up(batch_size)
    frozen = _frozen(modules)
    masters0 = {k: t.clone() for k, t in state.masters.items()}
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    seconds = []
    with tempfile.TemporaryDirectory() as run_dir:
        # the recipe with the state's one-step warm-up, no checkpoint and
        # no validation in these steps; steps 1-3 are logged, so each loss
        # is checked for steps <= 3
        runner = Runner(compose(CONFIG_DIR, overrides=[
            "exp=224x400", "runner.lr_warmup_steps=1",
            "runner.checkpointing_steps=100000"]), preset, modules,
            make_dataset(batch_size), run_dir=run_dir)
        try:
            if runner.tcfg != cfg:
                raise AssertionError(f"{runner.tcfg} != {cfg}")
            for i in range(steps):
                t0 = time.perf_counter()
                runner.train(state, [batch])
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                if i == 0 and any(not torch.equal(state.masters[k], t)
                                  for k, t in masters0.items()):
                    raise AssertionError("a master moved at step 1 (lr 0)")
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                records = [json.loads(line) for line in f]
        finally:
            # the tensorboard writer's thread writes into run_dir until
            # closed; removing the directory under it fails
            runner.logger.close()
    launches = _check_launches(f"training ({mode})", expected_launches(
        preset, mode, steps=steps))
    peak = torch.cuda.max_memory_allocated()
    losses = [r["loss"] for r in records]
    log(f"training ({mode}): losses {losses}, grad norms "
        f"{[r['grad_norm'] for r in records]}")
    log(f"training ({mode}): seconds per step {seconds} (the first includes "
        f"one-time setup such as cuDNN algorithm choice); peak memory "
        f"{peak / 2**30:.2f} GiB")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    moved = sum(not torch.equal(state.masters[k], t)
                for k, t in masters0.items())
    log(f"training: {moved} of {len(masters0)} trainable tensors moved")
    if moved < 0.9 * len(masters0):
        raise AssertionError("the trainable weights did not move")
    changed = frozen_changed(modules, frozen)
    if changed:
        raise AssertionError(f"{len(changed)} frozen weights changed, e.g. "
                             f"{changed[:5]}")
    return (modules, cfg, state, batch), launches, {
        "seconds": seconds, "peak_bytes": peak, "losses": losses}


def _fixed_draws(cfg, batch, seed: int, drop_mask=None):
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.train.train_step import sample_draws

    B = len(batch["input_ids"])
    draws = sample_draws(cfg, NoiseSchedule.create(), B, 6, (28, 50),
                         torch.Generator("cuda").manual_seed(seed), "cuda")
    if drop_mask is not None:
        draws.drop_mask = drop_mask
    return draws


def check_drop_all(setup) -> None:
    """One step whose drop mask is all ones: every view takes the uncond
    camera and text."""
    from magicdrive_tpu_torch.train import train_step

    modules, cfg, state, batch = setup
    draws = _fixed_draws(cfg, batch, 9, torch.ones(1, 6, device="cuda"))
    loss = float(train_step(modules, state, batch, cfg, draws=draws)["loss"])
    log(f"training: one step with an all-ones drop mask, loss {loss:.5f}")
    if not np.isfinite(loss):
        raise AssertionError(f"drop-all step loss {loss}")


def check_training_calls(setup, mode, what: str = "one training step",
                         bf16_floor: bool = False, preset=None) -> None:
    """In one training step of ``setup`` (modules, TrainConfig, state,
    batch: the path's own), every kernel call (forward, recompute and
    backward) against its plain version in fp32 on the inputs the path
    gave it (``bf16_floor``: see ``_call_checker``; ``preset``: the model's
    preset where it is not the 224x400 one, for ``training_calls``); then
    the gradients of the ControlNet, of the cross-view modules and of the
    temporal ones, where the model trains them, through the kernels
    against those through the plain versions, as a smoke test."""
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.train.train_step import (batch_tensors,
                                                       loss_and_grads)

    modules, cfg, state, batch = setup
    draws = _fixed_draws(cfg, batch, 10)
    tensors = batch_tensors(batch, "cuda")
    schedule = NoiseSchedule.create()
    names = training_calls(mode, preset)
    stats = {}
    with patched_kernels(_call_checker(stats, bf16_floor), names):
        loss_k, grads_k = loss_and_grads(modules, state, tensors, draws, cfg,
                                         schedule)
    _report_calls(f"{what} ({mode})", stats, names)
    with patched_kernels(lambda name, kern, plain: outside_remat(plain),
                         names):
        loss_p, grads_p = loss_and_grads(modules, state, tensors, draws, cfg,
                                         schedule)
    rels = {}
    for group, of in (("ControlNet", lambda k: k.startswith("controlnet.")),
                      ("cross-view", lambda k: k.startswith("unet.") and any(
                          f".{m}." in k for m in ("norm4", "attn4",
                                                  "connector"))),
                      ("temporal", lambda k: "_temp" in k)):
        keys = [k for k in grads_k if of(k)]
        if keys:
            gk = torch.cat([grads_k[k].flatten() for k in keys])
            gp = torch.cat([grads_p[k].flatten() for k in keys])
            rels[group] = f"{((gk - gp).norm() / gp.norm()).item():.3e}"
    log(f"{what} ({mode}), kernels vs plain versions: loss "
        f"{loss_k.item():.6f} vs {loss_p.item():.6f}; gradient relative L2 "
        f"{rels} (a smoke test, not a gate)")


# ---------------------------------------------------------------------------
# the training CLI and the training options
# ---------------------------------------------------------------------------

# run 1 of run_train_cli: the recipe's batch, 4 steps, a checkpoint every 2
# (1 kept), validation at step 4 on 2 samples, step 3 profiled (the window
# opens after step 2 and closes after step 3)
TRAIN_CLI_ARGS = ("exp=224x400", "runner=debug", "runner.train_batch_size=3",
                  "runner.max_train_steps=4", "runner.checkpointing_steps=2",
                  "runner.checkpoints_total_limit=1",
                  "runner.validation_steps=4", "runner.validation_index=[0,1]",
                  "runner.validation_before_run=false",
                  "+runner.profile_steps=[2,3]")
OPTION_BATCH = 3  # the recipe's
FRAMES = 16       # video training: one clip of 16 frames, 96 images


@contextlib.contextmanager
def timed_calls(owners):
    """{label: [seconds, ...]} of every call, to a sync, of the functions
    ``owners`` ({label: (object, attribute name)}) in the block."""
    seconds = {label: [] for label in owners}
    saved = {label: getattr(o, n) for label, (o, n) in owners.items()}

    def wrap(label, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[label].append(time.perf_counter() - t0)
            return out
        return call

    try:
        for label, (o, n) in owners.items():
            setattr(o, n, wrap(label, saved[label]))
        yield seconds
    finally:
        for label, (o, n) in owners.items():
            setattr(o, n, saved[label])


@contextlib.contextmanager
def seeded_cli_modules(frozen_out: dict):
    """``cli.train``'s modules on this script's seeded weights (as
    ``set_up``'s); ``frozen_out`` gets their frozen tensors as built."""
    from magicdrive_tpu_torch.cli import train as train_cli

    real = train_cli.build_modules

    def build(preset, device):
        modules = real(preset, device)
        init_weights(modules, seed=0)
        frozen_out.update(_frozen(modules))
        return modules

    train_cli.build_modules = build
    try:
        yield
    finally:
        train_cli.build_modules = real


def _state_equals(state, sd) -> list:
    """The keys of ``state.state_dict()`` that differ from ``sd`` (a loaded
    checkpoint), tensors bitwise."""
    bad = []

    def walk(a, b, key):
        if isinstance(a, dict):
            if set(a) != set(b):
                bad.append(key)
            for k in a:
                if k in b:
                    walk(a[k], b[k], f"{key}/{k}")
        elif isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{key}/{i}")
        elif torch.is_tensor(a):
            if not torch.equal(a.cpu(), b.cpu()):
                bad.append(key)
        elif a != b:
            bad.append(key)

    walk(state.state_dict(), sd, "")
    return bad


def _train_cli(argv, frozen):
    from magicdrive_tpu_torch.cli import train as train_cli
    from magicdrive_tpu_torch.train import runner as runner_mod

    with seeded_cli_modules(frozen), timed_calls({
            "build": (train_cli, "build_modules"),
            "step": (runner_mod, "train_step"),
            "checkpoint": (runner_mod.Runner, "save"),
            "validation": (runner_mod.Validator, "validate"),
            "export": (runner_mod.Runner, "save_deployable")}) as seconds:
        t0 = time.perf_counter()
        run = train_cli.main(argv)
        seconds["main"] = [time.perf_counter() - t0]
    return run, seconds


def _check_cli_run(what, run, preset, frozen, card, seconds,
                   logged) -> None:
    """The frozen weights as built (in the run's dtype); ``weights/``, read
    by the generation loader into new modules, the masters (trainable, cast
    as the loader casts) and the weights as built (frozen), each tensor by
    its state_dict name; the losses of the steps ``logged`` (the runner
    logs steps 1-3 and every 10th) in metrics.jsonl and finite (the
    runner's guard raises on any other step's); prints the run's times and
    peak memory."""
    from magicdrive_tpu_torch.cli.generate import load_pipeline

    peak = torch.cuda.max_memory_allocated()
    modules, masters = run.runner.modules, run.state.masters
    changed = [k for k, t in _frozen(modules).items()
               if not torch.equal(t, frozen[k].to(t.dtype))]
    if changed:
        raise AssertionError(f"{what}: frozen weights changed: "
                             f"{changed[:5]}")
    pipe = load_pipeline(preset, os.path.join(run.run_dir, "weights"),
                         "cuda", torch.bfloat16)
    loaded = {f"{n}.{k}": t for n, m in pipe.m.items()
              for k, t in m.state_dict().items()}
    del pipe
    if set(loaded) != set(masters) | set(frozen) or set(masters) & set(
            frozen):
        raise AssertionError(f"{what}: weights/ loads "
                             f"{len(loaded)} tensors, not the "
                             f"{len(masters)} masters and {len(frozen)} "
                             f"frozen ones")
    bad = [k for k, t in loaded.items() if not torch.equal(
        t, (masters[k] if k in masters else frozen[k]).to(t.dtype))]
    if bad:
        raise AssertionError(f"{what}: weights/ differs from the masters "
                             f"or the weights as built: {bad[:5]}")
    del loaded
    with open(os.path.join(run.run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = {r["step"]: r["loss"] for r in records}
    if list(losses) != list(logged) or \
            not all(np.isfinite(list(losses.values()))):
        raise AssertionError(f"{what}: losses {losses}")
    size = os.path.getsize(os.path.join(run.run_dir, "weights",
                                        "params.npz"))
    log(f"{what}: logged losses {losses}; weights/ {size / 2**30:.3f} GiB, "
        f"loaded by cli.generate's loader: {len(masters)} tensors the "
        f"masters' and {len(frozen)} the weights as built, bitwise in bf16; "
        f"frozen weights bitwise as built; seconds: {json.dumps(seconds)}; "
        f"peak memory {peak / 2**30:.2f} GiB ({card})")


def run_cli_training(by_path, timing, card: str, tmp: str, root: str,
                     version: str) -> None:
    """Run 1 (TRAIN_CLI_ARGS), its resume to step 6, and ``cli.generate``
    on run 1's weights; see ``run_train_cli``."""
    from PIL import Image

    from magicdrive_tpu_torch.cli import generate
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)
    from magicdrive_tpu_torch.train import runner as runner_mod

    data = [f"dataset.dataset_root={root}", f"dataset.version={version}"]
    cfg = compose(generate.CONFIG_DIR, overrides=[*TRAIN_CLI_ARGS, *data])
    preset = preset_from_config(cfg)
    rc = cfg["runner"]
    val_forwards = rc["validation_times"] * \
        rc["pipeline_param"]["num_inference_steps"]

    frozen, batches = {}, []
    real_step = runner_mod.train_step

    def step(modules, state, batch, *args, **kwargs):
        batches.append(batch)  # the step's own batch, checked below
        return real_step(modules, state, batch, *args, **kwargs)

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    runner_mod.train_step = step
    try:
        with dispatch.fused_mode("kvstat"):
            run1, seconds = _train_cli(
                [*TRAIN_CLI_ARGS, *data, f"log_root_prefix={tmp}/run1"],
                frozen)
    finally:
        runner_mod.train_step = real_step
    by_path["train_cli"] = _check_launches(
        "training CLI run 1 (kvstat)", expected_launches(
            preset, "kvstat", forwards=val_forwards, steps=4))
    timing["s/step train CLI (B=3)"] = seconds["step"]
    _check_cli_run("training CLI run 1", run1, preset, frozen, card, seconds,
                   logged=[1, 2, 3])
    validator = run1.runner.validator
    # the nuScenes batch's camera tokens (|context| ~ 95) put K1's plain
    # bf16 version itself near KERNEL_TOL from fp32: bf16_floor, as in
    # run_generate_cli and run_evaluation
    with dispatch.fused_mode("kvstat"):
        check_training_calls(
            (run1.runner.modules, run1.runner.tcfg, run1.state, batches[0]),
            "kvstat", f"a training CLI step (B={len(batches[0]['input_ids'])}"
            f", step 1's batch, step 4's weights)", bf16_floor=True)
        check_path_calls(preset, validator.pipe, validator.batch()[0],
                         "kvstat", bf16_floor=True,
                         what="the training CLI's Validator")
    del batches, validator
    ckpts = sorted(os.listdir(os.path.join(run1.run_dir, "checkpoints")))
    if ckpts != ["step_00000004.pt"]:
        raise AssertionError(f"run 1 keeps {ckpts}, not step 4 alone")
    ckpt = os.path.join(run1.run_dir, "checkpoints", ckpts[0])
    log(f"checkpoint at step 4: {os.path.getsize(ckpt) / 2**30:.3f} GiB")
    pngs = sorted(os.listdir(os.path.join(run1.run_dir, "val_images")))
    H, W = preset.image_size
    if pngs != ["step4_idx0_0.png", "step4_idx1_0.png"] or any(
            np.asarray(Image.open(os.path.join(
                run1.run_dir, "val_images", f))).shape != (2 * H, 6 * W, 3)
            for f in pngs):
        raise AssertionError(f"val_images {pngs}")
    traces = os.listdir(os.path.join(run1.run_dir, "profile"))
    with open(os.path.join(run1.run_dir, "profile", traces[0])) as f:
        trace = f.read()
    if "kvstat_kernel" not in trace:
        raise AssertionError(f"the trace {traces} holds no K1 launch")
    log(f"profile: {traces}, {len(trace)} bytes, K1's kernel in it")
    masters1 = {k: t.clone() for k, t in run1.state.masters.items()}
    run_dir = run1.run_dir
    del run1
    torch.cuda.empty_cache()

    # resume: the state before step 5 is the checkpoint's, bitwise
    real_train = runner_mod.Runner.train
    entry = {}

    def train(self, state, batches, epoch=0):
        if not entry:
            sd = torch.load(ckpt, map_location="cpu", weights_only=True)
            entry["differs"] = _state_equals(state, sd)
            entry["step"] = state.step
        return real_train(self, state, batches, epoch)

    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    runner_mod.Runner.train = train
    try:
        with dispatch.fused_mode("kvstat"):
            run2, seconds = _train_cli(
                [*TRAIN_CLI_ARGS, *data, f"log_root_prefix={tmp}/run2",
                 f"resume_from_checkpoint={os.path.dirname(ckpt)}",
                 "runner.max_train_steps=6",
                 "runner.validation_before_run=true"], frozen)
    finally:
        runner_mod.Runner.train = real_train
    if entry.get("step") != 4 or entry["differs"]:
        raise AssertionError(f"the resumed state before step 5: {entry}")
    by_path["train_cli_resume"] = _check_launches(
        "training CLI resume (kvstat)", expected_launches(
            preset, "kvstat", forwards=val_forwards, steps=2))
    if run2.state.step != 6:
        raise AssertionError(f"the resumed run ended at {run2.state.step}")
    moved = sum(not torch.equal(run2.state.masters[k], t)
                for k, t in masters1.items())
    log(f"resume: the state before step 5 is the step-4 checkpoint's "
        f"bitwise (step, masters, moments, counts); steps 5-6 moved "
        f"{moved} of {len(masters1)} trainable tensors")
    if moved < 0.9 * len(masters1):
        raise AssertionError("steps 5-6 did not train")
    _check_cli_run("training CLI resume", run2, preset, frozen, card,
                   seconds, logged=[])
    shutil.rmtree(run2.run_dir)
    del run2
    torch.cuda.empty_cache()

    # generation from run 1's weights, against a pipeline on run 1's masters
    # and the weights as built, which never went through weights/
    dispatch.reset_launches()
    with dispatch.fused_mode("kvstat"):
        made = generate.main(["--run_dir", run_dir, "--indices", "0"])
        by_path["train_cli_generate"] = _check_launches(
            "generate from the trained run (kvstat)", expected_launches(
                preset, "kvstat",
                forwards=rc["pipeline_param"]["num_inference_steps"]))
        modules = MagicDriveModules.create(preset, device="cuda")
        sds = {n: {} for n, _ in modules.items()}
        for key, t in {**frozen, **masters1}.items():
            n, k = key.split(".", 1)
            sds[n][k] = t
        del masters1
        direct = MagicDrivePipeline(
            modules.load_state_dicts(sds).to("cuda", torch.bfloat16),
            preset.pipeline)
        got = direct(made.batch, latents=made.latents[0]).cpu()
    same = torch.equal(got, torch.from_numpy(made.images[0]))
    log(f"generate from the trained run: {made.seconds} s, images bitwise "
        f"those of a pipeline on run 1's masters and frozen weights: {same}")
    if not same:
        raise AssertionError("cli.generate on the trained run differs from "
                             "a pipeline on its masters")
    del made, direct, modules, sds
    shutil.rmtree(run_dir)
    torch.cuda.empty_cache()


def _option_steps(what, modules, cfg, batch, preset, by_path, recompute=False,
                  steps: int = 2):
    """``steps`` train steps at ``cfg`` from a new state of ``modules``,
    their launches counted; -> (state, masters after each step, losses,
    seconds, peak bytes)."""
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.train import create_train_state, train_step

    state = create_train_state(modules, cfg)
    masters = [{k: t.clone() for k, t in state.masters.items()}]
    losses, seconds = [], []
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with dispatch.fused_mode("kvstat"):
        for i in range(steps):
            gen = torch.Generator("cuda").manual_seed(100 + i)
            metrics, s = _timed(lambda: train_step(modules, state, batch, cfg,
                                                   generator=gen))
            losses.append(float(metrics["loss"]))
            seconds.append(s)
            masters.append({k: t.clone() for k, t in state.masters.items()})
    by_path[what] = _check_launches(f"{what} (kvstat)", expected_launches(
        preset, "kvstat", steps=steps, recompute=recompute))
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses {losses}")
    return state, masters, losses, seconds, torch.cuda.max_memory_allocated()


def _moved(a, b, keys=None) -> int:
    return sum(not torch.equal(a[k], b[k]) for k in (keys or a))


def run_train_options(by_path, timing, card: str) -> None:
    """The TrainConfig options at full width, OPTION_BATCH samples, 2 steps
    each; see ``run_train_cli``."""
    import dataclasses

    from magicdrive_tpu_torch.config import (sd15mv_rawbox_224x400,
                                             sd15mv_rawbox_video_16f)
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset, make_sample)
    from magicdrive_tpu_torch.diffusion import NoiseSchedule
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.train import TrainConfig, create_train_state
    from magicdrive_tpu_torch.train.train_step import (batch_tensors,
                                                       loss_and_grads)

    preset = sd15mv_rawbox_224x400()
    modules = _new_modules(preset)
    batch = collate_fn([make_sample(i, with_images=True)
                        for i in range(OPTION_BATCH)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    base = TrainConfig(lr_warmup_steps=0)

    state, masters, losses, s, _ = _option_steps(
        "train_8bit", modules, dataclasses.replace(base, use_8bit_adam=True),
        batch, preset, by_path)
    sd = state.opt.state_dict()
    q_bytes = sum(t.numel() * t.element_size() for m in ("mu", "nu")
                  for qs in sd[m].values() for t in qs.values())
    n = sum(t.numel() for t in state.masters.values())
    moved = _moved(masters[0], masters[2])
    log(f"8-bit AdamW: moments {q_bytes} bytes ({q_bytes / n:.4f} per "
        f"parameter) against fp32 AdamW's {8 * n} (8 per parameter) over "
        f"{n} trainable parameters; losses {losses}, s/step {s}; {moved} "
        f"of {len(masters[0])} trainable tensors moved ({card})")
    if moved < 0.9 * len(masters[0]):
        raise AssertionError("8-bit AdamW: the masters did not move")
    del state, masters

    state, masters, losses, s, _ = _option_steps(
        "train_accumulation", modules,
        dataclasses.replace(base, gradient_accumulation_steps=2), batch,
        preset, by_path)
    m1, m2 = _moved(masters[0], masters[1]), _moved(masters[0], masters[2])
    log(f"gradient accumulation 2: {m1} tensors moved after micro-step 1, "
        f"{m2} after 2; losses {losses}")
    if m1 or m2 < 0.9 * len(masters[0]):
        raise AssertionError("gradient accumulation: the masters moved "
                             f"{m1} / {m2}")
    del state, masters

    state, masters, losses, s, _ = _option_steps(
        "train_cosine", modules,
        dataclasses.replace(base, lr_schedule="cosine", lr_warmup_steps=1,
                            max_train_steps=2), batch, preset, by_path)
    m1, m2 = _moved(masters[0], masters[1]), _moved(masters[0], masters[2])
    log(f"cosine schedule (warm-up 1 of 2 steps): {m1} tensors moved at "
        f"lr 0, {m2} after the peak step; losses {losses}")
    if m1 or m2 < 0.9 * len(masters[0]):
        raise AssertionError(f"cosine: moved {m1} / {m2}")
    del state, masters
    torch.cuda.empty_cache()

    # gradient checkpointing: the same weights (seed 0) built with and
    # without remat (the options above moved ``modules``)
    del modules
    modules = _new_modules(preset)
    schedule = NoiseSchedule.create()
    tensors = batch_tensors(batch, "cuda")
    draws = _fixed_draws(base, batch, 12)

    def grads_of(mods, recompute, mode):
        st = create_train_state(mods, base)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        sec = []
        with dispatch.fused_mode(mode):
            for _ in range(2):  # the first call cold
                grads = None
                (loss, grads), s = _timed(lambda: loss_and_grads(
                    mods, st, tensors, draws, base, schedule))
                sec.append(s)
        label = f"train_{'remat_' + str(policy) if recompute else 'plain'}" \
            f"_{mode}"
        by_path[label] = _check_launches(label, expected_launches(
            preset, mode, steps=2, recompute=recompute))
        peak = torch.cuda.max_memory_allocated() - before
        flat = torch.cat([g.flatten() for g in grads.values()])
        del st, grads
        return float(loss), flat, sec, peak

    # without remat in both fused modes, then "dots" in both (its recompute
    # under "auto" runs K8 and its pair again) and None under "kvstat"
    policy = None
    plain = {mode: grads_of(modules, False, mode)
             for mode in dispatch.FUSED_MODES}
    for policy, modes in (("dots", dispatch.FUSED_MODES), (None, ("kvstat",))):
        p = dataclasses.replace(preset, unet=dataclasses.replace(
            preset.unet, gradient_checkpointing=True, remat_policy=policy))
        p = dataclasses.replace(p, controlnet=dataclasses.replace(
            p.controlnet, unet=dataclasses.replace(
                p.controlnet.unet, gradient_checkpointing=True,
                remat_policy=policy)))
        remat_modules = _new_modules(p)
        for mode in modes:
            loss0, g0, sec0, peak0 = plain[mode]
            loss, g, sec, peak = grads_of(remat_modules, True, mode)
            rel = ((g - g0).norm() / g0.norm()).item()
            log(f"gradient checkpointing ({policy}, {mode}): loss "
                f"{loss:.6f} against {loss0:.6f} without (relative "
                f"{abs(loss - loss0) / loss0:.3e}, limit 1e-3); trainable "
                f"gradient relative L2 {rel:.3e} (limit {EPS_TOL}); the "
                f"step's activation peak {peak / 2**30:.2f} GiB against "
                f"{peak0 / 2**30:.2f} without; seconds (cold, warm) {sec} "
                f"against {sec0} ({card})")
            if abs(loss - loss0) > 1e-3 * abs(loss0) or not rel <= EPS_TOL:
                raise AssertionError(f"gradient checkpointing ({policy}, "
                                     f"{mode}) changed the step")
            del g
            if policy == "dots":  # the recompute's kernel calls checked
                with dispatch.fused_mode(mode):
                    check_training_calls(
                        (remat_modules, base,
                         create_train_state(remat_modules, base), batch),
                        mode, f'a remat "dots" step (B={OPTION_BATCH})')
        del remat_modules
        torch.cuda.empty_cache()
    del modules, plain, tensors
    torch.cuda.empty_cache()

    # video training: one 16-frame clip, remat "dots"
    vp = sd15mv_rawbox_video_16f()
    vp = dataclasses.replace(vp, unet=dataclasses.replace(
        vp.unet, gradient_checkpointing=True, remat_policy="dots"))
    vp = dataclasses.replace(vp, controlnet=dataclasses.replace(
        vp.controlnet, unet=dataclasses.replace(
            vp.controlnet.unet, gradient_checkpointing=True,
            remat_policy="dots")))
    vmodules = _new_modules(vp)
    clip = collate_fn(make_dataset(FRAMES, image_hw=vp.image_size,
                                   map_hw=vp.map_hw, with_images=True),
                      CollateConfig(bbox_max_len=vp.bbox_max_len))
    frozen = _frozen(vmodules)
    vcfg = dataclasses.replace(base, frames_per_clip=FRAMES)
    state, masters, losses, s, peak = _option_steps(
        "train_video_16f", vmodules, vcfg, clip, vp, by_path,
        recompute=True)
    temp = [k for k in masters[0] if "_temp" in k]
    moved = _moved(masters[0], masters[2], temp)
    changed = [k for k, t in _frozen(vmodules).items()
               if not torch.equal(t, frozen[k].to(t.dtype))]
    timing["s/step video 16f training"] = s
    log(f"video training ({FRAMES} frames x 6 views, remat dots): losses "
        f"{losses}, s/step {s} (the first cold), peak memory "
        f"{peak / 2**30:.2f} GiB; {moved} of {len(temp)} temporal tensors "
        f"moved; frozen changed: {len(changed)} ({card})")
    if not temp or moved < 0.9 * len(temp) or changed:
        raise AssertionError(f"video training: temporal moved {moved} of "
                             f"{len(temp)}, frozen changed {changed[:5]}")
    del masters, frozen
    with dispatch.fused_mode("kvstat"):
        check_training_calls((vmodules, vcfg, state, clip), "kvstat",
                             f"a {FRAMES}-frame video training step "
                             f'({FRAMES * 6} images, remat "dots")')
    del vmodules, state
    torch.cuda.empty_cache()


def run_cache(by_path, card: str, tmp: str, root: str, version: str) -> None:
    """``cli.prepare_cache`` on the tree, then a dataset on the cache: its
    maps bitwise the rasterized ones, and one full-width training step on a
    batch of it; where h5py does not import, logged and skipped (host
    code: no kernel and no device work hides behind it)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        log("cache: h5py does not import here; cli.prepare_cache and the "
            "cached dataset were not run")
        return
    from magicdrive_tpu_torch.cli import prepare_cache
    from magicdrive_tpu_torch.cli.generate import CONFIG_DIR
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.data import CollateConfig
    from magicdrive_tpu_torch.data.datasets import build_datasets
    from magicdrive_tpu_torch.data.loader import DataLoader
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.train import (create_train_state, runner,
                                            train_step)

    path = os.path.join(tmp, "cache.h5")
    _, sec = _timed(lambda: prepare_cache.main([
        "--dataroot", root, "--version", version, "--out", path,
        "--workers", "2"]))
    data = ["exp=224x400", f"dataset.dataset_root={root}",
            f"dataset.version={version}"]
    cfg = compose(CONFIG_DIR, overrides=data)
    cached = build_datasets(compose(CONFIG_DIR, overrides=[
        *data, f"dataset.cache_file.train={path}"]))[0]
    rastered = build_datasets(cfg)[0]
    same = [np.array_equal(cached[i]["bev_map"], rastered[i]["bev_map"])
            for i in range(len(rastered))]
    tcfg = runner.train_config_from_cfg(cfg["runner"])
    ccfg = CollateConfig(bbox_max_len=cfg["runner"]["bbox_max_length"])
    batches = [next(iter(DataLoader(ds, 3, ccfg))) for ds in (cached,
                                                              rastered)]
    same_batch = np.array_equal(batches[0]["bev_map"],
                                batches[1]["bev_map"])
    log(f"cache: {os.path.getsize(path)} bytes for {len(rastered)} frames, "
        f"written in {sec:.2f} s; maps bitwise the rasterized ones: {same}; "
        f"the batch's bev_map bitwise: {same_batch}")
    if not all(same) or not same_batch or cached.cache is None:
        raise AssertionError("the cached maps differ from the rasterized")
    preset = preset_from_config(cfg)
    modules = _new_modules(preset)
    state = create_train_state(modules, tcfg)
    batch = dict(batches[0], bev_map=batches[0]["bev_map"][
        ..., :cfg["dataset"]["map_channels_used"]])
    dispatch.reset_launches()
    with dispatch.fused_mode("kvstat"):
        loss = float(train_step(modules, state, batch, tcfg,
                                generator=torch.Generator("cuda")
                                .manual_seed(0))["loss"])
    by_path["train_cache"] = _check_launches(
        "a training step on the cached batch (kvstat)",
        expected_launches(preset, "kvstat", steps=1))
    log(f"cache: one training step on the cached nuScenes batch (B=3), "
        f"loss {loss:.5f} ({card})")
    if not np.isfinite(loss):
        raise AssertionError(f"cached batch loss {loss}")
    del modules, state
    torch.cuda.empty_cache()


def run_train_cli(by_path, timing, card: str) -> None:
    """The training entry point as users run it, at full width
    (sd15mv_rawbox_224x400, bf16, this script's seeded weights), under
    "kvstat", on a synthetic nuScenes tree in a temporary directory.
      1. ``cli.train.main`` with TRAIN_CLI_ARGS: the losses finite; only
         step 4 kept under checkpoints/; the two val_images PNGs; a trace
         under profile/ holding K1's kernel; weights/, loaded by the
         generation loader, equal to the masters (trainable) and the
         weights as built (frozen); the frozen weights bitwise as built;
         the launch counts those derived for 4 steps and the Validator's
         forwards; every kernel call of a step on the run's first batch
         and of a guided step of its Validator against the plain version.
         Prints the seconds of the build, each step, each checkpoint
         write, the validation and the export, and the peak memory.
      2. A second run resumed from run 1's checkpoints to step 6
         (validation first): before step 5 the step, the masters, both
         moment sets and both counts bitwise the checkpoint's; steps 5-6
         move the masters.
      3. ``cli.generate`` on run 1 (one request): its images bitwise those
         of a pipeline built here from run 1's masters and the frozen
         weights as built, not from weights/.
      4. The options at OPTION_BATCH samples, 2 steps each: 8-bit AdamW
         (the moments' bytes against fp32 AdamW's; the masters move);
         gradient accumulation 2 (no move after micro-step 1, a move after
         2); the cosine schedule; gradient checkpointing with "dots" (under
         "kvstat" and "auto") and None on fixed draws against the same
         weights without (loss within 1e-3 relative, the trainable gradient
         within EPS_TOL relative L2, the activation peaks, the launches
         with the recompute), and every kernel call of a "dots" step in
         each mode against its plain version.
      5. Video training: sd15mv_rawbox_video_16f with remat "dots", one
         clip of FRAMES frames (96 images), frames_per_clip FRAMES, 2
         steps: losses finite, the temporal weights move, the frozen
         weights do not; s/step and peak memory; then every kernel call
         of one more step against its plain version.
      6. The cache (``run_cache``)."""
    from magicdrive_tpu_torch.data.synth import make_mini_nuscenes

    with tempfile.TemporaryDirectory() as tmp:
        root, version = make_mini_nuscenes(os.path.join(tmp, "nuscenes"))
        run_cli_training(by_path, timing, card, tmp, root, version)
        run_train_options(by_path, timing, card)
        run_cache(by_path, card, tmp, root, version)


# ---------------------------------------------------------------------------
# multi-GPU: the process group, data-parallel training, view-sharded
# sampling and val_set_gen --multihost
# ---------------------------------------------------------------------------

RANK_TIMEOUT = 420      # seconds a job of ranks may take
DP_STEPS = 3            # dp=2 training steps a mode, then one checked step
# dp=2 against one process at B=2 after DP_STEPS: the logged gradient
# norms' relative error, and the relative L2 of the update (the masters
# minus those before the steps) and of Adam's first moment, which keeps the
# gradient's scale where AdamW's update does not. Read on an H100:
# 6.7e-05, 2.7e-03, 1.2e-03; with rank 0's half-batch gradient applied on
# both ranks 4.4e-02, 1.6e-01, 7.2e-02.
DP_NORM_TOL, DP_UPDATE_TOL, DP_MOMENT_TOL = 5e-3, 2e-2, 1e-2
# the dp=2 ranks' Runner: the recipe's optimizer with a one-step warm-up
# (train_set_up's), B=1 a rank, no checkpoint in the steps
DP_ARGS = ("exp=224x400", "runner.lr_warmup_steps=1",
           "runner.checkpointing_steps=100000", "runner.train_batch_size=1",
           "parallel.mesh_shape=[2,1]")
# the NCCL run of the training CLI: B=1, 2 steps (the first at lr 0) on the
# fixture scenes, its checkpoint and weights at the end
NCCL_ARGS = ("exp=224x400", "runner.train_batch_size=1",
             "runner.lr_warmup_steps=1", "runner.max_train_steps=2",
             "runner.num_workers=1")


def _checksums(tensors) -> list:
    """One exact integer a tensor from its bits (weighted by position), so
    equal lists mean bitwise equal tensors but for a collision."""
    out = []
    for t in tensors.values():
        bits = t.detach().reshape(-1).view(torch.int32).to(torch.int64)
        w = torch.arange(1, bits.numel() + 1, device=bits.device) % 65521
        out.append(int((bits * w).sum()))
    return out


def _fresh_state(masters0, cfg):
    from magicdrive_tpu_torch.train.state import TrainState, make_optimizer

    masters = {k: t.clone() for k, t in masters0.items()}
    return TrainState(0, masters, make_optimizer(masters, cfg))


def _one_process(runner, modules, cfg, masters0, batch) -> tuple:
    """DP_STEPS steps of one process at the global batch from ``masters0``
    with the draws the Runner makes (a generator seeded from seed and
    step), without a mesh; -> (state, losses, gradient norms, seconds)."""
    from magicdrive_tpu_torch.train import train_step

    state = _fresh_state(masters0, cfg)
    batch = dict(batch, bev_map=batch["bev_map"][..., :runner.map_channels])
    losses, norms, seconds = [], [], []
    for _ in range(DP_STEPS):
        gen = torch.Generator("cuda").manual_seed(
            runner.seed * 1_000_003 + state.step)
        t0 = time.perf_counter()
        m = train_step(modules, state, batch, cfg, generator=gen,
                       schedule=runner.schedule)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        seconds.append(time.perf_counter() - t0)
    return state, losses, norms, seconds


def first_moments(state) -> dict:
    """Adam's first moment of every trainable tensor in fp32 (the 8-bit
    optimizer's dequantized). Unlike AdamW's update it keeps the
    gradient's scale."""
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


def _rank_train(out: str) -> dict:
    """(2a) on one rank, per fused mode: DP_STEPS dp=2 steps through the
    Runner (``parallel.mesh_shape=[2,1]``) at B=1, this rank's row of a
    global fixture batch of 2, the masters' checksums of both ranks after
    each step; the launch counts; one more dp step with every kernel call
    of rank 0's against its plain version (KERNEL_TOL); the frozen weights
    bitwise unchanged. Rank 0 then takes DP_STEPS steps of one process at
    B=2 from the same masters and draws and holds the dp run to them."""
    from magicdrive_tpu_torch.cli.train import CONFIG_DIR
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset, make_sample)
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.parallel import multihost, shard_batch
    from magicdrive_tpu_torch.train import Runner

    rank = multihost.process_index()
    preset, modules, cfg, state0, _ = train_set_up(1)
    masters0 = {k: t.clone() for k, t in state0.masters.items()}
    del state0
    frozen = _frozen(modules)
    batch = collate_fn([make_sample(i, with_images=True) for i in range(2)],
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    res = {}
    for mode in dispatch.FUSED_MODES:
        with dispatch.fused_mode(mode):
            run_dir = os.path.join(out, f"dp_{mode}")
            runner = Runner(compose(CONFIG_DIR, overrides=list(DP_ARGS)),
                            preset, modules, make_dataset(2),
                            run_dir=run_dir)
            if runner.tcfg != cfg:
                raise AssertionError(f"{runner.tcfg} != {cfg}")
            local = shard_batch(batch, runner.mesh)
            state = _fresh_state(masters0, cfg)
            torch.cuda.reset_peak_memory_stats()
            dispatch.reset_launches()
            seconds, equal = [], []
            for _ in range(DP_STEPS):
                t0 = time.perf_counter()
                runner.train(state, [local])
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                a, b = multihost.all_gather_objects(_checksums(state.masters))
                equal.append(a == b)
            launches = dict(dispatch.LAUNCHES)
            want = expected_launches(preset, mode, steps=DP_STEPS)
            if launches != want:
                raise AssertionError(f"rank {rank}, dp=2 ({mode}): launches "
                                     f"{launches}, derived {want}")
            if not all(equal):
                raise AssertionError(f"dp=2 ({mode}): the ranks' masters "
                                     f"differ after the steps {equal}")
            peak = torch.cuda.max_memory_allocated()
            dp_masters = {k: t.clone() for k, t in state.masters.items()}
            dp_moments = {k: t.clone() for k, t in
                          first_moments(state).items()}
            stats, names = {}, training_calls(mode)
            checker = _call_checker(stats) if rank == 0 else \
                (lambda name, kern, plain: kern)
            with patched_kernels(checker, names):
                runner.train(state, [local])
            if rank == 0:
                _report_calls(f"a dp=2 training step of rank 0 ({mode})",
                              stats, names)
            runner.logger.close()
            changed = frozen_changed(modules, frozen)
            if changed:
                raise AssertionError(f"rank {rank}: {len(changed)} frozen "
                                     f"weights changed, e.g. {changed[:5]}")
            r = {"seconds": seconds, "peak_gib": peak / 2**30,
                 "tensors": len(masters0),
                 "launches": launches, "ranks_bitwise_equal": equal,
                 "moved": sum(not torch.equal(dp_masters[k], t)
                              for k, t in masters0.items())}
            if rank == 0:
                with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                    logged = [json.loads(x) for x in f]
                r["losses"] = [x["loss"] for x in logged]
                r["norms"] = [x["grad_norm"] for x in logged]
                torch.cuda.reset_peak_memory_stats()
                ref, r["one_losses"], r["one_norms"], r["one_seconds"] = \
                    _one_process(runner, modules, cfg, masters0, batch)
                r["one_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                r["masters_rel_l2"] = rel_l2(dp_masters, ref.masters)
                r["update_rel_l2"] = rel_l2(
                    {k: t - masters0[k] for k, t in dp_masters.items()},
                    {k: t - masters0[k] for k, t in ref.masters.items()})
                r["moment_rel_l2"] = rel_l2(dp_moments, first_moments(ref))
                r["moved_one"] = sum(not torch.equal(ref.masters[k], t)
                                     for k, t in masters0.items())
                del ref
            del dp_masters, dp_moments, state
            torch.cuda.empty_cache()
            multihost.barrier("one-process reference")
            res[mode] = r
    return res


def mgpu_latents(preset) -> torch.Tensor:
    """(1, n_cam, h, w, 4): a latent per view, so a cross-view exchange
    that mixes up cameras would show."""
    c = preset.pipeline
    return torch.randn((1, c.n_cam, c.latent_height, c.latent_width, 4),
                       generator=torch.Generator("cuda").manual_seed(13),
                       device="cuda")


def _rank_sample(out: str) -> dict:
    """(2b) on one rank: the full-width pipeline (this script's seeded
    weights) on a (dp=1, view=2) mesh, one request of set_up's first
    fixture batch under "kvstat" from mgpu_latents, this rank's 3 cameras;
    its launch counts equal to those derived for view-sharded attn4 and
    one gather a cross-view block and step; then every kernel call of one
    guided step against its plain version, on the gathered inputs. The
    rank of view index 0 then makes the unsharded request of the same
    batch and latents (out/sample_ref.pt)."""
    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.parallel import (COLLECTIVES, make_mesh,
                                               shard_batch)
    from magicdrive_tpu_torch.parallel.mesh import local_views
    from magicdrive_tpu_torch.parallel.multihost import reset_collectives
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDrivePipeline

    preset = config.sd15mv_rawbox_224x400()
    modules = _new_modules(preset).to("cuda", preset.pipeline.dtype)
    mesh = make_mesh((1, 2))
    pipe = MagicDrivePipeline(modules, preset.pipeline, mesh=mesh)
    batch = collate_fn(make_dataset(1, image_hw=preset.image_size,
                                    map_hw=preset.map_hw,
                                    map_channels=preset.map_channels),
                       CollateConfig(bbox_max_len=preset.bbox_max_len))
    local = shard_batch(dict(batch, latents=mgpu_latents(preset)), mesh,
                        n_cam=preset.pipeline.n_cam)
    steps = preset.pipeline.num_inference_steps
    blocks = sum(getattr(b, "cross_view", False)
                 for b in modules.unet.modules())
    res = {"views": list(range(preset.pipeline.n_cam))[
        local_views(mesh, preset.pipeline.n_cam)]}
    with dispatch.fused_mode("kvstat"):
        dispatch.reset_launches()
        reset_collectives()
        img, res["seconds"] = _timed(lambda: pipe(local,
                                                  latents=local["latents"]))
        launches = dict(dispatch.LAUNCHES)
        want = expected_launches(preset, "kvstat", forwards=steps, view=2)
        if launches != want:
            raise AssertionError(f"view-sharded request launches "
                                 f"{launches}, derived {want}")
        if COLLECTIVES["all_gather"] != blocks * steps:
            raise AssertionError(f"{COLLECTIVES['all_gather']} gathers, not "
                                 f"{blocks} blocks x {steps} steps")
        res.update(launches=launches, gathers=COLLECTIVES["all_gather"])
        torch.save(img.cpu(), os.path.join(
            out, f"sample_{mesh.index('view')}.pt"))
        h, w = preset.pipeline.latent_height, preset.pipeline.latent_width
        x = torch.randn((1, pipe.n_views, 4, h, w), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(
                            7 + mesh.index("view")))
        stats = {}
        names = tuple(k for k, v in want.items() if v)
        with patched_kernels(_call_checker(stats), names):
            pipe.guided_eps(x, int(pipe.coeffs.timesteps[0]),
                            pipe.conditioning(local))
        _report_calls(f"a view-sharded guided step, cameras {res['views']}",
                      stats, names)
        res["worst"] = {k: v[1] for k, v in stats.items()}
        if mesh.index("view") == 0:  # the unsharded request, rank 1 idle
            ref, res["unsharded_seconds"] = _timed(lambda: MagicDrivePipeline(
                modules, preset.pipeline)(batch, latents=mgpu_latents(preset)))
            torch.save(ref.cpu(), os.path.join(out, "sample_ref.pt"))
    return res


def _rank_val_set_gen(out: str, run_dir: str, root: str,
                      version: str) -> dict:
    """(2c) on one rank: ``cli.val_set_gen --multihost`` into out/vsg."""
    from magicdrive_tpu_torch.cli import val_set_gen
    from magicdrive_tpu_torch.kernels import dispatch

    dispatch.reset_launches()
    with dispatch.fused_mode("kvstat"):
        made = val_set_gen.main(
            ["--run_dir", run_dir, "--out", os.path.join(out, "vsg"),
             "--multihost", f"dataset.dataset_root={root}",
             f"dataset.version={version}"])
    return {"samples": len(made.dataset), "seconds": made.seconds,
            "launches": dict(dispatch.LAUNCHES)}


PARTS = ("train", "sample", "val_set_gen")


def rank_main(argv) -> None:
    """A rank of the multi-GPU phase's gloo job (``torchrun ...
    chip_smoke.py --rank OUT RUN_DIR ROOT VERSION``): it loads the kernel library the
    parent built, joins the group from the environment under gloo (the two
    ranks share the one card) and runs (2a), (2b) and (2c); its results go
    to OUT/rank<r>.json."""
    from magicdrive_tpu_torch.kernels import build
    from magicdrive_tpu_torch.parallel import multihost

    out, run_dir, root, version = argv
    if not build.library_path().exists():
        raise RuntimeError("the kernel library is not built: the parent "
                           "builds it before it starts the ranks")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not multihost.initialize_if_needed(backend="gloo", device="cuda"):
        raise RuntimeError("not started as a rank (no env:// variables)")
    rank = multihost.process_index()
    res = {"rank": rank, "backend": multihost.backend(),
           "device": str(multihost.rank_device("cuda"))}
    for part, fn in (("train", lambda: _rank_train(out)),
                     ("sample", lambda: _rank_sample(out)),
                     ("val_set_gen", lambda: _rank_val_set_gen(
                         out, run_dir, root, version))):
        t0 = time.perf_counter()
        res[part] = fn()
        res[part]["part_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        multihost.barrier(part)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    multihost.shutdown()


def torchrun(args, nproc: int, what: str, log_dir: str) -> list:
    """``python -m torch.distributed.run --standalone
    --nproc_per_node=nproc args`` from this script's directory, each rank's
    output under ``log_dir``, within RANK_TIMEOUT; -> each rank's stdout.
    A rank that fails fails the job: this raises, naming ``what``, with
    every rank's stderr. At the time limit the launcher is told to stop its
    ranks (SIGTERM), then killed."""
    import glob
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", "--redirects", "3", "--log-dir",
           log_dir, *args]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        text, late = proc.communicate(timeout=RANK_TIMEOUT)[0], False
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
            f"{what}: " + (f"stopped at {RANK_TIMEOUT} s; " if late else "")
            + f"exit {proc.returncode}: {text[-2000:]}" +
            "".join(f"\n-- rank {r}: {rank_log(r, 'stderr.log')[-3000:]}"
                    for r in range(nproc)))
    return [rank_log(r, "stdout.log") for r in range(nproc)]


def _log_rank(rank: int, output: str) -> None:
    """A rank's own log lines (the script's), prefixed with its rank."""
    for line in output.splitlines():
        if line.startswith(("training:", "path calls", "[process")):
            log(f"  [rank {rank}] {line}")


def run_nccl_cli(card: str, tmp: str) -> None:
    """(1) ``python -m magicdrive_tpu_torch.cli.train`` at B=1, 2 steps,
    as a torchrun job of one rank with ``parallel.multihost=true``: train.log names the nccl backend and
    counts one all-reduce a bucket and step; its losses against the same
    run in this process without a process group, made while the child
    runs (its checkpoint and export left out), bitwise or within EPS_TOL
    relative."""
    import re
    import threading

    from magicdrive_tpu_torch.cli import train as train_cli
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose
    from magicdrive_tpu_torch.pipeline.pipeline import MagicDriveModules
    from magicdrive_tpu_torch.train import runner as runner_mod
    from magicdrive_tpu_torch.train.state import trainable_parameters
    from magicdrive_tpu_torch.train.train_step import buckets

    args = [*NCCL_ARGS, f"dataset.dataset_root={tmp}/none"]
    child = {}

    def run_child():
        t0 = time.perf_counter()
        try:
            child["res"] = torchrun(
                ["-m", "magicdrive_tpu_torch.cli.train", *args,
                 "parallel.multihost=true", f"log_root_prefix={tmp}/nccl"],
                1, "the NCCL training CLI", os.path.join(tmp, "nccl_logs"))
        except BaseException as e:  # raised below, in this thread
            child["error"] = e
        child["wall"] = time.perf_counter() - t0

    # the same run without a process group, here, while the child runs
    # (its checkpoint and export left out)
    thread = threading.Thread(target=run_child)
    thread.start()
    saved = runner_mod.Runner.save, runner_mod.Runner.save_deployable
    runner_mod.Runner.save = runner_mod.Runner.save_deployable = \
        lambda self, state: None
    try:
        one = train_cli.main([*args, f"log_root_prefix={tmp}/alone"])
    finally:
        runner_mod.Runner.save, runner_mod.Runner.save_deployable = saved
        thread.join()
    if "error" in child:
        raise child["error"]
    wall = child["wall"]
    with open(os.path.join(one.run_dir, "metrics.jsonl")) as f:
        alone = [json.loads(x)["loss"] for x in f]
    del one
    torch.cuda.empty_cache()
    run_dir = os.path.join(tmp, "nccl", os.listdir(
        os.path.join(tmp, "nccl"))[0])
    with open(os.path.join(run_dir, "train.log")) as f:
        text = f.read()
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        losses = [json.loads(x)["loss"] for x in f]
    preset = preset_from_config(compose(train_cli.CONFIG_DIR,
                                        overrides=list(args)))
    sizes = [p.numel() for p in trainable_parameters(
        MagicDriveModules.create(preset, device="meta")).values()]
    want = 2 * len(buckets(sizes + [1]))
    m = re.search(r"collectives \{'all_reduce': (\d+)", text)
    if "rank 0 of 1 (backend nccl)" not in text or not m or \
            int(m.group(1)) != want:
        raise AssertionError(f"the NCCL run's log: backend or all-reduces "
                             f"(want {want}): {text[-1500:]}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, alone))
    log(f"multi-GPU (1): cli.train as a 1-rank NCCL job, {want} all-reduces "
        f"({want // 2} buckets a step), losses {losses} vs {alone} without a "
        f"process group: bitwise {losses == alone}, max relative "
        f"{rel:.3e}; {wall:.1f} s from launch to exit, its checkpoint and "
        f"export included, beside the run without a group ({card})")
    if len(losses) != 2 or not rel <= EPS_TOL:
        raise AssertionError(f"NCCL losses {losses} vs {alone}")


def _val_set_for_mgpu(tmp: str) -> dict:
    """A run directory of this script's seeded 224x400 weights, a synthetic
    tree of EVAL_SAMPLES samples and one process's val_set_gen on it: what
    run_evaluation leaves, for this phase run alone."""
    from magicdrive_tpu_torch.cli import val_set_gen
    from magicdrive_tpu_torch.cli.generate import CONFIG_DIR
    from magicdrive_tpu_torch.config import preset_from_config
    from magicdrive_tpu_torch.config_loader import compose, save_run_config
    from magicdrive_tpu_torch.convert import modules_to_jax_params
    from magicdrive_tpu_torch.data.synth import make_mini_nuscenes
    from magicdrive_tpu_torch.kernels import dispatch
    from magicdrive_tpu_torch.utils.serialization import save_params

    overrides = ["exp=224x400"]
    cfg = compose(CONFIG_DIR, overrides=overrides)
    run_dir = os.path.join(tmp, "run")
    save_run_config(cfg, run_dir, overrides)
    save_params(modules_to_jax_params(_new_modules(preset_from_config(cfg))),
                os.path.join(run_dir, "weights"))
    torch.cuda.empty_cache()
    root, version = make_mini_nuscenes(os.path.join(tmp, "nuscenes"),
                                       n_samples=EVAL_SAMPLES,
                                       images_per_sample=True)
    out = os.path.join(tmp, "generated")
    with dispatch.fused_mode("kvstat"):
        val_set_gen.main(["--run_dir", run_dir, "--out", out,
                          f"dataset.dataset_root={root}",
                          f"dataset.version={version}"])
    return {"run_dir": run_dir, "root": root, "version": version,
            "out": out}


def _first_pngs(evaluation: dict) -> list:
    """The PNG names of the tree's first validation sample, rep 0."""
    from magicdrive_tpu_torch.cli.generate import CONFIG_DIR
    from magicdrive_tpu_torch.config_loader import compose, load_run_overrides
    from magicdrive_tpu_torch.data.datasets import build_datasets

    cfg = compose(CONFIG_DIR, overrides=load_run_overrides(
        evaluation["run_dir"]) + [
        f"dataset.dataset_root={evaluation['root']}",
        f"dataset.version={evaluation['version']}"])
    return [os.path.splitext(os.path.basename(f))[0] + "_gen0.png"
            for f in build_datasets(cfg)[1].filenames(0)]


def run_multi_gpu(by_path, timing, card: str,
                  evaluation: dict = None) -> None:
    """The port across processes on the one card:
      1. NCCL at world size 1 through the training CLI (run_nccl_cli);
      2. a gloo job of two ranks on the card (rank_main), full width:
         (a) dp=2 training in both fused modes (_rank_train): the ranks'
             masters bitwise equal after every step, the launch counts,
             every kernel call of a rank-0 step within KERNEL_TOL, the
             frozen weights bitwise unchanged; against one process at
             B=2 on the same draws, the per-step losses within EPS_TOL
             relative, the gradient norms within DP_NORM_TOL, and after
             the last step the update and Adam's first moment within
             DP_UPDATE_TOL and DP_MOMENT_TOL relative L2;
         (b) a (dp=1, view=2) request (_rank_sample): the two ranks'
             cameras put together within EPS_TOL relative L2 of the
             unsharded request from the same latents, which rank 0 then
             makes; the launch counts of view-sharded attn4 (K1 once a
             neighbour list over the gathered cameras, no K2); every kernel
             call of a sharded guided step within KERNEL_TOL;
         (c) ``cli.val_set_gen --multihost`` on ``evaluation``'s run and
             tree (run_evaluation's, or made here): the union of the
             ranks' PNG names that of one process's run, and rank 0's
             first sample's PNGs (the same sample and latents as one
             process's first) bitwise that run's.
    Prints s/step at dp=2 against one process at B=2, the peak memory a
    rank, and s/request of the sharded request, with the card."""
    from PIL import Image

    from magicdrive_tpu_torch import config
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.kernels import dispatch

    with tempfile.TemporaryDirectory() as tmp:
        run_nccl_cli(card, tmp)
        if evaluation is None:
            evaluation = _val_set_for_mgpu(tmp)
        out = os.path.join(tmp, "ranks")
        os.makedirs(out)
        t0 = time.perf_counter()
        outputs = torchrun(
            [os.path.abspath(__file__), "--rank", out, evaluation["run_dir"],
             evaluation["root"], evaluation["version"]], 2,
            "the gloo job of two ranks", os.path.join(tmp, "gloo_logs"))
        wall = time.perf_counter() - t0
        for rank, output in enumerate(outputs):
            _log_rank(rank, output)
        res = []
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                res.append(json.load(f))
        log(f"multi-GPU (2): two gloo ranks on the card, {wall:.1f} s from "
            f"launch to exit; devices {[x['device'] for x in res]}; seconds "
            f"of each part " + json.dumps([{p: round(x[p]["part_s"], 1)
                                            for p in PARTS} for x in res]))
        for r, x in enumerate(res):
            by_path[f"dp2_train_rank{r}"] = {
                k: sum(x["train"][m]["launches"][k]
                       for m in dispatch.FUSED_MODES)
                for k in dispatch.LAUNCHES}
            by_path[f"view2_request_rank{r}"] = x["sample"]["launches"]
            by_path[f"val_set_gen_rank{r}"] = x["val_set_gen"]["launches"]

        # (a)
        for mode in dispatch.FUSED_MODES:
            a, b = (x["train"][mode] for x in res)
            rel = max(abs(p - q) / abs(q) for p, q in zip(a["losses"],
                                                          a["one_losses"]))
            norm = max(abs(p - q) / abs(q) for p, q in zip(a["norms"],
                                                           a["one_norms"]))
            log(f"multi-GPU (2a) {mode}: dp=2 losses {a['losses']} vs one "
                f"process at B=2 {a['one_losses']} (max relative {rel:.3e});"
                f" gradient norms {a['norms']} vs {a['one_norms']} (max "
                f"relative {norm:.3e}, limit {DP_NORM_TOL}); after step "
                f"{DP_STEPS} the update {a['update_rel_l2']:.3e} relative L2"
                f" from one process's (limit {DP_UPDATE_TOL}), Adam's first"
                f" moment {a['moment_rel_l2']:.3e} (limit {DP_MOMENT_TOL}), "
                f"the masters {a['masters_rel_l2']:.3e}; the ranks bitwise "
                f"equal after each step {a['ranks_bitwise_equal']}; moved "
                f"{a['moved']} (one process {a['moved_one']}) of "
                f"{a['tensors']} trainable tensors")
            log(f"multi-GPU (2a) {mode}: s/step dp=2 (B=1 a rank, 2 ranks "
                f"on one card, gloo) rank 0 {a['seconds']}, rank 1 "
                f"{b['seconds']}; one process at B=2 {a['one_seconds']} (the "
                f"first of each cold); peak memory rank 0 {a['peak_gib']:.2f}"
                f" GiB, rank 1 {b['peak_gib']:.2f} GiB, one process at B=2 "
                f"{a['one_peak_gib']:.2f} GiB ({card})")
            timing[f"s/step dp=2 {mode}"] = a["seconds"]
            timing[f"s/step one process B=2 {mode}"] = a["one_seconds"]
            if not (rel <= EPS_TOL and norm <= DP_NORM_TOL and
                    a["update_rel_l2"] <= DP_UPDATE_TOL and
                    a["moment_rel_l2"] <= DP_MOMENT_TOL and
                    len(a["losses"]) == DP_STEPS and
                    all(np.isfinite(a["losses"]))):
                raise AssertionError(
                    f"dp=2 ({mode}) against one process: losses {rel:.3e}, "
                    f"gradient norms {norm:.3e}, update "
                    f"{a['update_rel_l2']:.3e}, first moment "
                    f"{a['moment_rel_l2']:.3e}")
            if a["moved"] < 0.9 * a["moved_one"]:
                raise AssertionError(f"dp=2 ({mode}) moved {a['moved']}")

        # (b)
        preset = config.sd15mv_rawbox_224x400()
        batch = collate_fn(make_dataset(1, image_hw=preset.image_size,
                                        map_hw=preset.map_hw,
                                        map_channels=preset.map_channels),
                           CollateConfig(bbox_max_len=preset.bbox_max_len))
        got = torch.cat([torch.load(os.path.join(out, f"sample_{j}.pt"))
                         for j in range(2)], dim=1)
        ref = torch.load(os.path.join(out, "sample_ref.pt"))
        s = res[0]["sample"]["unsharded_seconds"]
        rel = ((got - ref).norm() / ref.norm()).item()
        err, _ = _worst(got, ref)
        log(f"multi-GPU (2b): a (dp=1, view=2) request, cameras "
            f"{[x['sample']['views'] for x in res]}, "
            f"{res[0]['sample']['gathers']} gathers a rank, against the "
            f"unsharded request from the same latents: relative L2 "
            f"{rel:.3e}, max abs err {err:.3e}; "
            f"{check_images(got, batch, preset)}; s/request (cold) rank 0 "
            f"{res[0]['sample']['seconds']:.3f}, rank 1 "
            f"{res[1]['sample']['seconds']:.3f}, unsharded {s:.3f} (rank 0, "
            f"rank 1 idle) ({card})")
        timing["s/request view=2"] = [res[0]["sample"]["seconds"]]
        if not rel <= EPS_TOL:
            raise AssertionError(f"view-sharded images {rel:.3e} from the "
                                 "unsharded")

        # (c)
        names = sorted(os.listdir(os.path.join(out, "vsg")))
        one = sorted(os.listdir(evaluation["out"]))
        if names != one or sum(x["val_set_gen"]["samples"]
                               for x in res) != EVAL_SAMPLES:
            raise AssertionError(f"val_set_gen --multihost wrote "
                                 f"{len(names)} PNGs, one process "
                                 f"{len(one)}")
        first = _first_pngs(evaluation)
        if len(first) != 6 or not set(first) <= set(names):
            raise AssertionError(f"the first sample's PNGs {first}")
        got, want = (np.stack([np.asarray(Image.open(os.path.join(d, f)))
                               for f in first]).astype(np.int16)
                     for d in (os.path.join(out, "vsg"), evaluation["out"]))
        diff = np.abs(got - want)
        log(f"multi-GPU (2c): val_set_gen --multihost over 2 ranks: "
            f"{len(names)} PNGs, the one-process run's names; rank 0's "
            f"first sample (6 PNGs, the one process's first sample and "
            f"latents) against the one process's: bitwise "
            f"{bool((diff == 0).all())}, max {int(diff.max())} levels, "
            f"{(diff > 0).mean():.3e} of the values differ; s/batch rank 0 "
            f"{res[0]['val_set_gen']['seconds']}, rank 1 "
            f"{res[1]['val_set_gen']['seconds']} ({card})")
        # one request repeats bit for bit in another process (the SDPA
        # backends of core/attention.py)
        if diff.max() > 0:
            raise AssertionError(f"rank 0's first sample is up to "
                                 f"{diff.max()} levels from the one-process "
                                 "run's")


def time_kernels(requests: int = 2) -> dict:
    """The CUDA-event ms of the REDESIGNED kernels (K1-K4, K7, K8 and the
    K8 pair) at their path shapes (as in ``check_kernels``, K1 with its kv
    projection alone, K8 and its pair with their out-projection alone where
    the tree has one) and the host-clock seconds of ``requests`` warm
    requests in each fused mode after one warm-up request, through the port
    this interpreter imports; printed as one JSON line. ``compare_trees``
    runs it in another checkout (one whose pair entries take the ring's
    shifts times the pairs on the ring alone)."""
    import inspect

    from magicdrive_tpu_torch.kernels import dispatch

    # a tree from before the neighbour table takes the ring as shifts
    shifts = "shifts" in inspect.signature(
        dispatch.kvstat_attention_pair).parameters
    ring = ring_table()
    rows = []
    for name, label, args in kernel_cases(
            torch.Generator(device="cuda").manual_seed(0)):
        if name not in REDESIGNED:
            continue
        if shifts and name.endswith("_pair"):
            if not torch.equal(args[-1], ring):
                continue
            args = (*args[:-1], (5, 1, 6))
        kern = getattr(dispatch, name)
        rows.append({"name": name, "shape": label,
                     "ms": cuda_ms(lambda: kern(*args))})
        if name == "kvstat_attention":
            rows[-1]["kv_project_ms"] = cuda_ms(_kv_project(args)[0])
        if name in _OUT_KERNELS and hasattr(dispatch, "_out_project"):
            rows[-1]["out_project_ms"] = cuda_ms(_out_project(name, args)[0])
    _, pipe, batches = set_up()
    seconds = {}
    for mode in dispatch.FUSED_MODES:
        with dispatch.fused_mode(mode):
            gen = torch.Generator(device="cuda").manual_seed(42)
            runs = []
            for i in range(requests + 1):
                t0 = time.perf_counter()
                pipe(batches[i % len(batches)], generator=gen)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
            seconds[mode] = runs[1:]
    result = {"kernels": rows, "warm_s_per_request": seconds}
    print(json.dumps(result), flush=True)
    return result


def compare_trees(other: str, requests: int = 2) -> None:
    """The REDESIGNED kernels' times and warm request times in both fused
    modes of another checkout (say a ``git archive`` of the parent unpacked
    into runs/parent) and of this one, in turns: other, this, this, other.
    Each turn is a process of its own that imports that tree's port and
    builds its kernels there; the timing code is this file's
    (``time_kernels``). Prints each turn's line, then each row's mean over
    the two turns of each tree, rows matched by kernel and shape (a time
    only one tree has is printed alone)."""
    environment()  # the card and its power limit, for the record
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    code = ("import importlib.util, sys; sys.path.insert(0, {tree!r}); "
            "spec = importlib.util.spec_from_file_location('smoke', {me!r}); "
            "m = importlib.util.module_from_spec(spec); "
            "spec.loader.exec_module(m); m.environment(); "
            "m.build_kernels(spill_gate=False); "
            "m.time_kernels({n})")
    turns = []
    for label, tree in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        proc = subprocess.run(
            [sys.executable, "-c", code.format(
                tree=tree, me=os.path.abspath(__file__), n=requests)],
            cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"turn in {tree} failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        log(f"{label} ({tree}): {json.dumps(result)}")
        turns.append((label, result))
    # rows matched by kernel and shape: a tree from before the neighbour
    # table has no rows over the other tables
    for row in turns[1][1]["kernels"]:
        means = {"other": {}, "this": {}}
        for side in means:
            got = [g for s, r in turns if s == side for g in r["kernels"]
                   if (g["name"], g["shape"]) == (row["name"], row["shape"])]
            if got:
                means[side] = {k: sum(g[k] for g in got) / len(got)
                               for k in got[0] if k.endswith("ms")}
        keys = sorted(set(means["other"]) | set(means["this"]))
        log(f"{row['name']} {row['shape']}: " + "; ".join(
            f"{k} other {means['other'][k]:.4f} this {means['this'][k]:.4f} "
            f"({means['this'][k] / means['other'][k]:.3f}x)"
            if k in means["other"] and k in means["this"] else
            f"{k} " + " ".join(f"{side} {means[side][k]:.4f}"
                               for side in means if k in means[side])
            for k in keys))
    for mode in turns[1][1]["warm_s_per_request"]:
        for side in ("other", "this"):
            log(f"warm {mode} s/request, {side}: " + ", ".join(
                f"{s:.4f}" for lab, r in turns if lab == side
                for s in r["warm_s_per_request"][mode]))


@contextlib.contextmanager
def phase(name: str):
    """One phase of ``main``: its wall seconds logged when it ends. On any
    exception it prints one line, ``chip_smoke FAILED in <name>: <type>:
    <message>``, on stdout and lets the exception go on, so the exit code
    stays non-zero, no later phase runs and no result line is printed."""
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        msg = " ".join(str(e).split())
        print(f"chip_smoke FAILED in {name}: {type(e).__name__}: "
              f"{msg[:2000]}", flush=True)
        raise
    log(f"phase {name} s {time.perf_counter() - t0:.1f}")


# K2 and the K8 pair on the nuScenes ring at L=1400 before the neighbour
# table replaced the ring shift (PERF.md, NVIDIA H100 80GB HBM3, 700.00 W)
RING_SHIFT_MS = {"kvstat_attention_pair": 0.5144,
                 "fused_qkv_out_attention_pair": 0.5300}


def log_pair_tables(rows) -> None:
    """K2's and the K8 pair's rows at L=1400 and 350 over each table, the
    ring's beside its time under the ring shift."""
    for name, before in RING_SHIFT_MS.items():
        got = {r["shape"]: r["ms"] for r in rows[name]
               if r["shape"].startswith("attn4 L=")}
        log(f"{name} by neighbour table (ms): " + ", ".join(
            f"{shape} {ms:.4f}" for shape, ms in got.items()) +
            f"; the ring at L=1400 {got['attn4 L=1400 C=320']:.4f} against "
            f"{before} under the ring shift")


def main() -> None:
    if sys.argv[1:2] == ["--rank"]:  # a rank of the multi-GPU phase
        rank_main(sys.argv[2:])
        return
    from magicdrive_tpu_torch.kernels import dispatch

    with phase("environment"):
        card = environment()
    with phase("build"):
        build_kernels()
    with phase("kernel checks"):
        log("kernel checks (bf16 kernel vs fp32 plain version, TF32 off):")
        rows = check_kernels()
        rows.update(check_flash_kernels())
        check_flash_depths()
        check_attention_depths()
        check_ff_widths()
        log(f"autograd checks (bf16 kernel route vs fp32 plain backward, "
            f"limit {GRAD_TOL} * max|ref| or the plain bf16 backward's "
            f"error):")
        check_autograd()
        log_pair_tables(rows)
    by_path, timing = {}, {}
    with phase("forced routes"):
        log("routes no bf16 preset reaches, at forced shapes:")
        check_forced_routes(by_path)
    with phase("generation"):
        preset, pipe, batches = set_up()
        for mode in dispatch.FUSED_MODES:
            with dispatch.fused_mode(mode):
                by_path[f"generation_{mode}"], \
                    timing[f"s/request {mode}"] = \
                    run_slice(preset, pipe, batches, mode)
                check_path_calls(preset, pipe, batches[0], mode)
                check_eps(preset, pipe, batches[0], mode)
                profile_guided_step(preset, pipe, batches[0], mode)
    with phase("options"):
        log("the pipeline's options (kvstat):")
        run_options(preset, pipe, batches, by_path, timing)
    with phase("given view"):
        log("given-view generation (kvstat):")
        run_given_view(preset, pipe, batches, by_path, timing)
    with phase("cross-view forms"):
        log("the other cross-view forms and the box-embedder options:")
        run_cross_view_forms(pipe, batches, by_path, timing, card)
    del pipe
    torch.cuda.empty_cache()
    # the evaluation's run, tree and val set, kept for the multi-GPU phase
    kept = tempfile.TemporaryDirectory()
    with phase("evaluation"):
        log("the evaluation chain: conversion, the generation CLI, val-set "
            "generation, FID; the map drop:")
        evaluation = run_evaluation(by_path, timing, card, keep=kept.name)
    with phase("hi-res"):
        run_hires(by_path, timing)
    with phase("video"):
        run_video(by_path, timing)
    for mode in dispatch.FUSED_MODES:
        with phase(f"training {mode}"), dispatch.fused_mode(mode):
            setup, by_path[f"training_{mode}"], run = run_training(mode=mode)
            timing[f"s/step {mode}"] = run["seconds"]
            if mode == "kvstat":
                check_drop_all(setup)
            check_training_calls(setup, mode)
            profile_train_step(setup, mode)
        del setup
        torch.cuda.empty_cache()
    with phase("training CLI"):
        log("the training CLI, its resume and export, the training options, "
            "video training and the cache:")
        run_train_cli(by_path, timing, card)
    with phase("multi-GPU"):
        log("across processes: NCCL through the training CLI; two gloo "
            "ranks on the card: dp=2 training, a view-sharded request, "
            "val_set_gen --multihost:")
        run_multi_gpu(by_path, timing, card, evaluation)
    kept.cleanup()
    with phase("kernels line"):
        log(f"path times (the first of each includes one-time setup): "
            f"{timing}")
        log("whole K6 (its two launches, counted under their own names): " +
            json.dumps(rows["flash_attention_bwd"]))
        kernels = []
        for n, (src, rep) in KERNELS.items():
            worst = max(rows[n], key=lambda r: r["max_abs_err"])
            launches = {path: counts[n] for path, counts in by_path.items()}
            kernels.append({
                "name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": sum(launches.values()), **worst,
                "launches_by_path": launches, "shapes": rows[n]})
        missing = [k["name"] for k in kernels if k["launches"] <= 0]
        if missing:
            raise AssertionError(f"kernels launched on no path: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
