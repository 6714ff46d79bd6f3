"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero and prints
no result line):
  1. environment: a CUDA device, the torch/CUDA versions, the card's name
     and power limit from nvidia-smi;
  2. build: the hand-written kernels (magicdrive_tpu_torch/kernels/csrc),
     compiled from this checkout;
  3. kernel checks: K1-K4 at every shape the 224x400 generation path gives
     them (bf16, B=1 with CFG: 12 views) against their plain versions in
     fp32 with TF32 off, max|kernel - ref| <= 1e-2 * max|ref|, with CUDA-
     event times of the kernel and of the plain version on the same inputs;
  4. slice: the full-width sd15mv_rawbox_224x400 pipeline (20 UniPC steps,
     CFG 2.0, bf16, B=1) on seeded random weights with every floating
     parameter non-zero, for 2 requests; the launch counts of that run show
     K1-K4 on the path;
  5. path checks: in one guided UNet+ControlNet step, every kernel call is
     held against its plain version in fp32 on the same inputs (the tolerance
     of phase 3), and the guided eps with kernels agrees with the eps through
     the plain versions to relative L2 <= 2e-2. The eps comparison is a smoke
     test, not a gate: bf16 noise of the whole network sits near 1.1e-2, and
     planted faults in K2 and K4 passed it while the per-call check and
     phase 3 caught both (PERF.md).
The line before the last is {"kernels": [...]}, one entry per kernel, at the
shape where its error was largest, with every shape under "shapes"; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_REQUESTS = 2
KERNEL_TOL = 1e-2   # max|kernel - ref| <= KERNEL_TOL * max|ref|
EPS_TOL = 2e-2      # relative L2 of the guided eps, kernels vs plain
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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_kernels() -> None:
    from magicdrive_tpu_torch.kernels import build

    t0 = time.perf_counter()
    path, compiler_log = build.build()
    log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in compiler_log.splitlines():  # ptxas: registers, spills
        if line.startswith("ptxas info"):
            log("  " + line.strip())
    build.load()


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (name, source, TPU kernel replaced)
KERNELS = {
    "kvstat_attention": (
        "magicdrive_tpu_torch/kernels/csrc/kvstat_attention.cu",
        "magicdrive_tpu/kernels/fused_attention.py:211"),
    "kvstat_attention_pair": (
        "magicdrive_tpu_torch/kernels/csrc/kvstat_pair_attention.cu",
        "magicdrive_tpu/kernels/fused_attention.py:467"),
    "fused_ff": ("magicdrive_tpu_torch/kernels/csrc/geglu.cu",
                 "magicdrive_tpu/kernels/geglu.py:221"),
    "fused_geglu": ("magicdrive_tpu_torch/kernels/csrc/geglu.cu",
                    "magicdrive_tpu/kernels/geglu.py:70"),
}


def kernel_cases(gen: torch.Generator):
    """(kernel, shape label, args) at every shape the 224x400 path gives
    each kernel: 12 views, 8 heads; text context 1 + 77 + 160 tokens."""
    dev = "cuda"

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(torch.bfloat16)

    cases = []
    for L, C in ((1400, 320), (350, 640)):
        x = rnd(12, L, C)
        w = [rnd(C, C, scale=C ** -0.5) for _ in range(3)]
        cases.append(("kvstat_attention", f"attn1 L={L} C={C}",
                      (x, x, *w, 8, (C // 8) ** -0.5)))
        cases.append(("kvstat_attention_pair", f"attn4 L={L} C={C}",
                      (x, *w, 8, (C // 8) ** -0.5, (5, 1, 6))))
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
    return cases


def _f32(a):
    return a.float() if torch.is_tensor(a) else a


def check_kernels():
    from magicdrive_tpu_torch.kernels import dispatch, reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, label, args in kernel_cases(gen):
        kern, plain = getattr(dispatch, name), getattr(reference, name)
        got = kern(*args).float()
        ref = plain(*map(_f32, args)).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ms = cuda_ms(lambda: kern(*args))
        plain_ms = cuda_ms(lambda: plain(*args))
        ok = np.isfinite(err) and err <= KERNEL_TOL * scale
        log(f"  {name:22s} {label:28s} max_abs_err {err:.3e} "
            f"(max|ref| {scale:.3e}) kernel {ms:.4f} ms plain {plain_ms:.4f}"
            f" ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {label}: max abs err {err} > "
                                 f"{KERNEL_TOL} * {scale}")
        rows.setdefault(name, []).append({
            "shape": label, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms})
    return rows


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
def patched_kernels(make):
    """The model's kernel calls replaced by ``make(name, kernel, plain)``
    for the checks of phase 5."""
    from magicdrive_tpu_torch.kernels import dispatch, reference

    saved = {n: getattr(dispatch, n) for n in KERNELS}
    try:
        for n, fn in saved.items():
            setattr(dispatch, n, make(n, fn, getattr(reference, n)))
        yield
    finally:
        for n, fn in saved.items():
            setattr(dispatch, n, fn)


def set_up():
    """The full-width pipeline on seeded weights and N_REQUESTS fixture
    request batches."""
    from magicdrive_tpu_torch.config import sd15mv_rawbox_224x400
    from magicdrive_tpu_torch.data import (CollateConfig, collate_fn,
                                           make_dataset)
    from magicdrive_tpu_torch.pipeline.pipeline import (MagicDriveModules,
                                                        MagicDrivePipeline)

    preset = sd15mv_rawbox_224x400()
    t0 = time.perf_counter()
    with torch.device("cuda"):
        modules = MagicDriveModules.create(preset)
    init_weights(modules, seed=0)
    modules.to("cuda", preset.pipeline.dtype)
    pipe = MagicDrivePipeline(modules, preset.pipeline)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for _, m in modules.items()
                   for p in m.parameters())
    log(f"slice: {preset.name}, {n_params / 1e6:.1f} M parameters, set up "
        f"in {time.perf_counter() - t0:.1f} s")
    ccfg = CollateConfig(bbox_max_len=preset.bbox_max_len)
    batches = [collate_fn([s], ccfg) for s in make_dataset(N_REQUESTS)]
    return pipe, batches


def run_slice(pipe, batches):
    from magicdrive_tpu_torch.kernels import dispatch

    dispatch.reset_launches()
    gen = torch.Generator(device="cuda").manual_seed(42)
    seconds = []
    for b in batches:
        t0 = time.perf_counter()
        img = pipe(b, generator=gen)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if tuple(img.shape) != (1, 6, 224, 400, 3):
            raise AssertionError(f"image shape {tuple(img.shape)}")
        if not torch.isfinite(img).all():
            raise AssertionError("non-finite image values")
        lo, hi = img.min().item(), img.max().item()
        if lo < 0.0 or hi > 1.0:
            raise AssertionError(f"image values outside [0, 1]: {lo} {hi}")
        log(f"  request: {seconds[-1]:.3f} s, image min {lo:.3f} max "
            f"{hi:.3f} mean {img.mean().item():.4f} std "
            f"{img.std().item():.4f}")
    launches = dict(dispatch.LAUNCHES)
    log(f"slice launches: {launches}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the path: {missing}")
    log(f"slice: seconds per request {seconds} (the first includes "
        f"one-time setup such as cuDNN algorithm choice)")
    return launches


def _step_inputs(pipe, batch):
    """A latent drawn per view: with the shared initial latent of a first
    step the views differ only by their conditioning, and a cross-view
    fault that mixes up neighbours would hardly show."""
    c = pipe.cfg
    x = torch.randn((1, c.n_cam, 4, c.latent_height, c.latent_width),
                    generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    return x, int(pipe.coeffs.timesteps[0]), pipe.conditioning(batch)


def check_path_calls(pipe, batch) -> None:
    """Every kernel call of one guided step against its plain version in
    fp32 on the inputs the path gave it."""
    x, t, cond = _step_inputs(pipe, batch)
    stats = {}  # kernel -> [calls, worst max|err| / max|ref|]

    def make(name, kern, plain):
        def call(*args):
            out = kern(*args)
            ref = plain(*map(_f32, args)).float()
            err = (out.float() - ref).abs().max().item()
            rel = err / max(ref.abs().max().item(), 1e-30)
            s = stats.setdefault(name, [0, 0.0])
            s[0], s[1] = s[0] + 1, max(s[1], rel)
            if not (np.isfinite(rel) and rel <= KERNEL_TOL):
                raise AssertionError(
                    f"{name} on the path, x {tuple(args[0].shape)}: max abs "
                    f"err {err:.3e} = {rel:.3e} * max|ref| > {KERNEL_TOL}")
            return out
        return call

    with patched_kernels(make):
        pipe.guided_eps(x, t, cond)
    log("path calls of one guided step, kernel vs fp32 plain version: " +
        ", ".join(f"{n} {c} calls, worst {r:.3e} * max|ref|"
                  for n, (c, r) in stats.items()))
    if set(stats) != set(KERNELS):
        raise AssertionError(f"kernels not called in the step: "
                             f"{set(KERNELS) - set(stats)}")


def check_eps(pipe, batch) -> None:
    """The guided eps of one step through the kernels against the same step
    through the plain versions."""
    x, t, cond = _step_inputs(pipe, batch)
    eps_k = pipe.guided_eps(x, t, cond)
    with patched_kernels(lambda name, kern, plain: plain):
        eps_p = pipe.guided_eps(x, t, cond)
        noise = torch.randn(x.shape, device=x.device,
                            generator=torch.Generator("cuda").manual_seed(8))
        eps_n = pipe.guided_eps(x * (1 + 1e-3 * noise), t, cond)
    rel = ((eps_k - eps_p).norm() / eps_p.norm()).item()
    sens = ((eps_n - eps_p).norm() / eps_p.norm()).item()
    log(f"guided eps, kernels vs plain versions: relative L2 {rel:.3e} "
        f"(|eps| rms {eps_p.pow(2).mean().sqrt().item():.3e}; plain vs "
        f"plain on a latent perturbed by 1e-3: {sens:.3e})")
    if not (np.isfinite(rel) and rel <= EPS_TOL):
        raise AssertionError(f"eps relative L2 {rel} > {EPS_TOL}")


def main() -> None:
    environment()
    build_kernels()
    log("kernel checks (bf16 kernel vs fp32 plain version, TF32 off):")
    rows = check_kernels()
    pipe, batches = set_up()
    launches = run_slice(pipe, batches)
    check_path_calls(pipe, batches[0])
    check_eps(pipe, batches[0])
    kernels = []
    for n, (src, rep) in KERNELS.items():
        worst = max(rows[n], key=lambda r: r["max_abs_err"])
        kernels.append({"name": n, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[n], **worst,
                        "shapes": rows[n]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
