"""Guided generation: a closed loop of one client sending back-to-back
requests of ``batch`` frames to ``MagicDrivePipeline.__call__``.

Each request takes the next of ``pool`` seeded layouts (cameras, boxes,
map, prompt) and a fresh latent per frame, shared by its views as the
pipeline draws it; its images are copied to the host as the generation CLIs
copy them. Set-up builds the modules on the device without their default
initialisation, loads the benchmark's seeded weights and runs one request
at the cell's shapes. After the window one finished
request, drawn from the seed, is generated again by the plain fp32
reference, and its final latents and images are compared.

Per-layer readings (``--trace 1``): CUDA events around
``MagicDrivePipeline.decode`` over the window, then ``trace_units``
requests under the profiler's device trace, then one more request under
the host and device trace with a range around every transformer attention
(attn1, attn2, and the cross-view attention of the UNet's blocks).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import common, flops, scenes, trace, weights
from benchmark.harness.preset import dtype as config_dtype
from benchmark.harness.preset import port_preset
from benchmark.reference import model as ref_model
from benchmark.reference import steps as ref_steps

class Program:
    """The system under test on one configuration and seed."""

    def __init__(self, cell, seed: int, device):
        from magicdrive_tpu_torch.pipeline.pipeline import (
            MagicDriveModules, MagicDrivePipeline)

        self.cell, self.seed, self.device = cell, seed, device
        cfg = cell.config
        preset = port_preset(cfg)
        t0 = time.perf_counter()
        with common.skip_init():
            self.modules = MagicDriveModules.create(preset, device=device
                                                    ).to(device,
                                                         config_dtype(cfg))
        common.sync(device)
        self.times = {"modules": time.perf_counter() - t0}
        self.load(seed)
        self.times["weights"] = time.perf_counter() - t0 - \
            self.times["modules"]
        self.pipe = MagicDrivePipeline(self.modules, preset.pipeline)
        self.final = []  # the latents each decode call received
        inner = self.pipe.decode

        def decode(x):
            self.final.append(x.detach().clone())
            return inner(x)
        self.pipe.decode = decode

    def load(self, seed: int) -> None:
        cfg = self.cell.config
        sd = weights.make(cfg["model"], seed, cfg["weights"],
                          self.device, config_dtype(cfg))
        for name, mod in self.modules.items():
            mod.load_state_dict(sd[name], strict=True)

    def __call__(self, req):
        batch, latents = req
        return self.pipe(batch, latents=latents).cpu().numpy()

    def attention_targets(self):
        """(object, attribute) of every transformer attention call."""
        out = []
        for _, mod in self.modules.items():
            for m in mod.modules():
                if hasattr(m, "attn1") and hasattr(m, "attn2"):
                    out += [(m.attn1, "forward"), (m.attn2, "forward")]
                    if getattr(m, "cross_view", False):
                        out.append((m, "_cross_view"))
        return out


def requests(cell, seed: int, device):
    """request(k) -> (host batch, latents (B, N, h, w, 4) on ``device``)."""
    p = scenes.shape_params(cell.config, cell.traffic)
    B, n = cell.traffic["batch"], cell.traffic["pool"]
    pool = [scenes.batch(seed, i, B, p) for i in range(n + 1)]
    pc = cell.config["pipeline"]
    shape = (B, 1, pc["latent_height"], pc["latent_width"], 4)

    def request(k: int):
        # k = -1: the warm-up's latents, from a stream of their own
        g = common.generator(seed, 1 if k >= 0 else 3, max(k, 0),
                             device=device)
        lat = torch.randn(shape, generator=g, device=device)
        return pool[k % n], lat.expand(-1, pc["n_cam"], -1, -1, -1)
    # the warm-up's layout is the pool's last, which no request takes
    request.warm = lambda: (pool[n], request(-1)[1])
    return request


def reference_model(cell, seed: int, device, model=None):
    """The plain fp32 reference with the seed's weights (TF32 off)."""
    cfg = cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if model is None:
        with torch.device(device):
            model = ref_model.Model(cfg["model"]).eval()
    sd = weights.make(cfg["model"], seed, cfg["weights"], device,
                      config_dtype(cfg))
    for name in ("unet", "controlnet", "vae", "clip"):
        getattr(model, name).load_state_dict(sd[name], strict=True)
    return model


def reference(cell, model, req, device, lower: bool = False):
    """(final latents, images) of the plain reference for ``req``, in
    float32 (``lower``: the control, with float8 products)."""
    pc = cell.config["pipeline"]
    batch, latents = req
    t = scenes.to_tensors(batch, device)
    t["latents"] = latents.permute(0, 1, 4, 2, 3)
    with ref_model.lower_precision() if lower else common.nothing():
        x, img = ref_steps.generate(model, t, pc["num_inference_steps"],
                                    pc["guidance_scale"])
    return x.cpu(), img.cpu()


def gaps(got, want) -> dict:
    """latent_gap: ||x - x_ref|| / ||x_ref|| of the final latents;
    image_gap: ||img - img_ref|| / ||img_ref|| of the images."""
    (x, img), (xr, imgr) = got, want
    img = torch.as_tensor(np.asarray(img))
    return {"latent_gap": common.rel_gap(x.cpu(), xr),
            "image_gap": common.rel_gap(img, imgr)}


def run(cell, args, device, log) -> dict:
    t0 = time.perf_counter()
    prog = Program(cell, args.seed, device)
    request = requests(cell, args.seed, device)
    common.sync(device)
    t1 = time.perf_counter()
    prog(request.warm())
    prog.final.clear()
    common.sync(device)
    log(f"set-up: program and weights {t1 - t0:.2f} s (modules "
        f"{prog.times['modules']:.2f}, weights {prog.times['weights']:.2f}),"
        f" warm-up request {time.perf_counter() - t1:.2f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_end = time.perf_counter()

    images = []
    spans = common.Spans(prog.pipe, "decode") if args.trace else None
    win = common.window(lambda k: images.append(prog(request(k))),
                        args.seconds, device)
    decode_ms = spans.close() if spans else None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    B = cell.traffic["batch"]
    frames = win["units"] * B
    failed = sum(not np.isfinite(i).all() for i in images)
    record = {"window_s": win["seconds"], "units": win["units"],
              "frames": frames}
    result = {"setup_end": setup_end, "attempted": win["units"],
              "failed": int(failed), "memory_peak_bytes": int(peak),
              "end_to_end": {"frames_per_s": frames / win["seconds"]}}

    if args.trace:
        pc = cell.config["pipeline"]
        work = flops.request(cell.config, B, pc["num_inference_steps"])
        name = torch.cuda.get_device_name(0)
        record.update(
            peaks=flops.peaks(name), decode_ms=decode_ms, flops=work,
            device_name=name, power=common.power_limit())
        u, n = win["units"], cell.traffic["trace_units"]
        record["trace"] = trace.traced(
            lambda: [prog(request(u + i)) for i in range(n)], args.tmpdir,
            host=False)
        with common.ranges({"attn": prog.attention_targets()}):
            record["trace_host"] = trace.traced(
                lambda: prog(request(u + n)), args.tmpdir, host=True)
        record["trace_units"] = n
        record["attention_bound_s"] = None if record["peaks"] is None else \
            pc["num_inference_steps"] * flops.attention_bound(
                work["attention"], torch.finfo(config_dtype(
                    cell.config)).bits // 8, *record["peaks"])
        log(f"card: {record['power']}")

    # the comparison: a finished request drawn from the seed
    k = int(np.random.default_rng([args.seed % (1 << 64), 7]).integers(
        win["units"]))
    got = (prog.final[k], images[k])
    req = request(k)
    del prog, images
    common.free(device)
    t0 = time.perf_counter()
    want = reference(cell, reference_model(cell, args.seed, device), req,
                     device)
    log(f"reference: {time.perf_counter() - t0:.2f} s")
    result["numbers"] = gaps(got, want)
    result["record"] = record
    return result
