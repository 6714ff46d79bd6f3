"""What the drivers of every traffic kind share: the measured window, spans
of device time around calls into the program, the gaps that decide
``correct``, and the card's description."""
from __future__ import annotations

import contextlib
import gc
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def window(unit: Callable[[int], None], seconds: float, device) -> dict:
    """Run ``unit(i)`` for i = 0, 1, ... until the host clock, read after
    a unit, passes ``seconds``; the window ends after that unit and a
    device synchronise. -> {"units", "seconds", "start"}."""
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        unit(n)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return {"units": n, "seconds": time.perf_counter() - t0, "start": t0}


class Spans:
    """CUDA events around every call of ``obj.<attr>`` while on: the
    device milliseconds between the call's first and last operation."""

    def __init__(self, obj, attr: str):
        self.obj, self.attr = obj, attr
        self.pairs: List = []
        self.inner = getattr(obj, attr)
        self.own = attr in vars(obj)

        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = self.inner(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            return out
        setattr(obj, attr, call)

    def close(self) -> List[float]:
        """Remove the wrapper; -> the ms of every call (after a sync)."""
        if self.own:
            setattr(self.obj, self.attr, self.inner)
        else:
            delattr(self.obj, self.attr)
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.pairs]


@contextlib.contextmanager
def ranges(calls: Dict[str, List]):
    """``calls``: {range name: [(obj, attr), ...]}: each call of
    ``obj.<attr>`` inside a profiler range ``bench.<name>``."""
    from torch.profiler import record_function

    saved = []
    for name, targets in calls.items():
        for obj, attr in targets:
            inner = getattr(obj, attr)

            def call(*a, _inner=inner, _name="bench." + name, **kw):
                with record_function(_name):
                    return _inner(*a, **kw)
            saved.append((obj, attr, attr in vars(obj), inner))
            setattr(obj, attr, call)
    try:
        yield
    finally:
        for obj, attr, own, inner in reversed(saved):
            if own:
                setattr(obj, attr, inner)
            else:
                delattr(obj, attr)


nothing = contextlib.nullcontext

# torch.nn.init's fills, which module constructors call
INIT_FILLS = ("uniform_", "normal_", "trunc_normal_", "constant_", "ones_",
              "zeros_", "eye_", "dirac_", "xavier_uniform_",
              "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
              "orthogonal_", "sparse_")


@contextlib.contextmanager
def skip_init():
    """Modules built inside are left as allocated, without PyTorch's
    default initialisation, for a strict ``load_state_dict`` that
    overwrites every parameter and persistent buffer. Buffers that are no
    state are made as usual: they come from tensors, not from the fills."""
    from torch.nn import init

    saved = {n: getattr(init, n) for n in INIT_FILLS}
    for n in INIT_FILLS:
        setattr(init, n, lambda t, *a, **kw: t)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(init, n, f)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def rel_gap(got: torch.Tensor, want: torch.Tensor,
            base: Optional[torch.Tensor] = None) -> float:
    """||got - want|| / ||base|| (``base`` defaults to ``want``)."""
    got, want = got.double(), want.double()
    base = want if base is None else base.double()
    return float((got - want).norm() / base.norm().clamp_min(1e-30))


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keys=None) -> Dict[str, float]:
    """Each leaf's |got - want| of per-leaf norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    keys = list(want) if keys is None else list(keys)
    med = float(torch.tensor([want[k] for k in want]).median())
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30)
            for k in keys}


def checks_line(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value", "limit"}} of every number compared."""
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}


def within(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k]
               for k in limits)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    """A torch generator for (seed, stream...), the seed any whole number."""
    import numpy as np

    s = int(np.random.SeedSequence([seed % (1 << 64), *stream]
                                   ).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s >> 1)
