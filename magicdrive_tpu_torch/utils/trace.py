"""Spans of the port: which layer of a request or a training
step the host and the device spend their time in.

``span(name)`` is a context manager around a stretch of the program, and
``spanned(name)`` the same around every call of a function. Off, the
default, a span is one check of a module global and a shared no-op object:
it reads no clock and records nothing. On (``enable()``, ``disable()``,
``with enabled():``; there is no other switch) each span records its name,
its start and end on the host clock (``time.perf_counter_ns``), its parent
(the span open around it on the same thread) and its unit: the request or
training step it belongs to, which a span opened with ``unit=True``
starts. Spans are kept in memory until ``drain()``; nothing is written.
While a ``torch.profiler`` session records, an enabled span also opens
``record_function(name)``: a ``user_annotation`` range in the Chrome trace,
on the clock of the device's kernels and copies, so the device's work and
its idle gaps can be put down to the innermost span the host was in.

The spans, from the entry points down:

  md.pipeline.request       ``MagicDrivePipeline.__call__`` (a unit)
  md.pipeline.conditioning  its CLIP, tokens and map features
  md.pipeline.step          one denoising step: guided eps and the update
  md.pipeline.decode        the VAE decode
  md.transformer            ``Transformer2DModel.forward``
  md.attn                   a block's attn1, attn2 and cross-view calls
  md.ff                     a block's feed-forward call
  md.resnet                 ``ResnetBlock2D.forward``
  md.train.step             ``train_step`` (a unit)
  md.train.masters          the fp32 masters copied into the bf16 weights
  md.train.encode           the loss's frozen CLIP and VAE encode
  md.train.forward          the rest of the loss: ControlNet, UNet, MSE
  md.train.backward         ``torch.autograd.grad`` of the loss
  md.train.optimizer        ``TrainState.apply_gradients``

Their reader is the training runner's ``profile_steps`` window
(``train/runner.py``), which turns spans on: its exported Chrome trace
holds each step's phases and blocks, and, where a validation falls inside
the window, the pipeline's request, conditioning, steps and decode.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

import torch

_ON = False
_SPANS: List["Span"] = []
_IDS = itertools.count()
_LOCAL = threading.local()  # .stack: the ids of the spans open on a thread
_UNIT: Optional[int] = None  # the id of the unit span open, on any thread


class Span(NamedTuple):
    """A finished span. ``parent`` is the id of the span open around it on
    its thread; ``unit`` the id of the unit span open when it started
    (a unit span's own id), on any thread, so that the spans the autograd
    thread opens in a step's backward belong to the step."""
    id: int
    name: str
    parent: Optional[int]
    unit: Optional[int]
    start_ns: int
    end_ns: int


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("name", "unit", "id", "parent", "start", "saved", "rf",
                 "stack")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit = name, unit

    def __enter__(self):
        global _UNIT
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.stack = stack
        self.id = next(_IDS)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if self.unit:
            self.saved, _UNIT = _UNIT, self.id
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _UNIT
        end = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        self.stack.pop()
        unit = self.id if self.unit else _UNIT
        if self.unit:
            _UNIT = self.saved
        _SPANS.append(Span(self.id, self.name, self.parent, unit, self.start,
                           end))
        return False


def span(name: str, unit: bool = False):
    """A context manager around a stretch named ``name``; with ``unit`` the
    stretch is a unit (a request, a training step) of its own."""
    if not _ON:
        return _OFF
    return _Open(name, unit)


def spanned(name: str, unit: bool = False):
    """A decorator: every call of the function inside ``span(name, unit)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Open(name, unit):
                return fn(*args, **kwargs)
        return call
    return wrap


def call(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` inside ``span(name)``."""
    if not _ON:
        return fn(*args, **kwargs)
    with _Open(name, False):
        return fn(*args, **kwargs)


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def is_enabled() -> bool:
    return _ON


@contextlib.contextmanager
def enabled(flag: bool = True):
    """Spans on (or off, ``flag`` False) inside; the previous state after."""
    global _ON
    saved, _ON = _ON, bool(flag)
    try:
        yield
    finally:
        _ON = saved


def drain() -> List[Span]:
    """The spans finished since the last drain, by start; they are then
    forgotten here."""
    global _SPANS
    out, _SPANS = _SPANS, []
    return sorted(out, key=lambda s: (s.start_ns, s.id))
