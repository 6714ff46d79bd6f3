"""Builds a C++ source of ``native/csrc`` with ``g++`` into a shared
library and loads it with ctypes.

A library is built at first use into ``native/_build/`` (ignored by git),
named by a hash of its source and flags as the kernels are
(``kernels/build.py``), so an edited source builds anew. A failed build
raises with the compiler's output: nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
from typing import Mapping, Sequence

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def library_path(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.read_bytes())
    return BUILD_DIR / f"libmd_{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile ``source`` if the library for its hash is missing; raises
    with the compiler's output when it fails."""
    path = library_path(source)
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", lib, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(lib, path)  # atomic: a reader never sees a partial file
    return path


@functools.lru_cache(maxsize=None)
def _load(name: str, signatures: tuple) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(CSRC / name)))
    for fn, argtypes in signatures:
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = None
    return lib


def load(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The library of ``csrc/<name>`` (built if needed) with the C
    signatures ``{function: argtypes}`` declared; every function returns
    void."""
    return _load(name, tuple((fn, tuple(a)) for fn, a in
                             signatures.items()))
