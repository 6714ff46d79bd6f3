"""Build and load the hand-written CUDA kernels (``kernels/csrc``).

Each source is compiled by its own ``nvcc`` for ``sm_90a``, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. Sources that include no PyTorch headers
compile in seconds, where a ``torch.utils.cpp_extension`` binding file takes
minutes, and every fresh machine builds anew.

The library is built at first use into ``kernels/_build/`` (ignored by
git), named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused. ``python -m
magicdrive_tpu_torch.kernels.build`` builds it and prints each kernel's
register and shared-memory use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (pointers and the stream as
# c_void_p: ctypes would otherwise pass a Python int as a 32-bit int)
_SIGNATURES = {
    "mdk_kv_project": (_I, [_P] * 5 + [_I] * 5 + [_P]),
    "mdk_kvstat_attention": (_I, [_P] * 5 + [_I] * 6 + [_F, _P]),
    "mdk_kvstat_attention_pair": (_I, [_P] * 5 + [_I] * 5 + [_F, _P, _I,
                                                               _P]),
    "mdk_geglu": (_I, [_P] * 4 + [_I] * 3 + [_P]),
    "mdk_ff": (_I, [_P] * 5 + [_I] * 4 + [_P]),
    "mdk_flash_fwd": (_I, [_P] * 5 + [_I] * 5 + [_P]),
    "mdk_flash_bwd_dq": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "mdk_flash_bwd_dkv": (_I, [_P] * 8 + [_I] * 5 + [_P]),
    "mdk_out_project": (_I, [_P] * 3 + [_I] * 3 + [_P]),
    "mdk_tensor_map_encode_us": (_F, [_I]),
    "mdk_error_string": (ctypes.c_char_p, [_I]),
}
# the fp32 instance of each kernel entry (csrc/f32_*.cu): the same
# arguments, pointers to fp32 tensors
KERNEL_ENTRIES = ("mdk_kv_project", "mdk_kvstat_attention",
                  "mdk_kvstat_attention_pair", "mdk_geglu", "mdk_ff",
                  "mdk_flash_fwd", "mdk_flash_bwd_dq", "mdk_flash_bwd_dkv",
                  "mdk_out_project")
_SIGNATURES.update({f"{n}_f32": _SIGNATURES[n] for n in KERNEL_ENTRIES})
# the tile the fp32 K4 (0 or 1), or the fp32 kv and out projections (0 to
# 3), take for (M, N) on the current card; the fp32 attention kernels'
# tiles (rows a block, rows a streamed tile, blocks an SM) by kernel and
# depth, the flash kernels' also by grid (op, BH, Lq, D, what)
_SIGNATURES["mdk_geglu_f32_tile"] = (_I, [_I, _I])
_SIGNATURES["mdk_project_f32_tile"] = (_I, [_I, _I])
_SIGNATURES["mdk_kvstat_f32_tile"] = (_I, [_I, _I, _I])
_SIGNATURES["mdk_flash_f32_tile"] = (_I, [_I] * 5)


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cpp"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): the kernels cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmdk_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[pathlib.Path, str]:
    """Compile the sources if the library for their hash is missing: one
    ``nvcc -c`` per source, run in parallel, then one link. Returns the
    library path and the compilers' output (empty when reused). Raises with
    that output when a step fails."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", obj,
                 str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs, failed = [], False
        for src, proc in zip(sources(), procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            failed |= proc.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "".join(logs))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                               *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, path)  # atomic: a reader never sees a partial file
    return path, "".join(logs)


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built if needed)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


if __name__ == "__main__":
    p, log = build()
    print(p)
    print(log)
