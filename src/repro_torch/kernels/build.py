"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared
library under ``build/kernels/`` at the repository root (a few seconds
per file: no PyTorch headers), then loaded with ``ctypes``. The library
name carries a hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited kernel is rebuilt.
``build_all()`` starts one ``nvcc`` per source at once and waits for all.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check()`` raises on a non-zero code, so a refused launch (too many
threads, too much shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                         "..", "..", ".."))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]
SOURCES = ("sasp_gemm", "fused_ffn", "sasp_gemm_masked", "int8_gemm",
           "flash_attn")

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str):
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", out + ".tmp",
           os.path.join(CSRC, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(_lib_path(name) + ".tmp", _lib_path(name))


def build_all(names: List[str] = SOURCES) -> Dict[str, str]:
    """Compile every kernel source in parallel; returns name -> .so."""
    procs = {n: _start(n) for n in names}
    for n, p in procs.items():
        _finish(n, p)
    return {n: _lib_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(_lib_path(name))
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


# dtype codes shared with csrc/*.cu
DT_F32, DT_BF16, DT_I8 = 0, 1, 2
ACT_CODES = {None: 0, "silu": 1, "gelu": 2, "relu": 3}


def dtype_code(dt) -> int:
    import torch
    codes = {torch.float32: DT_F32, torch.bfloat16: DT_BF16,
             torch.int8: DT_I8}
    if dt not in codes:
        raise TypeError(f"kernel takes float32, bfloat16 or int8, not {dt}")
    return codes[dt]
