"""Fused gated FFN over surviving d_ff column-blocks (port of
``repro.kernels.sasp_gemm.kernel.sasp_fused_ffn``):
``act(x@W1v + b1) * (x@W3v + b3) @ W2v + b2``.

``fused_ffn`` launches the CUDA kernel (``csrc/fused_ffn.cu``) for CUDA
tensors and runs ``fused_ffn_plain`` for CPU tensors. ``launches``
counts kernel launches (one per call: the visit-split pass and its
fixed-order reduction of the partials).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sasp_gemm.gemm import ACTS

launches = 0

# Visit groups the kernel aims for: two thread blocks per SM of an H100.
TARGET_SPLITS = 264


def visits_per_split(nv: int) -> int:
    """Visits per thread block, chosen from nv alone so that a row's
    result never depends on how many rows share the call."""
    return max(1, math.ceil(nv / TARGET_SPLITS))


@functools.lru_cache(maxsize=None)
def _lib():
    """(launch entry point, largest d the kernel admits), set up once."""
    lib = build.load("fused_ffn")
    lib.fused_ffn_max_d.restype = ctypes.c_int
    lib.fused_ffn_max_d.argtypes = []
    lib.fused_ffn_launch.restype = ctypes.c_int
    lib.fused_ffn_launch.argtypes = [ctypes.c_void_p] * 12 + \
        [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib.fused_ffn_launch, lib.fused_ffn_max_d()


def fused_ffn_plain(x: torch.Tensor, w1v, w3v, w2v, b1, b3, b2, *,
                    act: str = "silu",
                    scales: Optional[Tuple] = None) -> torch.Tensor:
    """Plain-PyTorch version of the fused gated FFN, visit by visit."""
    xf = x.to(torch.float32)
    if scales is None:
        w1 = w1v.to(x.dtype).to(torch.float32)
        w3 = w3v.to(x.dtype).to(torch.float32)
        w2 = w2v.to(x.dtype).to(torch.float32)
    else:
        w1, w3, w2 = (w.to(torch.float32) for w in (w1v, w3v, w2v))
    u = torch.einsum("md,vdf->vmf", xf, w1)
    g = torch.einsum("md,vdf->vmf", xf, w3)
    if scales is not None:
        s1, s3, s2 = (s.to(torch.float32)[:, None, None] for s in scales)
        u, g = u * s1, g * s3
    u = u + b1.to(torch.float32)[:, None, :]
    g = g + b3.to(torch.float32)[:, None, :]
    h = ACTS[act](u) * g
    if scales is None:
        h = h.to(x.dtype).to(torch.float32)
    else:
        h = h * s2
    y = torch.einsum("vmf,vfd->md", h, w2) + b2.to(torch.float32)
    return y.to(x.dtype)


def fused_ffn(x: torch.Tensor, w1v, w3v, w2v, b1, b3, b2, *,
              act: str = "silu",
              scales: Optional[Tuple] = None) -> torch.Tensor:
    """x (M, d) -> (M, d) in x.dtype. w1v/w3v (nv, d, bf), w2v (nv, bf, d)
    fp32/bf16, or int8 with ``scales`` = (s1, s3, s2) each (nv,);
    b1/b3 (nv, bf), b2 (d,) fp32."""
    if act not in ACTS or act is None:
        raise ValueError(f"fused FFN needs an activation, got {act!r}")
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1v, w3v, w2v, b1, b3, b2, act=act,
                               scales=scales)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on cuda or cpu, not {x.device}")
    if x.ndim != 2 or w1v.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)} must be (M, d), w1v "
                         f"{tuple(w1v.shape)} (nv, d, bf)")
    M, d = x.shape
    nv, _, bf = w1v.shape
    if bf > 32:
        raise ValueError(f"block_f {bf} > 32 is not supported")
    if (w1v.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 values need scales, fp values take none")
    if not (w1v.dtype == w3v.dtype == w2v.dtype):
        raise ValueError("w1v, w3v and w2v must share one dtype")
    expect = [("w1v", w1v, (nv, d, bf)), ("w3v", w3v, (nv, d, bf)),
              ("w2v", w2v, (nv, bf, d)), ("b1", b1, (nv, bf)),
              ("b3", b3, (nv, bf)), ("b2", b2, (d,))]
    expect += [(f"s{i}", s, (nv,)) for i, s in zip((1, 3, 2), scales or ())]
    for name, t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    launch, max_d = _lib()
    if d > max_d:
        raise ValueError(f"d_model {d} exceeds the kernel's shared-memory "
                         f"accumulator ({max_d})")
    dev = x.device
    x = x.contiguous()
    w1v, w3v, w2v = w1v.contiguous(), w3v.contiguous(), w2v.contiguous()
    b1, b3, b2 = (b.to(torch.float32).contiguous() for b in (b1, b3, b2))
    sc = [None, None, None] if scales is None else [
        s.to(torch.float32).contiguous() for s in scales]
    vps = visits_per_split(nv)
    S = math.ceil(nv / vps)
    partial = torch.empty((S, M, d), dtype=torch.float32, device=dev)
    out = torch.empty((M, d), dtype=x.dtype, device=dev)
    if M == 0:
        return out
    code = launch(
        x.data_ptr(), w1v.data_ptr(), w3v.data_ptr(), w2v.data_ptr(),
        *[None if s is None else s.data_ptr() for s in sc],
        b1.data_ptr(), b3.data_ptr(), b2.data_ptr(), partial.data_ptr(),
        out.data_ptr(), M, d, bf, nv, vps, build.dtype_code(x.dtype),
        build.dtype_code(w1v.dtype), build.ACT_CODES[act],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "sasp_fused_ffn")
    global launches
    launches += 1
    return out
