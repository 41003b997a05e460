"""Dense weight-only int8 GEMM with the per-block scale applied to each
k-block partial (port of ``repro.kernels.int8_gemm.kernel.int8_gemm``):
the paper's FP32_INT8 configuration without pruning.

``int8_gemm`` launches the CUDA kernel (``csrc/int8_gemm.cu``) for CUDA
tensors and runs ``int8_gemm_plain`` — the kernel's own arithmetic in
plain PyTorch — for CPU tensors. ``int8_gemm_ref`` dequantizes and then
multiplies (``repro.kernels.int8_gemm.ref``), which rounds differently.
``launches`` counts kernel launches, ``variant_launches`` the launches
by variant ("mma": tensor cores, "fma": fp32 FMAs); the variant, column
tile and k-block groups come from ``schedule``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.quantization import QuantizedWeight
from repro_torch.kernels import build
from repro_torch.kernels.int8_gemm import schedule
from repro_torch.kernels.sasp_gemm.gemm import as_type, check_words
from repro_torch.kernels.sasp_gemm.schedule import variant_code

launches = 0
variant_launches = {}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("int8_gemm").int8_gemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _plan(x_dtype, K: int, N: int, KB: int):
    """(variant, pipeline step depth, the launch's type / variant / column
    tile / group arguments): a function of the type and the weight's shape
    alone."""
    bk = K // KB
    variant = schedule.int8_variant(x_dtype, bk)
    step = schedule.step_depth(bk, variant)
    if step is None:
        raise ValueError(f"int8_gemm: k-blocks of {bk} rows; the kernel "
                         f"takes a multiple of 4")
    return variant, step, (build.dtype_code(x_dtype), variant_code(variant),
                           schedule.col_tile(variant),
                           schedule.int8_groups(K, N, bk, variant))


def int8_gemm_plain(x: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version: x widened to fp32, one (M, bk) @ (bk, N)
    partial per k-block, scaled per (k, n) block and added in ascending
    k; output in x's type."""
    (M, K), (K2, N), (KB, NB) = x.shape, w_q.shape, scale.shape
    bk, bn = K // KB, N // NB
    xf = x.to(torch.float32)
    wf = w_q.to(torch.float32)
    s = scale.to(torch.float32).repeat_interleave(bn, 1)        # (KB, N)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    for kb in range(KB):
        k0 = kb * bk
        acc = acc + torch.matmul(xf[:, k0:k0 + bk], wf[k0:k0 + bk]) * s[kb]
    return acc.to(x.dtype)


def int8_gemm_ref(x: torch.Tensor, w_q: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """Dequantize, then one fp32 matmul; output in x's type."""
    (K, N), (KB, NB) = w_q.shape, scale.shape
    bk, bn = K // KB, N // NB
    wq = w_q.reshape(KB, bk, NB, bn).to(torch.float32)
    w = (wq * scale.to(torch.float32)[:, None, :, None]).reshape(K, N)
    return torch.matmul(x.to(torch.float32), w).to(x.dtype)


def int8_gemm(x: torch.Tensor, w_q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32/bf16 @ int8 w_q (K, N) with fp32 scale (KB, NB) per
    (K / KB, N / NB) block -> (M, N) in x.dtype."""
    if x.device.type == "cpu":
        return int8_gemm_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, not {x.device}")
    if x.ndim != 2 or w_q.ndim != 2 or scale.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)}, w_q {tuple(w_q.shape)} and "
                         f"scale {tuple(scale.shape)} must be 2-D")
    (M, K), (K2, N), (KB, NB) = x.shape, w_q.shape, scale.shape
    if K != K2 or KB == 0 or NB == 0 or K % KB or N % NB:
        raise ValueError(f"x {tuple(x.shape)} @ w_q {tuple(w_q.shape)} "
                         f"with scale {tuple(scale.shape)}: shapes do not "
                         f"tile")
    if w_q.dtype != torch.int8:
        raise TypeError(f"w_q must be int8, not {w_q.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    for name, t in (("w_q", w_q), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if N % 4:
        raise ValueError(f"w_q {tuple(w_q.shape)}: N must be a multiple of 4")
    x = as_type(x, x.dtype)
    w_q = as_type(w_q, torch.int8)
    scale = as_type(scale, torch.float32)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    variant, step, codes = _plan(x.dtype, K, N, KB)
    check_words("int8_gemm", (x, step), (w_q, N))
    G = codes[-1]
    partial = None if G == 1 else torch.empty(
        (G, M, N), dtype=torch.float32, device=x.device)
    code = _launch_fn()(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        M, K, N, KB, NB, *codes,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "int8_gemm")
    global launches
    launches += 1
    variant_launches[variant] = variant_launches.get(variant, 0) + 1
    return out


def int8_matmul(x: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """(…, K) @ QuantizedWeight -> (…, N), dequantization fused in the
    kernel."""
    *lead, K = x.shape
    y = int8_gemm(x.reshape(-1, K), qw.q, qw.scale)
    return y.reshape(*lead, qw.q.shape[-1])
