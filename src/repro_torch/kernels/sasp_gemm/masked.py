"""Masked-grid GEMM, the dense-grid ablation: ``x @ (W ⊙ mask)`` from the
dense weight and a block mask (port of
``repro.kernels.sasp_gemm.kernel.sasp_gemm_masked``).

``sasp_gemm_masked`` launches the CUDA kernel
(``csrc/sasp_gemm_masked.cu``) for CUDA tensors and runs
``sasp_gemm_masked_plain`` for CPU tensors. The kernel reads every
weight block and skips only the multiply-adds of pruned ones, where the
tile-skip kernel (``gemm.sasp_gemm``) skips the reads too. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sasp_gemm import schedule
from repro_torch.kernels.sasp_gemm.gemm import check_words

launches = 0


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("sasp_gemm_masked").sasp_gemm_masked_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    return fn


def _block_mask(mask: torch.Tensor, bk: int, bn: int) -> torch.Tensor:
    return mask.to(torch.bool).repeat_interleave(bk, 0) \
        .repeat_interleave(bn, 1)


def sasp_gemm_masked_plain(x: torch.Tensor, w: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch version: weights rounded to x's type, pruned blocks
    zeroed, fp32 products and sums, output in x's type."""
    (K, N), (KB, NB) = w.shape, mask.shape
    wm = w.to(x.dtype).to(torch.float32) * _block_mask(mask, K // KB,
                                                      N // NB)
    return torch.matmul(x.to(torch.float32), wm).to(x.dtype)


def sasp_gemm_masked(x: torch.Tensor, w: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ (w (K, N) ⊙ mask) -> (M, N) in x.dtype. mask (KB, NB),
    nonzero = keep; bk = K / KB, bn = N / NB."""
    if x.device.type == "cpu":
        return sasp_gemm_masked_plain(x, w, mask)
    if x.device.type != "cuda":
        raise ValueError(f"sasp_gemm_masked runs on cuda or cpu, not "
                         f"{x.device}")
    if x.ndim != 2 or w.ndim != 2 or mask.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)} and mask "
                         f"{tuple(mask.shape)} must be 2-D")
    (M, K), (K2, N), (KB, NB) = x.shape, w.shape, mask.shape
    if K != K2 or KB == 0 or NB == 0 or K % KB or N % NB:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)} with "
                         f"mask {tuple(mask.shape)}: shapes do not tile")
    for name, t in (("w", w), ("mask", mask)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"{name} must be float32 or bfloat16, not "
                            f"{t.dtype}")
    x = x.contiguous()
    w = w.contiguous()
    mask = mask.to(torch.int32).contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    bk, bn = K // KB, N // NB
    check_words("sasp_gemm_masked", (x, bk), (w, bn))
    # the tile-skip kernel's variant and visit groups, so that
    # the two sum the same partials in the same order
    variant = schedule.gemm_variant(x.dtype, w.dtype, bk, bn)
    G = schedule.gemm_groups(KB, NB)
    partial = None if G == 1 else torch.empty(
        (G, M, N), dtype=torch.float32, device=x.device)
    code = _launch_fn()(
        x.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        M, K, N, KB, NB, build.dtype_code(x.dtype), build.dtype_code(w.dtype),
        schedule.variant_code(variant), G,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "sasp_gemm_masked")
    global launches
    launches += 1
    return out


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """(…, K) @ (w ⊙ mask) -> (…, N) through the masked-grid kernel."""
    *lead, K = x.shape
    y = sasp_gemm_masked(x.reshape(-1, K), w, mask)
    return y.reshape(*lead, w.shape[1])
