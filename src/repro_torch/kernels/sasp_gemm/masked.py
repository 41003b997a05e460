"""Masked-grid GEMM, the dense-grid ablation: ``x @ (W ⊙ mask)`` from the
dense weight and a block mask (port of
``repro.kernels.sasp_gemm.kernel.sasp_gemm_masked``).

``sasp_gemm_masked`` launches the CUDA kernel
(``csrc/sasp_gemm_masked.cu``) for CUDA tensors and runs
``sasp_gemm_masked_plain`` for CPU tensors. The kernel reads every
weight block and skips only the multiply-adds of pruned ones, where the
tile-skip kernel (``gemm.sasp_gemm``) skips the reads too. Its plan
(variant, tile, ring, k-block groups) is ``schedule.masked_plan``'s;
``sasp_gemm_masked_planned`` walks that plan's tiles, groups and
k-blocks in the kernel's order in plain PyTorch. ``launches`` counts
kernel launches, ``variant_launches`` the launches by variant ("tma":
TMA ring and tensor cores, bf16 x and W; "mma": tensor cores on the
shared cp.async loop; "fma": fp32 FMAs).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sasp_gemm import schedule
from repro_torch.kernels.sasp_gemm.gemm import as_type, check_words

launches = 0
variant_launches = {}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("sasp_gemm_masked").sasp_gemm_masked_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + \
        [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=4096)
def _plan(M: int, K: int, N: int, KB: int, NB: int, x_dtype, w_dtype):
    return schedule.masked_plan(M, K, N, KB, NB, x_dtype, w_dtype)


@functools.lru_cache(maxsize=None)
def _codes(x_dtype, w_dtype, variant: str):
    return (build.dtype_code(x_dtype), build.dtype_code(w_dtype),
            schedule.variant_code(variant))


def _launch(x, w, mask, out, plan) -> None:
    """Launch ``plan`` on checked, contiguous operands (the wrapper's, or
    ``tools/masked_sweep.py``'s alternative plans)."""
    (M, K), (KB, NB), N = x.shape, mask.shape, w.shape[1]
    partial = None if plan.groups == 1 else torch.empty(
        (plan.groups, M, N), dtype=torch.float32, device=x.device)
    code = _launch_fn()(
        x.data_ptr(), w.data_ptr(), mask.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        M, K, N, KB, NB, *_codes(x.dtype, w.dtype, plan.variant), plan.groups,
        plan.bm, plan.bn, plan.stages, plan.warps, plan.smem,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "sasp_gemm_masked")


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


def sasp_gemm_masked_planned(x: torch.Tensor, w: torch.Tensor,
                             mask: torch.Tensor, visits=None,
                             plan=None) -> torch.Tensor:
    """Plain PyTorch in the kernel's order: ``schedule.masked_visits`` of
    ``plan`` (by default the plan for these shapes and types), one fp32
    (rows, bk) @ (bk, bn) partial per live (k-block, column-block), added
    to its group's sum in ascending k; the groups added in order from
    zero; output in x's type. Appends every (m-tile, k-block,
    column-block) it walks to ``visits`` if given (a list). The variants
    off the TMA ring walk one column-block a tile."""
    (M, K), (KB, NB) = x.shape, mask.shape
    N = w.shape[1]
    bk, bn = K // KB, N // NB
    if plan is None:
        plan = schedule.masked_plan(M, K, N, KB, NB, x.dtype, w.dtype)
    if plan.variant != schedule.TMA:
        # one column-block a tile, the row tile the C side's
        plan = dataclasses.replace(plan, bm=M, bn=bn)
    xf = x.to(torch.float32)
    wf = w.to(x.dtype).to(torch.float32)
    live = mask.to(torch.bool)
    out = torch.zeros((M, N), dtype=torch.float32, device=x.device)
    sums = {}
    for mt, nt, g, kb, nbs in schedule.masked_visits(plan, M, KB, NB, bn):
        rows = slice(mt * plan.bm, min(M, (mt + 1) * plan.bm))
        for nb in nbs:
            if visits is not None:
                visits.append((mt, kb, nb))
            if not live[kb, nb]:
                continue
            cols = slice(nb * bn, (nb + 1) * bn)
            part = xf[rows, kb * bk:(kb + 1) * bk] @ wf[kb * bk:(kb + 1) * bk,
                                                         cols]
            key = (mt, nb, g)
            sums[key] = part if key not in sums else sums[key] + part
    for (mt, nb, g) in sorted(sums):
        rows = slice(mt * plan.bm, min(M, (mt + 1) * plan.bm))
        out[rows, nb * bn:(nb + 1) * bn] += sums[(mt, nb, g)]
    return out.to(x.dtype)


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
    x = as_type(x, x.dtype)
    w = as_type(w, w.dtype)
    mask = as_type(mask, torch.int32)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    check_words("sasp_gemm_masked", (x, K // KB), (w, N // NB))
    # the tile-skip kernel's visit groups, so that the two sum the same
    # partials in the same order
    plan = _plan(M, K, N, KB, NB, x.dtype, w.dtype)
    if plan.variant == schedule.TMA and (x.data_ptr() % 16 or
                                         w.data_ptr() % 16):
        # a tensor map's base must lie on a 16-byte boundary
        x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
    _launch(x, w, mask, out, plan)
    global launches
    launches += 1
    variant_launches[plan.variant] = variant_launches.get(plan.variant, 0) + 1
    return out


def masked_matmul(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """(…, K) @ (w ⊙ mask) -> (…, N) through the masked-grid kernel."""
    *lead, K = x.shape
    y = sasp_gemm_masked(x.reshape(-1, K), w, mask)
    return y.reshape(*lead, w.shape[1])
