"""Tile-skip GEMM: ``act(x @ (W ⊙ mask) + bias)`` over a packed visit
list (port of ``repro.kernels.sasp_gemm.kernel.sasp_gemm``).

``sasp_gemm`` launches the CUDA kernel (``csrc/sasp_gemm.cu``) for CUDA
tensors and runs ``sasp_gemm_plain`` — the same function in plain
PyTorch — for CPU tensors. ``launches`` counts kernel launches. The
variant and the visit groups come from ``schedule``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.sasp_gemm import schedule

launches = 0
# launches by variant ("mma": tensor cores, "fma": fp32 FMAs)
variant_launches = {}
# launches by weight type ("bfloat16", "float32", "int8"): the int8
# forms apart from the fp ones (a self-speculation drafter's from its
# target's)
weight_launches = {}

# activations of the flush epilogue; gelu is jax.nn.gelu's tanh form
ACTS = {
    None: lambda v: v,
    "silu": F.silu,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),
    "relu": F.relu,
}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("sasp_gemm").sasp_gemm_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    return fn


def sasp_gemm_plain(x: torch.Tensor, vals: torch.Tensor, kn: torch.Tensor,
                    n: int, scales: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    act: Optional[str] = None) -> torch.Tensor:
    """Plain-PyTorch version: one (M, bk) @ (bk, bn) product per visit,
    added onto its output column-block. fp: weights rounded to x.dtype,
    fp32 products; int8: fp32, partials scaled per visit.

    Each column-block sums its visits in list order (k order), one
    visit per pass, with no atomics, so a call gives the same bits on
    every run, on the card as on the CPU."""
    M, K = x.shape
    nnz, bk, bn = vals.shape
    NBc = n // bn
    kn = kn.to(torch.int64)
    xg = x.reshape(M, K // bk, bk)[:, kn[0]].to(torch.float32)  # (M,nnz,bk)
    if scales is None:
        w = vals.to(x.dtype).to(torch.float32)
    else:
        w = vals.to(torch.float32)
    part = torch.einsum("mvk,vkn->vmn", xg, w)                  # (nnz,M,bn)
    if scales is not None:
        part = part * scales.to(torch.float32)[:, None, None]
    # table[c, t]: the t-th visit of column-block c in list order (nnz,
    # a zero partial, past a column's last visit)
    cols = kn[1]
    order = torch.sort(cols, stable=True).indices
    counts = torch.bincount(cols, minlength=NBc)
    sc = cols[order]
    rank = torch.arange(nnz, device=x.device) - \
        (torch.cumsum(counts, 0) - counts)[sc]
    depth = int(counts.max()) if nnz else 0
    table = torch.full((NBc, max(depth, 1)), nnz, dtype=torch.int64,
                       device=x.device)
    table[sc, rank] = order
    part = torch.cat([part, part.new_zeros((1, M, bn))])
    acc = torch.zeros((NBc, M, bn), dtype=torch.float32, device=x.device)
    for t in range(depth):
        acc = acc + part[table[:, t]]
    y = acc.permute(1, 0, 2).reshape(M, n)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return ACTS[act](y).to(x.dtype)


def as_type(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """t as a contiguous tensor of ``dtype`` (t itself where it is one,
    without the dispatch ``contiguous()`` costs even then)."""
    if t is None or (t.dtype == dtype and t.is_contiguous()):
        return t
    return t.to(dtype).contiguous()


@functools.lru_cache(maxsize=None)
def _plan(x_dtype, w_dtype, K: int, group_nb: int, bk: int, bn: int, act):
    """(variant, the launch's type / activation / variant codes, visit
    groups): a function of the types and the weight's shape alone (for a
    col shard, of the whole weight's block grid)."""
    variant = schedule.gemm_variant(x_dtype, w_dtype, bk, bn)
    codes = (build.dtype_code(x_dtype), build.dtype_code(w_dtype),
             build.ACT_CODES[act], schedule.variant_code(variant))
    return variant, codes, schedule.gemm_groups(K // bk, group_nb)


def check_words(what: str, *rows) -> None:
    """The kernels copy rows of x and weights into shared memory in
    pieces of at least 4 bytes: every (tensor, row length) given must
    start on a 4-byte boundary and hold whole 4-byte words."""
    for t, n in rows:
        if (n * t.element_size()) % 4 or t.data_ptr() % 4:
            raise ValueError(f"{what}: rows of {n} {t.dtype} values are not "
                             f"whole, aligned 4-byte words")


def sasp_gemm(x: torch.Tensor, vals: torch.Tensor, kn: torch.Tensor,
              col_ptr: torch.Tensor, n: int,
              scales: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              act: Optional[str] = None,
              group_nb: Optional[int] = None) -> torch.Tensor:
    """x (M, K) @ packed weight -> (M, n) in x.dtype. vals (nnz, bk, bn)
    fp32/bf16, or int8 with ``scales`` (nnz,); kn (2, nnz) int32 sorted
    by (n, k); col_ptr (n // bn + 1,) int32; bias (n,) fp32. ``group_nb``:
    the column-blocks of the whole weight when this one is a col shard of
    it (default n // bn): the visit groups come from the whole weight's
    grid, so each column sums its visits as it does unsharded."""
    if act not in ACTS:
        raise ValueError(f"unknown activation {act!r}")
    if x.device.type == "cpu":
        return sasp_gemm_plain(x, vals, kn, n, scales, bias, act)
    if x.device.type != "cuda":
        raise ValueError(f"sasp_gemm runs on cuda or cpu, not {x.device}")
    if x.ndim != 2 or vals.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)} must be (M, K), vals "
                         f"{tuple(vals.shape)} (nnz, bk, bn)")
    M, K = x.shape
    nnz, bk, bn = vals.shape
    if K % bk or n % bn:
        raise ValueError(f"shape ({K}, {n}) not divisible by block "
                         f"({bk}, {bn})")
    if (vals.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 values need scales, fp values take none")
    for name, t, shape in (("kn", kn, (2, nnz)),
                           ("col_ptr", col_ptr, (n // bn + 1,)),
                           ("scales", scales, (nnz,)), ("bias", bias, (n,))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if vals.device != x.device:
        raise ValueError(f"vals on {vals.device}, x on {x.device}")
    x = as_type(x, x.dtype)
    vals = as_type(vals, vals.dtype)
    kcoord = as_type(kn[0], torch.int32)
    col_ptr = as_type(col_ptr, torch.int32)
    scales = as_type(scales, torch.float32)
    bias = as_type(bias, torch.float32)
    out = torch.empty((M, n), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    check_words("sasp_gemm", (x, bk), (vals, bn))
    variant, codes, G = _plan(x.dtype, vals.dtype, K,
                              group_nb or n // bn, bk, bn, act)
    partial = None if G == 1 else torch.empty(
        (G, M, n), dtype=torch.float32, device=x.device)
    code = _launch_fn()(
        x.data_ptr(), vals.data_ptr(), kcoord.data_ptr(), col_ptr.data_ptr(),
        None if scales is None else scales.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        M, K, n, bk, bn, *codes, G,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "sasp_gemm")
    global launches
    launches += 1
    variant_launches[variant] = variant_launches.get(variant, 0) + 1
    wkey = str(vals.dtype)[6:]
    weight_launches[wkey] = weight_launches.get(wkey, 0) + 1
    return out


def bsr_visit_list(w):
    """A ``BlockSparseWeight``'s per-call visit-list view: every padded
    (j, n) slot becomes a visit, n-major, so column n owns visits
    [k_max·n, k_max·(n+1)). Returns (vals (k_max·NB, bk, bn), kn (2,
    k_max·NB), col_ptr (NB + 1,), scales or None). Padding slots are zero
    blocks and add nothing; ``col_ptr`` is built directly, since the
    padding's k = 0 breaks the k order within a column."""
    k_max, NB = w.idx.shape
    bk, bn = w.block
    dev = w.vals.device
    vals = w.vals.permute(1, 0, 2, 3).reshape(k_max * NB, bk, bn)
    kn = torch.stack([
        w.idx.t().reshape(-1).to(torch.int32),
        torch.arange(NB, dtype=torch.int32, device=dev
                     ).repeat_interleave(k_max)])
    col_ptr = k_max * torch.arange(NB + 1, dtype=torch.int32, device=dev)
    scales = None if w.scale is None else w.scale.t().reshape(-1)
    return vals, kn, col_ptr, scales


def sasp_matmul(x: torch.Tensor, w, group_nb: Optional[int] = None
                ) -> torch.Tensor:
    """(…, K) @ ``BlockSparseWeight`` -> (…, N) through the tile-skip
    kernel, repacking the container into a visit list on every call (the
    cost the ``kernel`` path pays and the ``packed`` path avoids).
    ``group_nb``: the column blocks of the whole weight when ``w`` is a
    TP column shard of it (``sasp_gemm``)."""
    *lead, K = x.shape
    vals, kn, col_ptr, scales = bsr_visit_list(w)
    y = sasp_gemm(x.reshape(-1, K), vals, kn, col_ptr, w.shape[1],
                  scales=scales, group_nb=group_nb)
    return y.reshape(*lead, w.shape[1]).to(x.dtype)
