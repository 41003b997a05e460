"""The schedule of the SASP kernels (``csrc/tile_mma.cuh`` and the three
kernels on it), decided here and passed to the C entry points.

Every choice that can change the order in which one output's products are
summed — the variant (tensor-core MMA or fp32 FMA), the visit groups of
the tile-skip and masked-grid GEMMs, the visit groups of the fused FFN's
down-projection — is a function of the operand types and the weight's
shape alone, never of the number of rows M: a row's result is the same
bit for bit whether it is computed alone or in a batch. The block shapes
the C side picks from M (``tile::mma_geom``) change no row's sum.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

# SMs of an H100
SMS = 132
# (column tile x visit group) blocks the tile-skip / masked-grid GEMM aims
# for: a decode call streams its weights from many columns at once
GROUP_BLOCKS = 8 * SMS
# fewest k-blocks a visit group of the tile-skip / masked-grid GEMM takes
MIN_KB_PER_GROUP = 16
# fewest visits a down-projection group of the fused FFN takes
MIN_VISITS_PER_GROUP = 16
FFN_DOWN_COLS = 128     # columns of d a down-projection block takes at prefill

MMA, FMA = "mma", "fma"
_VARIANT_CODE = {FMA: 0, MMA: 1}


def variant_code(variant: str) -> int:
    return _VARIANT_CODE[variant]


def gemm_variant(x_dtype, w_dtype, bk: int, bn: int) -> str:
    """Tensor cores for bf16 x (weights are exact in bf16 or rounded to it
    as the reference rounds them) with a block the MMA tile takes: bk a
    multiple of 16 and bn of 16. fp32 x stays on fp32 FMAs (TF32 would
    round x)."""
    del w_dtype  # fp32, bf16 and int8 weights all enter the MMA as bf16
    if x_dtype == torch.bfloat16 and bk % 16 == 0 and bn % 16 == 0:
        return MMA
    return FMA


def gemm_groups(KB: int, NB: int) -> int:
    """Visit groups per output column-block: about GROUP_BLOCKS
    column-block x group blocks, no group under MIN_KB_PER_GROUP
    k-blocks. From the block grid (KB, NB) alone."""
    return max(1, min(math.ceil(GROUP_BLOCKS / NB), KB // MIN_KB_PER_GROUP))


def k_bounds(KB: int, G: int) -> List[int]:
    """Group g takes the k-blocks [b[g], b[g+1])."""
    return [g * KB // G for g in range(G + 1)]


def group_spans(kcoord: np.ndarray, col_ptr: np.ndarray, KB: int,
                G: int) -> np.ndarray:
    """The kernels' split of each column's visits, (NB, G + 1) visit
    offsets: group g of column n takes visits [s[n, g], s[n, g + 1]),
    s[n, g] = the first visit of the column whose k-block is >= b[g]
    (csrc/sasp_gemm.cu ``scan_column``)."""
    kcoord = np.asarray(kcoord)
    col_ptr = np.asarray(col_ptr)
    bounds = k_bounds(KB, G)
    NB = col_ptr.shape[0] - 1
    spans = np.empty((NB, G + 1), dtype=np.int64)
    for n in range(NB):
        v0, v1 = int(col_ptr[n]), int(col_ptr[n + 1])
        ks = kcoord[v0:v1]
        for g, b in enumerate(bounds):
            hit = np.nonzero(ks >= b)[0]
            spans[n, g] = v0 + (int(hit[0]) if hit.size else v1 - v0)
    return spans


def ffn_up_depth(d: int) -> int:
    """Depth of one up-projection step: 64-deep slices of d where d allows
    (half the steps, and half the barriers, of 32; the sums are the same
    chain of 16-deep products either way)."""
    for ks in (64, 32, 16, 8, 4, 2):
        if d % ks == 0:
            return ks
    return 1


def ffn_variants(x_dtype, quantized: bool, d: int, bf: int
                 ) -> Tuple[str, str]:
    """(up, down). Up: tensor cores for bf16 x when its step depth is a
    multiple of 16 and 2·bf a tile width (16, 32, 64). Down: tensor cores
    for the fp path's bf16 h when bf is a multiple of 16 and d of 64; the
    int8 path keeps h in fp32 and runs its down-projection as FMAs."""
    bf16 = x_dtype == torch.bfloat16
    up = MMA if bf16 and ffn_up_depth(d) % 16 == 0 and 2 * bf in (16, 32, 64) \
        else FMA
    down = MMA if bf16 and not quantized and bf % 16 == 0 and d % 64 == 0 \
        else FMA
    return up, down


def ffn_down_groups(nv: int, d: int) -> Tuple[int, int]:
    """(groups, visits per group) of the down-projection: as many groups
    as let one wave of (128-column tile x group) blocks, the prefill
    tiling, fill the SMs, no group under MIN_VISITS_PER_GROUP visits.
    From nv and d alone; every group is non-empty."""
    tiles = math.ceil(d / FFN_DOWN_COLS)
    G = max(1, min(SMS // tiles, nv // MIN_VISITS_PER_GROUP))
    vps = math.ceil(nv / G)
    return math.ceil(nv / vps), vps
