"""The schedule of the dense int8 GEMM (``csrc/int8_gemm.cu``), decided
here and passed to the C entry point.

The variant (tensor-core MMA or fp32 FMA), the column tile and the
k-block groups are functions of the operand type and the weight's shape
alone, never of the number of rows M: a row's result is the same bit for
bit whether it is computed alone or in a batch. The block's row tile,
which the C side picks from M, changes no row's sum.
"""
from __future__ import annotations

import math
import torch

from repro_torch.kernels.sasp_gemm.schedule import FMA, MMA, SMS, k_bounds

# at least one (column tile x k group) block per SM, so that a decode call
# streams its weight from every SM
MIN_BLOCKS = SMS
# at least one k group per this many k-blocks: a deep weight (w2, 800
# k-blocks of 32) splits further; each group costs an (M, N) fp32 partial,
# written and read once, which a prefill call pays for
KB_PER_GROUP = 100
# fewest k-blocks a group takes
MIN_KB_PER_GROUP = 8
# columns of a block's output tile, by variant (csrc/int8_gemm.cu MMA_BN,
# FMA_BN)
COL_TILE = {MMA: 128, FMA: 64}
# k-block depths the MMA variant takes: a pipeline step is one whole
# k-block, so that its first product starts from zero with no branch
MMA_DEPTHS = (16, 32, 64, 128)

__all__ = ["int8_variant", "col_tile", "step_depth", "int8_groups",
           "k_bounds", "MMA", "FMA"]


def int8_variant(x_dtype, bk: int) -> str:
    """Tensor cores for bf16 x when a k-block is 16, 32, 64 or 128 deep
    (one pipeline step): int8 weights and bf16 x are exact in bf16, so the
    products are exact. fp32 x stays on fp32 FMAs (TF32 would round x), as
    do other block depths (bk = 8 among them, shallower than an MMA)."""
    if x_dtype == torch.bfloat16 and bk in MMA_DEPTHS:
        return MMA
    return FMA


def step_depth(bk: int, variant: str):
    """Rows of k a pipeline step copies (csrc/int8_gemm.cu
    ``launch_depth``): MMA a whole k-block; FMA the deepest of 32, 16, 8, 4
    that divides bk, None where none does (the kernel does not take such a
    block)."""
    if variant == MMA:
        return bk
    for d in (32, 16, 8, 4):
        if bk % d == 0:
            return d
    return None


def col_tile(variant: str) -> int:
    return COL_TILE[variant]


def int8_groups(K: int, N: int, bk: int, variant: str) -> int:
    """k-block groups: enough (column tile x group) blocks for one per SM,
    one group per KB_PER_GROUP k-blocks where that is more, no group under
    MIN_KB_PER_GROUP k-blocks. From the weight's shape and the variant
    alone (qwen3-32b, 32-deep blocks: wq 3, wk/wv 17, wo 4, w1/w3 2, w2
    8). Group g takes the k-blocks [k_bounds(KB, G)[g], ...[g + 1])."""
    KB = K // bk
    tiles = math.ceil(N / col_tile(variant))
    want = max(math.ceil(MIN_BLOCKS / tiles), round(KB / KB_PER_GROUP))
    return max(1, min(want, KB // MIN_KB_PER_GROUP))
