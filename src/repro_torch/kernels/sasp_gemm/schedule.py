"""The schedule of the SASP kernels (``csrc/tile_mma.cuh`` and the three
kernels on it, and the masked grid's TMA variant, ``csrc/tma_ring.cuh``),
decided here and passed to the C entry points.

Every choice that can change the order in which one output's products are
summed — the variant (tensor-core MMA or fp32 FMA), the visit groups of
the tile-skip and masked-grid GEMMs, the visit groups of the fused FFN's
down-projection — is a function of the operand types and the weight's
shape alone, never of the number of rows M: a row's result is the same
bit for bit whether it is computed alone or in a batch. The block shapes
the C side picks from M (``tile::mma_geom``), and the masked grid's tile
rows and columns and its ring (``masked_plan``), change no row's sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Tuple

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
# the masked grid's TMA-fed variant (bf16 x and W; csrc/sasp_gemm_masked.cu)
TMA = "tma"
_VARIANT_CODE = {FMA: 0, MMA: 1, TMA: 2}


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
    k-blocks. From the block grid (KB, NB) alone; a TP col shard passes
    the whole weight's NB, so it sums each column in the whole weight's
    order."""
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


# ---------------------------------------------------------------------------
# the masked grid (csrc/sasp_gemm_masked.cu)
# ---------------------------------------------------------------------------

# k-block depths and column-block widths the TMA variant takes: a stage
# holds STAGE_K rows of k, whole k-blocks of it, and a wide tile whole
# column-blocks
TMA_BK = (16, 32, 64)
TMA_BN = (16, 32, 64, 128)
STAGE_K = 64          # rows of k a stage holds: one x box row of 128 bytes
BOX_COLS = 64         # W and x boxes: 64 bf16 = 128 bytes, the 128-byte swizzle's row
BOX_MAX = 256         # TMA's limit on each box dimension
SWIZZLE_BYTES = 128
SMEM_LIMIT = 227 * 1024                 # dynamic shared memory a block may take
DECODE_ROWS = 16      # one m16 tile: a decode block (M <= 16) ...
DECODE_WARP_COLS = 16  # ... 16 columns a warp
WARP_ROWS = 32        # prefill: 32 rows x 64 columns a warp ...
WARP_COLS = 64
MAX_WARP_ROWS = 6     # ... in up to 6 x 2 warps: 192 x 128
PREFILL_COLS = 128
# ring stages (tools/masked_sweep.py on an H100; PERF.md): four 18 KB
# stages let three decode blocks share an SM; five 40 KB stages a
# prefill block, which has the SM alone (its registers)
DECODE_STAGES = 4
PREFILL_STAGES = 5


@dataclasses.dataclass(frozen=True)
class MaskedPlan:
    """How the masked grid computes one call. ``variant`` "tma" (bf16 x and
    W: TMA ring, mma.sync), "mma" or "fma" (tile_mma.cuh's loop, one
    column-block a block, its tile from M on the C side: the fields after
    ``groups`` are 0 here). ``groups`` and their k-blocks are
    ``gemm_groups`` / ``k_bounds``'s, the tile-skip kernel's: one group a
    block, (G, M, N) fp32 partials reduced in group order when G > 1. A
    TMA block computes a ``bm`` x ``bn`` tile with ``warps`` consumer
    warps (and one producer) over a ring of ``stages`` stages in ``smem``
    bytes of dynamic shared memory; the C side refuses a launch whose
    ``warps`` or ``smem`` differ from its own count. Its TMA boxes are
    (``BOX_COLS`` columns, ``bm`` rows) of x and (``BOX_COLS``, bk or
    ``STAGE_K`` rows) of W."""
    variant: str
    groups: int
    bm: int = 0
    bn: int = 0
    stages: int = 0
    warps: int = 0
    smem: int = 0


def tma_takes(x_dtype, w_dtype, bk: int, bn: int) -> bool:
    """The TMA variant: bf16 x and W (exact in the bf16 fragment), k-blocks
    whole in a 64-deep stage, column-blocks whole in a 64- or 128-column
    tile."""
    return (x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16
            and bk in TMA_BK and bn in TMA_BN)


def masked_smem(bm: int, bn: int, stages: int, words: int) -> int:
    """Dynamic shared memory of a TMA block: 1024 bytes to align the ring,
    the stages (x box and W boxes), two mbarriers a stage, the mask words
    of its group (csrc/sasp_gemm_masked.cu ``tma_smem_bytes``)."""
    return 1024 + stages * (bm + bn) * STAGE_K * 2 + 16 * stages + 4 * words


def masked_plan(M: int, K: int, N: int, KB: int, NB: int, x_dtype,
                w_dtype) -> MaskedPlan:
    """The masked grid's plan. Groups from the block grid alone (the
    tile-skip kernel's); M chooses only the tile rows and the ring (decode
    or prefill)."""
    bk, bn = K // KB, N // NB
    G = gemm_groups(KB, NB)
    if not tma_takes(x_dtype, w_dtype, bk, bn):
        return MaskedPlan(gemm_variant(x_dtype, w_dtype, bk, bn), G)
    if M <= DECODE_ROWS:
        # decode: the wider tile where it still gives a block an SM
        tile = max(bn, 128 if math.ceil(N / 128) * G >= SMS else 64)
        return tma_plan(G, KB, DECODE_ROWS, tile, DECODE_STAGES)
    return tma_plan(G, KB,
                    WARP_ROWS * min(MAX_WARP_ROWS, math.ceil(M / WARP_ROWS)),
                    PREFILL_COLS, PREFILL_STAGES)


def tma_plan(groups: int, KB: int, bm: int, bn: int, stages: int
             ) -> MaskedPlan:
    """A TMA plan of ``bm`` x ``bn`` tiles over ``stages`` stages, with the
    warps and shared memory the C side counts for it: 16 x 16 warp tiles
    when bm is ``DECODE_ROWS``, else 32 x 64 (``masked_plan``'s, and
    ``tools/masked_sweep.py``'s alternatives)."""
    if bm == DECODE_ROWS:
        warps = bn // DECODE_WARP_COLS
    else:
        warps = (bm // WARP_ROWS) * (bn // WARP_COLS)
    return MaskedPlan(TMA, groups, bm, bn, stages, warps,
                      masked_smem(bm, bn, stages, math.ceil(KB / groups)))


def masked_blocks(plan: MaskedPlan, M: int, N: int) -> int:
    """Thread blocks of one TMA launch (its main kernel)."""
    return math.ceil(M / plan.bm) * math.ceil(N / plan.bn) * plan.groups


def masked_visits(plan: MaskedPlan, M: int, KB: int, NB: int, bn: int
                  ) -> Iterator[Tuple[int, int, int, int, range]]:
    """The TMA variant's walk, in the kernel's order: for each block (m-tile,
    n-tile, group), each k-block of the group in ascending order, with
    the column-blocks of the tile it predicates. Yields (m-tile, n-tile,
    group, k-block, column-blocks)."""
    b = k_bounds(KB, plan.groups)
    nbt = plan.bn // bn
    for mt in range(math.ceil(M / plan.bm)):
        for nt in range(math.ceil(NB / nbt)):
            for g in range(plan.groups):
                for kb in range(b[g], b[g + 1]):
                    yield mt, nt, g, kb, range(nt * nbt,
                                               min(NB, (nt + 1) * nbt))
