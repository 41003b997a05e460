"""The masked grid's plan (``repro_torch.kernels.sasp_gemm.schedule.
masked_plan``) on the CPU: its k-block groups are the tile-skip kernel's
and do not move with M, its tiles hold whole mask column-blocks, its TMA
boxes obey the hardware's rules, its shared memory fits a block, and it
puts a block on every SM at decode for every qwen3-32b projection. The
plain walk of the plan (``masked.sasp_gemm_masked_planned``) visits every
(k-block, column-block) of each row tile once and gives the plain
version's product (1e-5: the same fp32 partials, summed per group) and
the reference's ``masked_matmul`` run as its tests run it (Pallas in
interpret mode; 1e-4, the reference tests' own bound), in the order of
the fp32 plan and of the bf16 TMA plan (wide tiles, groups) alike."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sasp_gemm import ops as sasp_ops  # noqa: E402
from repro_torch.kernels.sasp_gemm import masked as t_masked  # noqa: E402
from repro_torch.kernels.sasp_gemm import schedule  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per test worker)

RNG = np.random.default_rng(0)
T = torch.from_numpy
BF16 = torch.bfloat16

# qwen3-32b projections, 32 x 32 tiles: (K, N)
QWEN3_32B = {"wq": (5120, 8192), "wk/wv": (5120, 1024), "wo": (8192, 5120),
             "w1/w3": (5120, 25600), "w2": (25600, 5120)}
# (K, N, bk, bn): the card tests' shapes and the model's
SHAPES = [(256, 192, 32, 32), (256, 192, 16, 64), (256, 192, 64, 16),
          (1024, 1024, 32, 32), (2048, 384, 32, 128), (512, 320, 16, 32),
          *[(K, N, 32, 32) for K, N in QWEN3_32B.values()]]
ROWS = [1, 4, 16, 17, 37, 70, 168, 200]


@pytest.mark.parametrize("K,N,bk,bn", SHAPES)
def test_groups_are_the_tile_skip_kernels_and_ignore_m(K, N, bk, bn):
    KB, NB = K // bk, N // bn
    for M in ROWS:
        plan = schedule.masked_plan(M, K, N, KB, NB, BF16, BF16)
        assert plan.variant == schedule.TMA
        assert plan.groups == schedule.gemm_groups(KB, NB)
        b = schedule.k_bounds(KB, plan.groups)
        assert b[0] == 0 and b[-1] == KB and all(np.diff(b) > 0)


@pytest.mark.parametrize("K,N,bk,bn", SHAPES)
@pytest.mark.parametrize("M", ROWS)
def test_tiles_boxes_and_shared_memory(K, N, bk, bn, M):
    KB, NB = K // bk, N // bn
    plan = schedule.masked_plan(M, K, N, KB, NB, BF16, BF16)
    # tile columns are whole mask column-blocks, whole W boxes
    assert plan.bn % bn == 0 and plan.bn % schedule.BOX_COLS == 0
    # a stage holds whole k-blocks
    assert schedule.STAGE_K % bk == 0
    # TMA, 128-byte swizzle: inner box <= 128 bytes, each box dimension
    # <= 256, global rows a multiple of 16 bytes. The boxes the C side
    # encodes: (BOX_COLS, bm) of x, (BOX_COLS, bk) and (BOX_COLS, STAGE_K)
    # of W; the C side refuses a box that breaks these rules, and a plan
    # whose smem or warps differ from its own (the card tests launch
    # every plan shape here)
    for cols, rows in ((schedule.BOX_COLS, plan.bm), (schedule.BOX_COLS, bk),
                       (schedule.BOX_COLS, schedule.STAGE_K)):
        assert cols * 2 <= schedule.SWIZZLE_BYTES
        assert 0 < cols <= schedule.BOX_MAX and 0 < rows <= schedule.BOX_MAX
    assert (K * 2) % 16 == 0 and (N * 2) % 16 == 0
    # the ring, its barriers and the mask words fit one block
    assert plan.smem == schedule.masked_smem(
        plan.bm, plan.bn, plan.stages, math.ceil(KB / plan.groups))
    assert plan.smem <= schedule.SMEM_LIMIT
    # consumer warps: the C side's grid of 16 x 16 (decode) or 32 x 64
    # warp tiles
    if M <= schedule.DECODE_ROWS:
        assert plan.bm == 16 and plan.warps == plan.bn // 16 <= 8
    else:
        assert plan.bm % 32 == 0 and plan.bm <= 192
        assert plan.warps == (plan.bm // 32) * (plan.bn // 64) <= 12
        assert plan.bm >= min(M, 192) - 31


@pytest.mark.parametrize("proj", sorted(QWEN3_32B))
def test_decode_puts_a_block_on_every_sm(proj):
    K, N = QWEN3_32B[proj]
    plan = schedule.masked_plan(4, K, N, K // 32, N // 32, BF16, BF16)
    assert schedule.masked_blocks(plan, 4, N) >= schedule.SMS


@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.float32, BF16),
                                     (BF16, torch.float32)])
@pytest.mark.parametrize("M", [4, 168])
def test_other_types_stay_on_the_shared_loop(xdt, wdt, M):
    """fp32 x never plans a tensor-core variant; fp32 W under bf16 x keeps
    the tile-skip kernel's mma.sync loop."""
    plan = schedule.masked_plan(M, 5120, 8192, 160, 256, xdt, wdt)
    assert plan.variant == schedule.gemm_variant(xdt, wdt, 32, 32)
    if xdt == torch.float32:
        assert plan.variant == schedule.FMA
    assert plan.groups == schedule.gemm_groups(160, 256)


@pytest.mark.parametrize("bk,bn", [(8, 32), (32, 8), (128, 32), (32, 256),
                                   (48, 32)])
def test_blocks_a_box_cannot_take_stay_on_the_shared_loop(bk, bn):
    plan = schedule.masked_plan(4, 48 * bk, 24 * bn, 48, 24, BF16, BF16)
    assert plan.variant != schedule.TMA


def _case(M, K, N, bk, bn, sparsity):
    x = RNG.normal(size=(M, K)).astype(np.float32)
    w = RNG.normal(size=(K, N)).astype(np.float32)
    mask = RNG.random((K // bk, N // bn)) > sparsity
    mask[:, 0] = False                       # an empty output column
    return x, w, mask


@pytest.mark.parametrize("M,K,N,bk,bn,sp", [
    (4, 256, 192, 32, 32, 0.5), (37, 256, 192, 16, 64, 0.5),
    (70, 256, 192, 64, 16, 0.3), (17, 1024, 1024, 32, 32, 0.5),
    (200, 512, 320, 16, 32, 0.6), (1, 2048, 384, 32, 128, 0.5)])
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
def test_plan_order_visits_every_block_once_and_matches(M, K, N, bk, bn, sp,
                                                        xdt):
    x, w, mask = _case(M, K, N, bk, bn, sp)
    typ = getattr(torch, xdt)
    xt, wt = T(x).to(typ), T(w).to(typ)
    mt = T(mask.astype(np.int32))
    visits = []
    got = t_masked.sasp_gemm_masked_planned(xt, wt, mt, visits)
    KB, NB = mask.shape
    plan = schedule.masked_plan(M, K, N, KB, NB, typ, typ)
    m_tiles = math.ceil(M / plan.bm) if plan.variant == schedule.TMA else 1
    assert sorted(visits) == [(mt_, kb, nb) for mt_ in range(m_tiles)
                              for kb in range(KB) for nb in range(NB)]
    want = t_masked.sasp_gemm_masked_plain(xt, wt, mt).float()
    scale = float(want.abs().max())
    tol = 1e-5 if xdt == "float32" else 2 ** -7      # one bf16 ulp, output
    assert float((got.float() - want).abs().max()) <= tol * scale
    if xdt == "float32":
        ref = np.asarray(sasp_ops.masked_matmul(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask, jnp.int32),
            block_m=M, block_k=bk, block_n=bn))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N,bk,bn,sp", [
    (4, 256, 192, 32, 32, 0.5), (37, 256, 192, 16, 64, 0.5),
    (70, 256, 192, 64, 16, 0.3), (17, 1024, 1024, 32, 32, 0.5),
    (200, 512, 320, 16, 32, 0.6), (1, 2048, 384, 32, 128, 0.5),
    (168, 1600, 320, 32, 32, 0.5)])
def test_tma_plan_order_matches_the_reference(M, K, N, bk, bn, sp):
    """The walk in the TMA variant's order (wide tiles, its row tile, the
    groups) on fp32 operands that bf16 holds exactly, so that the walk's
    fp32 sums are those of the bf16 kernel's plan: every (k-block,
    column-block) once per row tile, the plain version within 1e-5 and
    the reference's Pallas ``masked_matmul`` within 1e-4."""
    x, w, mask = _case(M, K, N, bk, bn, sp)
    x = T(x).to(BF16).float().numpy()
    w = T(w).to(BF16).float().numpy()
    xt, wt, mt = T(x), T(w), T(mask.astype(np.int32))
    KB, NB = mask.shape
    plan = schedule.masked_plan(M, K, N, KB, NB, BF16, BF16)
    assert plan.variant == schedule.TMA
    visits = []
    got = t_masked.sasp_gemm_masked_planned(xt, wt, mt, visits, plan=plan)
    assert got.dtype == torch.float32
    assert sorted(visits) == [(mt_, kb, nb)
                              for mt_ in range(math.ceil(M / plan.bm))
                              for kb in range(KB) for nb in range(NB)]
    want = t_masked.sasp_gemm_masked_plain(xt, wt, mt)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    ref = np.asarray(sasp_ops.masked_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask, jnp.int32),
        block_m=M, block_k=bk, block_n=bn))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_plan_order_of_an_all_pruned_and_an_all_live_mask():
    x, w, _ = _case(37, 256, 192, 32, 32, 0.5)
    xt, wt = T(x), T(w)
    for keep in (False, True):
        mt = torch.full((8, 6), int(keep), dtype=torch.int32)
        got = t_masked.sasp_gemm_masked_planned(xt, wt, mt)
        want = t_masked.sasp_gemm_masked_plain(xt, wt, mt)
        if keep:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        else:
            assert not got.any()
