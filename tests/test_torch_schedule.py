"""The schedule of the port's SASP kernels (``repro_torch.kernels.sasp_gemm.
schedule``), on the CPU: every split of the visits is a function of the
weight alone and covers every visit exactly once; the masked grid and the
tile-skip kernel over the BSR of the same weights group the live tiles
alike (what makes the two bit-identical on the card); and the fused FFN's
two per-phase plain functions (the gated up-projection into h, the
down-projection of h) compose to the reference's ``sasp_fused_ffn``, run
as the JAX tests run it (Pallas in interpret mode). Tolerance 1e-4 (fp32
summation order)."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sasp_gemm import ops as sasp_ops  # noqa: E402
from repro_torch.core.sparse import bsr_from_mask, col_ptr_from_kn  # noqa: E402
from repro_torch.kernels.sasp_gemm import fused_ffn as t_ffn  # noqa: E402
from repro_torch.kernels.sasp_gemm import gemm as t_gemm  # noqa: E402
from repro_torch.kernels.sasp_gemm import pack as t_pack  # noqa: E402
from repro_torch.kernels.sasp_gemm import schedule  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per test worker)

RNG = np.random.default_rng(0)
T = torch.from_numpy


def _mask(KB, NB, sparsity):
    m = RNG.random((KB, NB)) > sparsity
    m[:, 0] = False                          # an empty column
    return m


def _assert_partition(spans, col_ptr):
    """Group boundaries rise from each column's first visit to its end:
    every visit falls in exactly one group."""
    col_ptr = np.asarray(col_ptr)
    assert (spans[:, 0] == col_ptr[:-1]).all()
    assert (spans[:, -1] == col_ptr[1:]).all()
    assert (np.diff(spans, axis=1) >= 0).all()


def test_no_plan_reads_the_row_count():
    """No split or variant can depend on M."""
    for fn in (schedule.gemm_variant, schedule.gemm_groups,
               schedule.k_bounds, schedule.group_spans,
               schedule.ffn_up_depth, schedule.ffn_variants,
               schedule.ffn_down_groups):
        params = inspect.signature(fn).parameters
        assert "M" not in params and "rows" not in params


@pytest.mark.parametrize("KB,NB", [(160, 32), (160, 256), (256, 160),
                                   (800, 160), (8, 6), (16, 3), (3, 1)])
def test_gemm_groups_from_the_block_grid(KB, NB):
    G = schedule.gemm_groups(KB, NB)
    assert 1 <= G <= max(1, KB // schedule.MIN_KB_PER_GROUP)
    if G > 1:
        assert NB * (G - 1) < schedule.GROUP_BLOCKS
    b = schedule.k_bounds(KB, G)
    assert b[0] == 0 and b[-1] == KB and all(np.diff(b) > 0)


def test_qwen3_32b_projections_split_most_where_columns_are_few():
    # wk / wv (32 column-blocks) split most; every projection gives a
    # decode call four blocks per SM, unless its groups would fall under
    # MIN_KB_PER_GROUP k-blocks
    shapes = ((160, 256), (160, 32), (256, 160), (160, 800), (800, 160))
    groups = [schedule.gemm_groups(KB, NB) for KB, NB in shapes]
    assert groups[1] == max(groups)
    for (KB, NB), G in zip(shapes, groups):
        most = KB // schedule.MIN_KB_PER_GROUP
        assert NB * G >= min(4 * schedule.SMS, NB * most)


@pytest.mark.parametrize("KB,NB,sp,pad", [(32, 8, 0.5, 3), (16, 3, 0.2, 0),
                                          (64, 4, 0.9, 5)])
def test_packed_visit_groups_cover_every_visit_once(KB, NB, sp, pad):
    bk = bn = 4
    mask = _mask(KB, NB, sp)
    w = RNG.normal(size=(KB * bk, NB * bn)).astype(np.float32)
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn)
    vals, kn, sc = t_pack.pad_block_list(vals, kn, sc, vals.shape[0] + pad)
    col_ptr = col_ptr_from_kn(T(kn), NB).numpy()
    for G in (1, 2, 3, schedule.gemm_groups(KB, NB)):
        spans = schedule.group_spans(kn[0], col_ptr, KB, G)
        _assert_partition(spans, col_ptr)
        b = schedule.k_bounds(KB, G)
        for n in range(NB):
            for g in range(G):
                ks = kn[0, spans[n, g]:spans[n, g + 1]]
                live = vals[spans[n, g]:spans[n, g + 1]].any(axis=(1, 2))
                assert ((ks[live] >= b[g]) & (ks[live] < b[g + 1])).all()


@pytest.mark.parametrize("KB,NB,sp", [(32, 8, 0.5), (16, 3, 0.7),
                                      (40, 5, 0.1)])
def test_bsr_groups_match_the_masked_grid(KB, NB, sp):
    """The BSR view's zero padding (k = 0 after the live visits) falls in
    the last group that holds live visits; the live visits of group g are
    exactly the mask's live k-blocks in [b[g], b[g+1]), in ascending
    order: the masked grid's group g."""
    bk = bn = 4
    mask = _mask(KB, NB, sp)
    w = RNG.normal(size=(KB * bk, NB * bn)).astype(np.float32) + 3.0
    bsr = bsr_from_mask(w, mask, bk, bn, device="cpu")
    vals, kn, col_ptr, _ = t_gemm.bsr_visit_list(bsr)
    kn, col_ptr = kn.numpy(), col_ptr.numpy()
    live_visit = vals.numpy().any(axis=(1, 2))
    for G in (1, 2, 4, schedule.gemm_groups(KB, NB)):
        spans = schedule.group_spans(kn[0], col_ptr, KB, G)
        _assert_partition(spans, col_ptr)
        b = schedule.k_bounds(KB, G)
        for n in range(NB):
            for g in range(G):
                seg = slice(spans[n, g], spans[n, g + 1])
                got = kn[0, seg][live_visit[seg]]
                want = np.nonzero(mask[b[g]:b[g + 1], n])[0] + b[g]
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nv", [1, 15, 16, 17, 100, 800, 803, 4000])
@pytest.mark.parametrize("d", [64, 256, 5120])
def test_ffn_down_groups_cover_every_visit_once(nv, d):
    G, vps = schedule.ffn_down_groups(nv, d)
    assert G >= 1 and vps >= 1
    covered = np.concatenate([np.arange(g * vps, min(nv, (g + 1) * vps))
                              for g in range(G)])
    np.testing.assert_array_equal(covered, np.arange(nv))
    assert (G - 1) * vps < nv                    # no empty group
    if G > 1:
        assert vps >= schedule.MIN_VISITS_PER_GROUP


def test_variants_follow_types_and_shapes():
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    assert schedule.gemm_variant(bf16, bf16, 32, 32) == "mma"
    assert schedule.gemm_variant(bf16, i8, 32, 32) == "mma"
    assert schedule.gemm_variant(bf16, f32, 16, 64) == "mma"
    assert schedule.gemm_variant(f32, f32, 32, 32) == "fma"
    assert schedule.gemm_variant(bf16, bf16, 8, 32) == "fma"
    assert schedule.gemm_variant(bf16, bf16, 32, 8) == "fma"
    assert schedule.ffn_variants(bf16, False, 5120, 32) == ("mma", "mma")
    assert schedule.ffn_variants(bf16, True, 5120, 32) == ("mma", "fma")
    assert schedule.ffn_variants(f32, False, 5120, 32) == ("fma", "fma")
    assert schedule.ffn_variants(bf16, False, 256, 8) == ("mma", "fma")


def _ffn_case(M, d, F, bk, bf, sp):
    x = RNG.normal(size=(M, d)).astype(np.float32)
    ws = []
    for shape, blk in (((d, F), (bk, bf)), ((d, F), (bk, bf)),
                       ((F, d), (bf, bk))):
        w = RNG.normal(size=shape).astype(np.float32)
        m = RNG.random((shape[0] // blk[0], shape[1] // blk[1])) > sp
        ws.append((w.reshape(m.shape[0], blk[0], m.shape[1], blk[1])
                   * m[:, None, :, None]).reshape(shape))
    ws[2] *= 0.1
    return x, ws


@pytest.mark.parametrize("M,d,F,bk,bf,sp", [
    (16, 32, 64, 8, 16, 0.0),
    (32, 64, 128, 16, 16, 0.4),
    (7, 16, 32, 8, 8, 0.5),          # ragged M
])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_phases_compose_to_pallas_fp32(M, d, F, bk, bf, sp, act):
    x, (w1, w3, w2) = _ffn_case(M, d, F, bk, bf, sp)
    b1 = RNG.normal(size=(F,)).astype(np.float32)
    b3 = RNG.normal(size=(F,)).astype(np.float32)
    b2 = RNG.normal(size=(d,)).astype(np.float32)
    pk = t_pack.build_fused_ffn(w1, w3, w2, block_f=bf, b1=b1, b3=b3,
                                b2=b2, nv_pad=F // bf + 2)
    w1v, w3v, w2v, b1v, b3v, b2v = map(T, pk[:6])
    h = t_ffn.ffn_up_plain(T(x), w1v, w3v, b1v, b3v, act=act)
    assert h.shape == (M, w1v.shape[0] * bf) and h.dtype == torch.float32
    got = t_ffn.ffn_down_plain(h, w2v, b2v, out_dtype=torch.float32).numpy()
    ref = np.asarray(sasp_ops.fused_ffn_matmul(
        jnp.asarray(x), *map(jnp.asarray, pk[:6]), act=act,
        block_m=min(M, 128)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_ffn_phases_compose_to_pallas_int8():
    x, (w1, w3, w2) = _ffn_case(32, 64, 128, 16, 16, 0.4)
    w1v, w3v, w2v, b1, b3, b2, sc = t_pack.build_fused_ffn(
        w1, w3, w2, block_f=16, quantize=True)
    s1, s3, s2 = map(T, sc)
    h = t_ffn.ffn_up_plain(T(x), T(w1v), T(w3v), T(b1), T(b3), act="silu",
                           scales=(s1, s3, s2))
    assert h.dtype == torch.float32               # the int8 path keeps h fp32
    got = t_ffn.ffn_down_plain(h, T(w2v), T(b2), out_dtype=torch.float32,
                               s2=s2).numpy()
    ref = np.asarray(sasp_ops.fused_ffn_matmul(
        jnp.asarray(x), *map(jnp.asarray, (w1v, w3v, w2v, b1, b3, b2)),
        scales=tuple(map(jnp.asarray, sc)), act="silu"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_ffn_up_plain_rounds_h_to_bf16():
    """The fp path's h is in x's type, as the reference rounds it."""
    x, (w1, w3, w2) = _ffn_case(4, 32, 64, 8, 16, 0.3)
    pk = t_pack.build_fused_ffn(w1, w3, w2, block_f=16)
    xb = T(x).to(torch.bfloat16)
    h = t_ffn.ffn_up_plain(xb, *map(T, (pk[0], pk[1], pk[3], pk[4])))
    assert h.dtype == torch.bfloat16
    two = t_ffn.ffn_down_plain(h, T(pk[2]), T(pk[5]),
                               out_dtype=torch.bfloat16)
    one = t_ffn.fused_ffn_plain(xb, *map(T, pk[:6]))
    err = (two.float() - one.float()).abs().max()
    assert float(err) <= 1e-2 * float(one.float().abs().max())
