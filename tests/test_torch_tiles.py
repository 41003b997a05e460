"""The schedule of the port's flash-attention and dense int8 kernels, on
the CPU.

Flash attention: ``tile_class`` (the rule by which the CUDA kernel skips a
(query tile, key tile) pair, or leaves the mask out of it) is held against
the brute-force visibility matrix over random positions and windows:
SKIP must mean that no pair is visible, FULL that every pair is. The plain
version skips the tiles the rule skips; on positions that are not an
arange (a left-padded row) it is held against the Pallas kernel in
interpret mode (tolerance 2e-5, fp32 summation order, the reference
tests' own bound).

Dense int8 GEMM: the variant, column tile and k-block groups cover every
k-block once, in ascending order within a group, read no M, and send
k-blocks shallower than an MMA step to the FMA variant.
"""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.kernel import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as t_flash  # noqa: E402
from repro_torch.kernels.int8_gemm import schedule as i8s  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per test worker)

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # the fixed twins below still run
    HAVE_HYPOTHESIS = False

T = torch.from_numpy


def _check_tile_class(qp, kp, window, bq, bk):
    """Every (query tile, key tile) pair of bq x bk: SKIP => no visible
    pair, FULL => every pair visible and the tile whole."""
    qp, kp = np.asarray(qp, np.int64), np.asarray(kp, np.int64)
    qb = t_flash.tile_bounds(T(qp), bq)
    kb = t_flash.tile_bounds(T(kp), bk)
    seen = set()
    for i, (qmin, qmax) in enumerate(qb):
        qs = qp[i * bq:(i + 1) * bq]
        for j, (kmin, kmax) in enumerate(kb):
            ks = kp[j * bk:(j + 1) * bk]
            ragged = len(qs) < bq or len(ks) < bk
            cls = t_flash.tile_class(qmin, qmax, kmin, kmax, window, ragged)
            d = qs[:, None] - ks[None, :]
            vis = (d >= 0) & (d < window)
            if cls == t_flash.SKIP:
                assert not vis.any()
            elif cls == t_flash.FULL:
                assert vis.all() and not ragged
            seen.add(cls)
    return seen


def _positions(rng, n, kind):
    if kind == "arange":
        return np.arange(n) + int(rng.integers(-5, 50))
    if kind == "padded":                 # a left-padded batch row
        pad = int(rng.integers(0, n))
        return np.concatenate([np.full(pad, -1), np.arange(n - pad)])
    return np.sort(rng.integers(-20, 3 * n, size=n))   # repeats and gaps


@pytest.mark.parametrize("seed", range(8))
def test_tile_class_vs_brute_force_fixed(seed):
    rng = np.random.default_rng(seed)
    kinds = ("arange", "padded", "sorted")
    qp = _positions(rng, int(rng.integers(1, 150)), kinds[seed % 3])
    kp = _positions(rng, int(rng.integers(1, 150)), kinds[(seed + 1) % 3])
    for window in (1, 7, 40, 10 ** 9):
        for bq, bk in ((64, 64), (16, 32), (7, 5)):
            _check_tile_class(qp, kp, window, bq, bk)


def test_tile_class_sees_all_three_classes():
    """Causal attention over 200 positions in 64-tiles: tiles past the
    diagonal are skipped, tiles below it are full, the diagonal partial."""
    pos = np.arange(200)
    assert _check_tile_class(pos, pos, 10 ** 9, 64, 64) == {
        t_flash.SKIP, t_flash.PARTIAL, t_flash.FULL}


if HAVE_HYPOTHESIS:
    @settings(max_examples=60, deadline=None)
    @given(qp=st.lists(st.integers(-30, 200), min_size=1, max_size=90),
           kp=st.lists(st.integers(-30, 200), min_size=1, max_size=90),
           window=st.one_of(st.integers(1, 250), st.just(10 ** 9)),
           bq=st.integers(1, 64), bk=st.integers(1, 64),
           sort=st.booleans())
    def test_tile_class_vs_brute_force_property(qp, kp, window, bq, bk, sort):
        if sort:
            qp, kp = sorted(qp), sorted(kp)
        _check_tile_class(qp, kp, window, bq, bk)


def test_plain_skips_what_tile_class_skips(monkeypatch):
    """Causal self-attention over 300 positions: the plain version leaves
    out the key tiles past each query tile, and gives the dense oracle's
    result all the same."""
    from repro_torch.kernels.flash_attn import ref as t_ref

    rng = np.random.default_rng(1)
    q, k, v = (T(rng.normal(size=(2, 300, 16)).astype(np.float32))
               for _ in range(3))
    pos = T(np.arange(300))
    calls = []
    real = t_flash.tile_class
    monkeypatch.setattr(t_flash, "tile_class",
                        lambda *a: calls.append(real(*a)) or calls[-1])
    got = t_flash.flash_attention(q, k, v, pos, pos, window=10 ** 9)
    assert calls.count(t_flash.SKIP) > 0 and calls.count(t_flash.FULL) > 0
    np.testing.assert_allclose(
        got.numpy(), t_ref.flash_attention_ref(q, k, v, pos, pos,
                                               window=10 ** 9).numpy(),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [10 ** 9, 24])
def test_flash_left_padded_positions_vs_pallas(window):
    """Repeated negative positions (left padding) and a repeated position:
    the plain version with its tile skipping equals the Pallas kernel."""
    rng = np.random.default_rng(2)
    pos = np.concatenate([np.full(50, -1), np.arange(-3, 0), np.arange(107)])
    pos[100] = pos[99]
    S, D = pos.shape[0], 32
    q, k, v = (rng.normal(size=(2, S, D)).astype(np.float32)
               for _ in range(3))
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(pos), jnp.asarray(pos), window=window,
                           block_q=32, block_k=32)
    got = t_flash.flash_attention(T(q), T(k), T(v), T(pos), T(pos),
                                  window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_kernel_view_keeps_aligned_strided_views():
    """The flash wrapper hands strided (B, S, H, D) views to the kernel as
    they are; only a view the tensor-core kernel cannot read (a stride not
    a multiple of 8 elements, a misaligned base) is copied."""
    base = torch.zeros((2, 40, 12, 64), dtype=torch.bfloat16)
    view = base[:, 3:30, :8]
    assert t_flash._kernel_view(view, True) is view
    assert t_flash._kernel_view(view, False) is view
    odd = torch.zeros((2, 40, 12, 67), dtype=torch.bfloat16)[..., :64]
    assert t_flash._kernel_view(odd, True) is not odd
    assert t_flash._kernel_view(odd, False) is odd
    shifted = torch.zeros(64 * 9, dtype=torch.bfloat16)[1:1 + 64 * 8] \
        .reshape(1, 8, 1, 64)
    copied = t_flash._kernel_view(shifted, True)
    assert copied is not shifted and torch.equal(copied, shifted)


# ---------------------------------------------------------------------------
# the dense int8 GEMM's schedule
# ---------------------------------------------------------------------------

SHAPES = [(5120, 8192, 32, 32), (5120, 1024, 32, 32), (8192, 5120, 32, 32),
          (5120, 25600, 32, 32), (25600, 5120, 32, 32), (2048, 384, 32, 32),
          (256, 192, 8, 16), (256, 192, 64, 64), (1024, 96, 16, 48),
          (96, 64, 12, 8)]


def test_int8_schedule_reads_no_m():
    for fn in (i8s.int8_variant, i8s.col_tile, i8s.step_depth,
               i8s.int8_groups, i8s.k_bounds):
        params = inspect.signature(fn).parameters
        assert "M" not in params and "rows" not in params


@pytest.mark.parametrize("K,N,bk,bn", SHAPES)
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_int8_groups_cover_every_k_block_once(K, N, bk, bn, xdt):
    """Groups are consecutive, non-empty runs of k-blocks from 0 to KB: a
    block's k-blocks are added in ascending order within its group, the
    groups in order by the reduce."""
    variant = i8s.int8_variant(xdt, bk)
    KB = K // bk
    G = i8s.int8_groups(K, N, bk, variant)
    b = i8s.k_bounds(KB, G)            # csrc/int8_gemm.cu: kb0, kb1
    assert len(b) == G + 1 and G >= 1
    assert b[0] == 0 and b[-1] == KB and all(np.diff(b) > 0)
    covered = np.concatenate([np.arange(b[g], b[g + 1]) for g in range(G)])
    np.testing.assert_array_equal(covered, np.arange(KB))
    if G > 1:
        assert min(np.diff(b)) >= i8s.MIN_KB_PER_GROUP


@pytest.mark.parametrize("bk", [4, 8, 12, 16, 24, 32, 48, 64, 128, 256])
def test_int8_variant_takes_the_block_depth(bk):
    """bf16 x runs the tensor cores only where a k-block is one pipeline
    step of whole MMAs (16, 32, 64, 128); shallower blocks (bk = 8) and
    fp32 x go to the FMA variant, whose step divides bk."""
    v16 = i8s.int8_variant(torch.bfloat16, bk)
    assert v16 == (i8s.MMA if bk in (16, 32, 64, 128) else i8s.FMA)
    assert i8s.int8_variant(torch.float32, bk) == i8s.FMA
    if bk < 16:
        assert v16 == i8s.FMA
    for variant in {v16, i8s.FMA}:
        step = i8s.step_depth(bk, variant)
        assert step is not None and bk % step == 0
        if variant == i8s.MMA:
            assert step % 16 == 0
        assert i8s.col_tile(variant) % 32 == 0


def test_int8_qwen3_32b_groups_fill_the_card_at_decode():
    """Every projection of qwen3-32b gives a decode call at least one block
    per SM, unless its groups would fall under MIN_KB_PER_GROUP k-blocks;
    the deep w2 splits most."""
    shapes = {"wq": (5120, 8192), "wk": (5120, 1024), "wo": (8192, 5120),
              "w1": (5120, 25600), "w2": (25600, 5120)}
    groups = {}
    for name, (K, N) in shapes.items():
        G = i8s.int8_groups(K, N, 32, i8s.MMA)
        tiles = -(-N // i8s.col_tile(i8s.MMA))
        assert tiles * G >= min(i8s.SMS, tiles * (K // 32 //
                                                  i8s.MIN_KB_PER_GROUP))
        groups[name] = G
    assert groups["w2"] > groups["w1"] and groups["wk"] == max(groups.values())


def test_int8_gemm_on_cpu_runs_the_plain_version():
    from repro_torch.core.quantization import quantize_int8
    from repro_torch.kernels.int8_gemm import gemm as t_int8

    rng = np.random.default_rng(3)
    qw = quantize_int8(T(rng.normal(size=(64, 96)).astype(np.float32)), 16,
                       32)
    x = T(rng.normal(size=(5, 64)).astype(np.float32))
    n0, runs = t_int8.launches, dict(t_int8.variant_launches)
    got = t_int8.int8_matmul(x, qw)
    assert t_int8.launches == n0 and t_int8.variant_launches == runs
    torch.testing.assert_close(got, t_int8.int8_gemm_plain(x, qw.q, qw.scale),
                               rtol=0, atol=0)
