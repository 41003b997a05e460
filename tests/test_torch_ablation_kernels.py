"""The port's masked-grid GEMM, dense int8 GEMM, flash attention and
tile-skip GEMM over BSR against the reference: the plain PyTorch versions
(what the wrappers run on CPU tensors) vs the Pallas kernels in interpret
mode and the ref.py oracles, on the same numpy inputs (cases of
tests/test_kernels.py and tests/test_flash_attn.py). The CUDA kernels
themselves are held against the plain versions in tests/test_torch_cuda.py.

Tolerances: 1e-4 for the fp32 GEMMs (summation order, the reference
tests' own bound), 2e-5 for fp32 attention (likewise), 3e-2 of the
output scale for bf16 attention against the fp32 oracle (one bf16 ulp is
2^-8), 2e-2 of the output scale for int8 against the unquantized
product (the reference's bound)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.quantization import dequantize_int8  # noqa: E402
from repro.core.quantization import quantize_int8  # noqa: E402
from repro.core.sparse import bsr_from_mask  # noqa: E402
from repro.core.sparse import bsr_matmul as ref_bsr_matmul  # noqa: E402
from repro.core.sparse import bsr_to_dense as ref_bsr_to_dense  # noqa: E402
from repro.kernels.flash_attn.kernel import flash_attention  # noqa: E402
from repro.kernels.flash_attn.ops import mha  # noqa: E402
from repro.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro.kernels.int8_gemm.ops import int8_matmul  # noqa: E402
from repro.kernels.int8_gemm.ref import int8_gemm_ref  # noqa: E402
from repro.kernels.sasp_gemm import ops as sasp_ops  # noqa: E402
from repro.kernels.sasp_gemm.ref import masked_dense_ref  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import quantization as t_quant  # noqa: E402
from repro_torch.core import sparse as t_sparse  # noqa: E402
from repro_torch.kernels.flash_attn import kernel as t_flash  # noqa: E402
from repro_torch.kernels.flash_attn import ops as t_flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as t_flash_ref  # noqa: E402
from repro_torch.kernels.int8_gemm import gemm as t_int8  # noqa: E402
from repro_torch.kernels.sasp_gemm import gemm as t_gemm  # noqa: E402
from repro_torch.kernels.sasp_gemm import masked as t_masked  # noqa: E402
from repro_torch.models.attention import attend_chunked  # noqa: E402
from torch_parity import to_np  # noqa: E402

RNG = np.random.default_rng(0)
T = torch.from_numpy


def _case(M, K, N, bk, bn, sparsity):
    x = RNG.normal(size=(M, K)).astype(np.float32)
    w = RNG.normal(size=(K, N)).astype(np.float32)
    mask = RNG.random((K // bk, N // bn)) > sparsity
    return x, w, mask


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


SWEEP = [
    (8, 16, 16, 8, 8, 0.0),
    (16, 32, 64, 8, 16, 0.3),
    (64, 128, 128, 32, 32, 0.5),
    (32, 64, 96, 16, 16, 0.9),
    (7, 16, 32, 8, 8, 0.4),          # ragged M
]


@pytest.mark.parametrize("M,K,N,bk,bn,sp", SWEEP)
def test_masked_matmul_vs_pallas(M, K, N, bk, bn, sp):
    x, w, mask = _case(M, K, N, bk, bn, sp)
    mask[:, 0] = False                       # a fully pruned column-block
    want = sasp_ops.masked_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(mask, jnp.int32),
                                  block_m=M, block_k=bk, block_n=bn)
    got = t_masked.masked_matmul(T(x), T(w), T(mask.astype(np.int32)))
    _close(got, want, 1e-4)
    _close(got, masked_dense_ref(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(mask)), 1e-4)
    assert not got[:, :bn].any()


def test_masked_matmul_bf16_rounds_weights_to_x():
    x, w, mask = _case(16, 64, 64, 16, 16, 0.5)
    x16 = jnp.asarray(x, jnp.bfloat16)
    want = sasp_ops.masked_matmul(x16, jnp.asarray(w),
                                  jnp.asarray(mask, jnp.int32), block_m=16,
                                  block_k=16, block_n=16)
    got = t_masked.masked_matmul(T(x).to(torch.bfloat16), T(w),
                                 T(mask.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err < 1e-2


@pytest.mark.parametrize("M,K,N,bk,bn", [
    (16, 32, 64, 8, 16), (64, 128, 128, 32, 32), (7, 16, 16, 8, 8),
    (32, 64, 64, 64, 64),
])
def test_int8_matmul_vs_pallas_and_ref(M, K, N, bk, bn):
    x = RNG.normal(size=(M, K)).astype(np.float32)
    w = RNG.normal(size=(K, N)).astype(np.float32)
    qw = quantize_int8(jnp.asarray(w), bk, bn)
    tqw = bridge.from_numpy(to_np(qw), device="cpu")
    assert isinstance(tqw, t_quant.QuantizedWeight)
    got = t_int8.int8_matmul(T(x), tqw)
    _close(got, int8_matmul(jnp.asarray(x), qw), 1e-4)
    _close(got, int8_gemm_ref(jnp.asarray(x), qw.q, qw.scale), 1e-4)
    _close(t_int8.int8_gemm_ref(T(x), tqw.q, tqw.scale),
           int8_gemm_ref(jnp.asarray(x), qw.q, qw.scale), 1e-4)
    full = x @ w
    assert np.abs(got.numpy() - full).max() / np.abs(full).max() < 2e-2


def test_quantize_int8_equals_reference():
    w = RNG.normal(size=(3, 64, 96)).astype(np.float32)
    for bk, bn in ((16, 32), (128, 8)):        # 128 > K: clamped to K
        ref = quantize_int8(jnp.asarray(w), bk, bn)
        mine = t_quant.quantize_int8(T(w), bk, bn)
        assert mine.block == tuple(ref.block)
        np.testing.assert_array_equal(mine.q.numpy(), np.asarray(ref.q))
        np.testing.assert_array_equal(mine.scale.numpy(),
                                      np.asarray(ref.scale))
        np.testing.assert_array_equal(
            t_quant.dequantize_int8(mine.layer(1)).numpy(),
            np.asarray(dequantize_int8(ref))[1])


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("M,K,N,bk,bn,sp", [
    (16, 64, 96, 16, 16, 0.5), (7, 32, 64, 8, 16, 0.3),
    (32, 128, 128, 32, 32, 0.8)])
def test_sasp_matmul_over_bsr_vs_pallas(M, K, N, bk, bn, sp, quantize):
    x, w, mask = _case(M, K, N, bk, bn, sp)
    mask[:, 1] = False                       # an all-padding column
    ref = bsr_from_mask(w, mask, bk, bn, quantize=quantize)
    mine = t_sparse.bsr_from_mask(w, mask, bk, bn, quantize=quantize,
                                  device="cpu")
    for f in ("vals", "idx", "scale"):
        a, b = getattr(mine, f), getattr(ref, f)
        if b is None:
            assert a is None
            continue
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n0 = t_gemm.launches
    got = t_gemm.sasp_matmul(T(x), mine)
    assert t_gemm.launches == n0                 # CPU: the plain version
    _close(got, sasp_ops.sasp_matmul(jnp.asarray(x), ref), 1e-4)
    _close(t_sparse.bsr_matmul(T(x), mine),
           ref_bsr_matmul(jnp.asarray(x), ref), 1e-4)
    np.testing.assert_array_equal(t_sparse.bsr_to_dense(mine).numpy(),
                                  np.asarray(ref_bsr_to_dense(ref)))
    if not quantize:
        _close(got, masked_dense_ref(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(mask)), 1e-4)


def test_bsr_visit_list_walks_columns_in_order():
    _, w, mask = _case(1, 64, 64, 16, 16, 0.5)
    bsr = t_sparse.bsr_from_mask(w, mask, 16, 16, device="cpu")
    vals, kn, col_ptr, scales = t_gemm.bsr_visit_list(bsr)
    k_max, NB = bsr.idx.shape
    assert scales is None and vals.shape == (k_max * NB, 16, 16)
    np.testing.assert_array_equal(col_ptr.numpy(),
                                  k_max * np.arange(NB + 1))
    for n in range(NB):
        seg = slice(n * k_max, (n + 1) * k_max)
        assert (kn[1, seg] == n).all()
        np.testing.assert_array_equal(kn[0, seg].numpy(),
                                      bsr.idx[:, n].numpy())
        np.testing.assert_array_equal(vals[seg].numpy(),
                                      bsr.vals[:, n].numpy())


def _qkv(H, Sq, Sk, D, Hk=None):
    Hk = Hk or H
    return (RNG.normal(size=(H, Sq, D)).astype(np.float32),
            RNG.normal(size=(Hk, Sk, D)).astype(np.float32),
            RNG.normal(size=(Hk, Sk, D)).astype(np.float32))


@pytest.mark.parametrize("H,Sq,Sk,D,win,bq,bk", [
    (2, 64, 64, 32, 10 ** 9, 32, 32),        # causal
    (4, 128, 128, 64, 32, 64, 64),           # sliding window
    (2, 64, 128, 32, 10 ** 9, 32, 32),       # Sq < Sk
    (1, 32, 32, 16, 8, 16, 16),              # tiny window
    (2, 42, 42, 128, 10 ** 9, 42, 42),       # ragged against 16 x 32 tiles
    (2, 1, 70, 64, 10 ** 9, 1, 70),          # one query, ragged keys
])
def test_flash_vs_pallas(H, Sq, Sk, D, win, bq, bk):
    q, k, v = _qkv(H, Sq, Sk, D)
    qp, kp = np.arange(Sk - Sq, Sk), np.arange(Sk)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(qp), jnp.asarray(kp), window=win,
                           block_q=bq, block_k=bk)
    got = t_flash.flash_attention(T(q), T(k), T(v), T(qp), T(kp),
                                  window=win)
    _close(got, want, 2e-5)
    _close(t_flash_ref.flash_attention_ref(T(q), T(k), T(v), T(qp), T(kp),
                                           window=win),
           flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(qp),
                               jnp.asarray(kp), window=win), 2e-5)


def test_flash_bf16_vs_fp32_ref():
    q, k, v = _qkv(2, 64, 64, 32)
    pos = np.arange(64)
    bf = [T(a).to(torch.bfloat16) for a in (q, k, v)]
    got = t_flash.flash_attention(*bf, T(pos), T(pos), window=10 ** 9)
    assert got.dtype == torch.bfloat16
    ref = flash_attention_ref(*(jnp.asarray(a.float().numpy()) for a in bf),
                              jnp.asarray(pos), jnp.asarray(pos),
                              window=10 ** 9)
    ref = np.asarray(ref)
    assert np.abs(got.float().numpy() - ref).max() / np.abs(ref).max() \
        < 3e-2


def test_flash_row_that_sees_no_key_is_zero():
    """Queries before every key (q_pos < kv_pos) see nothing: 0, as the
    reference kernel's max(l, 1e-20) flush gives."""
    q, k, v = _qkv(2, 8, 32, 16)
    qp = np.array([-3, -1, 0, 1, 5, 9, 20, 31])
    kp = np.arange(32)
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(qp), jnp.asarray(kp), window=4,
                           block_q=8, block_k=16)
    got = t_flash.flash_attention(T(q), T(k), T(v), T(qp), T(kp), window=4)
    _close(got, want, 2e-5)
    assert not got[:, :2].any() and got[:, 2:].abs().sum() > 0


def test_mha_gqa_vs_chunked_attention_and_pallas():
    B, S, H, KH, D = 2, 64, 8, 2, 16
    q = RNG.normal(size=(B, S, H, D)).astype(np.float32)
    k = RNG.normal(size=(B, S, KH, D)).astype(np.float32)
    v = RNG.normal(size=(B, S, KH, D)).astype(np.float32)
    pos = np.arange(S)
    got = t_flash_ops.mha(T(q), T(k), T(v), T(pos), T(pos), window=10 ** 9)
    chunked = attend_chunked(T(q).reshape(B, S, KH, H // KH, D), T(k), T(v),
                             T(pos), T(pos), window=S + 1
                             ).reshape(B, S, H, D)
    np.testing.assert_allclose(got.numpy(), chunked.numpy(), rtol=2e-5,
                               atol=2e-5)
    _close(got, mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(pos), jnp.asarray(pos), window=10 ** 9),
           2e-5)
