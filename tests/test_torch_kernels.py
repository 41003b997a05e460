"""The port's tile-skip GEMM and fused gated FFN against the reference:
the plain PyTorch versions (what the wrappers run on CPU tensors) vs the
Pallas kernels in interpret mode and the ref.py oracles, on the same
numpy inputs — fp32, int8, bias, every activation, empty columns and
dup-last padding (cases of tests/test_kernels.py and
tests/test_fused_kernels.py). The CUDA kernels themselves are held
against the plain versions in tests/test_torch_cuda.py. Tolerance 1e-4
(fp32 summation order) unless stated."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.sasp_gemm import ops as sasp_ops  # noqa: E402
from repro.kernels.sasp_gemm.ref import (  # noqa: E402
    block_list_ref,
    epilogue_ref,
    fused_ffn_ref,
    masked_dense_ref,
)
from repro_torch.core.sparse import col_ptr_from_kn  # noqa: E402
from repro_torch.kernels.sasp_gemm import fused_ffn as t_ffn  # noqa: E402
from repro_torch.kernels.sasp_gemm import gemm as t_gemm  # noqa: E402
from repro_torch.kernels.sasp_gemm import pack as t_pack  # noqa: E402
import torch_parity  # noqa: E402,F401  (one torch thread per test worker)

RNG = np.random.default_rng(0)
T = torch.from_numpy


def _case(M, K, N, bk, bn, sparsity):
    x = RNG.normal(size=(M, K)).astype(np.float32)
    w = RNG.normal(size=(K, N)).astype(np.float32)
    mask = RNG.random((K // bk, N // bn)) > sparsity
    return x, w, mask


def _mask_dense(w, mask, bk, bn):
    KB, NB = mask.shape
    return (w.reshape(KB, bk, NB, bn) * mask[:, None, :, None]
            ).reshape(w.shape).astype(np.float32)


def _ffn_case(M, d, F, bk, bf, sp1, sp2):
    x = RNG.normal(size=(M, d)).astype(np.float32)
    w1 = RNG.normal(size=(d, F)).astype(np.float32)
    w3 = RNG.normal(size=(d, F)).astype(np.float32)
    w2 = RNG.normal(size=(F, d)).astype(np.float32) * 0.1
    m1 = RNG.random((d // bk, F // bf)) > sp1
    m3 = RNG.random((d // bk, F // bf)) > sp1
    m2 = RNG.random((F // bf, d // bk)) > sp2
    return (x, _mask_dense(w1, m1, bk, bf), _mask_dense(w3, m3, bk, bf),
            _mask_dense(w2, m2, bf, bk))


def _gemm(x, vals, kn, n, scales=None, bias=None, act=None):
    """Port wrapper on CPU tensors (its plain version)."""
    return t_gemm.sasp_gemm(
        T(x), T(np.asarray(vals)), T(np.asarray(kn)),
        col_ptr_from_kn(T(np.asarray(kn)), n // np.asarray(vals).shape[2]),
        n, scales=None if scales is None else T(np.asarray(scales)),
        bias=None if bias is None else T(bias), act=act).numpy()


SWEEP = [
    (8, 16, 16, 8, 8, 0.0),
    (16, 32, 64, 8, 16, 0.3),
    (64, 128, 128, 32, 32, 0.5),
    (32, 64, 96, 16, 16, 0.9),
    (7, 16, 32, 8, 8, 0.4),          # ragged M
]


@pytest.mark.parametrize("M,K,N,bk,bn,sp", SWEEP)
@pytest.mark.parametrize("act", [None, "silu", "gelu", "relu"])
def test_gemm_fp32_bias_act_vs_pallas(M, K, N, bk, bn, sp, act):
    x, w, mask = _case(M, K, N, bk, bn, sp)
    bias = RNG.normal(size=(N,)).astype(np.float32)
    vals, kn, _ = t_pack.build_kernel_weight(w, mask, bk, bn)
    got = _gemm(x, vals, kn, N, bias=bias, act=act)
    ref = np.asarray(sasp_ops.sasp_matmul_packed(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(kn), n=N,
        block_m=min(M, 128), bias=jnp.asarray(bias), act=act))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    oracle = np.asarray(epilogue_ref(masked_dense_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)), bias, act))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N,bk,bn,sp", SWEEP[:4])
def test_gemm_int8_vs_pallas(M, K, N, bk, bn, sp):
    x, w, mask = _case(M, K, N, bk, bn, sp)
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn,
                                              quantize=True)
    got = _gemm(x, vals, kn, N, scales=sc)
    ref = np.asarray(sasp_ops.sasp_matmul_packed(
        jnp.asarray(x), jnp.asarray(vals), jnp.asarray(kn), jnp.asarray(sc),
        n=N))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, block_list_ref(x, vals, kn, N,
                                                   scales=sc),
                               rtol=1e-4, atol=1e-4)


def test_gemm_int8_bias_silu_vs_oracle():
    M, K, N, bk, bn = 32, 64, 64, 16, 16
    x, w, mask = _case(M, K, N, bk, bn, 0.4)
    bias = RNG.normal(size=(N,)).astype(np.float32)
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn,
                                              quantize=True)
    got = _gemm(x, vals, kn, N, scales=sc, bias=bias, act="silu")
    ref = np.asarray(epilogue_ref(jnp.asarray(block_list_ref(
        x, vals, kn, N, scales=sc)), bias, "silu"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    dense = np.asarray(epilogue_ref(masked_dense_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)), bias, "silu"))
    assert np.abs(got - dense).max() / (np.abs(dense).max() + 1e-9) < 2e-2


def test_gemm_bf16_vs_pallas():
    """bf16 activations: the weight is rounded to bf16 before the
    product (kernel.py:78); bf16 output, so a sum taken in another order
    may round one bf16 ulp apart: tolerance 1e-2 of the output scale."""
    M, K, N, bk, bn = 32, 64, 64, 16, 16
    x, w, mask = _case(M, K, N, bk, bn, 0.5)
    vals, kn, _ = t_pack.build_kernel_weight(w, mask, bk, bn)
    got = t_gemm.sasp_gemm(
        T(x).to(torch.bfloat16), T(vals), T(kn),
        col_ptr_from_kn(T(kn), N // bn), N, act="relu"
    ).to(torch.float32).numpy()
    ref = np.asarray(sasp_ops.sasp_matmul_packed(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(vals), jnp.asarray(kn),
        n=N, act="relu").astype(jnp.float32))
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9) < 1e-2


def test_gemm_empty_columns_flush_act_bias():
    M, K, N, bk, bn = 16, 32, 32, 8, 8
    x, w, _ = _case(M, K, N, bk, bn, 0.0)
    mask = np.zeros((4, 4), bool)
    mask[:, 0] = True
    bias = RNG.normal(size=(N,)).astype(np.float32)
    vals, kn, _ = t_pack.build_kernel_weight(w, mask, bk, bn)
    got = _gemm(x, vals, kn, N, bias=bias, act="silu")
    want = np.asarray(epilogue_ref(jnp.zeros((1, N)), bias, "silu"))
    np.testing.assert_allclose(got[:, bn:], np.broadcast_to(
        want[:, bn:], (M, N - bn)), rtol=1e-5, atol=1e-5)
    ref = np.asarray(epilogue_ref(masked_dense_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask)), bias, "silu"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_gemm_dup_last_padding_adds_nothing():
    M, K, N, bk, bn = 16, 32, 64, 8, 16
    x, w, mask = _case(M, K, N, bk, bn, 0.5)
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn,
                                              quantize=True)
    y0 = _gemm(x, vals, kn, N, scales=sc)
    vp, kp, sp = t_pack.pad_block_list(vals, kn, sc, vals.shape[0] + 3)
    np.testing.assert_array_equal(kp[:, -1], kn[:, -1])
    y1 = _gemm(x, vp, kp, N, scales=sp)
    np.testing.assert_allclose(y0, y1, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("M,d,F,bk,bf,sp1,sp2", [
    (16, 32, 64, 8, 16, 0.0, 0.0),
    (32, 64, 128, 16, 16, 0.4, 0.4),
    (8, 32, 96, 8, 16, 0.7, 0.3),
    (7, 16, 32, 8, 8, 0.5, 0.5),     # ragged M
])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_fused_ffn_fp32_vs_pallas(M, d, F, bk, bf, sp1, sp2, act):
    x, w1m, w3m, w2m = _ffn_case(M, d, F, bk, bf, sp1, sp2)
    b1 = RNG.normal(size=(F,)).astype(np.float32)
    b3 = RNG.normal(size=(F,)).astype(np.float32)
    b2 = RNG.normal(size=(d,)).astype(np.float32)
    packed = t_pack.build_fused_ffn(w1m, w3m, w2m, block_f=bf, b1=b1,
                                    b3=b3, b2=b2)
    got = t_ffn.fused_ffn(T(x), *map(T, packed[:6]), act=act).numpy()
    ref = np.asarray(sasp_ops.fused_ffn_matmul(
        jnp.asarray(x), *map(jnp.asarray, packed[:6]), act=act,
        block_m=min(M, 128)))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    oracle = np.asarray(fused_ffn_ref(x, w1m, w3m, w2m, b1, b3, b2,
                                      act=act))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4)


def test_fused_ffn_int8_vs_pallas():
    M, d, F, bk, bf = 32, 64, 128, 16, 16
    x, w1m, w3m, w2m = _ffn_case(M, d, F, bk, bf, 0.4, 0.4)
    w1v, w3v, w2v, b1, b3, b2, sc = t_pack.build_fused_ffn(
        w1m, w3m, w2m, block_f=bf, quantize=True)
    got = t_ffn.fused_ffn(T(x), T(w1v), T(w3v), T(w2v), T(b1), T(b3), T(b2),
                          act="silu", scales=tuple(map(T, sc))).numpy()
    ref = np.asarray(sasp_ops.fused_ffn_matmul(
        jnp.asarray(x), *map(jnp.asarray, (w1v, w3v, w2v, b1, b3, b2)),
        scales=tuple(map(jnp.asarray, sc)), act="silu"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    dense = np.asarray(fused_ffn_ref(x, w1m, w3m, w2m, act="silu"))
    assert np.abs(got - dense).max() / (np.abs(dense).max() + 1e-9) < 5e-2


def test_fused_ffn_all_pruned_and_padding():
    """All of d_ff pruned -> one zero visit -> exactly b2; zero-w2v visit
    padding adds nothing."""
    M, d, F, bf = 8, 16, 32, 8
    x = RNG.normal(size=(M, d)).astype(np.float32)
    z = np.zeros((d, F), np.float32)
    b2 = RNG.normal(size=(d,)).astype(np.float32)
    pk = t_pack.build_fused_ffn(z, z, z.T.copy(), block_f=bf, b2=b2)
    assert pk[0].shape[0] == 1
    y = t_ffn.fused_ffn(T(x), *map(T, pk[:6]), act="silu").numpy()
    np.testing.assert_allclose(y, np.broadcast_to(b2, (M, d)), atol=1e-6)
    x, w1m, w3m, w2m = _ffn_case(16, 32, 64, 8, 16, 0.5, 0.5)
    a = t_pack.build_fused_ffn(w1m, w3m, w2m, block_f=16)
    b = t_pack.build_fused_ffn(w1m, w3m, w2m, block_f=16,
                               nv_pad=a[0].shape[0] + 2,
                               return_visits=True)
    assert (b[-1][-2:] == -1).all()
    ya = t_ffn.fused_ffn(T(x), *map(T, a[:6]), act="silu").numpy()
    yb = t_ffn.fused_ffn(T(x), *map(T, b[:6]), act="silu").numpy()
    np.testing.assert_allclose(ya, yb, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("quantize", [False, True])
def test_packers_equal_reference(quantize):
    """The port's numpy packers reproduce the reference's exactly."""
    x, w1m, w3m, w2m = _ffn_case(8, 32, 64, 8, 16, 0.5, 0.5)
    mine = t_pack.build_fused_ffn(w1m, w3m, w2m, block_f=16,
                                  quantize=quantize, nv_pad=6,
                                  return_visits=True)
    ref = sasp_ops.build_fused_ffn(w1m, w3m, w2m, block_f=16,
                                   quantize=quantize, nv_pad=6,
                                   return_visits=True)
    for a, b in zip(mine[:6] + mine[7:], ref[:6] + ref[7:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    if quantize:
        for a, b in zip(mine[6], ref[6]):
            np.testing.assert_array_equal(a, np.asarray(b))
    _, w, mask = _case(8, 32, 64, 8, 16, 0.6)
    mine = t_pack.build_kernel_weight(w, mask, 8, 16, quantize=quantize)
    ref = sasp_ops.build_kernel_weight(w, mask, 8, 16, quantize=quantize)
    for a, b in zip(mine, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, np.asarray(b))
