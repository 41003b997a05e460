"""The port's CUDA kernels on the card (marker ``cuda``; every test skips
where ``torch.cuda.is_available()`` is false). Each kernel variant is
held against its plain PyTorch version on the same CUDA tensors, and the
packed engine's streams must not depend on which requests share a batch;
the serving tier on the card: a 2-rank scheduler against the solo engine,
tracing on and off bit for bit, and a ``host_worker`` process; one train
step on the card against the same step on the CPU; TP col shards of wq's
grid equal to their columns of the unsharded kernel bit for bit; the
layer-by-layer build's peak at full width; the vocab-sharded gather and
head of 2 ranks sharing the card against the replicated ones.
Imports torch and repro_torch only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance, as a fraction of the largest output: 1e-4 with fp32
activations (summation order), 2e-2 with bf16 outputs (one bf16 ulp is
2^-8 of the value)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.sparse import col_ptr_from_kn  # noqa: E402
from repro_torch.kernels.sasp_gemm import fused_ffn as t_ffn  # noqa: E402
from repro_torch.kernels.sasp_gemm import gemm as t_gemm  # noqa: E402
from repro_torch.kernels.sasp_gemm import pack as t_pack  # noqa: E402

RNG = np.random.default_rng(0)
T = torch.from_numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _masked(shape, bk, bn, sparsity):
    w = RNG.normal(size=shape).astype(np.float32)
    mask = RNG.random((shape[0] // bk, shape[1] // bn)) > sparsity
    KB, NB = mask.shape
    return (w.reshape(KB, bk, NB, bn) * mask[:, None, :, None]
            ).reshape(shape), mask


def _close(got, want, tol):
    err = (got.float() - want.float()).abs().max()
    assert float(err) <= tol * float(want.float().abs().max()), float(err)


def _close_rows(got, want, tol):
    """``_close`` for each row of the last axis on its own: attention rows
    average different numbers of keys and differ in scale."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(dim=-1)
    bad = err > tol * w.abs().amax(dim=-1)
    assert not bad.any(), float((err / w.abs().amax(dim=-1)
                                 .clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "int8"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("M", [1, 4, 37])
@pytest.mark.parametrize("bias,act", [(False, None), (True, "silu"),
                                      (True, "gelu")])
def test_gemm_matches_plain(cuda_device, xdt, wdt, M, bias, act):
    K, N, bk, bn = 256, 192, 32, 32
    w, mask = _masked((K, N), bk, bn, 0.5)
    mask[:, 1] = False                      # an empty output column
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn,
                                              quantize=wdt == "int8")
    vals, kn, sc = t_pack.pad_block_list(vals, kn, sc, vals.shape[0] + 2)
    dev = cuda_device
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    vt = T(vals).to(dev)
    if wdt == "bfloat16":
        vt = vt.to(torch.bfloat16)
    kt = T(kn).to(dev)
    st = None if sc is None else T(sc).to(dev)
    bt = T(RNG.normal(size=(N,)).astype(np.float32)).to(dev) if bias \
        else None
    cp = col_ptr_from_kn(kt, N // bn)
    n0 = t_gemm.launches
    got = t_gemm.sasp_gemm(x, vt, kt, cp, N, scales=st, bias=bt, act=act)
    want = t_gemm.sasp_gemm_plain(x, vt, kt, N, st, bt, act)
    torch.cuda.synchronize()
    assert t_gemm.launches == n0 + 1
    tol = 1e-4 if xdt == "float32" else 2e-2
    _close(got, want, tol)
    # a row's result does not depend on the rows beside it
    solo = t_gemm.sasp_gemm(x[:1].contiguous(), vt, kt, cp, N, scales=st,
                            bias=bt, act=act)
    torch.testing.assert_close(solo, got[:1], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "int8"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("M", [1, 4, 37])
@pytest.mark.parametrize("bf", [16, 32])
def test_fused_ffn_matches_plain(cuda_device, xdt, wdt, M, bf):
    d, F = 256, 512
    w1, _ = _masked((d, F), 32, bf, 0.4)
    w3, _ = _masked((d, F), 32, bf, 0.4)
    w2, _ = _masked((F, d), bf, 32, 0.4)
    w2 *= 0.1
    b1 = RNG.normal(size=(F,)).astype(np.float32)
    pk = t_pack.build_fused_ffn(w1, w3, w2, block_f=bf, b1=b1,
                                b2=np.ones((d,), np.float32),
                                quantize=wdt == "int8", nv_pad=F // bf + 3)
    dev = cuda_device
    ws = [T(a).to(dev) for a in pk[:3]]
    if wdt == "bfloat16":
        ws = [a.to(torch.bfloat16) for a in ws]
    bs = [T(a).to(dev) for a in pk[3:6]]
    sc = None if pk[6] is None else tuple(T(s).to(dev) for s in pk[6])
    x = T(RNG.normal(size=(M, d)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    n0 = t_ffn.launches
    got = t_ffn.fused_ffn(x, *ws, *bs, act="silu", scales=sc)
    want = t_ffn.fused_ffn_plain(x, *ws, *bs, act="silu", scales=sc)
    torch.cuda.synchronize()
    assert t_ffn.launches == n0 + 1
    tol = 1e-4 if xdt == "float32" else 2e-2
    _close(got, want, tol)
    solo = t_ffn.fused_ffn(x[:1].contiguous(), *ws, *bs, act="silu",
                           scales=sc)
    torch.testing.assert_close(solo, got[:1], rtol=0, atol=0)


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(cuda_device):
    x = torch.zeros((2, 64), device=cuda_device)
    vals = torch.zeros((2, 32, 32), device=cuda_device)
    kn = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    cp = col_ptr_from_kn(kn, 1)
    with pytest.raises(ValueError):
        t_gemm.sasp_gemm(x, vals.to(torch.int8), kn, cp, 32)  # no scales
    with pytest.raises(ValueError):
        t_gemm.sasp_gemm(x, vals.cpu(), kn, cp, 32)           # wrong device
    w = torch.zeros((1, 64, 64), device=cuda_device)
    b = torch.zeros((1, 64), device=cuda_device)
    with pytest.raises(ValueError):                            # bf > 32
        t_ffn.fused_ffn(x, w, w, w, b, b, torch.zeros(64, device=x.device))


@pytest.mark.cuda
def test_packed_engine_batch_matches_solo(cuda_device):
    """A request's greedy stream is the same alone and in a batch of
    three (left-padded prefill, batched decode) through both kernels."""
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, Request

    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=128, vocab=256),
        compute_dtype="bfloat16")
    params = lm.init_params(cfg, seed=0, device=cuda_device)
    # test-only: wo and w2 up to the 0.02 of the other projections, so that
    # 50% global tile pruning leaves them (and the FFN) nonzero
    slot = params["segments"][0]["slot0"]
    slot["mixer"]["wo"]["w"].mul_(2.0)      # sqrt(2 L) with L = 2
    slot["ffn"]["w2"]["w"].mul_(2.0)
    params, pcfg = build_serving_params(
        params, cfg, path="packed", sparsity=0.5, scope="all", verbose=False)
    prompts = [RNG.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (5, 11, 8)]

    def run(ps, slots):
        eng = Engine(params, pcfg, batch_slots=slots, cache_len=32)
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(ps)])
        return {r.rid: r.out_tokens for r in done}

    g0, f0 = t_gemm.launches, t_ffn.launches
    batch = run(prompts, 3)
    assert t_gemm.launches > g0 and t_ffn.launches > f0
    for i, p in enumerate(prompts):
        assert run([p], 1)[0] == batch[i]


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("M", [1, 4, 37, 70])
@pytest.mark.parametrize("bk,bn", [(32, 32), (16, 64), (64, 16)])
def test_masked_gemm_matches_plain_and_tile_skip(cuda_device, xdt, wdt, M,
                                                 bk, bn):
    from repro_torch.core.sparse import bsr_from_mask
    from repro_torch.kernels.sasp_gemm import masked as t_masked

    K, N = 256, 192
    w, mask = _masked((K, N), bk, bn, 0.5)
    mask[:, 1] = False                      # an empty output column
    dev = cuda_device
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    wt = T(w).to(dev, getattr(torch, wdt))
    mt = T(mask.astype(np.int32)).to(dev)
    n0 = t_masked.launches
    got = t_masked.masked_matmul(x, wt, mt)
    want = t_masked.sasp_gemm_masked_plain(x, wt, mt)
    torch.cuda.synchronize()
    assert t_masked.launches == n0 + 1
    _close(got, want, 1e-4 if xdt == "float32" else 2e-2)
    # the same sums, in the same order, as the tile-skip kernel over BSR
    bsr = bsr_from_mask(w, mask, bk, bn, device=dev)
    bsr.vals = bsr.vals.to(getattr(torch, wdt))
    torch.testing.assert_close(t_gemm.sasp_matmul(x, bsr), got, rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 37, 70])
@pytest.mark.parametrize("bk,bn", [(32, 32), (8, 16), (64, 64)])
def test_int8_gemm_matches_plain(cuda_device, xdt, M, bk, bn):
    from repro_torch.core.quantization import quantize_int8
    from repro_torch.kernels.int8_gemm import gemm as t_int8

    K, N = 256, 192
    dev = cuda_device
    qw = quantize_int8(T(RNG.normal(size=(K, N)).astype(np.float32)).to(dev),
                       bk, bn)
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    n0 = t_int8.launches
    got = t_int8.int8_matmul(x, qw)
    want = t_int8.int8_gemm_plain(x, qw.q, qw.scale)
    torch.cuda.synchronize()
    assert t_int8.launches == n0 + 1 and got.dtype == x.dtype
    _close(got, want, 1e-4 if xdt == "float32" else 2e-2)
    # dequantize-then-matmul rounds differently: held loosely
    _close(got, t_int8.int8_gemm_ref(x, qw.q, qw.scale), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,Hk,Sq,Sk,D,window", [
    (4, 4, 64, 64, 32, 10 ** 9),            # causal
    (8, 2, 42, 42, 128, 10 ** 9),           # GQA, ragged against tiles
    (4, 1, 1, 256, 128, 10 ** 9),           # one query against a cache
    (2, 2, 100, 300, 64, 37),               # window, Sq < Sk
    (2, 2, 33, 33, 16, 8),                  # tiny window, tiny head dim
])
def test_flash_attention_matches_plain(cuda_device, dt, H, Hk, Sq, Sk, D,
                                       window):
    from repro_torch.kernels.flash_attn import kernel as t_flash
    from repro_torch.kernels.flash_attn import ref as t_ref

    dev = cuda_device
    typ = getattr(torch, dt)
    q = T(RNG.normal(size=(H, Sq, D)).astype(np.float32)).to(dev, typ)
    k = T(RNG.normal(size=(Hk, Sk, D)).astype(np.float32)).to(dev, typ)
    v = T(RNG.normal(size=(Hk, Sk, D)).astype(np.float32)).to(dev, typ)
    qp = torch.arange(Sk - Sq, Sk, device=dev, dtype=torch.int32)
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)
    n0 = t_flash.launches
    got = t_flash.flash_attention(q, k, v, qp, kp, window=window)
    want = t_flash.flash_attention_plain(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    assert t_flash.launches == n0 + 1
    _close_rows(got, want, 1e-4 if dt == "float32" else 2e-2)
    G = H // Hk
    ref = t_ref.flash_attention_ref(
        q.float(), k.float().repeat_interleave(G, 0),
        v.float().repeat_interleave(G, 0), qp, kp, window=window)
    _close_rows(got, ref, 2e-5 if dt == "float32" else 3e-2)


@pytest.mark.cuda
def test_flash_attention_unseen_rows_are_zero(cuda_device):
    from repro_torch.kernels.flash_attn import kernel as t_flash

    dev = cuda_device
    q, k, v = (T(RNG.normal(size=(2, n, 64)).astype(np.float32)).to(dev)
               for n in (40, 70, 70))
    qp = torch.arange(-20, 20, device=dev, dtype=torch.int32)
    kp = torch.arange(70, device=dev, dtype=torch.int32)
    got = t_flash.flash_attention(q, k, v, qp, kp, window=5)
    want = t_flash.flash_attention_plain(q, k, v, qp, kp, window=5)
    torch.cuda.synchronize()
    assert not got[:, :20].any()
    _close_rows(got[:, 20:], want[:, 20:], 1e-4)


@pytest.mark.cuda
def test_new_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels.flash_attn import kernel as t_flash
    from repro_torch.kernels.int8_gemm import gemm as t_int8
    from repro_torch.kernels.sasp_gemm import masked as t_masked

    dev = cuda_device
    x = torch.zeros((2, 64), device=dev)
    w = torch.zeros((64, 64), device=dev)
    with pytest.raises(ValueError):                       # K not tiled
        t_masked.sasp_gemm_masked(x, w, torch.ones((3, 2), device=dev))
    with pytest.raises(ValueError):                       # wrong device
        t_masked.sasp_gemm_masked(x, w.cpu(), torch.ones((2, 2)))
    with pytest.raises(TypeError):                        # int8 weight
        t_masked.sasp_gemm_masked(x, w.to(torch.int8),
                                  torch.ones((2, 2), device=dev))
    s = torch.ones((2, 2), device=dev)
    with pytest.raises(TypeError):                        # not int8
        t_int8.int8_gemm(x, w, s)
    with pytest.raises(ValueError):                       # scale shape
        t_int8.int8_gemm(x, w.to(torch.int8), torch.ones((3, 2), device=dev))
    q = torch.zeros((4, 8, 64), device=dev)
    kv = torch.zeros((3, 8, 64), device=dev)
    pos = torch.arange(8, device=dev)
    with pytest.raises(ValueError):                       # 3 kv heads of 4
        t_flash.flash_attention(q, kv, kv, pos, pos, window=8)
    with pytest.raises(ValueError):                       # head dim 48
        t_flash.flash_attention(q[..., :48], q[..., :48], q[..., :48], pos,
                                pos, window=8)
    with pytest.raises(TypeError):                        # mixed types
        t_flash.flash_attention(q, q.to(torch.bfloat16), q, pos, pos,
                                window=8)


# ---------------------------------------------------------------------------
# the tensor-core / FMA mainloop (csrc/tile_mma.cuh): every variant at
# decode and prefill row counts, rows independent of M bit for bit, the
# visit split of a weight with few column-blocks
# ---------------------------------------------------------------------------


def _gemm_operands(dev, K, N, bk, bn, xdt, wdt, M, bias, sparsity=0.5):
    from repro_torch.kernels.sasp_gemm import schedule

    w, mask = _masked((K, N), bk, bn, sparsity)
    mask[:, 1] = False                      # an empty output column
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn,
                                              quantize=wdt == "int8")
    vals, kn, sc = t_pack.pad_block_list(vals, kn, sc, vals.shape[0] + 2)
    vt = T(vals).to(dev)
    if wdt == "bfloat16":
        vt = vt.to(torch.bfloat16)
    kt = T(kn).to(dev)
    st = None if sc is None else T(sc).to(dev)
    bt = T(RNG.normal(size=(N,)).astype(np.float32)).to(dev) if bias \
        else None
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    variant = schedule.gemm_variant(x.dtype, vt.dtype, bk, bn)
    return x, vt, kt, col_ptr_from_kn(kt, N // bn), st, bt, variant


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "int8"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("M", [1, 4, 17, 168])
@pytest.mark.parametrize("bk,bn,act", [(32, 32, "relu"), (16, 64, "silu"),
                                       (8, 32, "gelu")])
def test_gemm_variants_match_plain(cuda_device, xdt, wdt, M, bk, bn, act):
    """bk = 8 keeps bf16 x on the FMA variant; every other case with bf16
    x runs the tensor cores."""
    x, vt, kt, cp, st, bt, variant = _gemm_operands(
        cuda_device, 256, 192, bk, bn, xdt, wdt, M, True)
    assert variant == ("mma" if xdt == "bfloat16" and bk % 16 == 0
                       else "fma")
    n0 = t_gemm.launches
    got = t_gemm.sasp_gemm(x, vt, kt, cp, 192, scales=st, bias=bt, act=act)
    want = t_gemm.sasp_gemm_plain(x, vt, kt, 192, st, bt, act)
    torch.cuda.synchronize()
    assert t_gemm.launches == n0 + 1 and got.dtype == x.dtype
    _close(got, want, 1e-4 if xdt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("K,N", [(256, 192), (1024, 1024)])
def test_gemm_rows_do_not_depend_on_M(cuda_device, xdt, wdt, K, N):
    """Rows of a 168-row call equal the same rows computed 1 and 4 at a
    time, bit for bit; (1024, 1024) in 32x32 blocks has 32 column-blocks,
    so its visits are split into groups and reduced."""
    from repro_torch.kernels.sasp_gemm import schedule

    x, vt, kt, cp, st, bt, _ = _gemm_operands(
        cuda_device, K, N, 32, 32, xdt, wdt, 168, True)
    if K == 1024:
        assert schedule.gemm_groups(K // 32, N // 32) > 1
    full = t_gemm.sasp_gemm(x, vt, kt, cp, N, scales=st, bias=bt,
                            act="silu")
    for rows in (slice(0, 1), slice(77, 78), slice(164, 168), slice(0, 4)):
        part = t_gemm.sasp_gemm(x[rows].contiguous(), vt, kt, cp, N,
                                scales=st, bias=bt, act="silu")
        torch.testing.assert_close(part, full[rows], rtol=0, atol=0)
    want = t_gemm.sasp_gemm_plain(x, vt, kt, N, st, bt, "silu")
    _close(full, want, 1e-4 if xdt == "float32" else 2e-2)


def _ffn_operands(dev, d, F, bf, xdt, wdt, M):
    w1, _ = _masked((d, F), 32, bf, 0.4)
    w3, _ = _masked((d, F), 32, bf, 0.4)
    w2, _ = _masked((F, d), bf, 32, 0.4)
    w2 *= 0.1
    b1 = RNG.normal(size=(F,)).astype(np.float32)
    pk = t_pack.build_fused_ffn(w1, w3, w2, block_f=bf, b1=b1,
                                b2=np.ones((d,), np.float32),
                                quantize=wdt == "int8", nv_pad=F // bf + 3)
    ws = [T(a).to(dev) for a in pk[:3]]
    if wdt == "bfloat16":
        ws = [a.to(torch.bfloat16) for a in ws]
    bs = [T(a).to(dev) for a in pk[3:6]]
    sc = None if pk[6] is None else tuple(T(s).to(dev) for s in pk[6])
    x = T(RNG.normal(size=(M, d)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    return x, ws, bs, sc


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("float32", "int8"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("M", [1, 4, 17, 168])
@pytest.mark.parametrize("bf,act", [(32, "silu"), (16, "gelu"),
                                    (8, "relu")])
def test_fused_ffn_variants_match_plain(cuda_device, xdt, wdt, M, bf, act):
    """bf = 8 keeps the bf16 down-projection on FMAs (bf not a multiple of
    16); the int8 path's down-projection (fp32 h) always runs as FMAs."""
    from repro_torch.kernels.sasp_gemm import schedule

    x, ws, bs, sc = _ffn_operands(cuda_device, 256, 512, bf, xdt, wdt, M)
    up, down = schedule.ffn_variants(x.dtype, sc is not None, 256, bf)
    assert up == ("mma" if xdt == "bfloat16" else "fma")
    assert down == ("mma" if xdt == "bfloat16" and sc is None and bf != 8
                    else "fma")
    n0 = t_ffn.launches
    got = t_ffn.fused_ffn(x, *ws, *bs, act=act, scales=sc)
    want = t_ffn.fused_ffn_plain(x, *ws, *bs, act=act, scales=sc)
    torch.cuda.synchronize()
    assert t_ffn.launches == n0 + 1 and got.dtype == x.dtype
    _close(got, want, 1e-4 if xdt == "float32" else 2e-2)
    # the two phases' plain versions compose to the same function
    h = t_ffn.ffn_up_plain(x, ws[0], ws[1], bs[0], bs[1], act=act,
                           scales=sc)
    two = t_ffn.ffn_down_plain(h, ws[2], bs[2], out_dtype=x.dtype,
                               s2=None if sc is None else sc[2])
    _close(two, want, 1e-4 if xdt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "int8")])
def test_fused_ffn_rows_do_not_depend_on_M(cuda_device, xdt, wdt):
    """nv = 2048 / 32 + 3 visits: the down-projection splits them into
    groups; rows of a 168-row call equal the same rows at M = 1 and 4."""
    from repro_torch.kernels.sasp_gemm import schedule

    x, ws, bs, sc = _ffn_operands(cuda_device, 256, 2048, 32, xdt, wdt, 168)
    assert schedule.ffn_down_groups(ws[0].shape[0], 256)[0] > 1
    full = t_ffn.fused_ffn(x, *ws, *bs, act="silu", scales=sc)
    for rows in (slice(0, 1), slice(99, 100), slice(164, 168), slice(0, 4)):
        part = t_ffn.fused_ffn(x[rows].contiguous(), *ws, *bs, act="silu",
                               scales=sc)
        torch.testing.assert_close(part, full[rows], rtol=0, atol=0)
    want = t_ffn.fused_ffn_plain(x, *ws, *bs, act="silu", scales=sc)
    _close(full, want, 1e-4 if xdt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("M", [4, 70])
def test_masked_grid_equals_tile_skip_across_visit_groups(cuda_device, xdt,
                                                          wdt, M):
    """32 column-blocks of 32 k-blocks: both kernels split each column into
    the same k-block groups and reduce them in the same order, so the
    masked grid still equals the tile-skip kernel over BSR bit for bit."""
    from repro_torch.core.sparse import bsr_from_mask
    from repro_torch.kernels.sasp_gemm import masked as t_masked
    from repro_torch.kernels.sasp_gemm import schedule

    K = N = 1024
    assert schedule.gemm_groups(K // 32, N // 32) > 1
    w, mask = _masked((K, N), 32, 32, 0.5)
    mask[:, 1] = False
    dev = cuda_device
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    wt = T(w).to(dev, getattr(torch, wdt))
    mt = T(mask.astype(np.int32)).to(dev)
    got = t_masked.masked_matmul(x, wt, mt)
    _close(got, t_masked.sasp_gemm_masked_plain(x, wt, mt),
           1e-4 if xdt == "float32" else 2e-2)
    bsr = bsr_from_mask(w, mask, 32, 32, device=dev)
    bsr.vals = bsr.vals.to(getattr(torch, wdt))
    torch.testing.assert_close(t_gemm.sasp_matmul(x, bsr), got, rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# the masked grid's TMA-fed variant (csrc/sasp_gemm_masked.cu on
# csrc/tma_ring.cuh): ragged rows, column tiles past N, k-block groups that
# do not divide KB, all-pruned / all-live masks and an empty column, and
# every variant its plan picks; each case held against the plain version
# and, bit for bit, against the tile-skip kernel over BSR
# ---------------------------------------------------------------------------


def _masked_operands(dev, K, N, bk, bn, kind, xdt, wdt, M):
    """Dense weights with every tile nonzero (a pruned tile the kernel
    multiplied would show) and a mask of the given kind."""
    w = RNG.normal(size=(K, N)).astype(np.float32)
    mask = RNG.random((K // bk, N // bn)) > 0.5
    if kind == "all_pruned":
        mask[:] = False
    elif kind == "all_live":
        mask[:] = True
    elif kind == "empty_column":
        mask[:, -1] = False
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    return x, w, mask, T(w).to(dev, getattr(torch, wdt)), \
        T(mask.astype(np.int32)).to(dev)


def _masked_vs_plain_and_tile_skip(dev, x, w, mask, wt, mt, bk, bn, wdt):
    from repro_torch.core.sparse import bsr_from_mask
    from repro_torch.kernels.sasp_gemm import masked as t_masked

    before = dict(t_masked.variant_launches)
    got = t_masked.masked_matmul(x, wt, mt)
    ran = [k for k, n in t_masked.variant_launches.items()
           if n != before.get(k, 0)]
    want = t_masked.sasp_gemm_masked_plain(x, wt, mt)
    torch.cuda.synchronize()
    if mask.any():
        _close(got, want, 1e-4 if x.dtype == torch.float32 else 2e-2)
    else:
        assert not got.any() and not want.any()
    bsr = bsr_from_mask(w, mask, bk, bn, device=dev)
    bsr.vals = bsr.vals.to(getattr(torch, wdt))
    torch.testing.assert_close(t_gemm.sasp_matmul(x, bsr), got, rtol=0,
                               atol=0)
    return ran


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,bk,bn", [(256, 192, 32, 32),
                                       (1600, 320, 32, 32),
                                       (1024, 384, 16, 64),
                                       (768, 320, 64, 16),
                                       (2048, 256, 32, 128)])
@pytest.mark.parametrize("M", [1, 4, 37, 70, 168, 200])
@pytest.mark.parametrize("kind", ["random", "all_pruned", "all_live",
                                  "empty_column"])
def test_masked_tma_variant_matches_plain_and_tile_skip(cuda_device, K, N,
                                                        bk, bn, M, kind):
    from repro_torch.kernels.sasp_gemm import schedule

    x, w, mask, wt, mt = _masked_operands(cuda_device, K, N, bk, bn, kind,
                                          "bfloat16", "bfloat16", M)
    plan = schedule.masked_plan(M, K, N, K // bk, N // bn, x.dtype, wt.dtype)
    assert plan.variant == schedule.TMA
    ran = _masked_vs_plain_and_tile_skip(cuda_device, x, w, mask, wt, mt, bk,
                                         bn, "bfloat16")
    assert ran == [plan.variant]


def test_masked_tma_cases_cover_ragged_tiles_and_groups():
    """The shapes above hold what they are there for (no card needed)."""
    from repro_torch.kernels.sasp_gemm import schedule

    ragged_n = groups_ragged = False
    for K, N, bk, bn in ((256, 192, 32, 32), (1600, 320, 32, 32),
                         (1024, 384, 16, 64), (768, 320, 64, 16),
                         (2048, 256, 32, 128)):
        KB, NB = K // bk, N // bn
        for M in (4, 168):
            plan = schedule.masked_plan(M, K, N, KB, NB, torch.bfloat16,
                                        torch.bfloat16)
            ragged_n |= N % plan.bn != 0
        G = schedule.gemm_groups(KB, NB)
        groups_ragged |= G > 1 and KB % G != 0
    assert ragged_n and groups_ragged


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt,bk,bn", [
    ("bfloat16", "bfloat16", 32, 32), ("bfloat16", "float32", 32, 32),
    ("float32", "float32", 32, 32), ("float32", "bfloat16", 32, 32),
    ("bfloat16", "bfloat16", 8, 32), ("bfloat16", "bfloat16", 32, 256)])
@pytest.mark.parametrize("M", [4, 168])
def test_masked_grid_runs_the_variant_its_plan_names(cuda_device, xdt, wdt,
                                                     bk, bn, M):
    from repro_torch.kernels.sasp_gemm import schedule

    K, N = 48 * bk, 3 * bn
    x, w, mask, wt, mt = _masked_operands(cuda_device, K, N, bk, bn,
                                          "empty_column", xdt, wdt, M)
    plan = schedule.masked_plan(M, K, N, K // bk, N // bn, x.dtype, wt.dtype)
    ran = _masked_vs_plain_and_tile_skip(cuda_device, x, w, mask, wt, mt, bk,
                                         bn, wdt)
    assert ran == [plan.variant]


@pytest.mark.cuda
def test_masked_tma_rows_do_not_depend_on_m(cuda_device):
    """A row's result is the same bit for bit alone or among 168."""
    from repro_torch.kernels.sasp_gemm import masked as t_masked

    x, w, mask, wt, mt = _masked_operands(cuda_device, 1600, 320, 32, 32,
                                          "random", "bfloat16", "bfloat16",
                                          168)
    full = t_masked.masked_matmul(x, wt, mt)
    for rows in (slice(0, 1), slice(99, 100), slice(164, 168), slice(0, 4),
                 slice(0, 37)):
        part = t_masked.masked_matmul(x[rows].contiguous(), wt, mt)
        torch.testing.assert_close(part, full[rows], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,bk,bn", [(1600, 320, 32, 32),
                                       (1024, 384, 16, 64),
                                       (2048, 256, 32, 128)])
@pytest.mark.parametrize("M", [4, 168])
def test_masked_tma_kernel_matches_its_plan_order_walk(cuda_device, K, N, bk,
                                                       bn, M):
    """The kernel against the plain walk of its own plan
    (``sasp_gemm_masked_planned``: its tiles, groups and k-blocks in order,
    fp32 sums on the CPU) on the same bf16 values: one bf16 step of the
    output's scale, the rounding of the kernel's single cast."""
    from repro_torch.kernels.sasp_gemm import masked as t_masked
    from repro_torch.kernels.sasp_gemm import schedule

    x, w, mask, wt, mt = _masked_operands(cuda_device, K, N, bk, bn,
                                          "empty_column", "bfloat16",
                                          "bfloat16", M)
    plan = schedule.masked_plan(M, K, N, K // bk, N // bn, x.dtype, wt.dtype)
    assert plan.variant == schedule.TMA
    got = t_masked.masked_matmul(x, wt, mt)
    walk = t_masked.sasp_gemm_masked_planned(
        x.float().cpu(), wt.float().cpu(), mt.cpu(), plan=plan)
    _close(got.cpu(), walk, 2 ** -7)


@pytest.mark.cuda
def test_masked_tma_takes_an_unaligned_view(cuda_device):
    """x that starts off a 16-byte boundary (a tensor map's base must lie
    on one) is copied, not refused."""
    from repro_torch.kernels.sasp_gemm import masked as t_masked

    x, w, mask, wt, mt = _masked_operands(cuda_device, 256, 192, 32, 32,
                                          "random", "bfloat16", "bfloat16", 5)
    big = torch.zeros(5 * 256 + 2, dtype=torch.bfloat16, device=cuda_device)
    view = big[2:].view(5, 256)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    torch.testing.assert_close(t_masked.masked_matmul(view, wt, mt),
                               t_masked.masked_matmul(x, wt, mt), rtol=0,
                               atol=0)


# ---------------------------------------------------------------------------
# flash attention on the tensor cores and the int8 GEMM on its split-k
# mainloop: GQA over ragged tiles, windows that cut tiles, positions that
# are not an arange, strided views, scale blocks inside wide column tiles,
# rows independent of M
# ---------------------------------------------------------------------------


def _flash_case(dev, typ, H, Hk, Sq, Sk, D):
    q = T(RNG.normal(size=(H, Sq, D)).astype(np.float32)).to(dev, typ)
    k = T(RNG.normal(size=(Hk, Sk, D)).astype(np.float32)).to(dev, typ)
    v = T(RNG.normal(size=(Hk, Sk, D)).astype(np.float32)).to(dev, typ)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,window", [
    (200, 333, 10 ** 9),                    # ragged rows and keys, causal
    (333, 333, 100),                        # a window cutting tiles diagonally
    (1, 333, 10 ** 9),                      # one query, 8 heads of one kv head
])
def test_flash_gqa_ragged_tiles_match_plain(cuda_device, dt, Sq, Sk, window):
    """D = 128 with 8 query heads to a kv head: a tile's rows are (position,
    head) pairs, the tiles ragged at both ends."""
    from repro_torch.kernels.flash_attn import kernel as t_flash

    dev, typ = cuda_device, getattr(torch, dt)
    q, k, v = _flash_case(dev, typ, 16, 2, Sq, Sk, 128)
    qp = torch.arange(Sk - Sq, Sk, device=dev, dtype=torch.int32)
    kp = torch.arange(Sk, device=dev, dtype=torch.int32)
    runs = dict(t_flash.variant_launches)
    got = t_flash.flash_attention(q, k, v, qp, kp, window=window)
    want = t_flash.flash_attention_plain(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    ran = t_flash.variant(typ)
    assert t_flash.variant_launches[ran] == runs.get(ran, 0) + 1
    assert ran == ("mma" if dt == "bfloat16" else "fma")
    _close_rows(got, want, 1e-4 if dt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [10 ** 9, 40])
def test_flash_left_padded_positions_match_plain(cuda_device, dt, window):
    """The prefill of a left-padded batch row: a run of repeated negative
    positions, then 0, 1, ... with one position repeated: with both
    windows, pairs of 64-position tiles are skipped, full and partial in
    one call."""
    from repro_torch.kernels.flash_attn import kernel as t_flash

    dev, typ = cuda_device, getattr(torch, dt)
    pos = np.concatenate([np.full(70, -1), np.arange(-5, 0), np.arange(225)])
    pos[150] = pos[149]                     # a repeated position
    kp = T(pos.astype(np.int32)).to(dev)
    qp = kp.clone()
    q, k, v = _flash_case(dev, typ, 8, 2, 300, 300, 64)
    classes = {t_flash.tile_class(qmin, qmax, kmin, kmax, window, False)
               for qmin, qmax in t_flash.tile_bounds(qp, 64)
               for kmin, kmax in t_flash.tile_bounds(kp, 64)}
    assert classes == {t_flash.SKIP, t_flash.PARTIAL, t_flash.FULL}
    got = t_flash.flash_attention(q, k, v, qp, kp, window=window)
    want = t_flash.flash_attention_plain(q, k, v, qp, kp, window=window)
    torch.cuda.synchronize()
    _close_rows(got, want, 1e-4 if dt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mha_strided_views_equal_contiguous(cuda_device, dt):
    """mha reads (B, S, H, D) views in place: slices of a wider cache and a
    q taken from a fused projection give the same bits as their
    contiguous copies."""
    from repro_torch.kernels.flash_attn import kernel as t_flash
    from repro_torch.kernels.flash_attn.ops import mha

    dev, typ = cuda_device, getattr(torch, dt)
    B, S, H, KH, D = 2, 77, 8, 2, 64
    qkv = T(RNG.normal(size=(B, S, H + 2 * KH, D)).astype(np.float32)
            ).to(dev, typ)
    cache = T(RNG.normal(size=(B, 96, KH, 2, D)).astype(np.float32)
              ).to(dev, typ)
    q = qkv[:, :, :H]                        # a view, heads strided
    k, v = cache[:, 10:10 + S, :, 0], cache[:, 10:10 + S, :, 1]
    assert not (q.is_contiguous() or k.is_contiguous())
    pos = torch.arange(S, device=dev, dtype=torch.int32)
    n0 = t_flash.launches
    got = mha(q, k, v, pos, pos, window=10 ** 9)
    want = mha(q.contiguous(), k.contiguous(), v.contiguous(), pos, pos,
               window=10 ** 9)
    torch.cuda.synchronize()
    assert t_flash.launches == n0 + 2
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    plain = t_flash.flash_attention_plain(
        q.permute(0, 2, 1, 3).reshape(B * H, S, D),
        k.permute(0, 2, 1, 3).reshape(B * KH, S, D),
        v.permute(0, 2, 1, 3).reshape(B * KH, S, D), pos, pos,
        window=10 ** 9).reshape(B, H, S, D).permute(0, 2, 1, 3)
    _close_rows(got, plain, 1e-4 if dt == "float32" else 2e-2)


def _int8_case(dev, K, N, bk, bn, M, xdt):
    from repro_torch.core.quantization import quantize_int8

    qw = quantize_int8(T(RNG.normal(size=(K, N)).astype(np.float32)).to(dev),
                       bk, bn)
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    return qw, x


@pytest.mark.cuda
@pytest.mark.parametrize("xdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 37, 168])
def test_int8_wide_tiles_and_k_groups_match_plain(cuda_device, xdt, M):
    """32x32 scale blocks, K 2048 and N 384: each column tile spans several
    scale blocks and the k-blocks split into several groups."""
    from repro_torch.kernels.int8_gemm import gemm as t_int8
    from repro_torch.kernels.int8_gemm import schedule

    qw, x = _int8_case(cuda_device, 2048, 384, 32, 32, M, xdt)
    variant = schedule.int8_variant(x.dtype, 32)
    assert variant == ("mma" if xdt == "bfloat16" else "fma")
    assert schedule.col_tile(variant) > 32
    assert schedule.int8_groups(2048, 384, 32, variant) > 1
    runs = dict(t_int8.variant_launches)
    got = t_int8.int8_matmul(x, qw)
    want = t_int8.int8_gemm_plain(x, qw.q, qw.scale)
    torch.cuda.synchronize()
    assert t_int8.variant_launches[variant] == runs.get(variant, 0) + 1
    _close(got, want, 1e-4 if xdt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,bk,bn", [("bfloat16", 32, 32),
                                       ("bfloat16", 64, 16),
                                       ("bfloat16", 8, 32),
                                       ("float32", 32, 32)])
def test_int8_rows_do_not_depend_on_M(cuda_device, xdt, bk, bn):
    """The rows of a 168-row call equal the same rows computed alone, bit
    for bit (the variant and k groups read no M)."""
    from repro_torch.kernels.int8_gemm import gemm as t_int8

    qw, x = _int8_case(cuda_device, 2048, 384, bk, bn, 168, xdt)
    full = t_int8.int8_matmul(x, qw)
    for rows in (slice(0, 1), slice(77, 78), slice(164, 168), slice(0, 4),
                 slice(100, 137)):
        part = t_int8.int8_matmul(x[rows].contiguous(), qw)
        torch.testing.assert_close(part, full[rows], rtol=0, atol=0)
    _close(full, t_int8.int8_gemm_plain(x, qw.q, qw.scale),
           1e-4 if xdt == "float32" else 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("M", [4, 168])
def test_gemm_plain_gives_equal_bits_twice(cuda_device, xdt, wdt, M):
    """The plain tile-skip GEMM, the kernel's oracle, adds each column's
    visits in a fixed order: two calls on the same inputs give the same
    bits (padded visit lists and an empty column included)."""
    K, N, bk, bn = 1024, 512, 32, 32
    w, mask = _masked((K, N), bk, bn, 0.5)
    mask[:, 3] = False
    vals, kn, sc = t_pack.build_kernel_weight(w, mask, bk, bn,
                                              quantize=wdt == "int8")
    vals, kn, sc = t_pack.pad_block_list(vals, kn, sc, vals.shape[0] + 5)
    dev = cuda_device
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(
        dev, getattr(torch, xdt))
    v = T(vals).to(dev)
    if wdt != "int8":
        v = v.to(getattr(torch, wdt))
    s = None if sc is None else T(sc).to(dev)
    bias = T(RNG.normal(size=(N,)).astype(np.float32)).to(dev)
    a = t_gemm.sasp_gemm_plain(x, v, T(kn).to(dev), N, s, bias, "silu")
    b = t_gemm.sasp_gemm_plain(x, v, T(kn).to(dev), N, s, bias, "silu")
    torch.cuda.synchronize()
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _paged_model(cuda_device, layers=2):
    """A bf16 packed reduced qwen3-32b (50% of its 32x32 tiles pruned,
    scope all) on the card."""
    from repro_torch.launch.serve import build_serving_params
    from repro_torch.models import lm

    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=layers, d_model=128,
                vocab=256), compute_dtype="bfloat16")
    params = lm.init_params(cfg, seed=0, device=cuda_device)
    # test-only: wo and w2 up to the 0.02 of the other projections
    for seg in params["segments"]:
        for slot in seg.values():
            slot["mixer"]["wo"]["w"].mul_((2 * layers) ** 0.5)
            slot["ffn"]["w2"]["w"].mul_((2 * layers) ** 0.5)
    return build_serving_params(params, cfg, path="packed", sparsity=0.5,
                                scope="all", verbose=False)


@pytest.mark.cuda
def test_paged_streams_equal_contiguous_bit_for_bit(cuda_device):
    """On the card, the paged engine (an ample pool, and a small one
    with host spill and a preempt / resume) gives the contiguous
    engine's streams, and its final logits bit for bit: the same shapes
    go through the same kernels, only the page gather / scatter
    differs."""
    from repro_torch.serve.engine import Engine, Request

    params, cfg = _paged_model(cuda_device)
    prompts = [RNG.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (37, 12, 70, 5)]

    def run(**kw):
        eng = Engine(params, cfg, batch_slots=4, cache_len=128, **kw)
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=12)
                        for i, p in enumerate(prompts)])
        return {r.rid: r.out_tokens for r in done}, eng

    contig, _ = run()
    paged, eng = run(kv_pages=16)
    assert paged == contig
    assert eng.pool.page_len == 32
    eng.pool.check()
    # one more decode step of both engines from the same state: equal
    # logits, bit for bit
    ce = Engine(params, cfg, batch_slots=4, cache_len=128)
    pe = Engine(params, cfg, batch_slots=4, cache_len=128, kv_pages=16)
    for e in (ce, pe):
        for i, p in enumerate(prompts):
            e.submit(Request(rid=i, prompt=p, max_new_tokens=12))
        e.step()
    toks = torch.tensor([[r.out_tokens[-1]] for r in ce.slot_req],
                        dtype=torch.int32, device=cuda_device)
    pos = torch.as_tensor(ce.pos, device=cuda_device)
    for r, p in zip(pe.slot_req, ce.pos):
        assert pe.pool.ensure_writable(r.rid, int(p) // pe.pool.page_len)
    bt = pe.pool.block_table([r.rid for r in pe.slot_req])
    with torch.no_grad():
        want = ce._decode_step(params, cfg, toks, pos)
        got = pe._paged_decode_step(params, cfg, toks, pos, bt)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a small pool: admission defers, a preempted request spills, faults
    eng = Engine(params, cfg, batch_slots=2, cache_len=128, kv_pages=6,
                 kv_host_pages=6)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.queue.append(eng.preempt_slot(0))
    while eng.has_work():
        eng.step()
        eng.pool.check()
    assert {r.rid: r.out_tokens for r in reqs} == contig
    assert eng.memory_stats().device_used == 0


@pytest.mark.cuda
def test_int8_drafter_runs_the_int8_kernel_forms(cuda_device):
    """``draft_int8``: the drafter's decode steps launch the int8 forms
    of both kernels and the verify pass the bf16 ones (counted by weight
    type); streams equal the engine's without a drafter."""
    from repro_torch.serve.engine import Engine, Request

    params, cfg = _paged_model(cuda_device)
    prompt = RNG.integers(0, 256, size=(40,)).astype(np.int32)

    def run(**kw):
        eng = Engine(params, cfg, batch_slots=2, cache_len=128, kv_pages=16,
                     **kw)
        done = eng.run([Request(rid=i, prompt=prompt[:30 + 5 * i],
                                max_new_tokens=16) for i in range(2)])
        return {r.rid: r.out_tokens for r in done}, eng

    off, _ = run()
    g0, f0 = dict(t_gemm.weight_launches), dict(t_ffn.weight_launches)
    on, eng = run(draft_sparsity=0.75, draft_int8=True, draft_k=4)
    assert on == off and eng.stats["spec_rounds"] > 0
    for mod, before in ((t_gemm, g0), (t_ffn, f0)):
        for wt in ("int8", "bfloat16"):
            assert mod.weight_launches.get(wt, 0) > before.get(wt, 0), \
                (mod.__name__, wt, mod.weight_launches)
    eng.pool.check()


@pytest.mark.cuda
def test_scheduler_two_ranks_streams_equal_solo(cuda_device):
    """A 2-rank ShardedScheduler on the card (EDF, preemption, one params
    tree for both ranks) gives every request the stream it has alone
    through Engine(batch_slots=1), and runs both kernels."""
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.scheduler import SchedulerConfig, ShardedScheduler

    params, cfg = _paged_model(cuda_device)
    prompts = [RNG.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (37, 12, 70, 5, 23, 9, 30, 16)]

    def reqs():
        # four batch requests fill the four slots, then four interactive
        # ones arrive and preempt
        return [Request(rid=i, prompt=p, max_new_tokens=10 if i < 4 else 6,
                        slo="batch" if i < 4 else "interactive")
                for i, p in enumerate(prompts)]

    solo = {}
    for r in reqs():
        solo[r.rid] = Engine(params, cfg, batch_slots=1, cache_len=128).run(
            [r])[0].out_tokens
    sched = ShardedScheduler(params, cfg, ranks=2, sched=SchedulerConfig(
        slots_per_rank=2, cache_len=128, policy="edf", preempt=True))
    batch = reqs()
    for r in batch[:4]:
        assert sched.submit(r)
    sched.step()
    for r in batch[4:]:
        assert sched.submit(r)
    g0, f0 = t_gemm.launches, t_ffn.launches
    done = []
    while sched.has_work():
        done += sched.step()
    assert {r.rid: r.out_tokens for r in done} == solo
    assert t_gemm.launches > g0 and t_ffn.launches > f0
    st = sched.stats()
    assert all(p["admitted"] > 0 for p in st["per_rank"])
    assert st["preemptions"] >= 1


@pytest.mark.cuda
def test_tracing_on_and_off_bit_identical(cuda_device):
    """The span tracer reads no device value and draws no random number:
    with tracing on, a paged engine's streams (one sampled), every decode
    step's logits and the generator's state equal the untraced run's."""
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.serve.telemetry import Telemetry

    params, cfg = _paged_model(cuda_device)
    prompts = [RNG.integers(0, 256, size=(n,)).astype(np.int32)
               for n in (37, 12, 70)]

    def run(trace):
        eng = Engine(params, cfg, batch_slots=2, cache_len=128, kv_pages=12,
                     telemetry=Telemetry(trace=trace))
        steps, inner = [], eng._paged_decode_step

        def rec(*a):
            out = inner(*a)
            steps.append(out.clone())
            return out

        eng._paged_decode_step = rec
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=10,
                                temperature=0.7 if i == 1 else 0.0)
                        for i, p in enumerate(prompts)])
        torch.cuda.synchronize()
        return ({r.rid: r.out_tokens for r in done}, steps,
                eng._gen.get_state(), eng)

    off, s_off, g_off, _ = run(False)
    on, s_on, g_on, eng = run(True)
    assert on == off
    assert len(s_on) == len(s_off) > 0
    for a, b in zip(s_on, s_off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(g_on, g_off)
    names = {e["name"] for e in eng.telemetry.tracer.events()}
    assert {"submit", "admit", "prefill", "token"} <= names


@pytest.mark.cuda
@pytest.mark.timeout(600)
def test_host_worker_starts_on_the_card_and_answers_ping(cuda_device):
    """``python -m repro_torch.serve.host_worker`` with device "cuda"
    starts, answers ping, serves a request and exits on ``exit``."""
    from repro_torch.serve.engine import Request
    from repro_torch.serve.frontend import SubprocessHost

    host = SubprocessHost(0, spec=dict(device="cuda", layers=1, d_model=128,
                                       vocab=256, sasp=0.5, path="packed",
                                       scope="all", compute="bfloat16",
                                       cache_len=64))
    try:
        assert host.alive and host.heartbeat()
        req = Request(rid=7, prompt=np.arange(1, 9, dtype=np.int32),
                      max_new_tokens=4)
        assert host.submit(req) == "ok"
        toks, done = [], []
        for _ in range(20):
            fin, failed, ev = host.step()
            assert not failed
            toks += [t for rid, i, t in ev if rid == 7]
            done += fin
            if done:
                break
        assert done == [7] and len(toks) == 4
        assert host.heartbeat()
    finally:
        host.close()
    assert host.proc.returncode == 0


def _named(tree):
    from repro_torch.train.checkpoint import named_leaves
    return dict(named_leaves(tree))


@pytest.mark.cuda
@pytest.mark.parametrize("n_microbatches", [1, 2])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, n_microbatches):
    """One ``make_train_step`` step with the SASP overlay on the card and
    on the CPU (fp32, reduced qwen3-32b, 2 layers, d 128): gradients and
    moments within 1e-5 of each leaf's scale, params too wherever the
    gradient is at least 100 eps (the first AdamW step moves an element
    by lr g / (|g| + eps), which amplifies rounding where |g| is near
    eps), and every pruned FFN tile's gradient exactly 0 on the card."""
    import copy

    from repro_torch.configs import SASPConfig
    from repro_torch.core.pruning import compute_sasp_masks
    from repro_torch.core.sasp import build_sasp_overlay
    from repro_torch.data.pipeline import DataConfig, lm_batch
    from repro_torch.models import lm
    from repro_torch.serve.host_worker import spread_output_scales
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_train_step, value_and_grad

    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=128, vocab=256),
        sasp=SASPConfig(enabled=True, block_k=32, block_n=32, sparsity=0.5))
    base = spread_output_scales(lm.init_params(cfg, seed=0, device="cpu"),
                                cfg)
    overlay, _ = build_sasp_overlay(base, cfg.sasp)
    masks = compute_sasp_masks(base, cfg.sasp)
    batch = lm_batch(DataConfig(vocab_size=256, seq_len=64,
                                global_batch=4), 0)
    opt_cfg = AdamWConfig()

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(to(v, dev) for v in tree)
        return tree.to(dev)

    out = {}
    for dev in ("cpu", cuda_device):
        p = to(copy.deepcopy(base), dev)
        ov = to(overlay, dev)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads = value_and_grad(cfg, p, b, ov)[2]
        p, opt, m = make_train_step(cfg, opt_cfg, overlay=ov,
                                    n_microbatches=n_microbatches)(
            p, adamw_init(p, opt_cfg), b)
        out[str(dev)] = dict(grads=grads, params=p, m=opt.m, v=opt.v,
                             loss=float(m["loss"]))
    card, cpu = out["cuda"], out["cpu"]
    assert abs(card["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    g_cpu = _named(cpu["grads"])
    for key in ("grads", "m", "v", "params"):
        a, b = _named(card[key]), _named(cpu[key])
        assert a.keys() == b.keys()
        for n in b:
            diff = (a[n].cpu() - b[n]).abs()
            if key == "params":
                diff = diff * (g_cpu[n].abs() >= 100 * opt_cfg.eps)
            assert float(diff.max()) <= 1e-5 * float(b[n].abs().max()), \
                (key, n)
    g_card = card["grads"]
    for path, mask in masks.items():
        g = g_card
        for k in path:
            g = g[k]
        L, K, N = g.shape
        KB, NB = mask.shape[-2:]
        tiles = g.reshape(L, KB, K // KB, NB, N // NB).abs().amax(dim=(2, 4))
        assert bool((tiles[~mask.to(tiles.device)] == 0).all()), path


@pytest.mark.cuda
@pytest.mark.parametrize("top_k,capacity", [(2, 1.25), (6, 0.5)])
def test_moe_ffn_local_on_the_card_matches_the_cpu(cuda_device, top_k,
                                                   capacity):
    """``moe_ffn_local`` (fp32, 8 experts, capacity 0.5 drops slots) on the
    card against the CPU: the same routing exactly, outputs and aux loss
    within 1e-4 of their scale."""
    from repro_torch.models import moe

    cfg = reduced(get_config("granite-moe-1b-a400m"), layers=1, d_model=64,
                  vocab=64)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=8, top_k=top_k, capacity_factor=capacity))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, layers=1,
                     device="cpu", out_scale=0.02)
    p = {k: {"w": v["w"][0] * 10} for k, v in p.items()}
    x = T(RNG.normal(size=(4, 37, 64)).astype(np.float32))
    y, aux = moe.moe_ffn_local(p, cfg, x)
    pc = {k: {"w": v["w"].to(cuda_device)} for k, v in p.items()}
    yc, auxc = moe.moe_ffn_local(pc, cfg, x.to(cuda_device))
    r = moe.route(p, cfg, x.reshape(-1, 64))
    rc = moe.route(pc, cfg, x.reshape(-1, 64).to(cuda_device))
    for f in ("expert_idx", "sort_idx", "pos_in_expert"):
        assert torch.equal(getattr(rc, f).cpu(), getattr(r, f)), f
    _close(yc.cpu(), y, 1e-4)
    assert abs(float(auxc) - float(aux)) <= 1e-5 * abs(float(aux))


@pytest.mark.cuda
@pytest.mark.parametrize("groups,S", [(1, 256), (2, 45)])
def test_ssd_chunked_on_the_card_matches_the_cpu(cuda_device, groups, S):
    """``ssd_chunked`` at mamba2-780m's head count and state size (48 heads
    of 64, state 128, chunk 256) on the card against the CPU, fp32:
    outputs and final state within 1e-4 of their scale."""
    from repro_torch.models import ssm

    B, H, P, N = 2, 48, 64, 128
    x = T(RNG.normal(size=(B, S, H, P)).astype(np.float32))
    dt = T(np.log1p(np.exp(RNG.normal(size=(B, S, H)) - 3)).astype(
        np.float32))
    A = -torch.arange(1, H + 1, dtype=torch.float32)
    Bm = T(RNG.normal(size=(B, S, groups, N)).astype(np.float32))
    Cm = T(RNG.normal(size=(B, S, groups, N)).astype(np.float32))
    D = torch.ones(H)
    h0 = torch.zeros(B, H, P, N)
    args = (x, dt, A, Bm, Cm, D, h0)
    y, h = ssm.ssd_chunked(*args, chunk=256)
    yc, hc = ssm.ssd_chunked(*(a.to(cuda_device) for a in args), chunk=256)
    _close(yc.cpu(), y, 1e-4)
    _close(hc.cpu(), h, 1e-4)


@functools.lru_cache(maxsize=None)
def _wq_packs(quantize: bool, tp: int):
    """wq's shape (5120 -> 8192, 32x32 tiles, half pruned, bias and silu)
    packed whole and in ``tp`` col shards, on the card."""
    from repro_torch.core.deploy import pack_weight
    rng = np.random.default_rng(5)
    K, N, b = 5120, 8192, 32
    mask = rng.random((K // b, N // b)) > 0.5
    w = rng.normal(size=(K, N)).astype(np.float32) * np.kron(
        mask, np.ones((b, b), np.float32))
    kw = dict(block_k=b, block_n=b, act="silu", quantize=quantize,
              bias=rng.normal(size=(N,)).astype(np.float32), device="cuda")
    return pack_weight(w, **kw), pack_weight(w, tp=tp, shard_kind="col",
                                             **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "int8")])
@pytest.mark.parametrize("M", [4, 168])
@pytest.mark.parametrize("tp", [2, 8])
def test_col_shards_equal_unsharded_kernel_bit_for_bit(cuda_device, xdt,
                                                       wdt, M, tp):
    """A TP col shard of wq's grid (KB 160, NB 256) plans its visit groups
    from the whole grid (``group_nb``), so its columns equal the
    unsharded kernel's bit for bit (bias and act fused per shard)."""
    from repro_torch.core.deploy import packed_matmul
    from repro_torch.kernels.sasp_gemm import schedule
    full, shards = _wq_packs(wdt == "int8", tp)
    K, N = full.shape
    b = full.block[1]
    assert schedule.gemm_groups(K // b, N // b // tp) != \
        schedule.gemm_groups(K // b, N // b)
    if wdt == "bfloat16":
        full = dataclasses.replace(full, vals=full.vals.to(torch.bfloat16))
        shards = dataclasses.replace(shards,
                                     vals=shards.vals.to(torch.bfloat16))
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(cuda_device).to(
        getattr(torch, xdt))
    want = packed_matmul(x, full)
    ns = N // tp
    for s in range(tp):
        got = packed_matmul(x, shards.shard(s), group_nb=N // b)
        assert torch.equal(got, want[:, s * ns:(s + 1) * ns]), s


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,quantize", [("float32", False),
                                         ("bfloat16", False),
                                         ("bfloat16", True)])
@pytest.mark.parametrize("M", [4, 168])
@pytest.mark.parametrize("tp", [2, 4])
def test_bsr_col_shards_equal_unsharded_kernel_bit_for_bit(cuda_device, xdt,
                                                           quantize, M, tp):
    """The kernel path on a mesh: a rank's column blocks of a BSR (w1's
    shape, 5120 -> 25600, half the 32x32 tiles) through ``sasp_matmul``
    with the whole grid's visit groups (``group_nb``), the product
    ``models.ffn._bsr_mm_sharded`` gathers, equal bit for bit to the
    unsharded kernel's columns."""
    from repro_torch.core.sparse import bsr_from_mask
    from repro_torch.kernels.sasp_gemm.gemm import sasp_matmul
    from repro_torch.models.ffn import _bsr_shard
    rng = np.random.default_rng(6)
    K, N, b = 5120, 25600, 32
    mask = rng.random((K // b, N // b)) > 0.5
    w = rng.normal(size=(K, N)).astype(np.float32)
    bsr = bsr_from_mask(w, mask, b, b, quantize=quantize, device=cuda_device)
    x = T(RNG.normal(size=(M, K)).astype(np.float32)).to(cuda_device).to(
        getattr(torch, xdt))
    want = sasp_matmul(x, bsr)
    ns = N // tp
    for s in range(tp):
        got = sasp_matmul(x, _bsr_shard(bsr, s, tp), group_nb=N // b)
        assert torch.equal(got, want[:, s * ns:(s + 1) * ns]), s


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("tp", [1, 2])
def test_packing_on_the_card_equals_the_cpu(cuda_device, quantize, tp):
    """``deploy_packed`` packs on the weights' device: the card's
    containers (tile gathers, flush visits, padding, int8 scales and
    rounding by true division) equal the CPU's bit for bit, fused and
    per-matrix; and the layer-by-layer rank build on the card equals
    each rank's shard of the whole build."""
    from repro_torch.configs import SASPConfig
    from repro_torch.core import deploy as t_deploy
    from repro_torch.core.pruning import prune_params
    from repro_torch.launch import serve as t_serve
    from repro_torch.models import lm

    cfg = reduced(get_config("qwen3-32b"), layers=3, d_model=256,
                  vocab=512)
    sasp = SASPConfig(enabled=True, block_k=32, block_n=32, sparsity=0.5,
                      scope="all", quantize=quantize)
    cfg = dataclasses.replace(cfg, sasp=sasp)
    params, _ = prune_params(lm.init_params(cfg, seed=0, device="cpu"),
                             sasp)
    from repro_torch.core.pruning import map_leaves
    on_card = map_leaves(lambda _, t: t.to(cuda_device), params)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        elif dataclasses.is_dataclass(tree):
            for f in dataclasses.fields(tree):
                yield from leaves(getattr(tree, f.name), path + (f.name,))
        else:
            yield path, tree

    def same(a_tree, b_tree):
        a, b = list(leaves(a_tree)), list(leaves(b_tree))
        assert [p for p, _ in a] == [p for p, _ in b]
        for (path, x), (_, y) in zip(a, b):
            if torch.is_tensor(y):
                assert x.dtype == y.dtype and torch.equal(
                    x.cpu(), y.cpu()), path
            else:
                assert x == y, path

    for fuse in (True, False):
        want, _ = t_deploy.deploy_packed(params, cfg, fuse_ffn=fuse, tp=tp)
        got, _ = t_deploy.deploy_packed(on_card, cfg, fuse_ffn=fuse, tp=tp)
        same(got, want)
    # the rank build on the card: each rank's tree equals its shard of
    # the whole build of the same (card-drawn) weights
    from repro_torch.distribution.sharding import local_params
    whole, wcfg = t_serve.build_serving_params(
        lm.init_params(cfg, seed=0, device=cuda_device), cfg,
        path="packed", sparsity=0.5, scope="all", int8_weights=quantize,
        verbose=False, tp=tp)
    for rank in range(tp):
        got = t_serve.build_rank_params(
            cfg, tp=tp, rank=rank, device=cuda_device, sparsity=0.5,
            scope="all", int8_weights=quantize)[0]
        same(got, local_params(whole, wcfg, tp, rank))


@pytest.mark.cuda
def test_layer_build_at_full_width_peaks_under_tree_and_three_layers(
        cuda_device):
    """``build_rank_params`` at qwen3-32b's full width, 8 layers, tp 1
    (one card's packed build, taken layer by layer): the device's peak
    above what it held before stays under the built tree (containers and
    table) plus 3 layers' fp32 masters."""
    from repro_torch.launch import serve as t_serve
    cfg = dataclasses.replace(get_config("qwen3-32b"), num_layers=8,
                              compute_dtype="bfloat16")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, _, _, _ = t_serve.build_rank_params(
        cfg, tp=1, rank=0, device=cuda_device, sparsity=0.5, scope="all")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    tree = torch.cuda.memory_allocated() - base
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.num_heads * cfg.attn_head_dim, \
        cfg.num_kv_heads * cfg.attn_head_dim
    layer = 4 * (2 * d * q + 2 * d * kv + 3 * d * f)
    assert tree > 0 and peak <= tree + 3 * layer, (peak, tree, layer)
    del params
    torch.cuda.empty_cache()


def vocab_rank(rank: int, init_file: str) -> dict:
    """One of 2 ranks sharing the card (gloo, host-staged): its rows of a
    tp=2 deployment's table, gathered and through the head under the
    mesh."""
    from repro_torch.distribution import context as dctx
    from repro_torch.distribution.sharding import local_config, local_params
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(1, 2, rank=rank, init_file=init_file, backend="gloo",
                     device="cuda")
    params, cfg = _vocab_tree(mesh.device)
    local, lcfg = local_params(params, cfg, 2, rank), local_config(cfg, 2)
    toks, x = _vocab_inputs(mesh.device, cfg)
    from repro_torch.models import lm
    with torch.no_grad(), dctx.use_mesh(mesh):
        return dict(rows=int(local["embed"]["emb"].shape[0]),
                    gather=lm._embed_in(local, lcfg, toks).float().cpu()
                    .numpy(),
                    head=lm.logits_fn(local, lcfg, x).cpu().numpy())


def _vocab_tree(device):
    from repro_torch.launch import serve as t_serve
    from repro_torch.models import lm
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=256, vocab=4096),
        compute_dtype="bfloat16")
    with torch.no_grad():
        return t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device=device), cfg, path="packed",
            sparsity=0.5, scope="all", verbose=False, tp=2)


def _vocab_inputs(device, cfg):
    gen = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 9), generator=gen,
                         device=device)
    x = torch.randn((4, 9, cfg.d_model), generator=gen,
                    device=device).to(torch.bfloat16)
    return toks, x


@pytest.mark.cuda
@pytest.mark.timeout(300)
def test_vocab_sharded_gather_and_head_on_the_card(cuda_device, tmp_path):
    """2 ranks sharing the card over gloo (host-staged): the sharded
    gather equals the replicated gather bit for bit, the all-gathered
    head the shard loop's head bit for bit and the whole table's within
    1e-5 of its scale."""
    from repro_torch.launch.mesh import init_file_in, run_ranks
    from repro_torch.models import lm
    ranks = run_ranks(vocab_rank, 2, (init_file_in(str(tmp_path)),),
                      timeout=240)
    params, cfg = _vocab_tree(cuda_device)
    toks, x = _vocab_inputs(cuda_device, cfg)
    whole = dataclasses.replace(cfg, vocab_shards=1)
    with torch.no_grad():
        gather = lm._embed_in(params, whole, toks).float().cpu().numpy()
        loop = lm.logits_fn(params, cfg, x).cpu().numpy()
        head = lm.logits_fn(params, whole, x).cpu().numpy()
    assert cfg.vocab_shards == 2
    for r in ranks:
        assert r["rows"] == cfg.vocab_size // 2
        assert np.array_equal(r["gather"], gather)
        assert np.array_equal(r["head"], loop)
    assert float(np.abs(loop - head).max()) <= 1e-5 * float(
        np.abs(head).max())
