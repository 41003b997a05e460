"""The port's CUDA kernels on the card (marker ``cuda``; every test skips
where ``torch.cuda.is_available()`` is false). Each kernel variant is
held against its plain PyTorch version on the same CUDA tensors, and the
packed engine's streams must not depend on which requests share a batch.
Imports torch and repro_torch only, so it runs on a machine without jax:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance, as a fraction of the largest output: 1e-4 with fp32
activations (summation order), 2e-2 with bf16 outputs (one bf16 ulp is
2^-8 of the value)."""
import dataclasses

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
