"""Fused gated FFN over surviving d_ff column-blocks (port of
``repro.kernels.sasp_gemm.kernel.sasp_fused_ffn``):
``act(x@W1v + b1) * (x@W3v + b3) @ W2v + b2``.

``fused_ffn`` launches the CUDA kernels (``csrc/fused_ffn.cu``) for CUDA
tensors and runs ``fused_ffn_plain`` for CPU tensors. ``launches``
counts calls that launched them (one per call: the gated up-projection,
the down-projection and, where its visits are split into groups, their
fixed-order reduction). ``ffn_up_plain`` and ``ffn_down_plain`` are the
two phases in plain PyTorch, with the intermediate ``h`` the kernels pass
through device memory.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sasp_gemm import schedule
from repro_torch.kernels.sasp_gemm.gemm import ACTS, as_type, check_words

launches = 0
# launches by variant of the (up, down) phases, e.g. "mma/mma"
variant_launches = {}
# launches by weight type ("bfloat16", "float32", "int8"): the int8
# forms apart from the fp ones (a self-speculation drafter's from its
# target's)
weight_launches = {}


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("fused_ffn").fused_ffn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 12 + \
        [ctypes.c_void_p]
    return fn


@functools.lru_cache(maxsize=None)
def _plan(x_dtype, w_dtype, d: int, bf: int, nv: int, act: str):
    """(up-projection step depth, up and down variants, the launch's type
    / activation / variant codes, down-projection groups and visits per
    group): a function of the types and the weight's shape alone."""
    ks = schedule.ffn_up_depth(d)
    up, down = schedule.ffn_variants(x_dtype, w_dtype == torch.int8, d, bf)
    codes = (build.dtype_code(x_dtype), build.dtype_code(w_dtype),
             build.ACT_CODES[act], ks, schedule.variant_code(up),
             schedule.variant_code(down))
    return (ks, up, down, codes, *schedule.ffn_down_groups(nv, d))


def fused_ffn_plain(x: torch.Tensor, w1v, w3v, w2v, b1, b3, b2, *,
                    act: str = "silu",
                    scales: Optional[Tuple] = None) -> torch.Tensor:
    """Plain-PyTorch version of the fused gated FFN, visit by visit."""
    xf = x.to(torch.float32)
    if scales is None:
        w1 = w1v.to(x.dtype).to(torch.float32)
        w3 = w3v.to(x.dtype).to(torch.float32)
        w2 = w2v.to(x.dtype).to(torch.float32)
    else:
        w1, w3, w2 = (w.to(torch.float32) for w in (w1v, w3v, w2v))
    u = torch.einsum("md,vdf->vmf", xf, w1)
    g = torch.einsum("md,vdf->vmf", xf, w3)
    if scales is not None:
        s1, s3, s2 = (s.to(torch.float32)[:, None, None] for s in scales)
        u, g = u * s1, g * s3
    u = u + b1.to(torch.float32)[:, None, :]
    g = g + b3.to(torch.float32)[:, None, :]
    h = ACTS[act](u) * g
    if scales is None:
        h = h.to(x.dtype).to(torch.float32)
    else:
        h = h * s2
    y = torch.einsum("vmf,vfd->md", h, w2) + b2.to(torch.float32)
    return y.to(x.dtype)


def ffn_up_plain(x: torch.Tensor, w1v, w3v, b1, b3, *, act: str = "silu",
                 scales: Optional[Tuple] = None) -> torch.Tensor:
    """Phase (a) in plain PyTorch: h (M, nv·bf), visit v's columns at
    [v·bf, (v+1)·bf); in x's type on the fp path (the reference rounds h
    there), fp32 on the int8 path."""
    xf = x.to(torch.float32)
    if scales is None:
        w1 = w1v.to(x.dtype).to(torch.float32)
        w3 = w3v.to(x.dtype).to(torch.float32)
    else:
        w1, w3 = w1v.to(torch.float32), w3v.to(torch.float32)
    u = torch.einsum("md,vdf->mvf", xf, w1)
    g = torch.einsum("md,vdf->mvf", xf, w3)
    if scales is not None:
        u = u * scales[0].to(torch.float32)[:, None]
        g = g * scales[1].to(torch.float32)[:, None]
    h = ACTS[act](u + b1.to(torch.float32)) * (g + b3.to(torch.float32))
    h = h.reshape(x.shape[0], -1)
    return h.to(x.dtype) if scales is None else h


def ffn_down_plain(h: torch.Tensor, w2v, b2, *, out_dtype,
                   s2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase (b) in plain PyTorch: h (M, nv·bf) @ the nv w2v slabs (each
    visit's partial times s2 on the int8 path) + b2, in ``out_dtype``."""
    nv, bf, d = w2v.shape
    hf = h.to(torch.float32).reshape(h.shape[0], nv, bf)
    w2 = w2v.to(torch.float32) if s2 is not None \
        else w2v.to(h.dtype).to(torch.float32)
    part = torch.einsum("mvf,vfd->mvd", hf, w2)
    if s2 is not None:
        part = part * s2.to(torch.float32)[:, None]
    return (part.sum(dim=1) + b2.to(torch.float32)).to(out_dtype)


def fused_ffn(x: torch.Tensor, w1v, w3v, w2v, b1, b3, b2, *,
              act: str = "silu",
              scales: Optional[Tuple] = None) -> torch.Tensor:
    """x (M, d) -> (M, d) in x.dtype. w1v/w3v (nv, d, bf), w2v (nv, bf, d)
    fp32/bf16, or int8 with ``scales`` = (s1, s3, s2) each (nv,);
    b1/b3 (nv, bf), b2 (d,) fp32."""
    if act not in ACTS or act is None:
        raise ValueError(f"fused FFN needs an activation, got {act!r}")
    if x.device.type == "cpu":
        return fused_ffn_plain(x, w1v, w3v, w2v, b1, b3, b2, act=act,
                               scales=scales)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn runs on cuda or cpu, not {x.device}")
    if x.ndim != 2 or w1v.ndim != 3:
        raise ValueError(f"x {tuple(x.shape)} must be (M, d), w1v "
                         f"{tuple(w1v.shape)} (nv, d, bf)")
    M, d = x.shape
    nv, _, bf = w1v.shape
    if bf > 32:
        raise ValueError(f"block_f {bf} > 32 is not supported")
    if (w1v.dtype == torch.int8) != (scales is not None):
        raise ValueError("int8 values need scales, fp values take none")
    if not (w1v.dtype == w3v.dtype == w2v.dtype):
        raise ValueError("w1v, w3v and w2v must share one dtype")
    expect = [("w1v", w1v, (nv, d, bf)), ("w3v", w3v, (nv, d, bf)),
              ("w2v", w2v, (nv, bf, d)), ("b1", b1, (nv, bf)),
              ("b3", b3, (nv, bf)), ("b2", b2, (d,))]
    expect += [(f"s{i}", s, (nv,)) for i, s in zip((1, 3, 2), scales or ())]
    for name, t, shape in expect:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    dev = x.device
    x = as_type(x, x.dtype)
    w1v, w3v, w2v = (as_type(w, w.dtype) for w in (w1v, w3v, w2v))
    b1, b3, b2 = (as_type(b, torch.float32) for b in (b1, b3, b2))
    sc = (None, None, None) if scales is None else tuple(
        as_type(s, torch.float32) for s in scales)
    out = torch.empty((M, d), dtype=x.dtype, device=dev)
    if M == 0:
        return out
    ks, up, down, codes, G, vps = _plan(x.dtype, w1v.dtype, d, bf, nv, act)
    # the (M, nv·bf) intermediate: x's type on the fp path, fp32 on int8
    h = torch.empty((M, nv * bf), device=dev, dtype=x.dtype
                    if scales is None else torch.float32)
    partial = None if G == 1 else torch.empty(
        (G, M, d), dtype=torch.float32, device=dev)
    check_words("sasp_fused_ffn", (x, ks), (w1v, bf), (w2v, d), (h, bf))
    code = _launch_fn()(
        x.data_ptr(), w1v.data_ptr(), w3v.data_ptr(), w2v.data_ptr(),
        *[None if s is None else s.data_ptr() for s in sc],
        b1.data_ptr(), b3.data_ptr(), b2.data_ptr(), h.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        M, d, bf, nv, *codes, G, vps,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(code, "sasp_fused_ffn")
    global launches
    launches += 1
    key = f"{up}/{down}"
    variant_launches[key] = variant_launches.get(key, 0) + 1
    wkey = str(w1v.dtype)[6:]
    weight_launches[wkey] = weight_launches.get(wkey, 0) + 1
    return out
