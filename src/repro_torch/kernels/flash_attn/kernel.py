"""Flash attention: online softmax over key tiles (port of
``repro.kernels.flash_attn.kernel.flash_attention``).

``flash_attention`` launches the CUDA kernel (``csrc/flash_attn.cu``)
for CUDA tensors and runs ``flash_attention_plain`` — the same online
softmax, tile by tile, in plain PyTorch — for CPU tensors. K and V may
have fewer heads than q (GQA): head h reads kv head h // G.
``tile_class`` is the rule both use to skip a (query tile, key tile) pair
that no query can see and to leave the mask out of one where every query
sees every key. ``launches`` counts kernel launches, ``variant_launches``
the launches by variant ("mma": bf16 tensor cores, "fma": fp32 FMAs).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.sasp_gemm.gemm import as_type

launches = 0
variant_launches = {}

NEG_INF = -1.0e30
BLOCK_K = 64                 # keys per tile (the tensor-core kernel's)
BLOCK_Q = 128                # query positions per tile of the plain version
HEAD_DIMS = (16, 32, 64, 128)
_INT32_MAX = 2 ** 31 - 1
MMA, FMA = "mma", "fma"
SKIP, PARTIAL, FULL = 0, 1, 2


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("flash_attn").flash_attn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + \
        [ctypes.c_longlong] * 12 + [ctypes.c_int, ctypes.c_float,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    return fn


def tile_class(qmin: int, qmax: int, kmin: int, kmax: int, window: int,
               ragged: bool) -> int:
    """How a tile of queries with positions in [qmin, qmax] meets a tile
    of keys with positions in [kmin, kmax] (key j visible to query i iff
    0 <= q_pos[i] - kv_pos[j] < window): SKIP when no pair can be visible,
    FULL when every pair is and the tile has no row or key past the end
    of its axis (``ragged``), else PARTIAL. The CUDA kernel applies the
    same rule to its 64-row, 64-key tiles (csrc/flash_attn.cu ``cls``)."""
    if qmax - kmin < 0 or qmin - kmax >= window:
        return SKIP
    if not ragged and qmin - kmax >= 0 and qmax - kmin < window:
        return FULL
    return PARTIAL


def tile_bounds(pos: torch.Tensor, block: int) -> List[Tuple[int, int]]:
    """(min, max) of ``pos`` over each run of ``block`` entries."""
    n = pos.shape[0]
    pad = (-n) % block
    p = pos.to(torch.int64)
    if pad:
        p = torch.cat([p, p[-1:].expand(pad)])
    p = p.reshape(-1, block)
    return list(zip(p.amin(1).tolist(), p.amax(1).tolist()))


def variant(dtype) -> str:
    """Tensor cores for bf16; fp32 stays on fp32 FMAs (TF32 would keep
    about 3 digits)."""
    return MMA if dtype == torch.bfloat16 else FMA


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, window: int):
    """Plain-PyTorch version of the kernel's arithmetic: fp32 scores times
    D^-0.5, NEG_INF where masked, running max / sum / accumulator over
    key tiles, p rounded to v's type before p @ v, flush divided by
    max(l, 1e-20). Query tiles of BLOCK_Q positions meet key tiles of
    BLOCK_K keys; a pair that ``tile_class`` calls SKIP is left out (it
    would leave (m, l, acc) exactly as they are), one it calls FULL is
    not masked."""
    H, Sq, D = q.shape
    Hk, Sk = k.shape[:2]
    G = H // Hk
    kf = k.repeat_interleave(G, dim=0).to(torch.float32)
    vf = v.repeat_interleave(G, dim=0)
    qf = q.to(torch.float32)
    qp = q_pos.to(torch.int64)
    kp = kv_pos.to(torch.int64)
    out = torch.zeros((H, Sq, D), dtype=q.dtype, device=q.device)
    kbounds = tile_bounds(kp, BLOCK_K)
    for qi, (qmin, qmax) in enumerate(tile_bounds(qp, BLOCK_Q)):
        r0, r1 = qi * BLOCK_Q, min(Sq, (qi + 1) * BLOCK_Q)
        m = torch.full((H, r1 - r0), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((H, r1 - r0), dtype=torch.float32, device=q.device)
        acc = torch.zeros((H, r1 - r0, D), dtype=torch.float32,
                          device=q.device)
        for kj, (kmin, kmax) in enumerate(kbounds):
            c0, c1 = kj * BLOCK_K, min(Sk, (kj + 1) * BLOCK_K)
            cls = tile_class(qmin, qmax, kmin, kmax, window,
                             r1 - r0 < BLOCK_Q or c1 - c0 < BLOCK_K)
            if cls == SKIP:
                continue
            s = torch.einsum("hqd,hkd->hqk", qf[:, r0:r1], kf[:, c0:c1]) \
                * (D ** -0.5)
            if cls == FULL:
                mask = None
            else:
                delta = qp[r0:r1, None] - kp[None, c0:c1]
                mask = ((delta >= 0) & (delta < window))[None]
                s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            if mask is not None:
                p = torch.where(mask, p, torch.zeros_like(p))
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "hqk,hkd->hqd", p.to(v.dtype).to(torch.float32),
                vf[:, c0:c1].to(torch.float32))
            m = m_new
        out[:, r0:r1] = (acc / torch.clamp(l, min=1e-20)[..., None]
                         ).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """q (H, Sq, D); k, v (H / G, Sk, D), one type (fp32 or bf16); q_pos
    (Sq,) and kv_pos (Sk,) absolute positions. Key j is visible to query
    i iff 0 <= q_pos[i] - kv_pos[j] < window (window >= Sk: causal). A
    query that sees no key gives 0. Returns (H, Sq, D) in q's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, window=window)
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (H, Sq, D), k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} one "
                         f"(H/G, Sk, D)")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # (heads, S, D) is the (1, S, heads, D) view of the kernel's layout
    launch_bshd(*(t.transpose(0, 1)[None] for t in (q, k, v, out)),
                q_pos, kv_pos, window=window)
    return out


def _kernel_view(t: torch.Tensor, mma: bool) -> torch.Tensor:
    """t itself where the kernel takes it (last axis contiguous; for the
    tensor-core variant every stride a multiple of 8 elements and the base
    16-byte aligned, for its 16-byte copies), else a contiguous copy."""
    ok = t.stride(-1) == 1 and (not mma or (
        t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:-1])))
    if ok:
        return t
    return t.contiguous() if not t.is_contiguous() else t.clone()


def launch_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, q_pos: torch.Tensor, kv_pos: torch.Tensor,
                *, window: int) -> None:
    """The kernel on (B, S, heads, D) views, strided as they are: q and out
    (B, Sq, H, D), k and v (B, Sk, H / G, D); writes out in place."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or \
            out.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and out {tuple(out.shape)} "
                         f"must be one (B, Sq, H, D), k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} one (B, Sk, H/G, D)")
    (B, Sq, H, D), (Bk, Sk, Hk, Dk) = q.shape, k.shape
    if Dk != D or Bk != B or Hk == 0 or H % Hk:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: head "
                         f"dims or batches differ, or kv heads do not "
                         f"divide heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype == out.dtype or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share float32 or bfloat16, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(q_pos.shape) != (Sq,) or tuple(kv_pos.shape) != (Sk,):
        raise ValueError(f"positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} must be ({Sq},), ({Sk},)")
    for name, t in (("k", k), ("v", v), ("out", out), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    if B == 0 or Sq == 0 or H == 0:
        return
    if Sk == 0:
        out.zero_()
        return
    var = variant(q.dtype)
    mma = var == MMA
    q, k, v = (_kernel_view(t, mma) for t in (q, k, v))
    o = _kernel_view(out, mma)
    qp = as_type(q_pos, torch.int32)
    kp = as_type(kv_pos, torch.int32)
    bounds = torch.empty(2 * -(-Sk // BLOCK_K), dtype=torch.int32,
                         device=q.device) if mma else None
    code = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), o.data_ptr(),
        None if bounds is None else bounds.data_ptr(), B, H, Hk, Sq, Sk, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        min(int(window), _INT32_MAX), D ** -0.5, build.dtype_code(q.dtype),
        int(mma), torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "flash_attention")
    if o is not out:
        out.copy_(o)
    global launches
    launches += 1
    variant_launches[var] = variant_launches.get(var, 0) + 1
