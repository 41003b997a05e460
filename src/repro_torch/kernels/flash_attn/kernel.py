"""Flash attention: online softmax over key blocks (port of
``repro.kernels.flash_attn.kernel.flash_attention``).

``flash_attention`` launches the CUDA kernel (``csrc/flash_attn.cu``)
for CUDA tensors and runs ``flash_attention_plain`` — the same online
softmax, key block by key block, in plain PyTorch — for CPU tensors.
K and V may have fewer heads than q (GQA): head h reads kv head h // G.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

launches = 0

NEG_INF = -1.0e30
BLOCK_K = 32                 # keys per block of the kernel
HEAD_DIMS = (16, 32, 64, 128)
_INT32_MAX = 2 ** 31 - 1


@functools.lru_cache(maxsize=None)
def _launch_fn():
    """The launch entry point, its signature set once."""
    fn = build.load("flash_attn").flash_attn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
        [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, window: int):
    """Plain-PyTorch version of the kernel's arithmetic: fp32 scores times
    D^-0.5, NEG_INF where masked, running max / sum / accumulator over
    key blocks, p rounded to v's type before p @ v, flush divided by
    max(l, 1e-20)."""
    H, Sq, D = q.shape
    Hk, Sk = k.shape[:2]
    G = H // Hk
    kf = k.repeat_interleave(G, dim=0).to(torch.float32)
    vf = v.repeat_interleave(G, dim=0)
    qf = q.to(torch.float32)
    qp = q_pos.to(torch.int64)
    kp = kv_pos.to(torch.int64)
    m = torch.full((H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((H, Sq, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, Sk, BLOCK_K):
        kb = kf[:, c0:c0 + BLOCK_K]
        vb = vf[:, c0:c0 + BLOCK_K]
        s = torch.einsum("hqd,hkd->hqk", qf, kb) * (D ** -0.5)
        delta = qp[:, None] - kp[None, c0:c0 + BLOCK_K]
        mask = ((delta >= 0) & (delta < window))[None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "hqk,hkd->hqd", p.to(v.dtype).to(torch.float32),
            vb.to(torch.float32))
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)[..., None]).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """q (H, Sq, D); k, v (H / G, Sk, D), one type (fp32 or bf16); q_pos
    (Sq,) and kv_pos (Sk,) absolute positions. Key j is visible to query
    i iff 0 <= q_pos[i] - kv_pos[j] < window (window >= Sk: causal). A
    query that sees no key gives 0. Returns (H, Sq, D) in q's type."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (H, Sq, D), k "
                         f"{tuple(k.shape)} and v {tuple(v.shape)} one "
                         f"(H/G, Sk, D)")
    (H, Sq, D), (Hk, Sk, Dk) = q.shape, k.shape
    if Dk != D or Hk == 0 or H % Hk:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: head "
                         f"dims differ or kv heads do not divide heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share float32 or bfloat16, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(q_pos.shape) != (Sq,) or tuple(kv_pos.shape) != (Sk,):
        raise ValueError(f"positions {tuple(q_pos.shape)}, "
                         f"{tuple(kv_pos.shape)} must be ({Sq},), ({Sk},)")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    qp = q_pos.to(torch.int32).contiguous()
    kp = kv_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    if H == 0 or Sq == 0:
        return out
    code = _launch_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), qp.data_ptr(),
        kp.data_ptr(), out.data_ptr(), H, Sq, Sk, D, H // Hk,
        min(int(window), _INT32_MAX), D ** -0.5, build.dtype_code(q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "flash_attention")
    global launches
    launches += 1
    return out
