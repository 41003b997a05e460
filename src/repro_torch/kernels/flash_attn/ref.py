"""Dense masked-softmax oracle of the flash-attention kernel (port of
``repro.kernels.flash_attn.ref``)."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def flash_attention_ref(q, k, v, q_pos, kv_pos, *, window: int):
    """q (H, Sq, D); k/v (H, Sk, D); 1-D positions. Key j is visible to
    query i iff 0 <= q_pos[i] - kv_pos[j] < window."""
    D = q.shape[-1]
    s = torch.einsum("hqd,hkd->hqk", q.to(torch.float32),
                     k.to(torch.float32)) * (D ** -0.5)
    delta = q_pos[:, None].to(torch.int64) - kv_pos[None, :].to(torch.int64)
    mask = (delta >= 0) & (delta < window)
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask[None], p, torch.zeros_like(p))
    return torch.einsum("hqk,hkd->hqd", p,
                        v.to(torch.float32)).to(q.dtype)
