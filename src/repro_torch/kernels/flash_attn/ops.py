"""GQA wrapper of the flash-attention kernel (port of
``repro.kernels.flash_attn.ops.mha``): folds (B, S, H, D) layouts into
the kernel's (heads, S, D) form. The kernel reads kv head h // G, so K
and V are not repeated G times as in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.kernel import flash_attention


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_pos: torch.Tensor, kv_pos: torch.Tensor, *, window: int
        ) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KH, D) with H % KH == 0 (GQA);
    positions 1-D, shared by the batch. Returns (B, Sq, H, D)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, D)
    kf = k.permute(0, 2, 1, 3).reshape(B * KH, Sk, D)
    vf = v.permute(0, 2, 1, 3).reshape(B * KH, Sk, D)
    o = flash_attention(qf, kf, vf, q_pos, kv_pos, window=window)
    return o.reshape(B, H, Sq, D).permute(0, 2, 1, 3)
