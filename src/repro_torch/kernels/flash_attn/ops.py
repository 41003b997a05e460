"""GQA wrapper of the flash-attention kernel (port of
``repro.kernels.flash_attn.ops.mha``). The kernel takes the (B, S, H, D)
tensors as strided views and reads kv head h // G, so nothing is
permuted, copied or repeated G times as in the reference."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn import kernel as _kernel


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        q_pos: torch.Tensor, kv_pos: torch.Tensor, *, window: int
        ) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, KH, D) with H % KH == 0 (GQA);
    positions 1-D, shared by the batch. Returns (B, Sq, H, D)."""
    if q.device.type == "cpu":
        B, Sq, H, D = q.shape
        Sk, KH = k.shape[1], k.shape[2]
        o = _kernel.flash_attention_plain(
            q.permute(0, 2, 1, 3).reshape(B * H, Sq, D),
            k.permute(0, 2, 1, 3).reshape(B * KH, Sk, D),
            v.permute(0, 2, 1, 3).reshape(B * KH, Sk, D),
            q_pos, kv_pos, window=window)
        return o.reshape(B, H, Sq, D).permute(0, 2, 1, 3)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernel.launch_bshd(q, k, v, out, q_pos, kv_pos, window=window)
    return out
