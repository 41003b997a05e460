"""Weight-only int8 quantization of the port (``repro.core.quantization``):
the paper's FP32_INT8 setting.

Symmetric scales, one per (block_k × block_n) tile, so that pruning and
quantization share one block layout. ``quantize_int8`` clamps the block
to the matrix (``min(bk, K), min(bn, N)``) as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class QuantizedWeight:
    """q: int8 (…, K, N); scale: fp32 (…, KB, NB); block (bk, bn)."""

    q: torch.Tensor
    scale: torch.Tensor
    block: Tuple[int, int]

    def layer(self, i: int) -> "QuantizedWeight":
        """Layer ``i`` of a layer-stacked weight."""
        return QuantizedWeight(self.q[i], self.scale[i], self.block)


def quantize_int8(w: torch.Tensor, bk: int, bn: int) -> QuantizedWeight:
    *lead, K, N = w.shape
    bk, bn = min(bk, K), min(bn, N)
    KB, NB = K // bk, N // bn
    wb = w.reshape(*lead, KB, bk, NB, bn).to(torch.float32)
    amax = torch.amax(torch.abs(wb), dim=(-3, -1), keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wb / scale), -127, 127).to(torch.int8)
    return QuantizedWeight(q=q.reshape(*lead, K, N),
                           scale=scale.reshape(*lead, KB, NB),
                           block=(bk, bn))


def dequantize_int8(qw: QuantizedWeight, dtype=torch.float32
                    ) -> torch.Tensor:
    bk, bn = qw.block
    *lead, K, N = qw.q.shape
    KB, NB = K // bk, N // bn
    qb = qw.q.reshape(*lead, KB, bk, NB, bn).to(torch.float32)
    wb = qb * qw.scale[..., :, None, :, None]
    return wb.reshape(*lead, K, N).to(dtype)
