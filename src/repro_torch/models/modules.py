"""Functional helpers of the port's decoder (``repro.models.modules``).

Params are nested dicts of tensors. JAX promotes mixed-type operands
implicitly (bf16 @ f32 -> f32) and ``preferred_element_type=float32``
keeps fp32 results of bf16 products; ``torch.matmul`` refuses mixed
types and returns bf16 for bf16 inputs, so every such product here
names its result type explicitly.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.sasp_gemm.gemm import ACTS

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def as_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX type promotion of the operands."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A product with ``preferred_element_type=float32``: exact products
    of the operands, summed and returned in fp32."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def embedding_apply(p: Params, tokens: torch.Tensor, *, dtype
                    ) -> torch.Tensor:
    return p["emb"].to(dtype)[tokens.to(torch.int64)]


def act_fn(name: str):
    return ACTS[name]


def rmsnorm_apply(p: Params, x: torch.Tensor, *, eps: float
                  ) -> torch.Tensor:
    return qknorm_apply(p["scale"], x, eps=eps)


def qknorm_apply(scale: torch.Tensor, x: torch.Tensor, *, eps: float
                 ) -> torch.Tensor:
    """RMS norm over the last axis, in fp32, back to x's type."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(dt)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * inv
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
