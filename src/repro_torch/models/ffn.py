"""Feed-forward layers of the port (``repro.models.ffn``), single device.

Paths:
  * dense — no SASP;
  * masked — pruned tiles zeroed in the dense weights, or a
    ``sasp_masks`` overlay; with int8 weights (``qw``) each matrix is
    dequantized in plain torch and multiplied densely, as the reference
    does;
  * bsr — ``BlockSparseWeight`` containers (``sasp_bsr``) through the
    gathered block matmul ``bsr_matmul``;
  * kernel — the same containers through the tile-skip kernel
    (``sasp_matmul``), repacked into a visit list on every call;
  * packed — the whole-FFN fused kernel when a ``PackedFFN``
    (``sasp_fused``) is attached, else the per-matrix tile-skip GEMMs
    (``sasp_packed``) with the activation folded into w1's flush.

The shard_map (TP) paths and the rs+int8-ag reduction are not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.pruning import apply_block_mask
from repro_torch.core.quantization import dequantize_int8
from repro_torch.core.sparse import bsr_matmul
from repro_torch.kernels.sasp_gemm.gemm import sasp_matmul
from repro_torch.models.modules import act_fn, as_dtype


def ffn_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int,
             device, out_scale: float, d_ff: Optional[int] = None) -> Dict:
    """Layer-stacked (layers, …) gated-FFN params from ``gen``; w2 is
    drawn at ``out_scale``."""
    dt = as_dtype(cfg.param_dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dt)

    p = {"w1": {"w": normal((layers, d, f), 0.02)},
         "w2": {"w": normal((layers, f, d), out_scale)}}
    if cfg.ffn_gated:
        p["w3"] = {"w": normal((layers, d, f), 0.02)}
    return p


def _materialize(p: Dict, name: str, dtype) -> torch.Tensor:
    entry = p[name]
    w = dequantize_int8(entry["qw"]) if "qw" in entry else entry["w"]
    masks = p.get("sasp_masks")
    if masks is not None and name in masks:
        w = apply_block_mask(w, masks[name])
    return w.to(dtype)


def _mm(p: Dict, name: str, x2: torch.Tensor, cfg: ModelConfig
        ) -> torch.Tensor:
    """(M, K) @ weight[name] through whatever SASP view is attached."""
    bsr = p.get("sasp_bsr")
    if bsr is not None and name in bsr:
        if cfg.sasp.path == "kernel":
            return sasp_matmul(x2, bsr[name])
        return bsr_matmul(x2, bsr[name])
    return torch.matmul(x2, _materialize(p, name, x2.dtype))


def _ffn_apply_packed(p: Dict, cfg: ModelConfig, x2: torch.Tensor
                      ) -> Optional[torch.Tensor]:
    from repro_torch.core.deploy import packed_ffn_apply, packed_matmul

    fused = p.get("sasp_fused")
    if fused is not None:
        return packed_ffn_apply(x2, fused)
    packed = p.get("sasp_packed")
    if packed is not None and "w1" in packed:
        h = packed_matmul(x2, packed["w1"])          # act in the flush
        if cfg.ffn_gated and "w3" in packed:
            h = h * packed_matmul(x2, packed["w3"])
        return packed_matmul(h, packed["w2"])
    return None


def ffn_apply(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    *lead, d = x.shape
    x2 = x.reshape(-1, d)
    if "sasp_fused" in p or "sasp_packed" in p:
        y = _ffn_apply_packed(p, cfg, x2)
        if y is not None:
            return y.reshape(*lead, d).to(x.dtype)
    act = act_fn(cfg.act)
    h = _mm(p, "w1", x2, cfg)
    if cfg.ffn_gated:
        h = act(h) * _mm(p, "w3", x2, cfg)
    else:
        h = act(h)
    y = _mm(p, "w2", h, cfg)
    if "b" in p.get("w2", {}):
        y = y + p["w2"]["b"].to(y.dtype)
    return y.reshape(*lead, d).to(x.dtype)
