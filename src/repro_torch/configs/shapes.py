"""Assigned input shapes. ``decode_*`` / ``long_*`` lower ``serve_step``
(one new token against a KV cache of seq_len), NOT ``train_step``.
``long_500k`` is only run for sub-quadratic archs (ssm / hybrid / 5:1
local:global) — see ModelConfig.supports_long_context + DESIGN.md §5."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", "train", seq_len=4_096, global_batch=256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", seq_len=32_768,
                          global_batch=32)
DECODE_32K = ShapeConfig("decode_32k", "decode", seq_len=32_768,
                         global_batch=128)
LONG_500K = ShapeConfig("long_500k", "decode", seq_len=524_288,
                        global_batch=1)

ALL_SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def get_shape(name: str) -> ShapeConfig:
    return ALL_SHAPES[name]


def shapes_for(cfg: ModelConfig) -> List[ShapeConfig]:
    """The shape cells applicable to this arch (all are decoder-only LMs,
    so decode shapes always apply; long_500k gated on sub-quadratic)."""
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.supports_long_context:
        out.append(LONG_500K)
    return out


def skipped_shapes_for(cfg: ModelConfig) -> List[str]:
    return [] if cfg.supports_long_context else [LONG_500K.name]
