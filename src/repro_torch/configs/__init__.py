"""Model configs of the PyTorch port: a copy of the reference package's
``configs/base.py``, ``configs/archs.py`` and ``configs/shapes.py``, so
that every ``--arch`` id resolves to the same ``ModelConfig``
(``reduced()`` included) and every shape cell to the same
``ShapeConfig``."""
# importing archs registers every --arch id
from repro_torch.configs import archs as _archs  # noqa: F401
from repro_torch.configs.archs import ASSIGNED_ARCHS
from repro_torch.configs.base import (
    ATTN_GLOBAL,
    ATTN_LOCAL,
    FFN_DENSE,
    FFN_MOE,
    MIXER_ATTN,
    MIXER_MAMBA,
    ModelConfig,
    MoEConfig,
    SASPConfig,
    ShapeConfig,
    SSMConfig,
    get_config,
    list_archs,
    reduced,
    register,
    with_sasp,
)
from repro_torch.configs.shapes import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    get_shape,
    shapes_for,
    skipped_shapes_for,
)

__all__ = [
    "ASSIGNED_ARCHS", "ModelConfig", "MoEConfig", "SASPConfig", "SSMConfig",
    "ShapeConfig", "get_config", "list_archs", "reduced", "register",
    "with_sasp", "ALL_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
    "LONG_500K", "get_shape", "shapes_for", "skipped_shapes_for",
    "MIXER_ATTN", "MIXER_MAMBA", "ATTN_GLOBAL", "ATTN_LOCAL",
    "FFN_DENSE", "FFN_MOE",
]
