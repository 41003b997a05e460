"""Model configs of the PyTorch port: a copy of the reference package's
``configs/base.py`` and ``configs/archs.py``, so that every ``--arch`` id
resolves to the same ``ModelConfig`` (``reduced()`` included)."""
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
    SSMConfig,
    get_config,
    list_archs,
    reduced,
    register,
    with_sasp,
)

__all__ = [
    "ASSIGNED_ARCHS", "ModelConfig", "MoEConfig", "SASPConfig", "SSMConfig",
    "get_config", "list_archs", "reduced", "register", "with_sasp",
    "MIXER_ATTN", "MIXER_MAMBA", "ATTN_GLOBAL", "ATTN_LOCAL",
    "FFN_DENSE", "FFN_MOE",
]
