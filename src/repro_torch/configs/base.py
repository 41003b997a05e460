"""Config dataclasses + registry for the SASP framework.

Every assigned architecture is a `ModelConfig` produced by a factory in its
own module (``src/repro_torch/configs/<id>.py``) and registered here under its
``--arch`` id.  Shapes (train_4k / prefill_32k / decode_32k / long_500k) are
`ShapeConfig` rows in ``shapes.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# SASP — the paper's technique as a first-class config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SASPConfig:
    """Systolic-Array Structured Pruning configuration (paper §3.1).

    block_k/block_n: pruning tile = (block_k, block_n) over a (K, N) weight
      matrix — matched to the accelerator tile (paper: systolic array size;
      TPU: MXU/VMEM block, multiples of 128).
    sparsity: global fraction of tiles zeroed, chosen by lowest L1 norm
      *across the whole model* (heterogeneous per-layer rates fall out).
    scope: which GEMMs are prunable. The paper targets feed-forward GEMMs.
    quantize: weight-only INT8 (per-block symmetric scales) — the paper's
      FP32_INT8 hybrid-multiplier setting.
    path: execution path — "masked" (dense ⊙ mask; training + fallback),
      "bsr" (gathered block-compressed jnp; FLOP/byte savings visible to
      XLA), "kernel" (Pallas tile-skip kernel; TPU-native).
    """

    enabled: bool = False
    block_k: int = 128
    block_n: int = 128
    sparsity: float = 0.0
    scope: str = "ffn"            # "ffn" | "all"
    quantize: bool = False
    path: str = "masked"          # "masked" | "bsr" | "kernel"

    def __post_init__(self):
        assert self.scope in ("ffn", "all"), self.scope
        assert self.path in ("masked", "bsr", "kernel"), self.path
        assert 0.0 <= self.sparsity < 1.0, self.sparsity


# ---------------------------------------------------------------------------
# Sub-configs per family
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # Router jitter/aux-loss weight (GShard-style load balancing).
    router_aux_weight: float = 0.01
    # If >0, this many always-on shared experts (DeepSeek-style).
    num_shared_experts: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD — state space duality, arXiv:2405.21060)."""

    state_dim: int = 128
    expand: int = 2
    head_dim: int = 64            # SSD P (channels per head)
    conv_kernel: int = 4
    ngroups: int = 1
    chunk_size: int = 256         # SSD chunked-scan block length
    dt_min: float = 0.001
    dt_max: float = 0.1
    # a TP rank's local config holds 1/head_shards of the heads and of
    # the x channels (``distribution.sharding.local_config``)
    head_shards: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


# ---------------------------------------------------------------------------
# The model config
# ---------------------------------------------------------------------------

# Per-layer mixer kinds (hybrid archs interleave these).
MIXER_ATTN = 0
MIXER_MAMBA = 1

# Per-layer attention kinds (gemma3 interleaves these).
ATTN_GLOBAL = 0
ATTN_LOCAL = 1

# Per-layer FFN kinds (jamba interleaves these).
FFN_DENSE = 0
FFN_MOE = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    # --- attention ---
    num_heads: int = 0            # 0 for attention-free archs
    num_kv_heads: int = 0
    head_dim: int = 0             # explicit (gemma/qwen use != d_model/heads)
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0       # >0 => local layers use this window
    # pattern period for local:global interleave (gemma3: 6 => 5 local + 1
    # global per group; 0 => all layers global).
    local_global_period: int = 0
    # --- ffn ---
    d_ff: int = 0
    act: str = "silu"             # silu | gelu
    ffn_gated: bool = True        # SwiGLU/GeGLU (False: plain 2-matrix MLP)
    moe: Optional[MoEConfig] = None
    # --- ssm / hybrid ---
    ssm: Optional[SSMConfig] = None
    # period for mamba:attn interleave (jamba: 8 => 1 attn + 7 mamba per
    # group; 0 => homogeneous family).
    hybrid_attn_period: int = 0
    hybrid_attn_offset: int = 4   # index of the attn layer inside a group
    # period for dense:moe FFN interleave (jamba: 2 => alternate; 0 => all
    # layers share one FFN kind given by `moe is None`).
    moe_period: int = 0
    # --- misc ---
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    frontend: str = "none"        # none | audio_stub | vlm_stub
    supports_long_context: bool = False
    # --- serving ---
    kv_quant: bool = False        # int8 KV cache (beyond-paper)
    # TP FFN output reduction: "ar" (GSPMD all-reduce) | "rs_ag_int8"
    # (reduce-scatter bf16 + int8 all-gather: 0.75x wire bytes;
    # beyond-paper — see EXPERIMENTS.md §Perf B iter 5)
    tp_comm: str = "ar"
    # the embedding / head table's rows in this many equal vocab shards
    # (the reference's ``vocab`` rule; set by a TP deployment): a mesh
    # rank holds one, the shard loop computes the head shard by shard
    vocab_shards: int = 1
    # the 'model' shards of a TP deployment's dense and BSR matrices
    # (the reference's col / row / bsr rules; set by a TP deployment): a
    # mesh rank holds one of each, the shard loop runs them shard by shard
    tp_shards: int = 1
    # the 'data' shards of a MoE deployment's expert stacks (expert
    # parallelism, ``distribution.moe_ep``): a mesh rank holds E / ep
    # experts, the meshless loop runs the ep shards one after another
    ep_shards: int = 1
    # a mesh rank's config whose head counts do not divide 'model': the
    # rank holds every head and runs the whole attention core (the
    # reference's replicated SDPA; ``distribution.sharding.local_config``)
    heads_replicated: bool = False
    # the sequence-parallel KV layout of a deployment whose batch does
    # not split over 'data' (``distribution.sharding.seq_config``): the
    # cache length its rings are sized from (0: no such layout), the
    # sizes of 'data' and 'model' that may cut a ring's capacity
    # ('model' 1 where the KV heads split over it) and this rank's index
    # over them, data-major (-1: the meshless twin, every block of every
    # ring in one process)
    seq_cache_len: int = 0
    seq_mesh: Tuple[int, int] = (1, 1)
    seq_index: int = -1
    # --- SASP ---
    sasp: SASPConfig = field(default_factory=SASPConfig)
    # --- numerics ---
    param_dtype: str = "float32"  # master dtype (smoke/QoS tests)
    compute_dtype: str = "bfloat16"
    # scan-over-layers remat policy: "none"|"full"|"dots"
    remat: str = "full"
    # provenance
    source: str = ""

    # ------------------------------------------------------------------
    # Derived helpers
    # ------------------------------------------------------------------
    @property
    def attn_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def layer_mixer_kinds(self) -> List[int]:
        """Per-layer mixer: MIXER_ATTN / MIXER_MAMBA."""
        if self.family in ("ssm",):
            return [MIXER_MAMBA] * self.num_layers
        if self.hybrid_attn_period:
            return [
                MIXER_ATTN
                if (i % self.hybrid_attn_period) == self.hybrid_attn_offset
                else MIXER_MAMBA
                for i in range(self.num_layers)
            ]
        return [MIXER_ATTN] * self.num_layers

    def layer_attn_kinds(self) -> List[int]:
        """Per-layer attention locality: ATTN_GLOBAL / ATTN_LOCAL."""
        if self.local_global_period and self.sliding_window:
            # gemma3 style: (period-1) local layers then 1 global.
            return [
                ATTN_GLOBAL
                if (i % self.local_global_period) == self.local_global_period - 1
                else ATTN_LOCAL
                for i in range(self.num_layers)
            ]
        return [ATTN_GLOBAL] * self.num_layers

    def layer_ffn_kinds(self) -> List[int]:
        if self.moe is None:
            return [FFN_DENSE] * self.num_layers
        if self.moe_period:
            return [
                FFN_MOE if (i % self.moe_period) == 1 else FFN_DENSE
                for i in range(self.num_layers)
            ]
        return [FFN_MOE] * self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer), used for
        MODEL_FLOPS = 6·N·D and memory napkin math."""
        d = self.d_model
        n = 0
        n += self.vocab_size * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        hd = self.attn_head_dim
        ffn_mats = 3 if self.ffn_gated else 2
        mixers = self.layer_mixer_kinds()
        ffns = self.layer_ffn_kinds()
        for mk, fk in zip(mixers, ffns):
            if mk == MIXER_ATTN:
                n += d * (self.num_heads * hd)          # q
                n += 2 * d * (self.num_kv_heads * hd)   # k, v
                n += (self.num_heads * hd) * d          # o
                if self.qkv_bias:
                    n += (self.num_heads + 2 * self.num_kv_heads) * hd
            else:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.num_heads(d)
                n += d * (2 * di + 2 * s.ngroups * s.state_dim + nh)  # in_proj
                n += s.conv_kernel * (di + 2 * s.ngroups * s.state_dim)
                n += nh * 2                             # A_log, D
                n += di                                  # dt bias ~ nh; norm
                n += di * d                              # out_proj
            if fk == FFN_MOE:
                e = self.moe.num_experts + self.moe.num_shared_experts
                n += e * ffn_mats * d * self.d_ff        # (gate/)up/down
                n += d * self.moe.num_experts            # router
            else:
                n += ffn_mats * d * self.d_ff
            n += 2 * d                                   # 2 norms
        n += d                                           # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d, m = self.d_model, self.moe
        fm = 3 if self.ffn_gated else 2
        n_moe_layers = sum(1 for k in self.layer_ffn_kinds() if k == FFN_MOE)
        all_e = (m.num_experts + m.num_shared_experts) * fm * d * self.d_ff
        act_e = (m.top_k + m.num_shared_experts) * fm * d * self.d_ff
        return full - n_moe_layers * (all_e - act_e)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int

    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode"), self.kind


# ---------------------------------------------------------------------------
# Mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn

    return deco


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs as _c  # noqa: F401
    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    from repro_torch import configs as _c  # noqa: F401

    return sorted(_REGISTRY)


def with_sasp(cfg: ModelConfig, **kw) -> ModelConfig:
    return replace(cfg, sasp=replace(cfg.sasp, enabled=True, **kw))


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 64,
            vocab: int = 128, seq: int = 32) -> ModelConfig:
    """Family-preserving shrink: same structure, tiny dims. Used by the
    per-arch smoke tests; the FULL configs are only ever lowered via the
    dry-run (ShapeDtypeStruct, no allocation)."""
    kw = dict(
        num_layers=layers,
        d_model=d_model,
        vocab_size=vocab,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.num_heads:
        heads = max(2, min(4, cfg.num_heads))
        kvh = max(1, min(cfg.num_kv_heads, heads))
        while heads % kvh:
            kvh -= 1
        kw.update(num_heads=heads, num_kv_heads=kvh, head_dim=d_model // heads)
    if cfg.d_ff:
        kw.update(d_ff=d_model * 2 if cfg.moe is None else d_model)
    if cfg.moe is not None:
        kw.update(moe=replace(cfg.moe, num_experts=4,
                              top_k=min(2, cfg.moe.top_k)))
    if cfg.ssm is not None:
        kw.update(ssm=replace(cfg.ssm, state_dim=16, head_dim=16,
                              chunk_size=16))
    if cfg.sliding_window:
        kw.update(sliding_window=16, local_global_period=min(
            cfg.local_global_period, layers) or 0)
    if cfg.hybrid_attn_period:
        p = min(cfg.hybrid_attn_period, max(2, layers))
        kw.update(hybrid_attn_period=p, hybrid_attn_offset=p - 1,
                  moe_period=cfg.moe_period and 2)
    return replace(cfg, **kw)
