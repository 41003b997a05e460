"""The 10 assigned architectures (one factory per arch) + the paper's own
ESPnet ASR encoder rows (Table 1). Exact hyper-parameters from the
assignment block; ``source`` carries the citation tier."""
from __future__ import annotations

from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    register,
)

# ---------------------------------------------------------------------------
# LM-family transformers
# ---------------------------------------------------------------------------


@register("musicgen-medium")
def musicgen_medium() -> ModelConfig:
    # Decoder-only over EnCodec tokens; audio frontend is a stub that feeds
    # precomputed frame embeddings (DESIGN.md §5).
    return ModelConfig(
        name="musicgen-medium", family="audio",
        num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
        head_dim=64, d_ff=6144, vocab_size=2048, act="gelu",
        ffn_gated=False, frontend="audio_stub",
        source="arXiv:2306.05284; hf",
    )


@register("qwen3-32b")
def qwen3_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=25600, vocab_size=151_936,
        qk_norm=True, rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B; hf",
    )


@register("qwen2.5-32b")
def qwen25_32b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
        head_dim=128, d_ff=27648, vocab_size=152_064,
        qkv_bias=True, rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen2.5-0.5B; hf",
    )


@register("command-r-35b")
def command_r_35b() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b", family="dense",
        num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22528, vocab_size=256_000,
        rope_theta=8_000_000.0,
        source="hf:CohereForAI/c4ai-command-r-v01; unverified",
    )


@register("gemma3-4b")
def gemma3_4b() -> ModelConfig:
    # 5:1 local:global interleave, 1024-token sliding window on local
    # layers, 128k context => sub-quadratic enough for long_500k decode
    # (only 1-in-6 layers reads the full KV; see DESIGN.md §5).
    return ModelConfig(
        name="gemma3-4b", family="dense",
        num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
        head_dim=256, d_ff=10240, vocab_size=262_144, act="gelu",
        sliding_window=1024, local_global_period=6,
        rope_theta=1_000_000.0, logit_softcap=30.0,
        supports_long_context=True,
        source="hf:google/gemma-3-1b-pt; unverified",
    )


@register("granite-moe-1b-a400m")
def granite_moe_1b() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m", family="moe",
        num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
        head_dim=64, d_ff=512, vocab_size=49_155,
        moe=MoEConfig(num_experts=32, top_k=8),
        source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    )


@register("moonshot-v1-16b-a3b")
def moonshot_v1_16b() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe",
        num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
        head_dim=128, d_ff=1408, vocab_size=163_840,
        moe=MoEConfig(num_experts=64, top_k=6),
        source="hf:moonshotai/Moonlight-16B-A3B; hf",
    )


@register("mamba2-780m")
def mamba2_780m() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50_280,
        ssm=SSMConfig(state_dim=128, expand=2, head_dim=64, conv_kernel=4),
        supports_long_context=True,
        source="arXiv:2405.21060; unverified",
    )


@register("jamba-1.5-large-398b")
def jamba_15_large() -> ModelConfig:
    # Mamba+attn 1:7 interleave (1 attn per 8-layer group) and MoE on
    # alternating layers (16e top-2); 72 layers = 9 scan super-blocks.
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=24576, vocab_size=65_536,
        moe=MoEConfig(num_experts=16, top_k=2), moe_period=2,
        ssm=SSMConfig(state_dim=128, expand=2, head_dim=64, conv_kernel=4),
        hybrid_attn_period=8, hybrid_attn_offset=4,
        supports_long_context=True,
        source="arXiv:2403.19887; hf",
    )


@register("chameleon-34b")
def chameleon_34b() -> ModelConfig:
    # Early-fusion VLM over VQ image tokens; modality frontend is a stub
    # providing precomputed patch-token embeddings.
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, d_ff=22016, vocab_size=65_536,
        qk_norm=True, frontend="vlm_stub",
        source="arXiv:2405.09818; unverified",
    )


# ---------------------------------------------------------------------------
# The paper's own models (Table 1) — used by the QoS reproduction tier.
# These are *encoders*; the QoS harness adds a per-position classification
# head (token error rate ≙ WER).
# ---------------------------------------------------------------------------


@register("paper-espnet-asr")
def paper_espnet_asr() -> ModelConfig:
    return ModelConfig(
        name="paper-espnet-asr", family="dense",
        num_layers=18, d_model=512, num_heads=4, num_kv_heads=4,
        head_dim=128, d_ff=2048, vocab_size=5000, act="gelu",
        ffn_gated=False,
        source="paper Table 1 row 1 (ESPnet ASR, LibriSpeech)",
    )


@register("paper-espnet2-asr")
def paper_espnet2_asr() -> ModelConfig:
    return ModelConfig(
        name="paper-espnet2-asr", family="dense",
        num_layers=12, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=5000, act="gelu",
        ffn_gated=False,
        source="paper Table 1 row 2 (ESPnet2 ASR, LibriSpeech)",
    )


@register("paper-espnet2-mt")
def paper_espnet2_mt() -> ModelConfig:
    return ModelConfig(
        name="paper-espnet2-mt", family="dense",
        num_layers=6, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=1024, vocab_size=8000, act="gelu",
        ffn_gated=False,
        source="paper Table 1 row 3 (ESPnet2 MT, MuST-C)",
    )


ASSIGNED_ARCHS = [
    "musicgen-medium", "qwen3-32b", "qwen2.5-32b", "command-r-35b",
    "gemma3-4b", "granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
    "mamba2-780m", "jamba-1.5-large-398b", "chameleon-34b",
]
