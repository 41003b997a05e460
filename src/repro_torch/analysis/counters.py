"""Analytic FLOP / HBM-byte counters per (config × shape).

A copy of ``repro.analysis.counters``: the formulas and their order are
the reference's, so every ``StepCosts`` equals it exactly
(``tests/test_torch_counters.py``). The reference keeps them analytic
because XLA's CPU ``cost_analysis()`` counts a ``while`` body once; the
port keeps them analytic so that both packages report the same counts.
Its forward count is held to ``torch.utils.flop_counter.FlopCounterMode``
over one layer of the port's forward (0.65-1.55, the reference's band
against XLA), and the dry run (``launch/dryrun.py``) adds what only a
trace gives: per-rank memory and the collective record.

``tp`` is accepted and ignored, as in the reference: where the head
counts do not divide 'model', the attention core runs on every head on
every model rank (``models/attention.py``), and that redundant compute is
not charged, despite the docstring below (a fault of the reference,
ROADMAP Queue 3, copied so that the counts stay equal).

All numbers are GLOBAL per step (divide by chips for per-device).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.configs.base import (
    ATTN_LOCAL,
    FFN_MOE,
    MIXER_ATTN,
    ModelConfig,
    ShapeConfig,
)


@dataclass
class StepCosts:
    flops: float          # total FLOPs for the step
    bytes_hbm: float      # HBM traffic estimate
    flops_fwd: float      # forward-only part
    weight_bytes: float   # parameter bytes touched (one read)
    kv_bytes: float       # decode: cache bytes read per step
    detail: Dict[str, float]


def _dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.compute_dtype == "bfloat16" else 4


def layer_flops_fwd(cfg: ModelConfig, T: int, ctx: int, layer_idx: int,
                    sparsity: float = 0.0, tp: int = 1,
                    full_seq: bool = True) -> Dict[str, float]:
    """Forward FLOPs of one layer processing T tokens with attention
    context ``ctx`` (= T for training/prefill; cache length for decode).
    SASP ``sparsity`` scales the FFN GEMMs (tile-skip kernel).
    ``tp``: when head counts don't divide the model axis, full-sequence
    SDPA is replicated across it (models/attention.py) — the redundant
    compute is charged here so the roofline stays honest."""
    d = cfg.d_model
    mix = cfg.layer_mixer_kinds()[layer_idx]
    att = cfg.layer_attn_kinds()[layer_idx]
    ffn = cfg.layer_ffn_kinds()[layer_idx]
    out: Dict[str, float] = {}

    if mix == MIXER_ATTN:
        hd = cfg.attn_head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        out["attn_proj"] = 2.0 * T * d * (h * hd + 2 * kvh * hd) \
            + 2.0 * T * (h * hd) * d
        eff_ctx = min(ctx, cfg.sliding_window) if (
            att == ATTN_LOCAL and cfg.sliding_window) else ctx
        # chunked online softmax computes full (not causal-half) scores
        out["attn_sdpa"] = 2.0 * 2.0 * T * eff_ctx * h * hd
    else:
        s = cfg.ssm
        di, H = s.d_inner(d), s.num_heads(d)
        G, N, P = s.ngroups, s.state_dim, s.head_dim
        conv_dim = di + 2 * G * N
        out["ssm_proj"] = 2.0 * T * d * (di + conv_dim + H) \
            + 2.0 * T * di * d
        out["ssm_conv"] = 2.0 * T * conv_dim * s.conv_kernel
        if T == 1 or ctx != T:
            # decode recurrence: state update + readout per token
            out["ssm_scan"] = T * (6.0 * H * P * N)
        else:
            Q = min(s.chunk_size, T)
            # intra-chunk quadratic + inter-chunk state path
            out["ssm_scan"] = T * (2.0 * Q * (G * N + H * P)
                                   + 4.0 * H * P * N)

    n_mats = 3 if cfg.ffn_gated else 2
    keep = 1.0 - sparsity
    if ffn == FFN_MOE:
        rows = T * cfg.moe.top_k * cfg.moe.capacity_factor
        out["ffn"] = n_mats * 2.0 * rows * d * cfg.d_ff * keep
        out["router"] = 2.0 * T * d * cfg.moe.num_experts
        if cfg.moe.num_shared_experts:
            out["ffn"] += n_mats * 2.0 * T * d * cfg.d_ff \
                * cfg.moe.num_shared_experts
    else:
        out["ffn"] = n_mats * 2.0 * T * d * cfg.d_ff * keep
    return out


def step_costs(cfg: ModelConfig, shape: ShapeConfig,
               sparsity: float = 0.0,
               weight_quant_bytes: int = 0, tp: int = 16) -> StepCosts:
    """FLOPs + HBM bytes for one step of the given kind.

    train: fwd + bwd(2×fwd) + remat recompute (1×fwd if cfg.remat)
    prefill: fwd
    decode: fwd over 1 token/sequence with ctx = seq_len cache
    """
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype_bytes(cfg)
    wbytes_unit = weight_quant_bytes or dt
    n_params = cfg.param_count()
    n_active = cfg.active_param_count()

    if shape.kind == "decode":
        T_layer = B                      # one token per sequence
        ctx = S
    else:
        T_layer = B * S
        ctx = S

    detail: Dict[str, float] = {}
    fwd = 0.0
    full_seq = shape.kind != "decode"
    for li in range(cfg.num_layers):
        lf = layer_flops_fwd(cfg, T_layer, ctx, li, sparsity, tp=tp,
                             full_seq=full_seq)
        for k, v in lf.items():
            detail[k] = detail.get(k, 0.0) + v
            fwd += v
    # lm head (+ final norm negligible)
    head = 2.0 * T_layer * cfg.d_model * cfg.vocab_size
    detail["head"] = head
    fwd += head

    if shape.kind == "train":
        mult = 3.0 + (1.0 if cfg.remat != "none" else 0.0)
        flops = fwd * mult
    else:
        flops = fwd

    # ---- HBM bytes ----
    act_unit = T_layer * cfg.d_model * dt          # one activation tensor
    L = cfg.num_layers
    if shape.kind == "train":
        # weights: read fwd + bwd + remat; grads written+read; opt state rw
        w_traffic = n_params * wbytes_unit * (3.0 if cfg.remat != "none"
                                              else 2.0)
        w_traffic += n_params * (dt * 2.0)          # grads w+r
        w_traffic += n_params * (2.0 * 2.06)        # int8 m,v rw + scales
        act_traffic = act_unit * L * 10.0           # r/w through layers,
        #                                             both passes (napkin)
        kv = 0.0
        byt = w_traffic + act_traffic
    elif shape.kind == "prefill":
        w_traffic = n_params * wbytes_unit
        act_traffic = act_unit * L * 4.0
        kvh, hd = cfg.num_kv_heads, cfg.attn_head_dim
        kv = 0.0
        for li, (mk, ak) in enumerate(zip(cfg.layer_mixer_kinds(),
                                          cfg.layer_attn_kinds())):
            if mk == MIXER_ATTN:
                cap = min(S, cfg.sliding_window) if (
                    ak == ATTN_LOCAL and cfg.sliding_window) else S
                kv += B * cap * kvh * hd * 2 * dt   # cache write
        byt = w_traffic + act_traffic + kv
    else:  # decode
        # MoE: only routed experts' weights are touched when the batch is
        # small; bounded by min(1, B·top_k / E) coverage per MoE layer.
        w_traffic = 0.0
        moe_w = 0.0
        if cfg.moe is not None:
            cover = min(1.0, B * cfg.moe.top_k / cfg.moe.num_experts)
            n_moe = sum(1 for k in cfg.layer_ffn_kinds() if k == FFN_MOE)
            n_mats = 3 if cfg.ffn_gated else 2
            moe_all = n_moe * cfg.moe.num_experts * n_mats * \
                cfg.d_model * cfg.d_ff
            moe_w = moe_all * wbytes_unit
            w_traffic = (n_params - moe_all) * wbytes_unit \
                + moe_w * cover
        else:
            w_traffic = n_params * wbytes_unit
        w_traffic *= (1.0 - sparsity) if sparsity else 1.0
        kvh, hd = cfg.num_kv_heads, cfg.attn_head_dim
        # int8 KV cache: 1 B/elem + per-(slot,head) fp32 scale
        kv_unit = (1.0 + 4.0 / hd) if (cfg.kv_quant and hd) else dt
        kv = 0.0
        for li, (mk, ak) in enumerate(zip(cfg.layer_mixer_kinds(),
                                          cfg.layer_attn_kinds())):
            if mk == MIXER_ATTN:
                cap = min(S, cfg.sliding_window) if (
                    ak == ATTN_LOCAL and cfg.sliding_window) else S
                kv += B * cap * kvh * hd * 2 * kv_unit  # read full ring
            else:
                s = cfg.ssm
                kv += B * s.num_heads(cfg.d_model) * s.head_dim \
                    * s.state_dim * 4 * 2           # state rw (f32)
        act_traffic = act_unit * L * 4.0
        byt = w_traffic + act_traffic + kv

    return StepCosts(
        flops=flops, bytes_hbm=byt, flops_fwd=fwd,
        weight_bytes=n_params * wbytes_unit, kv_bytes=kv, detail=detail)
