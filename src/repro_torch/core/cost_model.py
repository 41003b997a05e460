"""Analytic systolic-array cost model — the reproduction-tier stand-in for
the paper's gem5 (§3.2) + RTL synthesis (§4.2) tiers. A copy of
``repro.core.cost_model``: the constants, the arithmetic and its order
are the reference's, so every number equals it exactly
(``tests/test_torch_cost_codesign.py``).

Weight-stationary tiling (paper Fig 3): a GEMM (M, K)·(K, N) is tiled into
(K/S)·(N/S) weight tiles; per tile the array pays
    c_w · S²/wpc   weight programming (wpc = weights per 32-bit bus word:
                   1 for FP32, 4 for INT8 — paper §3.2)
  + c_s · M        input/output streaming
  + c_f · S        skew-register fill/drain + instruction overhead
and a SASP-pruned tile is skipped entirely (paper Fig 3). The constants
below are least-squares fitted to the paper's Table 3 no-SASP speedups
(8 cells, FP32+INT8 × 4 sizes); the fit reproduces every cell within ~4 %:

    fp32  4×4  8.23 vs 8.42   | int8  4×4  8.39 vs 8.03
    fp32  8×8 19.12 vs 19.79  | int8  8×8 20.04 vs 20.18
    fp32 16  35.12 vs 35.22   | int8 16  38.33 vs 36.53
    fp32 32  51.90 vs 50.95   | int8 32  59.24 vs 61.33

Area/power are quadratic in S (paper §4.2), calibrated to Table 3 areas
(a₂ = 3.3e-3 mm²/PE ⇒ 8×8 = 0.21 mm², 32×32 = 3.37 mm² vs paper 3.34) and
to the power implied by Table 3 energies under the nominal CPU-baseline
runtime T_BASE (absolute watts depend on that normalization; ratios do not).
INT8 factors: area ×0.64, power ×0.72 (paper: 35.3 % / 19.5 % savings on
the multiplier, diluted over the full PE).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# ---- fitted constants (see module docstring) ----
C_W = 0.9599          # cycles per weight bus-word programmed
C_S = 0.5430          # cycles per activation streamed (in+out, pipelined)
C_F = 62.768          # per-tile fixed cycles (skew fill/drain + instrs)
CPI_MAC = 0.5836      # CPU cycles per MAC (SIMD baseline)
ALPHA_SW = 0.00875    # non-GEMM software fraction (Amdahl term)
FREQ_HZ = 1.0e9       # both CPU and array run at 1 GHz (paper Table 2)
T_BASE_S = 100.0      # nominal CPU-baseline runtime normalization

AREA_PER_PE_MM2 = 3.3e-3
POWER_PER_PE_W = 0.0092
INT8_AREA_FACTOR = 0.64
INT8_POWER_FACTOR = 0.72


@dataclass(frozen=True)
class SystolicConfig:
    size: int                     # S (array is S × S)
    quant: str = "fp32"           # "fp32" | "int8" (weights)

    @property
    def wpc(self) -> int:
        return 4 if self.quant == "int8" else 1

    @property
    def area_mm2(self) -> float:
        a = AREA_PER_PE_MM2 * self.size ** 2
        return a * (INT8_AREA_FACTOR if self.quant == "int8" else 1.0)

    @property
    def power_w(self) -> float:
        p = POWER_PER_PE_W * self.size ** 2
        return p * (INT8_POWER_FACTOR if self.quant == "int8" else 1.0)


@dataclass(frozen=True)
class GEMMWork:
    """One GEMM of the workload. ``sparsity`` is the SASP tile-pruning rate
    ON THIS GEMM (tile size = array size, so pruned tiles are skipped)."""

    M: int
    K: int
    N: int
    sparsity: float = 0.0

    @property
    def macs(self) -> int:
        return self.M * self.K * self.N


def gemm_cycles(sa: SystolicConfig, g: GEMMWork) -> float:
    tiles = -(-g.K // sa.size) * (-(-g.N // sa.size))
    per_tile = (C_W * sa.size * sa.size / sa.wpc + C_S * g.M
                + C_F * sa.size)
    return tiles * (1.0 - g.sparsity) * per_tile


def workload_time_s(sa: SystolicConfig, gemms: Sequence[GEMMWork]) -> float:
    """End-to-end time: accelerated GEMMs + Amdahl software part."""
    t_gemm = sum(gemm_cycles(sa, g) for g in gemms) / FREQ_HZ
    t_sw = ALPHA_SW * cpu_time_s(gemms)
    return t_gemm + t_sw


def cpu_time_s(gemms: Sequence[GEMMWork]) -> float:
    macs = sum(g.macs for g in gemms)
    return macs * CPI_MAC / FREQ_HZ


def speedup_vs_cpu(sa: SystolicConfig, gemms: Sequence[GEMMWork]) -> float:
    t_cpu = cpu_time_s(gemms) * (1.0 + ALPHA_SW)
    return t_cpu / workload_time_s(sa, gemms)


def scale_to_t_base(gemms: Sequence[GEMMWork]) -> float:
    """Normalization so the CPU baseline takes T_BASE_S (Table 3 energies
    were reported for a fixed test set; we normalize the same way)."""
    return T_BASE_S / (cpu_time_s(gemms) * (1.0 + ALPHA_SW))


def energy_j(sa: SystolicConfig, gemms: Sequence[GEMMWork],
             scale: Optional[float] = None) -> float:
    s = scale_to_t_base(gemms) if scale is None else scale
    return sa.power_w * workload_time_s(sa, gemms) * s


# ---------------------------------------------------------------------------
# Transformer-encoder workload (the paper's ASR/MT case study)
# ---------------------------------------------------------------------------


def encoder_gemms(*, num_layers: int, d_model: int, d_ff: int, seq: int,
                  ffn_gated: bool = False,
                  ffn_sparsity: float = 0.0,
                  attn_sparsity: float = 0.0) -> List[GEMMWork]:
    """Per-inference GEMM list of a transformer encoder. SASP scope
    follows the paper: FF GEMMs carry ``ffn_sparsity``; attention
    projections carry ``attn_sparsity`` (0 in the paper's experiments)."""
    gs: List[GEMMWork] = []
    n_ff = 3 if ffn_gated else 2
    for _ in range(num_layers):
        for _ in range(4):       # q, k, v, o projections
            gs.append(GEMMWork(seq, d_model, d_model,
                               sparsity=attn_sparsity))
        gs.append(GEMMWork(seq, d_model, d_ff, sparsity=ffn_sparsity))
        if n_ff == 3:
            gs.append(GEMMWork(seq, d_model, d_ff, sparsity=ffn_sparsity))
        gs.append(GEMMWork(seq, d_ff, d_model, sparsity=ffn_sparsity))
    return gs


def model_gemms_from_config(cfg, seq: int, ffn_sparsity: float = 0.0
                            ) -> List[GEMMWork]:
    """GEMM list for one forward pass of an assigned-arch config (decoder
    LM). Attention score/context matmuls are excluded (not weight GEMMs —
    they are not SASP-prunable and, on the edge system, not tiled into the
    weight-stationary array)."""
    from repro_torch.configs.base import FFN_MOE, MIXER_ATTN

    gs: List[GEMMWork] = []
    d = cfg.d_model
    hd = cfg.attn_head_dim
    for mk, fk in zip(cfg.layer_mixer_kinds(), cfg.layer_ffn_kinds()):
        if mk == MIXER_ATTN:
            gs.append(GEMMWork(seq, d, cfg.num_heads * hd))
            gs.append(GEMMWork(seq, d, cfg.num_kv_heads * hd))
            gs.append(GEMMWork(seq, d, cfg.num_kv_heads * hd))
            gs.append(GEMMWork(seq, cfg.num_heads * hd, d))
        else:
            s = cfg.ssm
            di = s.d_inner(d)
            gs.append(GEMMWork(seq, d, 2 * di + 2 * s.ngroups * s.state_dim
                               + s.num_heads(d)))
            gs.append(GEMMWork(seq, di, d))
        n_ff = 3 if cfg.ffn_gated else 2
        if fk == FFN_MOE:
            # active expert GEMMs per token: top_k experts
            eff_rows = seq * cfg.moe.top_k
            for _ in range(n_ff - 1):
                gs.append(GEMMWork(eff_rows, d, cfg.d_ff,
                                   sparsity=ffn_sparsity))
            gs.append(GEMMWork(eff_rows, cfg.d_ff, d,
                               sparsity=ffn_sparsity))
        else:
            for _ in range(n_ff - 1):
                gs.append(GEMMWork(seq, d, cfg.d_ff, sparsity=ffn_sparsity))
            gs.append(GEMMWork(seq, cfg.d_ff, d, sparsity=ffn_sparsity))
    return gs
