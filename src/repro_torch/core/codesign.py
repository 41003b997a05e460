"""The SASP co-design explorer (paper Fig 2): sweep hyper-parameters
(array/tile size × pruning rate × quantization), collect figures of merit
from every tier — QoS (algorithm), runtime (system model), area/energy
(hardware model) — and expose the trade-off views of Figs 7/9/10/11 and
Table 3.

QoS enters as a callable ``qos_fn(tile, sparsity, quant) -> float``
(degradation metric, lower = better, e.g. WER %).
`exponential_qos_proxy` provides the paper-shaped closed form for quick
sweeps and tests (a measured QoS tier, the reference's
``benchmarks/qos_harness.py``, is not ported yet). A copy of
``repro.core.codesign``: every design point equals the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.cost_model import (
    GEMMWork,
    SystolicConfig,
    encoder_gemms,
    energy_j,
    scale_to_t_base,
    speedup_vs_cpu,
    workload_time_s,
)


@dataclass
class DesignPoint:
    tile: int
    sparsity: float
    quant: str
    qos: float                  # degradation metric (e.g. WER %)
    speedup: float              # vs non-accelerated, non-quantized CPU
    time_s: float
    energy_j: float
    area_mm2: float

    @property
    def area_energy(self) -> float:
        return self.area_mm2 * self.energy_j


def exponential_qos_proxy(base_qos: float = 3.5,
                          brittleness: float = 21.0,
                          tile_slope: float = 0.19,
                          amp: float = 0.5,
                          tile_ref: int = 4) -> Callable:
    """Paper-shaped QoS model (Fig 9): WER grows exponentially in the
    pruning rate, steeper for larger tiles (large-tile brittleness, §4.4),
    small constant offset for INT8. Calibrated to the paper's inflection
    points: ΔWER ≈ 1.5 % at 25 % pruning on 4×4/8×8 and at 20 % on
    16×16/32×32 (Table 3's 5 % WER selections)."""

    def qos(tile: int, sparsity: float, quant: str) -> float:
        steep = brittleness * (1.0 + tile_slope * math.log2(
            max(tile, tile_ref) / tile_ref))
        q = amp * (math.exp(steep * sparsity ** 2) - 1.0)
        if quant == "int8":
            q += 0.08
        return base_qos + q

    return qos


def sweep(build_gemms: Callable[[float], Sequence[GEMMWork]],
          qos_fn: Callable[[int, float, str], float],
          tiles: Sequence[int] = (4, 8, 16, 32),
          sparsities: Sequence[float] = (0.0, 0.05, 0.10, 0.15, 0.20,
                                         0.25, 0.30, 0.40, 0.50),
          quants: Sequence[str] = ("fp32", "int8")) -> List[DesignPoint]:
    """build_gemms(ffn_sparsity) -> GEMM list (tile-size independent —
    tiling happens inside the cost model)."""
    base = build_gemms(0.0)
    scale = scale_to_t_base(base)
    pts = []
    for tile in tiles:
        for q in quants:
            sa = SystolicConfig(size=tile, quant=q)
            for s in sparsities:
                gs = build_gemms(s)
                pts.append(DesignPoint(
                    tile=tile, sparsity=s, quant=q,
                    qos=qos_fn(tile, s, q),
                    speedup=speedup_vs_cpu(sa, gs),
                    time_s=workload_time_s(sa, gs) * scale,
                    energy_j=energy_j(sa, gs, scale),
                    area_mm2=sa.area_mm2,
                ))
    return pts


def best_under_qos(points: Sequence[DesignPoint], qos_target: float
                   ) -> Dict[tuple, DesignPoint]:
    """Per (tile, quant): the fastest point meeting the QoS target —
    Table 3's 'SASP @ 5% WER' selection."""
    out: Dict[tuple, DesignPoint] = {}
    for p in points:
        if p.qos > qos_target:
            continue
        key = (p.tile, p.quant)
        if key not in out or p.speedup > out[key].speedup:
            out[key] = p
    return out


def pareto_front(points: Sequence[DesignPoint]) -> List[DesignPoint]:
    """Non-dominated set over (qos ↓, time ↓, area_energy ↓)."""
    front = []
    for p in points:
        dominated = any(
            (o.qos <= p.qos and o.time_s <= p.time_s
             and o.area_energy <= p.area_energy)
            and (o.qos < p.qos or o.time_s < p.time_s
                 or o.area_energy < p.area_energy)
            for o in points)
        if not dominated:
            front.append(p)
    return front


def speedup_at_fixed_qos(points: Sequence[DesignPoint], qos_target: float,
                         quant: str) -> Dict[int, float]:
    """Fig 11: speedup vs array size at a fixed QoS level (sublinear)."""
    sel = best_under_qos([p for p in points if p.quant == quant],
                         qos_target)
    return {tile: p.speedup for (tile, q), p in sorted(sel.items())}
