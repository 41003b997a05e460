"""NVIDIA H100 hardware constants + roofline terms (the counterpart of the
reference's ``core/tpu_model.py``, with the same names).

The three-term roofline:
    compute    = FLOPs        / (chips × PEAK_BF16_FLOPS)
    memory     = HBM bytes    / (chips × HBM_BW)
    collective = collective B / (chips × NVLINK_BW)
FLOPs and HBM bytes come from ``analysis.counters`` (analytic), the
collective bytes from a dry mesh's record (``analysis.comms``). Every term
is a prediction of this model, not a measurement.

The constants are those of the card the port runs on, an **NVIDIA H100
80GB HBM3** (SXM5) at its 700 W power limit:
  * ``HBM_BW``: 3.35 TB/s (NVIDIA H100 data sheet, SXM);
  * ``PEAK_FLOPS``: 989 TFLOP/s bf16 dense tensor-core, 67 TFLOP/s fp32
    (data sheet, SXM, without sparsity); ``chip_smoke.py``'s kernel
    bounds read these;
  * ``NVLINK_BW``: 450 GB/s a direction a card (NVLink 4: 18 links of
    25 GB/s a direction; data sheet's 900 GB/s is both directions), in
    place of the TPU's ICI;
  * ``HBM_BYTES``: ``torch.cuda.get_device_properties(0).total_memory``
    of that card, as ``chip_smoke.py`` phase 15 reads it (and checks);
  * ``CHIP_POWER_W``: the card's power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives it (a
    constant-power approximation for the energy axis; relative J only).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

HBM_BW = 3.35e12                   # B/s per card (H100 SXM data sheet)
PEAK_BF16_FLOPS = 989e12           # dense bf16 tensor-core FLOP/s per card
PEAK_FP32_FLOPS = 67e12            # fp32 FLOP/s per card (no tensor cores)
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS}
NVLINK_BW = 450e9                  # B/s a direction per card (NVLink 4)
HBM_BYTES = 85_017_493_504         # total_memory of an H100 80GB HBM3
CHIP_POWER_W = 700.0               # nvidia-smi power.limit of that card


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    bytes_coll: float
    chips: int

    @property
    def bound_s(self) -> float:
        """Lower-bound step time = max of the three terms (perfect
        overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper bound: no overlap at all."""
        return self.compute_s + self.memory_s + self.collective_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def mfu(self) -> float:
        """FLOP-roofline fraction if the step ran at bound_s."""
        if self.bound_s <= 0:
            return 0.0
        return self.compute_s / self.bound_s

    def energy_j(self) -> float:
        return self.bound_s * self.chips * CHIP_POWER_W

    def row(self) -> Dict[str, float]:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bound_s": self.bound_s,
            "bottleneck": self.bottleneck, "flops": self.flops,
            "bytes_hbm": self.bytes_hbm, "bytes_coll": self.bytes_coll,
        }


def roofline(flops: float, bytes_hbm: float, bytes_coll: float,
             chips: int) -> RooflineTerms:
    """The three terms of a step over ``chips`` cards, at the bf16 peak
    (as the reference's roofline)."""
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_BF16_FLOPS),
        memory_s=bytes_hbm / (chips * HBM_BW),
        collective_s=bytes_coll / (chips * NVLINK_BW),
        flops=flops, bytes_hbm=bytes_hbm, bytes_coll=bytes_coll,
        chips=chips,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for a train step;
    2·N·D for forward-only (prefill); 2·N_active per decoded token (the
    reference's formula)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens
