#!/usr/bin/env python3
"""Phase 20 of ``chip_smoke.py`` alone, with the phases it reads.

    python3 tools/analyze_phase.py

Builds the CUDA kernels, serves phase 3's packed qwen3-32b (full width,
4 layers, bf16) and checks its containers on the card
(``chip_smoke.analyze_containers``), runs phase 3c's paged engines and
phase 19's cut pools (``chip_smoke.paged_phase``,
``chip_smoke.paged_mesh_phase``: each records
``check_page_refcounts`` of its pools), then phase 20
(``chip_smoke.analyze_phase``): every pass of ``tools/analyze_torch``,
the packed pass on this card, under ``--strict`` against its baseline.
Prints the card's name and power limit first and ``RESULT`` with phase
20's line last; details in ``build/chip_smoke/analyze_phase.json``.
Needs a CUDA card; imports torch and repro_torch only.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/analyze_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    t0 = time.time()
    params, cfg, _, _ = chip_smoke.serve_phase(torch, counters)
    containers = chip_smoke.analyze_containers(torch, params)
    paged = chip_smoke.paged_phase(torch, params, cfg, counters)
    del params
    chip_smoke._free(torch)
    paged_mesh = chip_smoke.paged_mesh_phase(torch, counters)
    out = chip_smoke.analyze_phase(torch, containers, paged, paged_mesh)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "analyze_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(dict(analyze=out, paged=paged, paged_mesh=paged_mesh,
                       seconds=time.time() - t0), fh, indent=1, default=str)
    print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
