#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone: the analysis tier on the H100
model.

    python3 tools/analysis_phase.py

Builds the CUDA kernels, runs what phase 15 reads, phase 3 (packed
qwen3-32b, 4 layers: its decode ms/step and prefill ms) and phase 14 (a)
(qwen3-32b at full width, 2 layers, trained on ``--mesh 1,2``: each
rank's held and peak GiB and one step's collective record), then
``chip_smoke.analysis_phase``: (a) FlopCounterMode over one full-width
layer's forward against ``analysis.counters``; (b) the H100 roofline of
phase 3's decode step and prefill beside their measured times; (c) phase
14 (a)'s configuration traced on a dry 1,2 mesh, its held GiB within 10%
of the measured and its record equal to the real rank's; (d) the shard
loop at tp 16 with every KV head on every shard, against tp 1 and 8.
Prints the card's name and power limit first and ``RESULT`` with the
phase's seconds last; details in ``build/chip_smoke/analysis_phase.json``.
Needs a CUDA card; imports torch and repro_torch only.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/analysis_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    t0 = time.time()
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    params, _, _, e2e = chip_smoke.serve_phase(torch, counters)
    del params
    chip_smoke._free(torch)
    train_mesh = {"a": chip_smoke._tm_full(torch)}
    chip_smoke._free(torch)
    out = chip_smoke.analysis_phase(torch, counters, e2e, train_mesh)
    out["total_s"] = time.time() - t0
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "analysis_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(seconds=out["seconds"],
                                      total_s=out["total_s"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
