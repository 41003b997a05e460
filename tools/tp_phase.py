#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` alone: tensor-parallel packed serving.

    python3 tools/tp_phase.py [--layers N]

Builds the CUDA kernels, then runs ``chip_smoke.tp_phase``: (a) phase 3's
qwen3-32b (full width, N layers, default 4) served by the shard loop at
tp 2, 4 and 8 on one card, (b) ``--mesh 1,2`` through the serve
launcher's ``serve_mesh`` (2 spawned ranks, each building its tree
layer by layer), held bit for bit to (a)'s tp=2.
Prints the card's name and power limit first and ``RESULT`` with the
phase's JSON last; details in ``build/chip_smoke/tp_phase.json``. Needs a
CUDA card; imports torch and repro_torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/tp_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    out = chip_smoke.tp_phase(
        torch, {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn},
        layers=args.layers)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "tp_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["b"]["nccl"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
