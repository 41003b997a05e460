#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` alone: qwen3-32b at its full depth.

    python3 tools/depth_phase.py [--layers N]

Builds the CUDA kernels, then runs ``chip_smoke.depth_phase``: qwen3-32b
at full width and N layers (default 64, all of them), built layer by
layer, (a) served on one card and its first prefill held to the plain
versions of both kernels, (b) the shard loop at tp 2 and ``--mesh 1,2``
(2 spawned ranks, bit for bit the loop), (c) ``--mesh 1,4`` over NCCL
where the machine has four cards, (d) phase 3's 4-layer model restored
from a checkpoint through ``--mesh 1,2 --ckpt-dir`` and (e) again with
streaming, a trace and a metrics dump. Prints the card's name and power
limit first and ``RESULT`` with the phase's seconds last; details in
``build/chip_smoke/depth_phase.json``. Needs a CUDA card; imports torch
and repro_torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=chip_smoke.DEPTH["layers"])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("tools/depth_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    out = chip_smoke.depth_phase(
        torch, {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn},
        layers=args.layers)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "depth_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["b"]["nccl"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
