#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone: training under a (data, model)
mesh.

    python3 tools/train_mesh_phase.py [--nccl-only]

Builds the CUDA kernels, then runs ``chip_smoke.train_mesh_phase``: (a)
qwen3-32b at full width, 2 layers, the 50% FFN overlay, fp32 masters,
bf16 compute, batch 4 x 256, on ``--mesh 1,2`` (two spawned ranks on
this card, gloo host-staged), held to the meshless loop at tp 2 run
first in this process (masks, step 1's loss and gradient slices, the
params after step 1, the losses of 3 steps); (b) a narrower qwen3 (4
layers, d_model 1024, fp32 compute) on ``--mesh 2,1`` and ``2,2`` with
ZeRO, fp32 and int8 moments, 1 and 2 micro-batches, each held to its
loop, the last case saving a mesh checkpoint and resuming from it bit for
bit; (c) that checkpoint served packed through ``--mesh 1,2 --ckpt-dir``
(both main-path kernels on mma), streams equal to the shard loop's on the
whole restore; (d) over NCCL where the machine has four cards: full
width, 8 layers, on ``--mesh 2,2`` and ``1,4`` (``--nccl-only``: (d)
alone, for a four-card call). Prints the card's name and power limit
first and ``RESULT`` with the phase's seconds last; details in
``build/chip_smoke/train_mesh_phase.json``. Needs a CUDA card; imports
torch and repro_torch only.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nccl-only", action="store_true",
                    help="run (d) alone: full width, 8 layers, on --mesh "
                         "2,2 and 1,4 over NCCL (needs four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/train_mesh_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    if args.nccl_only:
        t0 = time.time()
        out = {"d": chip_smoke._tm_four_cards(torch)}
        out["seconds"] = time.time() - t0
    else:
        out = chip_smoke.train_mesh_phase(torch, counters)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "train_mesh_phase.json"),
              "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["d"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
