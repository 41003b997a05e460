#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone: every serving path of the dense
decoder on a mesh.

    python3 tools/mesh_paths_phase.py [--nccl-only]

Builds the CUDA kernels, then runs ``chip_smoke.mesh_paths_phase``:
qwen3-32b at full width (seed 0, wo and w2 spread, 50% of the 32x32
tiles where pruned, bf16 compute), (a) ``--mesh 1,2`` on one card (gloo,
host-staged) with ``--sasp 0``, masked, masked int8 (scope ffn), bsr,
kernel, packed (paged) and packed with an fp and an int8 drafter at 75%,
1 layer, every rank bit for bit the shard loop at tp 2 and greedy-equal
to the one-card engine up to printed near-ties; (b) the dense rs+int8-ag
FFN within 2e-2 of the exact one; (c) ``--mesh 1,4 --sasp 0`` and packed
at all 64 layers over NCCL where the machine has four cards
(``--nccl-only``: (c) alone, for a four-card call). Prints the card's
name and power limit first and ``RESULT`` with the phase's seconds last;
details in ``build/chip_smoke/mesh_paths_phase.json``. Needs a CUDA card;
imports torch and repro_torch only.
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
                    help="run (c) alone: --mesh 1,4 at 64 layers over NCCL "
                         "(needs four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/mesh_paths_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    if args.nccl_only:
        t0 = time.time()
        out = {"c": chip_smoke._mp_four_cards(torch)}
        out["seconds"] = time.time() - t0
    else:
        out = chip_smoke.mesh_paths_phase(torch, counters)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "mesh_paths_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["c"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
