#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone: data parallelism.

    python3 tools/dp_phase.py [--nccl-only]

Builds the CUDA kernels, then runs ``chip_smoke.dp_phase``: qwen3-32b at
full width (seed 0, wo and w2 spread, 50% of the 32x32 tiles, scope
all, bf16), (a) ``--mesh 2,1 --scheduler`` and ``--mesh 2,2
--scheduler`` at 2 layers on one card (gloo, host-staged), contiguous
and paged, every process bit for bit the meshless 2-rank scheduler over
the shard loop; (b) ``--mesh 2,2`` with one engine of 4 slots split over
'data', greedy-equal to each request alone; (c) ``--mesh 2,2
--scheduler`` at all 64 layers over NCCL where the machine has four
cards (``--nccl-only``: (c) alone, for a four-card call). Prints the
card's name and power limit first and ``RESULT`` with
the phase's seconds last; details in ``build/chip_smoke/dp_phase.json``.
Needs a CUDA card; imports torch and repro_torch only.
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
                    help="run (c) alone: --mesh 2,2 --scheduler at 64 "
                         "layers over NCCL (needs four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/dp_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    build.build_all()
    if args.nccl_only:
        t0 = time.time()
        out = {"c": chip_smoke._dp_four_cards(torch)}
        out["seconds"] = time.time() - t0
    else:
        out = chip_smoke.dp_phase(torch)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "dp_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["c"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
