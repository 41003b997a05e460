#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone, and the cut page pool at size on
four cards.

    python3 tools/paged_mesh_phase.py [--nccl-only]

Builds the CUDA kernels, then runs ``chip_smoke.paged_mesh_phase``: the
paged KV pool cut over 'data' as the reference places it
(``distribution.sharding.pool_axes``; ``Engine.layout`` "slots and pages
split over data"), with prefix sharing and a drafter, for qwen3-32b and
moonshot-v1-16b-a3b (its experts and its drafter's in EP over 'data') at
full width, 1 layer, on ``--mesh 2,1`` (gloo, host-staged on this card),
each process bit for bit its meshless twin. With four cards it then runs
``chip_smoke._pgm_four_cards`` over NCCL: qwen3-32b at 16 layers, 16
slots, an 8 GiB pool (4094 pages of 32 tokens) on one card, cut on
``--mesh 4,1`` and ``2,2``, and replicated on ``4,1`` (kv_pages 4093):
GiB held a rank, the pool's GiB, decode ms/step and tokens/s, each cut
rank's bits against its twin. ``--nccl-only``: the four-card runs
alone. Prints the card's name and power limit first and ``RESULT`` with
the phase's seconds last; details in
``build/chip_smoke/paged_mesh_phase.json``. Needs a CUDA card; imports
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
                    help="the four-card runs alone (needs four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/paged_mesh_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    t0 = time.time()
    out = {}
    if not args.nccl_only:
        out.update(chip_smoke.paged_mesh_phase(torch, counters))
        chip_smoke._free(torch)
    out["four cards"] = chip_smoke._pgm_four_cards(torch, counters)
    out["seconds"] = time.time() - t0
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "paged_mesh_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["four cards"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
