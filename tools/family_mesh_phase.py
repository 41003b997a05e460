#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone: MoE, SSM and hybrid layers on a
mesh.

    python3 tools/family_mesh_phase.py [--nccl-only]

Builds the CUDA kernels, then runs ``chip_smoke.family_mesh_phase``:
(a)-(c) on one card over gloo, host-staged: moonshot-v1-16b-a3b at full
width (1 layer) on ``--mesh 2,1`` (experts in EP over 'data'), ``1,2``
(experts' d_ff over 'model'), ``2,2`` and ``2,2 --scheduler`` (each
scheduler rank's experts whole), mamba2-780m whole on ``--mesh 1,2``
(SSM heads over 'model') and jamba's super-block at phase 8 (c)'s widths
on ``--mesh 2,2``; every process bit for bit its meshless loop of the
same shard counts (streams, served ranks, decode logits), 50% of the
32x32 tiles (scope all), bf16 compute; (d) over NCCL where the machine
has four cards: jamba-1.5-large at full width (one 8-layer super-block)
on ``--mesh 2,2``, then moonshot at all 48 layers on ``--mesh 4,1``
(``--nccl-only``: (d) alone, for a four-card call). Prints the card's
name and power limit first and ``RESULT`` with the phase's seconds last;
details in ``build/chip_smoke/family_mesh_phase.json``. Needs a CUDA
card; imports torch and repro_torch only.
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
                    help="run (d) alone: jamba at full width on --mesh 2,2 "
                         "and moonshot at 48 layers on --mesh 4,1 over NCCL "
                         "(needs four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/family_mesh_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    if args.nccl_only:
        t0 = time.time()
        out = {"d": chip_smoke._fm_four_cards(torch)}
        out["seconds"] = time.time() - t0
    else:
        out = chip_smoke.family_mesh_phase(torch, counters)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "family_mesh_phase.json"),
              "w", encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["d"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
