#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone: training on a (pod, data, model)
mesh.

    python3 tools/pod_mesh_phase.py [--nccl-only]

Builds the CUDA kernels, then runs ``chip_smoke.pod_mesh_phase``: (a)
moonshot-v1-16b-a3b at full width, 1 layer (eight ranks of 2 layers do
not fit one card), fp32 masters, bf16 compute,
remat full, the 50% FFN overlay (expert stacks included), batch 4 x 256,
on ``--mesh 2,2,2`` (eight spawned ranks on this card, gloo host-staged:
experts in EP over each pod's 'data' ranks, a replica in each pod), held
to the lock-step loop over the four DP groups run first in this process,
both pods' params and moments equal after every step; (b) a narrower
qwen3 (4 layers, d_model 512, vocab 8192, fp32) on 2,2,2 (fp32 moments
with 2 micro-batches; int8 moments) and on 2,1,2 (a checkpoint resumed
bit for bit), each held to its loop; (c) (b)'s checkpoint served packed
on one card; (d) (a)'s MoE step and (b)'s step traced on a dry 2,2,2
mesh (fake tensors, on the host), their records beside the real ranks'
and (a)'s held GiB beside the measured; (e) over NCCL where the machine has four cards:
moonshot at full width, 8 layers, on ``--mesh 2,2,1`` (``--nccl-only``:
(e) alone, for a four-card call). Prints the card's name and power limit
first and ``RESULT`` with the phase's seconds last; details in
``build/chip_smoke/pod_mesh_phase.json``. Needs a CUDA card; imports
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
                    help="run (e) alone: moonshot at full width, 8 layers, "
                         "on --mesh 2,2,1 over NCCL (needs four cards)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/pod_mesh_phase.py: no CUDA card", file=sys.stderr)
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
        out = {"e": chip_smoke._pod_four_cards(torch)}
        out["seconds"] = time.time() - t0
    else:
        out = chip_smoke.pod_mesh_phase(torch, counters)
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "pod_mesh_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["e"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
