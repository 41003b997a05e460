#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone, and the long-context layout at
full size on four cards.

    python3 tools/seq_mesh_phase.py [--nccl-only] [--dry]

Builds the CUDA kernels, then runs ``chip_smoke.seq_mesh_phase``: one
slot, so that the batch does not split over 'data' and each KV ring's
capacity is cut over the mesh (``distribution.sharding.seq_axes``): (a)
gemma3-4b at full width, 6 layers, cache 32768, on ``--mesh 2,1``; (b)
moonshot-v1-16b-a3b at full width, 1 layer, on ``--mesh 2,1``, its
experts cut over 'data' (the replicated MoE mode); (c) a narrow gemma3
with one KV head on ``--mesh 1,2``, its rings cut over 'model'; each
process (gloo, host-staged on this card) bit for bit its meshless twin.
With four cards it then runs ``chip_smoke._seq_four_cards`` over NCCL:
gemma3-4b at full depth (34 layers) with one slot at cache 524288 (the
long_500k ring) on one card and on ``--mesh 4,1`` and ``2,2`` (GiB held
a rank, decode ms/step over 32 steps after a 4096-token prompt, one
decode step at position 524287 bit for bit the twin's), and jamba-1.5-
large's block at full width on ``--mesh 4,1`` with one slot (GiB held a
rank). ``--nccl-only``: the four-card runs alone. ``--dry``: first the
dry run's ``long_500k`` cells of gemma3-4b and jamba-1.5-large-398b on
the production (16, 16) mesh (fake tensors, on the host). Prints the
card's name and power limit first and ``RESULT`` with the phase's
seconds last; details in ``build/chip_smoke/seq_mesh_phase.json``.
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
                    help="the four-card runs alone (needs four cards)")
    ap.add_argument("--dry", action="store_true",
                    help="first trace the long_500k cells of gemma3-4b and "
                         "jamba-1.5-large-398b on the dry (16, 16) mesh")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke
    if not torch.cuda.is_available():
        print("tools/seq_mesh_phase.py: no CUDA card", file=sys.stderr)
        return 3
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    if args.dry:
        from repro_torch.launch import dryrun
        t0 = time.time()
        for arch in ("gemma3-4b", "jamba-1.5-large-398b"):
            rep = dryrun.run_cell(arch, "long_500k",
                                  out_dir=os.path.join(chip_smoke.OUT_DIR,
                                                       "dryrun"))
            out[f"dry {arch}"] = dict(
                held_gib=rep.held_memory_per_device / 2**30,
                peak_gib=rep.peak_memory_per_device / 2**30,
                coll_axes=rep.coll_axes)
        out["dry_s"] = time.time() - t0
    from repro_torch.kernels import build
    from repro_torch.kernels.sasp_gemm import fused_ffn, gemm
    build.build_all()
    counters = {"sasp_gemm": gemm, "sasp_fused_ffn": fused_ffn}
    t0 = time.time()
    if not args.nccl_only:
        out.update(chip_smoke.seq_mesh_phase(torch, counters))
        chip_smoke._free(torch)
    out["four cards"] = chip_smoke._seq_four_cards(torch, counters)
    out["seconds"] = time.time() - t0
    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    with open(os.path.join(chip_smoke.OUT_DIR, "seq_mesh_phase.json"), "w",
              encoding="utf-8") as fh:
        json.dump(out, fh, indent=1, default=str)
    print("RESULT " + json.dumps(dict(
        seconds=out["seconds"], nccl=isinstance(out["four cards"], dict))),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
