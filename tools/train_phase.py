#!/usr/bin/env python3
"""Phase 7 (a) of ``chip_smoke.py`` alone, for one tree or several.

    python3 tools/train_phase.py [TREE ...]

Runs ``chip_smoke.train_full_width`` (qwen3-32b at full width, 4 layers,
fp32 master weights, bf16 compute, remat full, the SASP overlay at 50%,
AdamW, batch 4 x 256: 21 split steps, the ``make_train_step`` time and
one step under torch.profiler) of each TREE, a checkout of this repo
(default: the one this tool is in), each in a process of its own and in
the order given, so that two trees are compared in one call (for
example parent, change, change, parent with the parent unpacked by
``git archive`` into ``build/``). Prints the card's name and power limit
first, then each run's log and one line per run, ``RESULT`` and a JSON
object: ``tree``, ``step_ms``, ``fwd_bwd_ms``, ``opt_ms``, ``data_ms``,
``tok_s``, ``peak_gib``, and the profiled step's busy ms and kernels (and
its ops by input shape where the tree's smoke records them). Needs a
CUDA card; imports torch and repro_torch only.
"""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import json, sys
tree = sys.argv[1]
sys.path[:0] = [tree, tree + "/src"]
import torch
import chip_smoke
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
out = chip_smoke.train_full_width(torch)
keys = ("step_ms", "fwd_bwd_ms", "opt_ms", "data_ms", "tok_s", "peak_gib")
prof = out["profile"]
print("RESULT " + json.dumps(dict(
    tree=tree, **{k: out[k] for k in keys},
    busy_ms=prof.get("busy_ms_per_step"), kernels=prof.get("kernels"),
    ops=prof.get("ops"))), flush=True)
"""


def main(argv) -> int:
    trees = [os.path.abspath(t) for t in argv] or [ROOT]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(card.stdout.strip() or "nvidia-smi unavailable", flush=True)
    for tree in trees:
        print(f"--- {tree}", flush=True)
        run = subprocess.run([sys.executable, "-c", CHILD, tree], cwd=tree,
                             capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        sys.stderr.write(run.stderr)
        if run.returncode:
            print(f"{tree}: exit {run.returncode}", file=sys.stderr)
            return run.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
