#!/usr/bin/env python3
"""Time the masked grid's TMA variant under its plan and nearby plans.

    python3 tools/masked_sweep.py [--rows 4 168] [--reps 15] [--host]

For every qwen3-32b projection (32 x 32 tiles, half pruned, bf16 x and
W) and each row count, times on the card (CUDA events, L2 flushed by a
256 MB write before each launch, median of ``--reps``):
- ``ms``: ``masked_matmul`` as ``schedule.masked_plan`` plans it;
- ``library_ms``: ``torch.matmul`` on the masked weight;
- ``pruned_ms`` / ``live_ms``: the planned call with every tile pruned
  (the bytes alone, no MMA) and with every tile live;
- ``alts``: the same call under other tiles and ring depths (decode: 64
  or 128 columns, 3, 4 or 6 stages; prefill: 192, 96 or 64 rows, 3, 4 or
  5 stages), each checked bit for bit against the tile-skip kernel over
  BSR (``sasp_matmul``).
Prints one JSON line per (projection, rows) and the card's name and power
limit first. Needs a CUDA card; imports torch and repro_torch only.

``--host`` measures host time instead, for bf16 and fp32 x at every
projection and row count: ``wrapper_us``, the host's microseconds per
``masked.masked_matmul`` call (mean of 100 calls issued back to back
after 5 untimed ones, the device left to catch up afterwards), beside
``launch_us`` for ``masked._launch`` alone on ready operands (where the
package has it) and ``matmul_us`` for ``torch.matmul``; and ``flush_ms``,
the device time of the 256 MB write that precedes each timed launch in
``chip_smoke.py``'s phase 2 (a wrapper whose host time outlasts it is
timed with its host time). It uses nothing the package's earlier masked
wrapper lacks, so it can time two trees' wrappers side by side.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PROJ = (("wq", 5120, 8192), ("wk/wv", 5120, 1024), ("wo", 8192, 5120),
        ("w1/w3", 5120, 25600), ("w2", 25600, 5120))
BLOCK = 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[4, 168])
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--host", action="store_true",
                    help="time the wrapper's host work instead")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("masked_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.sparse import bsr_from_mask
    from repro_torch.kernels.sasp_gemm import gemm, masked, schedule

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")

    def ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[len(times) // 2]

    def run_plan(x, w, m, plan):
        out = torch.empty((x.shape[0], w.shape[1]), dtype=x.dtype,
                          device="cuda")
        masked._launch(x, w, m, out, plan)
        return out

    if args.host:
        return host(torch, masked, flush, args.rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    bf16 = torch.bfloat16
    for proj, K, N in PROJ:
        w = (torch.randn((K, N), generator=gen, device="cuda") * 0.02).to(bf16)
        mask = torch.rand((K // BLOCK, N // BLOCK), generator=gen,
                          device="cuda") > 0.5
        mi = mask.to(torch.int32)
        none, every = torch.zeros_like(mi), torch.ones_like(mi)
        wd = w * mask.repeat_interleave(BLOCK, 0).repeat_interleave(
            BLOCK, 1).to(bf16)
        bsr = bsr_from_mask(w.float().cpu().numpy(), mask.cpu().numpy(),
                            BLOCK, BLOCK, device="cuda")
        bsr = dataclasses.replace(bsr, vals=bsr.vals.to(bf16))
        for M in args.rows:
            x = torch.randn((M, K), generator=gen, device="cuda").to(bf16)
            skip = gemm.sasp_matmul(x, bsr)
            plan = schedule.masked_plan(M, K, N, K // BLOCK, N // BLOCK, bf16,
                                        bf16)
            r = dict(proj=proj, M=M, plan=[plan.bm, plan.bn, plan.stages],
                     groups=plan.groups,
                     equal=bool(torch.equal(masked.masked_matmul(x, w, mi),
                                            skip)),
                     library_ms=ms(lambda: torch.matmul(x, wd)),
                     ms=ms(lambda: masked.masked_matmul(x, w, mi)),
                     pruned_ms=ms(lambda: masked.masked_matmul(x, w, none)),
                     live_ms=ms(lambda: masked.masked_matmul(x, w, every)))
            KB = K // BLOCK
            if M <= schedule.DECODE_ROWS:
                alts = [schedule.tma_plan(plan.groups, KB, plan.bm, bn, st)
                        for bn in (64, 128) for st in (3, 4, 6)]
            else:
                alts = [schedule.tma_plan(plan.groups, KB, bm, plan.bn, st)
                        for bm in (192, 96, 64) for st in (3, 4, 5)
                        if bm <= plan.bm]
            r["alts"] = {}
            for p in alts:
                out = run_plan(x, w, mi, p)
                r["alts"][f"{p.bm}x{p.bn}/{p.stages}"] = [
                    ms(lambda: run_plan(x, w, mi, p)),
                    bool(torch.equal(out, skip))]
            print(json.dumps(r), flush=True)
        del w, wd, bsr
    return 0


def host(torch, masked, flush, rows) -> int:
    """``--host``: one JSON line per (projection, x type, rows)."""
    import time

    def us(fn, n=100):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / n * 1e6

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    flush.zero_()
    a.record()
    flush.zero_()
    b.record()
    torch.cuda.synchronize()
    print(json.dumps(dict(flush_ms=a.elapsed_time(b))), flush=True)
    launch = getattr(masked, "_launch", None)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for proj, K, N in PROJ:
        for typ in (torch.bfloat16, torch.float32):
            w = (torch.randn((K, N), generator=gen, device="cuda")
                 * 0.02).to(typ)
            mask = torch.rand((K // BLOCK, N // BLOCK), generator=gen,
                              device="cuda") > 0.5
            mi = mask.to(torch.int32)
            wd = w * mask.repeat_interleave(BLOCK, 0).repeat_interleave(
                BLOCK, 1).to(typ)
            for M in rows:
                x = torch.randn((M, K), generator=gen, device="cuda").to(typ)
                r = dict(proj=proj, x=str(typ).split(".")[-1], M=M,
                         wrapper_us=us(lambda: masked.masked_matmul(x, w, mi)),
                         launch_us=None,
                         matmul_us=us(lambda: torch.matmul(x, wd)))
                if launch is not None:
                    from repro_torch.kernels.sasp_gemm import schedule
                    plan = schedule.masked_plan(M, K, N, K // BLOCK,
                                                N // BLOCK, typ, typ)
                    out = torch.empty((M, N), dtype=typ, device="cuda")
                    r["launch_us"] = us(lambda: launch(x, w, mi, out, plan))
                print(json.dumps(r), flush=True)
            del w, wd
    return 0


if __name__ == "__main__":
    sys.exit(main())
