"""Training launcher of the port (``repro.launch.train``): train a model
on the synthetic LM stream on one device, optionally under a SASP
overlay, checkpointing in the reference's format.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b \\
      --reduce --steps 100 --batch 8 --seq 256 --sasp 0.25 [--device cpu]

``--reduce`` shrinks the config to 4 layers, d_model 128, vocab 512 (the
serve launcher's ``--reduce``, so ``python -m repro_torch.launch.serve
--ckpt-dir DIR`` serves what this wrote). ``--resume`` restarts from the
latest checkpoint in ``--ckpt-dir`` (params, optimizer and data step).
Every architecture of the reference runs (MoE, SSM, hybrid and the stub
frontends included). The default is qwen3-32b, not the reference's
mamba2-780m: at mamba2-780m's own widths the reference's SSD backward
gives NaN gradients (``_segsum_decay`` takes ``exp`` of positive sums
above the diagonal, which overflow to inf, before masking them to 0),
and the port, which computes what the reference computes, gives the same
NaNs. ``--mesh single|multi`` is not ported.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import torch

from repro_torch.configs import SASPConfig, get_config, reduced
from repro_torch.core.sasp import build_sasp_overlay
from repro_torch.data.pipeline import DataConfig, DataState, Pipeline
from repro_torch.models import lm
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.schedule import (PreemptionHook, StragglerWatchdog,
                                        warmup_cosine)
from repro_torch.train.train_step import make_train_step

MESH_NOT_PORTED = (
    "--mesh {} is not ported to repro_torch yet: training under a mesh "
    "(grad_compress, ZeRO) waits for ROADMAP Queue 1 item 6g; train "
    "with --mesh local, or with python -m repro.launch.train")


def parse_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--reduce", action="store_true",
                    help="family-preserving reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--sasp", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.mesh != "local":
        raise SystemExit(MESH_NOT_PORTED.format(args.mesh))

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, layers=4, d_model=128, vocab=512)
    if args.sasp:
        cfg = dataclasses.replace(
            cfg, sasp=SASPConfig(enabled=True, block_k=32, block_n=32,
                                 sparsity=args.sasp))

    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch)
    pipe = Pipeline(dcfg, kind="lm")
    opt_cfg = AdamWConfig(lr=args.lr)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    hook = PreemptionHook()
    wd = StragglerWatchdog()
    sched = warmup_cosine(min(30, args.steps // 10 + 1), args.steps)

    params = lm.init_params(cfg, seed=0, device=args.device)
    opt = adamw_init(params, opt_cfg)
    start = 0
    if args.resume and mgr.latest_step() is not None:
        state, extra = mgr.restore({"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        pipe = Pipeline(dcfg, kind="lm", state=DataState.from_dict(extra))
        start = mgr.latest_step()
        print(f"resumed from step {start}")

    overlay = None
    if args.sasp:
        overlay, got = build_sasp_overlay(params, cfg.sasp)
        print(f"SASP masks: {got:.1%} sparsity "
              f"(tile {cfg.sasp.block_k}x{cfg.sasp.block_n})")
    step_fn = make_train_step(cfg, opt_cfg, overlay=overlay,
                              lr_schedule=sched,
                              n_microbatches=args.microbatches)

    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(args.device)
                 for k, v in pipe.next().items()}
        t0 = time.time()
        params, opt, m = step_fn(params, opt, batch)
        _sync(args.device)
        slow = wd.observe(time.time() - t0)
        if (i + 1) % 10 == 0:
            print(f"step {i+1:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}"
                  f"{'  [SLOW]' if slow else ''}", flush=True)
        if (i + 1) % wd.checkpoint_every(args.ckpt_every) == 0 \
                or hook.requested:
            mgr.save_async(i + 1, {"params": params, "opt": opt},
                           extra=pipe.state.to_dict())
            if hook.requested:
                print("preemption requested: checkpointed, exiting")
                mgr.wait()
                return
    mgr.wait()
    mgr.save(args.steps, {"params": params, "opt": opt},
             extra=pipe.state.to_dict())
    print("done")


if __name__ == "__main__":
    main()
