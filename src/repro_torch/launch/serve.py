"""Serving launcher of the port: init a model, optionally prune + pack it
(SASP), and serve synthetic requests through the engine on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \\
      --sasp 0.5 --path packed --scope all --requests 4

Paths: ``dense`` (unpruned), ``masked`` (pruned tiles zeroed, dense
matmuls; ``--int8-weights`` stores the weights in scope as int8 with
per-block scales and dequantizes them per call), ``bsr`` (block-sparse
containers through the gathered block matmul), ``kernel`` (the same
containers through the tile-skip GEMM kernel, repacked per call),
``packed`` (visit-list containers through the tile-skip GEMM and fused
gated-FFN kernels). ``--reduce`` (default on) shrinks the config to 4
layers, d_model 128, vocab 512; ``--no-reduce`` serves the full config.

``--path masked --int8-weights --scope all`` is refused: the reference
quantizes the attention projections there too and then fails to serve
them (its attention reads only the dense ``w``), so the port does not
serve a combination the reference cannot.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import SASPConfig, get_config, reduced
from repro_torch.core.pruning import prune_params
from repro_torch.core.sasp import (bsr_overlay_from_masks, merge_overlay,
                                   quantize_params)
from repro_torch.models import lm
from repro_torch.models.modules import as_dtype
from repro_torch.serve.engine import Engine, Request

PATHS = ("dense", "masked", "bsr", "kernel", "packed")

MASKED_INT8_ALL = (
    "--path masked --int8-weights --scope all is not served: the reference "
    "quantizes wq/wk/wv/wo to {'qw'} there and its attention then fails "
    "with KeyError: 'w' (repro/models/attention.py:133 -> "
    "repro/models/modules.py:36); use --scope ffn, or --path packed")


def _masked_int8_all(path, int8_weights, scope, sparsity) -> bool:
    return (path == "masked" and int8_weights and scope == "all"
            and sparsity > 0)

# reference flags this slice does not serve yet
NOT_PORTED = ("--mesh", "--scheduler", "--hosts", "--int8-kv", "--kv-pages",
              "--kv-page-len", "--kv-watermark", "--kv-host-pool",
              "--kv-share", "--kv-share-min-pages", "--kv-dedup-every",
              "--draft-sparsity", "--draft-k", "--draft-int8",
              "--draft-interactive", "--ckpt-dir")


def build_serving_params(params, cfg, *, path: str, sparsity: float,
                         int8_weights: bool = False,
                         block_k: int = 32, block_n: int = 32,
                         scope: str = "ffn", verbose: bool = True):
    """Deploy ``params`` along one execution path; returns (params, cfg)
    ready for the Engine."""
    if path not in PATHS:
        raise ValueError(f"path {path!r} not in {PATHS}")
    if _masked_int8_all(path, int8_weights, scope, sparsity):
        raise ValueError(MASKED_INT8_ALL)
    if path == "dense" or sparsity <= 0:
        return params, cfg
    sasp = SASPConfig(enabled=True, block_k=block_k, block_n=block_n,
                      sparsity=sparsity, scope=scope,
                      quantize=int8_weights)
    cfg = dataclasses.replace(cfg, sasp=sasp)
    params, masks = prune_params(params, sasp)
    if verbose:
        print(f"SASP deployed: {sparsity:.0%} tile sparsity, "
              f"{len(masks)} matrices, path={path}")
    if path == "masked":
        if int8_weights:
            params = quantize_params(params, sasp)
            if verbose:
                print("weights quantized to INT8 (per-block scales)")
        return params, cfg
    if path in ("bsr", "kernel"):
        params = merge_overlay(params,
                               bsr_overlay_from_masks(params, masks, sasp))
        cfg = dataclasses.replace(
            cfg, sasp=dataclasses.replace(sasp, path=path))
        return params, cfg
    from repro_torch.core.deploy import (cast_packed_values, deploy_packed,
                                         packed_summary)
    params, cfg = deploy_packed(params, cfg)
    cdt = as_dtype(cfg.compute_dtype)
    if cdt != torch.float32:
        params = cast_packed_values(params, cdt)
    if verbose:
        s = packed_summary(params)
        print(f"packed: {s['n_packed_matrices']} matrices + "
              f"{s['n_fused_ffns']} fused FFNs, "
              f"{s['compression']:.2f}x dense bytes")
    return params, cfg


def synthetic_requests(n: int, vocab: int, max_new: int,
                       temperature: float = 0.0, eos_id=None):
    """The launcher's request mix: prompt lengths in [8, 48), seed 0."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, size=(rng.integers(8, 48),))
                    .astype(np.int32),
                    max_new_tokens=max_new, temperature=temperature,
                    eos_id=eos_id)
            for i in range(n)]


def parse_args(argv):
    for a in argv:
        flag = a.split("=", 1)[0]
        if flag in NOT_PORTED:
            raise SystemExit(f"{flag} is not ported to repro_torch yet "
                             "(serve it with python -m repro.launch.serve)")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--reduce", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--sasp", type=float, default=0.0)
    ap.add_argument("--path", choices=PATHS, default="masked")
    ap.add_argument("--scope", choices=("ffn", "all"), default="ffn")
    ap.add_argument("--int8-weights", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if _masked_int8_all(args.path, args.int8_weights, args.scope, args.sasp):
        raise SystemExit(MASKED_INT8_ALL)

    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, layers=4, d_model=128, vocab=512)
    with torch.no_grad():
        params = lm.init_params(cfg, seed=0, device=args.device)
        params, cfg = build_serving_params(
            params, cfg, path=args.path, sparsity=args.sasp,
            int8_weights=args.int8_weights, scope=args.scope)
    reqs = synthetic_requests(args.requests, cfg.vocab_size, args.max_new,
                              args.temperature, args.eos_id)
    eng = Engine(params, cfg, batch_slots=args.slots,
                 cache_len=args.cache_len)
    t0 = time.time()
    done = eng.run(reqs)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s, "
          f"{dt / max(toks, 1) * 1e3:.0f} ms/token)")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.out_tokens[:10]}…")


if __name__ == "__main__":
    main()
