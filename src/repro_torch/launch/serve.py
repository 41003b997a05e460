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
Every ``--arch`` of the reference serves: MoE stacks (granite-moe,
moonshot) take every engine option (experts stay masked-dense under
``packed``), SSM and hybrid stacks (mamba2, jamba) prefill one request
at a time and refuse the paged pool, and the stub-frontend models
(musicgen, chameleon) serve from their token tables.

``--path masked --int8-weights --scope all`` is refused: the reference
quantizes the attention projections there too and then fails to serve
them (its attention reads only the dense ``w``), so the port does not
serve a combination the reference cannot.

Engine options, with the reference's meanings and usage errors:
``--buckets`` (prefill length buckets), ``--int8-kv``, the paged pool
(``--kv-pages``, ``--kv-page-len``, ``--kv-watermark``,
``--kv-host-pool``), prefix sharing (``--kv-share``,
``--kv-share-min-pages``, ``--kv-dedup-every``), self-speculative
decoding (``--draft-sparsity``, ``--draft-k``, ``--draft-int8``,
``--draft-interactive``) and ``--stream``.

Serving tiers, with the reference's meanings and usage errors:
``--scheduler`` serves through the sharded scheduler (``--ranks``,
``--slots-per-rank``, ``--max-queue``, ``--admission fcfs|sjf|edf``,
``--aging``, ``--drain``, ``--preempt``, ``--preempt-mode kv|reprefill``,
``--shed count|deadline``, ``--interactive-every``); ``--hosts N`` serves
through the fault-tolerant cluster frontend over N in-process hosts
(``--chaos``, ``--retries``, ``--backoff``, ``--timeout``,
``--drain-timeout``). ``--trace-out`` writes a Chrome trace of the run,
``--metrics-dump`` the Prometheus text, ``--metrics-interval`` prints a
counter summary while serving. ``--ckpt-dir DIR`` serves the params of
the latest checkpoint in DIR (written by ``repro_torch.launch.train`` or
the reference's trainer; the config flags must match the trained model's
shapes).

``--path packed`` at a sparsity above 0 builds the model layer by layer
(``build_rank_params`` at tp 1): each layer is drawn from its own
generators (or read from ``--ckpt-dir``) alone, scored, then drawn again,
pruned, packed and cast before the next (an expert stack's experts one at
a time), so one card holds the packed model and one layer's masters, not
the whole fp32 tree: qwen3-32b serves at all 64 layers with
``--no-reduce``. On one card, ``--sasp 0``, a drafter
(``--draft-sparsity`` re-prunes the dense masters) and the dense,
masked, bsr and kernel paths build the whole fp32 tree first (64 layers
of qwen3-32b hold 31.2 B weights, 4 bytes each); on a mesh every one of
them is built layer by layer.

``--mesh DP,TP`` serves on a (data, model) mesh, on every path (dense,
``--sasp 0``, masked, masked ``--int8-weights --scope ffn``, bsr, kernel,
packed) and with a drafter (``--draft-sparsity``, ``--draft-int8``):
the launcher spawns DP x TP processes joined by ``torch.distributed``
(file-store rendezvous under ``build/mesh``). Every process takes the
same params, from the seed or from ``--ckpt-dir``, and builds its model
rank's tree layer by layer (``build_rank_params``): each layer is
deployed on the path (pruned, quantized, its BSR built, or packed into
TP-sharded visit lists) and cut to the rank's slice before the next is
taken, and the embedding / head table keeps the rank's V/TP rows, so a
card holds its rank's tree and one layer's masters, not the model; the
drafter's layers are re-pruned from each deployed layer and packed into
visit lists sharded like a packed target's. ``--sasp 0`` serves the
dense params, as the reference does. Without ``--scheduler`` one
``Engine`` serves on the whole mesh (``Engine.layout``, printed): its
slots split over 'data' where ``--slots`` divides by DP; where they do
not (``--mesh D,T --slots 1``, or ``--slots 3`` on D = 2) the
reference's long-context layout, every data rank running the whole
batch with each KV ring's capacity cut over 'data' (and over 'model'
where the heads do not split: on a ``--mesh 1,T`` mesh too), its
softmax combined over the blocks (``distribution.sharding.seq_axes``).
A paged pool (and so a drafter) whose ``--kv-pages`` + 2 pages the
reference's rule cuts over 'data' (``distribution.sharding.pool_axes``:
DP divides them) with ``--slots`` that split: slots and pages split over
'data', each data rank serving its slots from its own block of the pool
(the pool's GiB a rank printed); else replicated over 'data', every data
rank running the whole engine on the whole pool. With
``--scheduler``, ``ShardedScheduler(mesh=)`` runs
one scheduler rank per data index, each the engine of its TP group
(``--ranks``, if given, must equal DP: the reference's
``check_ranks``). Model rank 0 of each group samples and broadcasts the
tokens; world rank 0 alone prints, streams (``--stream``; every process
steps the same loop), writes ``--trace-out`` and ``--metrics-dump`` and
runs ``--metrics-interval``. Every process must serve the same streams,
from the same ranks. Transport: gloo on the CPU (``--device cpu``),
nccl where each process has its own card, gloo staged through the host
where processes share one. ``--mesh`` with ``--hosts`` is the
reference's usage error.

MoE, SSM and hybrid stacks serve on a mesh too. One ``Engine`` on the
mesh cuts its experts over 'data', whatever its slots: data rank d
holds the experts [d E/DP, (d+1) E/DP), each expert's d_ff over 'model'
(``distribution.moe_ep``; ``expert_shards``), in expert parallelism
where the slots split over 'data', else in the replicated mode (every
data rank routes the whole batch and multiplies its own experts' slots,
the outputs summed over 'data'). ``--scheduler`` ranks keep every
expert on every data rank, d_ff over 'model'. SSM layers split their
heads over 'model' and keep their states whole over 'data'. Attention heads
whose counts do not divide TP run whole on every model rank (the
reference's replicated SDPA; ``distribution.sharding.heads_split``). A
mesh that cannot place the arch (experts not divisible by DP where they
split, an expert d_ff or SSM heads not divisible by TP) is refused with
the reason;
``--path masked --int8-weights`` for MoE experts is refused too. A
drafter for MoE experts is built like the target's: each expert taken
alone, pruned by the target's masks and then the drafter's, cut to the
rank's experts and d_ff, masked-dense.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import re
import sys
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import SASPConfig, get_config, reduced
from repro_torch.configs.base import FFN_MOE, MIXER_ATTN
from repro_torch.core.pruning import prune_params
from repro_torch.core.sasp import (bsr_overlay_from_masks, merge_overlay,
                                   quantize_params)
from repro_torch.models import lm
from repro_torch.models.modules import as_dtype
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.telemetry import Telemetry, pcts_ms
from repro_torch.train.checkpoint import CheckpointManager

PATHS = ("dense", "masked", "bsr", "kernel", "packed")

MASKED_INT8_ALL = (
    "--path masked --int8-weights --scope all is not served: the reference "
    "quantizes wq/wk/wv/wo to {'qw'} there and its attention then fails "
    "with KeyError: 'w' (repro/models/attention.py:133 -> "
    "repro/models/modules.py:36); use --scope ffn, or --path packed")


MOE_INT8 = (
    "--path masked --int8-weights with MoE experts is not served: the "
    "expert products read only the dense 'w' (models/moe.py, as the "
    "reference's _expert_mm); use --path masked or --path packed")


def _masked_int8_all(path, int8_weights, scope, sparsity) -> bool:
    return (path == "masked" and int8_weights and scope == "all"
            and sparsity > 0)


def prefill_bucket_table(cache_len: int, n_buckets: int = 4,
                         min_len: int = 16) -> Tuple[int, ...]:
    """Geometric prefill buckets halving down from ``cache_len`` (the
    longest covers every cacheable prompt)."""
    out = []
    b = int(cache_len)
    while len(out) < n_buckets and b >= min_len:
        out.append(b)
        b //= 2
    return tuple(sorted(out)) if out else (int(cache_len),)


def rank_bucket_tables(ranks: int, cache_len: int, n_buckets: int = 4,
                       min_len: int = 16) -> Tuple[Tuple[int, ...], ...]:
    """One bucket table per scheduler rank, the same for every rank: a
    request takes the same prefill shapes whichever rank serves it, so
    re-routing never adds a shape."""
    table = prefill_bucket_table(cache_len, n_buckets, min_len)
    return tuple(table for _ in range(ranks))


def parse_buckets(spec: Optional[str], cache_len: int
                  ) -> Optional[Tuple[int, ...]]:
    """--buckets 'N' -> a geometric table of N lengths topping out at
    --cache-len; --buckets 'l1,l2,…' -> explicit lengths; None/'' ->
    exact shapes."""
    if not spec:
        return None
    try:
        if "," in spec:
            lens = tuple(int(v) for v in spec.split(","))
        else:
            lens = int(spec)
    except ValueError:
        raise SystemExit(
            f"--buckets expects an int count (e.g. --buckets 4) or "
            f"comma-separated lengths (e.g. --buckets 32,64,128), "
            f"got {spec!r}")
    if isinstance(lens, int):
        if lens < 1:
            raise SystemExit(f"--buckets count must be >= 1, got {spec!r}")
        return prefill_bucket_table(cache_len, lens)
    if not lens or any(v < 1 for v in lens):
        raise SystemExit(
            f"--buckets lengths must all be >= 1, got {spec!r}")
    if any(v > cache_len for v in lens):
        raise SystemExit(
            f"--buckets lengths must not exceed --cache-len "
            f"({cache_len}): a bucket beyond the cache can never "
            f"admit — got {spec!r}")
    return lens


def validate_kv_flags(*, kv_pages: Optional[int], kv_watermark: float,
                      kv_share: bool, kv_share_min_pages: int,
                      int8_kv: bool, draft_sparsity: Optional[float],
                      draft_k: int = 4, draft_int8: bool = False,
                      kv_dedup_every: int = 0, cache_len: int = 256):
    """Cross-flag validation of the KV and speculative-decoding flags;
    raises SystemExit with a usage message."""
    if not 0.0 < kv_watermark <= 1.0:
        raise SystemExit(
            f"--kv-watermark must lie in (0, 1], got {kv_watermark}")
    if kv_pages is not None and kv_pages < 1:
        raise SystemExit(f"--kv-pages must be >= 1, got {kv_pages}")
    if kv_share:
        if kv_pages is None:
            raise SystemExit("--kv-share requires --kv-pages (prefix "
                             "sharing lives on the paged pool)")
        if int8_kv:
            raise SystemExit("--kv-share is incompatible with "
                             "--int8-kv: suffix prefill would attend "
                             "dequantized prefix KV and break "
                             "bit-identity")
    if kv_share_min_pages < 1:
        raise SystemExit(f"--kv-share-min-pages must be >= 1, got "
                         f"{kv_share_min_pages}")
    if draft_sparsity is not None:
        if kv_pages is None:
            raise SystemExit("--draft-sparsity requires --kv-pages: "
                             "speculative drafts live on scratch pages "
                             "of the paged pool")
        if int8_kv:
            raise SystemExit("--draft-sparsity is incompatible with "
                             "--int8-kv: verification attends fresh "
                             "fp KV while sequential decode attends "
                             "dequantized KV, breaking bit-identity")
        if not 0.0 < draft_sparsity < 1.0:
            raise SystemExit(f"--draft-sparsity must lie in (0, 1), "
                             f"got {draft_sparsity}")
        if draft_k < 1:
            raise SystemExit(f"--draft-k must be >= 1, got {draft_k}")
        if draft_k + 1 > cache_len:
            raise SystemExit(
                f"--draft-k {draft_k} needs a draft+verify window of "
                f"{draft_k + 1} tokens inside --cache-len "
                f"({cache_len}); shrink --draft-k")
    elif draft_int8:
        raise SystemExit("--draft-int8 modifies the drafter pack; add "
                         "--draft-sparsity S")
    if kv_dedup_every < 0:
        raise SystemExit(f"--kv-dedup-every must be >= 0, got "
                         f"{kv_dedup_every}")
    if kv_dedup_every and not (kv_pages and kv_share):
        raise SystemExit("--kv-dedup-every requires --kv-pages and "
                         "--kv-share: the dedup sweep re-links "
                         "identical resident pages through the prefix "
                         "radix")


def build_serving_params(params, cfg, *, path: str, sparsity: float,
                         int8_weights: bool = False,
                         block_k: int = 32, block_n: int = 32,
                         scope: str = "ffn", verbose: bool = True,
                         mesh=None, tp: Optional[int] = None):
    """Deploy ``params`` along one execution path; returns (params, cfg)
    ready for the Engine. At ``sparsity`` 0 (or ``path`` dense) the dense
    params serve, as in the reference. ``mesh`` / ``tp``: a TP deployment
    over the mesh's 'model' axis, or at ``tp``: the packed visit lists in
    ``tp`` shard-local lists, and on every path the config's shard counts
    (``distribution.sharding.tp_config``). The tree holds every shard
    and every whole leaf; ``distribution.sharding.local_params`` takes a
    rank's."""
    if path not in PATHS:
        raise ValueError(f"path {path!r} not in {PATHS}")
    if _masked_int8_all(path, int8_weights, scope, sparsity):
        raise ValueError(MASKED_INT8_ALL)
    from repro_torch.distribution.sharding import tp_config
    if tp is None and mesh is not None:
        tp = mesh.axis_size("model")
    if path == "dense" or sparsity <= 0:
        return params, (cfg if tp is None else tp_config(cfg, tp))
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
        return params, (cfg if tp is None else tp_config(cfg, tp))
    if path in ("bsr", "kernel"):
        params = merge_overlay(params,
                               bsr_overlay_from_masks(params, masks, sasp))
        cfg = dataclasses.replace(
            cfg, sasp=dataclasses.replace(sasp, path=path))
        return params, (cfg if tp is None else tp_config(cfg, tp))
    from repro_torch.core.deploy import (cast_packed_values, deploy_packed,
                                         packed_summary)
    params, cfg = deploy_packed(params, cfg, tp=tp)
    cdt = as_dtype(cfg.compute_dtype)
    if cdt != torch.float32:
        params = cast_packed_values(params, cdt)
    if verbose:
        s = packed_summary(params)
        shard = f", {tp}-way shard-local visit lists" if (tp or 1) > 1 \
            else ""
        print(f"packed: {s['n_packed_matrices']} matrices + "
              f"{s['n_fused_ffns']} fused FFNs, "
              f"{s['compression']:.2f}x dense bytes{shard}")
    return params, cfg


def restore_params(ckpt_dir: str, params):
    """The params of the latest checkpoint in ``ckpt_dir`` (either
    package's format), in ``params``' structure, types and device."""
    mgr = CheckpointManager(ckpt_dir)
    state, _ = mgr.restore({"params": params})
    print(f"restored step {mgr.latest_step()} from {ckpt_dir}")
    return state["params"]


def synthetic_requests(n: int, vocab: int, max_new: int,
                       temperature: float = 0.0, eos_id=None,
                       interactive_every: int = 0):
    """The launcher's request mix: prompt lengths in [8, 48), seed 0;
    every ``interactive_every``-th request (from the first) is
    interactive-class, the others batch."""
    rng = np.random.default_rng(0)
    every = interactive_every
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, size=(rng.integers(8, 48),))
                    .astype(np.int32),
                    max_new_tokens=max_new, temperature=temperature,
                    eos_id=eos_id,
                    slo=("interactive" if every and i % every == 0
                         else "batch"))
            for i in range(n)]


def start_metrics_reporter(summary_fn: Callable[[], dict],
                           interval: float) -> threading.Event:
    """Print ``summary_fn()`` every ``interval`` seconds from a daemon
    thread until the returned event is set (--metrics-interval)."""
    stop = threading.Event()
    if interval <= 0:
        return stop

    def loop():
        while not stop.wait(interval):
            print(f"metrics: {summary_fn()}")

    threading.Thread(target=loop, daemon=True).start()
    return stop


def parse_args(argv):
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
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest checkpoint here")
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="paged KV: device page pool size (default: "
                         "contiguous per-slot rings)")
    ap.add_argument("--kv-page-len", type=int, default=None,
                    help="page length in tokens: a multiple of the SASP "
                         "tile that divides --cache-len (default: "
                         "tile-aligned automatic)")
    ap.add_argument("--kv-watermark", type=float, default=1.0,
                    help="fraction of --kv-pages that may stay resident; "
                         "allocations beyond it spill cold pages to host")
    ap.add_argument("--kv-host-pool", type=int, default=0,
                    help="host spill pool size in pages (0: cold pages "
                         "drop to re-prefill resume under pressure)")
    ap.add_argument("--kv-share", action="store_true",
                    help="prefix sharing over the paged pool; requires "
                         "--kv-pages, incompatible with --int8-kv")
    ap.add_argument("--kv-share-min-pages", type=int, default=1,
                    help="least whole pages a prompt must match before "
                         "sharing is taken")
    ap.add_argument("--kv-dedup-every", type=int, default=0,
                    help="dedup sweep cadence in decode steps (0 = off); "
                         "requires --kv-share")
    ap.add_argument("--draft-sparsity", type=float, default=None,
                    help="self-speculative decoding: the same weights "
                         "repacked at this higher tile sparsity draft "
                         "tokens; requires --kv-pages")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="drafted tokens per verify step")
    ap.add_argument("--draft-int8", action="store_true",
                    help="int8 drafter weights (with --draft-sparsity)")
    ap.add_argument("--draft-interactive", action="store_true",
                    help="let interactive requests speculate too")
    ap.add_argument("--buckets", default=None,
                    help="prefill buckets: an int count builds a "
                         "geometric table up to --cache-len; "
                         "comma-separated lengths give it explicitly")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the per-token iterator and "
                         "print tokens as they are sampled")
    ap.add_argument("--scheduler", action="store_true",
                    help="serve through the sharded request scheduler: "
                         "admission-controlled queue, one engine shard "
                         "per rank, continuous batching")
    ap.add_argument("--ranks", type=int, default=None,
                    help="engine shards of the scheduler (all on one "
                         "device, over the same weights)")
    ap.add_argument("--slots-per-rank", type=int, default=None,
                    help="slots of each rank's engine (default: --slots)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: reject submissions once "
                         "this many requests wait beyond free slot "
                         "capacity (default: unbounded)")
    ap.add_argument("--admission", choices=("fcfs", "sjf", "edf"),
                    default="fcfs",
                    help="queue policy: fcfs (arrival order), sjf "
                         "(shortest remaining work first) or edf "
                         "(earliest effective deadline first)")
    ap.add_argument("--aging", type=float, default=0.0,
                    help="anti-starvation credit per second waited "
                         "(seconds of deadline for edf, tokens for sjf)")
    ap.add_argument("--preempt", action="store_true",
                    help="interactive requests may evict the worst-"
                         "deadline batch decode at step granularity")
    ap.add_argument("--preempt-mode", choices=("kv", "reprefill"),
                    default="kv",
                    help="preempted-slot resume: 'kv' keeps the slot's "
                         "KV, 'reprefill' re-prefills prompt + tokens")
    ap.add_argument("--interactive-every", type=int, default=0,
                    help="mark every Nth synthetic request interactive "
                         "(0 = all batch)")
    ap.add_argument("--shed", choices=("count", "deadline"),
                    default="count",
                    help="overload shedding once --max-queue overflows: "
                         "'count' rejects the newcomer, 'deadline' evicts "
                         "the waiting request least likely to meet its "
                         "deadline (batch before interactive)")
    ap.add_argument("--drain", action="store_true",
                    help="drain-batch baseline: admit only when every "
                         "slot is free")
    ap.add_argument("--hosts", type=int, default=None,
                    help="serve through the fault-tolerant cluster "
                         "frontend over N in-process hosts, each its own "
                         "sharded scheduler")
    ap.add_argument("--retries", type=int, default=2,
                    help="re-submissions after a host failure before a "
                         "request fails (frontend only)")
    ap.add_argument("--backoff", type=float, default=0.05,
                    help="retry backoff base seconds: attempt k waits "
                         "base*2^(k-1), capped, with seeded jitter")
    ap.add_argument("--timeout", type=float, default=None,
                    help="per-request wall-clock watchdog seconds "
                         "(default: none)")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    help="graceful-shutdown bound in seconds")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="deterministic fault injection into the "
                         "frontend's hosts, e.g. 'kill:0@12,raise:1@3,"
                         "drop-hb:0@5x3,slow:1@0.02,seed:7' (requires "
                         "--hosts)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="arm the span tracer and write a Chrome trace-"
                         "event JSON of the run")
    ap.add_argument("--metrics-dump", default=None, metavar="PATH",
                    help="write the Prometheus text of every counter, "
                         "gauge and histogram at exit")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="print a counter summary every N seconds while "
                         "serving (0 = off)")
    ap.add_argument("--mesh", default=None, metavar="DP,TP",
                    help="serve on a (data, model) mesh of DP x TP spawned "
                         "processes (packed path), e.g. --mesh 2,2")
    args = ap.parse_args(argv)
    args.mesh = parse_mesh(args)
    return args


def parse_mesh(args) -> Optional[Tuple[int, int]]:
    """--mesh 'DP,TP' -> (DP, TP), or None; the reference's usage
    errors, and a mesh that cannot place the arch (experts that do not
    split over DP where they are sharded, SSM heads or an expert d_ff
    that do not split over TP) refused with the reason."""
    spec = args.mesh
    if not spec:
        return None
    m = re.fullmatch(r"\s*(\d+)\s*,\s*(\d+)\s*", spec)
    if not m or int(m.group(1)) < 1 or int(m.group(2)) < 1:
        raise SystemExit(f"--mesh expects 'DP,TP', two positive integers "
                         f"(e.g. --mesh 1,2), got {spec!r}")
    dp, tp = int(m.group(1)), int(m.group(2))
    check_ranks(args.ranks, (dp, tp))
    if args.hosts:
        raise SystemExit(
            "--hosts serves in-process hosts without a mesh; drop "
            "--mesh (per-host meshes are a multi-process deployment "
            "concern — see tests/dist_worker.py frontend_host)")
    from repro_torch.distribution.sharding import check_placement
    cfg = model_config(args)
    try:
        check_placement(cfg, tp, expert_shards(
            cfg, (dp, tp), scheduler=args.scheduler))
    except ValueError as e:
        raise SystemExit(f"--mesh {dp},{tp}: {e}")
    return dp, tp


def check_ranks(ranks: Optional[int], mesh: Optional[Tuple[int, int]]):
    """--ranks against the DP size of the (DP, TP) mesh: the reference's
    usage errors."""
    if ranks is None or mesh is None:
        return
    dp = mesh[0]
    shape = {"data": mesh[0], "model": mesh[1]}
    if ranks > dp:
        raise SystemExit(
            f"--ranks {ranks} exceeds the mesh's DP size {dp} "
            f"(mesh {shape}): each scheduler rank needs its "
            f"own DP slice of the mesh; drop --ranks or grow the DP "
            f"axis to >= {ranks}")
    if ranks != dp:
        raise SystemExit(
            f"--ranks {ranks} conflicts with the mesh's DP size {dp}: "
            f"under a mesh the DP axis decides the rank count; drop "
            f"--ranks")


def validate_tier_flags(args):
    """Usage errors of the scheduler / frontend flags (the reference's
    loud ones, and the port's for counts it would otherwise raise on
    deep inside)."""
    if args.hosts is not None and args.hosts < 1:
        raise SystemExit(f"--hosts must be >= 1, got {args.hosts}")
    if args.ranks is not None and args.ranks < 1:
        raise SystemExit(f"--ranks must be >= 1, got {args.ranks}")
    if args.chaos and not args.hosts:
        raise SystemExit("--chaos drives the cluster frontend's fault "
                         "hooks; add --hosts N")
    if not args.chaos:
        return None
    from repro_torch.serve.chaos import parse_chaos_spec
    try:
        return parse_chaos_spec(args.chaos)
    except ValueError as e:
        raise SystemExit(f"--chaos: {e}")


def scheduler_config(args, buckets):
    from repro_torch.serve.scheduler import SchedulerConfig
    return SchedulerConfig(
        slots_per_rank=args.slots_per_rank or args.slots,
        cache_len=args.cache_len, max_queue=args.max_queue,
        policy=args.admission, drain=args.drain, aging=args.aging,
        preempt=args.preempt, preempt_mode=args.preempt_mode,
        buckets=buckets, shed=args.shed, kv_pages=args.kv_pages,
        kv_page_len=args.kv_page_len, kv_watermark=args.kv_watermark,
        kv_host_pages=args.kv_host_pool, kv_share=args.kv_share,
        kv_share_min_pages=args.kv_share_min_pages,
        draft_sparsity=args.draft_sparsity, draft_k=args.draft_k,
        draft_int8=args.draft_int8,
        draft_interactive=args.draft_interactive,
        kv_dedup_every=args.kv_dedup_every)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if _masked_int8_all(args.path, args.int8_weights, args.scope, args.sasp):
        raise SystemExit(MASKED_INT8_ALL)
    chaos_cfg = validate_tier_flags(args)
    buckets = parse_buckets(args.buckets, args.cache_len)
    validate_kv_flags(
        kv_pages=args.kv_pages, kv_watermark=args.kv_watermark,
        kv_share=args.kv_share, kv_share_min_pages=args.kv_share_min_pages,
        int8_kv=args.int8_kv, draft_sparsity=args.draft_sparsity,
        draft_k=args.draft_k, draft_int8=args.draft_int8,
        kv_dedup_every=args.kv_dedup_every, cache_len=args.cache_len)

    if args.mesh:
        serve_mesh(mesh_spec(args, buckets))
        return
    cfg = model_config(args)
    if (args.path == "packed" and args.sasp > 0
            and args.draft_sparsity is None):
        # layer by layer: the card holds the packed model, not its masters
        params, cfg, _, _ = build_rank_params(
            cfg, tp=1, rank=0, device=args.device, sparsity=args.sasp,
            scope=args.scope, int8_weights=args.int8_weights,
            ckpt_dir=args.ckpt_dir, verbose=True)
    else:
        with torch.no_grad():
            params = lm.init_params(cfg, seed=0, device=args.device)
            if args.ckpt_dir:
                params = restore_params(args.ckpt_dir, params)
            params, cfg = build_serving_params(
                params, cfg, path=args.path, sparsity=args.sasp,
                int8_weights=args.int8_weights, scope=args.scope)
    reqs = synthetic_requests(args.requests, cfg.vocab_size, args.max_new,
                              args.temperature, args.eos_id,
                              args.interactive_every)
    trace = bool(args.trace_out)

    def drive(run_fn, stream_fn) -> Sequence[Request]:
        """--stream: print tokens as they retire; else run to done."""
        if not args.stream:
            return run_fn(reqs)
        n = 0
        for rid, tok in stream_fn(reqs):
            if n < 12:
                print(f"  stream: req {rid} += {tok}")
            n += 1
        print(f"  … streamed {n} tokens incrementally")
        return [r for r in reqs if r.done]

    if args.hosts:
        done, dt, tel_trace, tel_prom = _serve_frontend(
            args, params, cfg, reqs, buckets, chaos_cfg)
    elif args.scheduler:
        from repro_torch.serve.scheduler import ShardedScheduler
        sched = ShardedScheduler(params, cfg, ranks=args.ranks,
                                 telemetry=Telemetry(trace=trace),
                                 sched=scheduler_config(args, buckets))
        stop_rep = start_metrics_reporter(
            lambda: sched.telemetry.registry.summary()["counters"],
            args.metrics_interval)
        t0 = time.time()
        done = drive(sched.run, sched.stream)
        _sync(params)
        dt = time.time() - t0
        stop_rep.set()
        print_scheduler_summary(sched, done, args.admission, args.drain,
                                args.interactive_every)
        tel_trace, tel_prom = (sched.telemetry.write_trace,
                               sched.telemetry.prometheus)
    else:
        eng = Engine(params, cfg, batch_slots=args.slots,
                     cache_len=args.cache_len, buckets=buckets,
                     kv_pages=args.kv_pages, kv_page_len=args.kv_page_len,
                     kv_watermark=args.kv_watermark,
                     kv_host_pages=args.kv_host_pool,
                     kv_share=args.kv_share,
                     kv_share_min_pages=args.kv_share_min_pages,
                     draft_sparsity=args.draft_sparsity,
                     draft_k=args.draft_k, draft_int8=args.draft_int8,
                     draft_interactive=args.draft_interactive,
                     kv_dedup_every=args.kv_dedup_every,
                     telemetry=Telemetry(trace=trace))
        stop_rep = start_metrics_reporter(
            lambda: eng.telemetry.registry.summary()["counters"],
            args.metrics_interval)
        t0 = time.time()
        done = drive(eng.run, eng.stream)
        _sync(params)
        dt = time.time() - t0
        stop_rep.set()
        st = eng.stats
        if args.draft_sparsity is not None:
            drafted = st["spec_draft_tokens"]
            acc = st["spec_accepted_tokens"]
            print(f"speculative: {st['spec_rounds']} rounds, "
                  f"{acc}/{max(drafted, 1)} drafts accepted "
                  f"({acc / max(drafted, 1):.0%}), "
                  f"{st['spec_fallbacks']} fallbacks")
        mem = eng.memory_stats()
        if mem is not None:
            print(f"paged KV: {mem.device_pages} device pages × "
                  f"{eng.pool.page_len} tokens, {mem.spills} spills, "
                  f"{mem.faults} faults, {mem.drops} drops")
            if args.kv_share:
                print(f"prefix sharing: {mem.prefix_hits} hits, "
                      f"{mem.prefix_pages_reused} pages reused, "
                      f"{st['prefill_tokens_skipped']} prefill tokens "
                      f"skipped, {mem.cow_copies} COW copies")
        tel_trace, tel_prom = (eng.telemetry.write_trace,
                               eng.telemetry.prometheus)
    if args.trace_out:
        n_ev = tel_trace(args.trace_out)
        print(f"trace: {n_ev} events -> {args.trace_out} "
              "(load at ui.perfetto.dev)")
    if args.metrics_dump:
        with open(args.metrics_dump, "w", encoding="utf-8") as fh:
            fh.write(tel_prom())
        print(f"metrics -> {args.metrics_dump}")
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / max(dt, 1e-9):.1f} tok/s, "
          f"{dt / max(toks, 1) * 1e3:.0f} ms/token)")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  req {r.rid}: prompt[{len(r.prompt)}] -> "
              f"{r.out_tokens[:10]}…")


# ---------------------------------------------------------------------------
# --mesh: one spawned process per model rank
# ---------------------------------------------------------------------------


def model_config(args):
    """The config the flags name: ``--arch``, cut by ``--reduce``, with
    ``--int8-kv``."""
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, layers=4, d_model=128, vocab=512)
    if args.int8_kv:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    return cfg


def mesh_spec(args, buckets=None) -> dict:
    """What every process of a ``--mesh`` run serves, from the flags:
    the mesh's (DP, TP), the model's config, ``build_rank_params``'
    options (``build``: the seed or the checkpoint), the synthetic
    requests, the engine's options, the scheduler's (``scheduler``: a
    ``SchedulerConfig`` under ``--scheduler``, else None; ``ranks``) and
    world rank 0's outputs (``serve``: streaming, the trace, the
    metrics)."""
    return dict(
        mesh=args.mesh, cfg=model_config(args), device=args.device,
        build=dict(seed=0, sparsity=args.sasp, scope=args.scope,
                   int8_weights=args.int8_weights, ckpt_dir=args.ckpt_dir,
                   path=args.path, draft_sparsity=args.draft_sparsity,
                   draft_int8=args.draft_int8),
        requests=dict(n=args.requests, max_new=args.max_new,
                      temperature=args.temperature, eos_id=args.eos_id,
                      interactive_every=args.interactive_every),
        scheduler=(scheduler_config(args, buckets) if args.scheduler
                   else None),
        ranks=args.ranks,
        serve=dict(stream=args.stream, trace_out=args.trace_out,
                   metrics_dump=args.metrics_dump,
                   metrics_interval=args.metrics_interval),
        engine=dict(batch_slots=args.slots, cache_len=args.cache_len,
                    buckets=buckets, kv_pages=args.kv_pages,
                    kv_page_len=args.kv_page_len,
                    kv_watermark=args.kv_watermark,
                    kv_host_pages=args.kv_host_pool, kv_share=args.kv_share,
                    kv_share_min_pages=args.kv_share_min_pages,
                    kv_dedup_every=args.kv_dedup_every,
                    draft_k=args.draft_k,
                    draft_interactive=args.draft_interactive))


def mesh_requests(spec: dict, vocab: int):
    r = spec["requests"]
    return synthetic_requests(r["n"], vocab, r["max_new"], r["temperature"],
                              r["eos_id"], r.get("interactive_every", 0))


def print_scheduler_summary(sched, done, policy: str, drain: bool,
                            interactive_every: int):
    """The scheduler's summary lines: admission counts, every rank's
    stats, latency quantiles by SLO class, TTFT."""
    st = sched.stats()
    print(f"scheduler: {st['ranks']} rank(s), "
          f"{st['accepted']}/{st['submitted']} admitted "
          f"({st['rejected']} rejected, {st['failed']} failed, "
          f"{st['preemptions']} preempted), "
          f"policy={policy}{', drain baseline' if drain else ''}")
    for r_st in st["per_rank"]:
        print(f"  rank stats: {r_st}")
    if interactive_every:
        for klass in ("interactive", "batch"):
            lats = sorted(r.latency for r in done
                          if r.slo == klass and r.latency)
            if lats:
                p50, p95 = pcts_ms(lats)
                print(f"  {klass:12s}: n={len(lats)} "
                      f"p50={p50:.0f}ms p95={p95:.0f}ms")
    for klass, d in st.get("ttft", {}).items():
        print(f"  ttft {klass:12s}: n={d['count']} "
              f"p50={d['p50_ms']:.1f}ms p95={d['p95_ms']:.1f}ms")


def serve_mesh(spec: dict, rank_fn=None, *, store_dir=None,
               timeout: float = 900.0) -> list:
    """Spawn the mesh's DP x TP processes, each running ``rank_fn(rank,
    spec, init_file)`` (default :func:`serve_rank`; a module-level
    function, which a spawned rank imports by name), and return every
    process's result, a dict with its ``streams`` (and, under the
    scheduler, ``served``: each request's scheduler rank), in rank order.
    The processes' streams and served ranks must agree; a disagreement
    raises. The file store lives under ``store_dir`` (default
    ``build/mesh``)."""
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import init_file_in, run_ranks
    dp, tp = spec["mesh"]
    store = init_file_in(store_dir or os.path.join(build.REPO_ROOT, "build",
                                                   "mesh"),
                         f"store_{os.getpid()}_{time.time_ns()}")
    # by its module's name, so that a spawned rank can import it
    fn = rank_fn or importlib.import_module(
        "repro_torch.launch.serve").serve_rank
    try:
        results = run_ranks(fn, dp * tp, (spec, store), timeout=timeout)
    finally:
        if os.path.exists(store):
            os.remove(store)
    if any(r["streams"] != results[0]["streams"] for r in results):
        raise RuntimeError("the mesh's processes served different streams")
    if any(r.get("served") != results[0].get("served") for r in results):
        raise RuntimeError("the mesh's processes served requests on "
                           "different scheduler ranks")
    print(f"mesh: {dp * tp} processes ({dp} data x {tp} model ranks) "
          f"served equal streams")
    return results


def join_mesh(rank: int, spec: dict, init_file: str, backend=None):
    """Join ``spec``'s mesh as ``rank`` (``launch.mesh.make_mesh``;
    ``backend`` None picks by cards); on the CPU each of the DP x TP
    processes takes its share of this process's threads."""
    from repro_torch.launch.mesh import make_mesh
    dp, tp = spec["mesh"]
    if spec["device"] == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // (dp * tp)))
    return make_mesh(dp, tp, rank=rank, init_file=init_file,
                     backend=backend, device=spec["device"])


SPEC_KEYS = ("spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
             "spec_fallbacks")


def spec_counts(engines) -> dict:
    """The speculation counters summed over the engines of this process
    (a scheduler's peer views hold none)."""
    return {k: sum(e.stats[k] for e in engines if isinstance(e, Engine))
            for k in SPEC_KEYS}


def serve_rank(rank: int, spec: dict, init_file: str) -> dict:
    """One process of a ``--mesh`` run: join the mesh, build this model
    rank's tree (``build_rank_params``), serve the requests through one
    ``Engine`` on the mesh or, with ``spec["scheduler"]``, through
    ``ShardedScheduler(mesh=)``. Every process steps the same loop
    (``stream`` under ``--stream``), so the processes never part; world
    rank 0 alone prints, streams tokens, owns the tracer, writes the trace
    and the Prometheus dump and runs the interval reporter. Returns the
    streams, under the scheduler the rank that served each request, the
    transport, the seconds to build and to serve, this process's engine's
    speculation counters and the files this process wrote."""
    mesh = join_mesh(rank, spec, init_file)
    dp, tp = spec["mesh"]
    lead = mesh.rank == 0
    opts = spec.get("serve") or {}
    t0 = time.perf_counter()
    ep = expert_shards(spec["cfg"], spec["mesh"],
                       scheduler=spec.get("scheduler") is not None)
    params, cfg, lcfg, draft = build_rank_params(
        spec["cfg"], tp=tp, rank=mesh.model_rank, device=mesh.device,
        ep=ep, data_rank=mesh.data_rank, verbose=lead, **spec["build"])
    build_s = time.perf_counter() - t0
    if lead:
        print(f"mesh: {mesh.shape} over {dp * tp} processes, transport "
              f"{mesh.transport}; {rank_layout(cfg, lcfg, params, ep)}; "
              f"build {build_s:.1f} s", flush=True)
    tel = Telemetry(trace=bool(opts.get("trace_out")) and lead)
    sched_cfg = spec.get("scheduler")
    if sched_cfg is not None:
        from repro_torch.serve.scheduler import ShardedScheduler
        server = ShardedScheduler(params, lcfg, mesh=mesh,
                                  ranks=spec.get("ranks"), telemetry=tel,
                                  sched=sched_cfg, draft=draft)
    else:
        server = Engine(params, lcfg, mesh=mesh, telemetry=tel, draft=draft,
                        **spec["engine"])
        if lead and server.layout is not None:
            pool = "" if server.pool is None else (
                f"; a pool of {server.pool.blocks} block(s), "
                f"{server.pool.nbytes() / 2**30:.3f} GiB on world rank 0")
            print(f"engine: {server.B} slots {server.layout}{pool}",
                  flush=True)
    stop_rep = start_metrics_reporter(
        lambda: tel.registry.summary()["counters"],
        opts.get("metrics_interval", 0.0) if lead else 0.0)
    reqs = mesh_requests(spec, cfg.vocab_size)
    t0 = time.perf_counter()
    if opts.get("stream"):
        n = 0
        for rid, tok in server.stream(reqs):
            if lead and n < 12:
                print(f"  stream: req {rid} += {tok}", flush=True)
            n += 1
        if lead:
            print(f"  … streamed {n} tokens incrementally", flush=True)
        done = [r for r in reqs if r.done]
    else:
        done = server.run(reqs)
    _sync(params)
    dt = time.perf_counter() - t0
    stop_rep.set()
    streams = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    out = dict(rank=rank, transport=mesh.transport, build_s=build_s,
               serve_s=dt, streams=streams, wrote=[],
               spec=spec_counts(getattr(server, "shards", [server])))
    if sched_cfg is not None:
        out["served"] = {r.rid: r.rank for r in done}
    if lead:
        if draft is not None:
            sc = out["spec"]
            print(f"speculative: {sc['spec_rounds']} rounds, "
                  f"{sc['spec_accepted_tokens']}/"
                  f"{sc['spec_draft_tokens']} drafts accepted, "
                  f"{sc['spec_fallbacks']} fallbacks (this process's "
                  f"engine)", flush=True)
        if sched_cfg is not None:
            print_scheduler_summary(server, done, sched_cfg.policy,
                                    sched_cfg.drain,
                                    spec["requests"].get("interactive_every"))
        toks = sum(len(s) for s in streams.values())
        print(f"{len(done)} requests, {toks} tokens in {dt:.1f}s "
              f"({toks / max(dt, 1e-9):.1f} tok/s) on the mesh, world rank "
              f"0's clock", flush=True)
        for rid in sorted(streams)[:3]:
            print(f"  req {rid} -> {streams[rid][:10]}…", flush=True)
        if opts.get("trace_out"):
            n_ev = tel.write_trace(opts["trace_out"])
            print(f"trace: {n_ev} events -> {opts['trace_out']} (world "
                  f"rank 0)", flush=True)
            out["wrote"].append(opts["trace_out"])
        if opts.get("metrics_dump"):
            with open(opts["metrics_dump"], "w", encoding="utf-8") as fh:
                fh.write(tel.prometheus())
            print(f"metrics -> {opts['metrics_dump']} (world rank 0)",
                  flush=True)
            out["wrote"].append(opts["metrics_dump"])
    return out


class _Source:
    """Where ``build_rank_params`` takes the params from, a piece at a
    time: ``top`` (the embedding, final norm and head), ``layer(si, i,
    experts, slot)`` (slot ``slot`` of layer ``i`` of segment ``si``,
    each expert stack cut to the experts (lo, hi), (0, 0) for none) and
    ``expert(q, i, e)``
    (expert ``e`` of layer ``i`` of the expert stack at path ``q``, (1,
    1, din, dout))."""

    def __init__(self, top, layer, expert):
        self.top, self.layer, self.expert = top, layer, expert


def rank_layout(cfg, lcfg, params, ep: int) -> str:
    """What a rank holds of ``cfg``: its heads, SSM heads, experts and
    vocab rows."""
    parts = []
    if cfg.num_heads:
        parts.append(f"rank heads {lcfg.num_heads}/{lcfg.num_kv_heads} of "
                     f"{cfg.num_heads}/{cfg.num_kv_heads}")
    if cfg.ssm is not None and any(k != MIXER_ATTN
                                   for k in cfg.layer_mixer_kinds()):
        H = cfg.ssm.num_heads(cfg.d_model)
        parts.append(f"SSM heads {H // lcfg.ssm.head_shards} of {H}")
    if cfg.moe is not None:
        E = cfg.moe.num_experts
        parts.append(f"experts {E // ep} of {E} (d_ff "
                     f"{cfg.d_ff // cfg.tp_shards} of {cfg.d_ff})")
    parts.append(f"vocab rows {params['embed']['emb'].shape[0]} of "
                 f"{cfg.vocab_size}")
    return ", ".join(parts)


def _seed_source(cfg, seed: int, device) -> _Source:
    """The params ``lm.init_params`` draws from ``seed``: the top from the
    seeded generator, each layer (``lm.init_layer``) and each expert
    (``lm.draw_expert``) alone from its own generators."""
    def expert(q, i, e):
        slot = int(str(q[2])[len("slot"):])
        return lm.draw_expert(cfg, q[1], slot, q[4], i, e, seed=seed,
                              device=device)[None, None]
    return _Source(
        lm.init_top(cfg, seed=seed, device=device),
        lambda si, i, experts, slot: lm.init_layer(
            cfg, si, i, seed=seed, device=device, experts=experts,
            slots=(int(slot[len("slot"):]),)),
        expert)


def _ckpt_source(cfg, ckpt_dir: str, device) -> _Source:
    """The params of the latest checkpoint in ``ckpt_dir`` (either
    package's format), each leaf in the param type on ``device`` as
    ``restore_params`` gives it: the top leaves read whole, layer ``i``
    of each stacked leaf read alone (``CheckpointReader.layer``), an
    expert stack's layer only for the experts asked for, so the host
    holds one layer and no whole expert stack."""
    reader = CheckpointManager(ckpt_dir).reader()
    dt = as_dtype(cfg.param_dtype)
    plan = lm.segment_plan(cfg)
    names = [n for n in reader.names() if n.startswith("params/")]
    if not names:
        raise KeyError(f"checkpoint step {reader.step} in {ckpt_dir} holds "
                       f"no params")

    def tree(leaves):
        out: dict = {}
        for keys, t in leaves:
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t.to(device=device, dtype=dt)
        return out

    def path_of(n):
        keys = n[len("params/"):].split("/")
        return (keys[0], int(keys[1])) + tuple(keys[2:])

    def layer(si, i, experts, slot):
        prefix = f"params/segments/{si}/"
        mine = [n for n in names if n.startswith(prefix + slot + "/")]
        for n in mine:
            if reader.shape(n)[0] != plan[si][1]:
                raise ValueError(
                    f"{n!r} holds {reader.shape(n)[0]} layers, the model's "
                    f"segment {si} {plan[si][1]}")

        def read(n):
            if experts is not None and lm.expert_leaf(cfg, path_of(n)):
                return reader.layer(n, i, rows=experts)
            return reader.layer(n, i)
        return tree((n[len(prefix):].split("/"), read(n)) for n in mine)

    def expert(q, i, e):
        n = "params/" + "/".join(str(k) for k in q)
        return reader.layer(n, i, rows=(e, e + 1)).to(device=device,
                                                     dtype=dt)

    top = tree((n[len("params/"):].split("/"), reader.leaf(n))
               for n in names if not n.startswith("params/segments/"))
    print(f"restored step {reader.step} from {ckpt_dir} (layer by layer)")
    return _Source(top, layer, expert)


def expert_shards(cfg, mesh, *, scheduler: bool) -> int:
    """The experts' shards over 'data' that a (DP, TP) mesh serves with:
    DP where one ``Engine`` serves the whole mesh, whatever its slots
    (expert parallelism where the slots split over 'data', the
    replicated mode where every data rank holds the whole batch:
    ``moe_ep.moe_ffn_replicated``), else 1: each scheduler rank is a
    submesh with 'data' collapsed (the reference's ``dp_submeshes``) and
    holds every expert."""
    dp = mesh[0]
    if cfg.moe is None or dp == 1 or scheduler:
        return 1
    return dp


def build_rank_params(cfg, *, tp: int, rank: Optional[int], device,
                      seed: int = 0, sparsity: float, scope: str = "ffn",
                      int8_weights: bool = False, path: str = "packed",
                      draft_sparsity: Optional[float] = None,
                      draft_int8: bool = False, prepare=None,
                      ckpt_dir: Optional[str] = None, ep: int = 1,
                      data_rank: int = 0, verbose: bool = False):
    """Model rank ``rank``'s tree (at data rank ``data_rank`` of ``ep``
    expert shards) of a TP deployment at ``tp`` on
    ``path``, built layer by layer, and its self-speculation drafter. The
    tree equals ``distribution.sharding.local_params`` of
    ``build_serving_params(params, cfg, path=path, tp=tp, ...)``, where
    ``params`` are ``lm.init_params(cfg, seed=seed)`` or, with
    ``ckpt_dir``, the latest checkpoint's there; the drafter (with
    ``draft_sparsity``) equals ``local_params`` of ``core.deploy.
    draft_pack(that deployment, ..., tp=tp)``. Neither the host nor the
    device ever holds the model: a first pass takes each layer alone
    (drawn from its own generators, or read from the checkpoint), each
    expert of an expert stack alone again, and keeps only its prunable
    matrices' tile scores (the global SASP
    selection reads them all, in the whole tree's leaf order); a second
    pass takes each layer alone again, deploys it on the path (pruned in
    place; quantized on the masked int8 path; its BSR at the whole
    stack's depth on the bsr and kernel paths; packed into ``tp`` shards
    and cast on the packed path; as drawn on the dense path, or at
    ``sparsity`` 0), cuts it to the rank's slice and writes it into the
    layer-stacked tree (``core.deploy.LayerStack``). Expert stacks stay
    masked-dense: the rank's experts (all of them where ``ep`` is 1) are
    taken one at a time, pruned and cut to its d_ff before the next, so
    no rank holds a whole expert stack. The drafter's layer
    is the deployed layer re-pruned at ``draft_sparsity`` and packed: its
    global selection reads the target's tile scores with the target's
    pruned tiles set to 0, which is what ``tile_l1`` gives on the pruned
    weights ``draft_pack`` re-prunes; its expert stacks, like the
    target's, are taken one expert at a time, pruned by the target's
    masks and then the drafter's, cut to the rank's experts and d_ff,
    masked-dense, in the target's EP shards. The device holds the rank's trees,
    the table, and one layer's masters with their deployed copies.
    ``prepare(path, leaf)``, where given, changes each one-layer leaf (and
    each expert) as it is taken, before scoring and pruning. ``rank``
    None keeps every shard and every expert (the shard loop's tree,
    without the matrices a container replaces). ``tp`` 1 and ``rank`` 0
    is one card's model. Returns ``(params, cfg', lcfg, draft)``: the
    tree, the deployed config, the rank's local config, and the drafter's
    ``(tree, config)`` (the rank's local config; with ``rank`` None the
    shard loop's) or None."""
    from repro_torch.core.deploy import (LayerStack, cast_packed_values,
                                         deploy_packed, strip_packed)
    from repro_torch.core.pruning import (apply_block_mask,
                                          apply_block_mask_, iter_leaves,
                                          map_leaves, masks_from_scores,
                                          prunable_blocks, scope_predicate,
                                          tile_l1)
    from repro_torch.distribution.sharding import (check_placement,
                                                   local_config,
                                                   local_params,
                                                   spec_for_param,
                                                   take_slice, tp_config)
    if path not in PATHS:
        raise ValueError(f"path {path!r} not in {PATHS}")
    if _masked_int8_all(path, int8_weights, scope, sparsity):
        raise ValueError(MASKED_INT8_ALL)
    check_placement(cfg, tp, ep)
    moe = cfg.moe is not None
    if moe and path == "masked" and int8_weights and sparsity > 0:
        raise ValueError(MOE_INT8)
    tsasp = None                # the target's pruning, None: dense
    if path != "dense" and sparsity > 0:
        tsasp = SASPConfig(enabled=True, block_k=32, block_n=32,
                           sparsity=sparsity, scope=scope,
                           quantize=int8_weights,
                           path=path if path in ("bsr", "kernel")
                           else "masked")
        cfg = dataclasses.replace(cfg, sasp=tsasp)
    dsasp = None if draft_sparsity is None else dataclasses.replace(
        cfg.sasp, enabled=True, sparsity=float(draft_sparsity),
        quantize=bool(draft_int8))
    # the scores each selection reads: the target's of its scope, and the
    # drafter's own only where the target is dense (else the target's,
    # its pruned tiles 0)
    scored = [(sasp, scope_predicate(sasp), {}) for sasp in
              (tsasp, dsasp if tsasp is None else None) if sasp is not None]
    prep = prepare or (lambda path, t: t)
    cdt = as_dtype(cfg.compute_dtype)
    plan = lm.segment_plan(cfg)
    E = cfg.moe.num_experts if moe else 0
    # the experts this rank holds, and none in a layer as first taken
    lo, hi = (0, E) if rank is None or ep == 1 else \
        (data_rank * E // ep, (data_rank + 1) * E // ep)
    no_experts = (0, 0) if moe else None

    secs = dict.fromkeys(("scoring", "deploying", "stacking"), 0.0)

    def clock(part, t0):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        secs[part] += now - t0
        return now

    def one_layer(tree, si):
        """{path keyed from the root: leaf} -> paths keyed in a
        one-segment tree (segment index 0)."""
        return {("segments", 0) + p[2:]: v for p, v in tree.items()
                if p[1] == si}

    with torch.no_grad():
        t0 = time.perf_counter()
        src = (_seed_source(cfg, seed, device) if ckpt_dir is None
               else _ckpt_source(cfg, ckpt_dir, device))
        top = src.top

        def slots(si):
            """Segment si's slots in the tree's leaf order: a hybrid
            pattern's layers are taken one at a time too."""
            return sorted(f"slot{j}" for j in range(len(plan[si][0])))

        def taken(si, i, s):
            """Slot s of layer i of segment si without its experts,
            prepared, keyed from the root."""
            return map_leaves(prep, src.layer(si, i, no_experts, s),
                              ("segments", si))

        def expert(q, i, e):
            return prep(q, src.expert(q, i, e))

        # pass 1: every prunable matrix's tile scores, layer by layer
        # (expert by expert), assembled (L, [E,] KB, NB) in the whole
        # tree's leaf order
        if scored:
            for si, (_, repeat) in enumerate(plan):
                for i, s in ((i, s) for i in range(repeat)
                             for s in slots(si)):
                    for q, t in iter_leaves(taken(si, i, s),
                                            ("segments", si)):
                        for sasp, pred, out in scored:
                            blocks = prunable_blocks(q, t, sasp, pred)
                            if blocks is None:
                                continue
                            if lm.expert_leaf(cfg, q):
                                sc = torch.cat([tile_l1(expert(q, i, e),
                                                        *blocks)
                                                for e in range(E)], dim=1)
                            else:
                                sc = tile_l1(t, *blocks)
                            out.setdefault(q, []).append(sc)
        scores = [[(q, torch.cat(v)) for q, v in out.items()]
                  for _, _, out in scored]
        tmasks = {} if tsasp is None else masks_from_scores(scores[0],
                                                            sparsity)
        if dsasp is None or (path == "masked" and int8_weights):
            dmasks = {}         # the int8 path keeps no "w" in its scope
        else:
            dmasks = masks_from_scores(
                scores[-1] if tsasp is None else
                [(q, torch.where(tmasks[q], v, torch.zeros_like(v)))
                 for q, v in scores[0]], dsasp.sparsity)
        k_max = {q: max(1, int(m.sum(dim=-2).max()))
                 for q, m in tmasks.items()}
        del scored, scores
        t0 = clock("scoring", t0)

        def rank_experts(q, i, draft=False):
            """The rank's experts of layer i of the stack at q: each taken
            alone, pruned (by the target's masks, then the drafter's for
            the drafter), cut to the rank's d_ff, stacked (1, E', …)."""
            parts = []
            for e in range(lo, hi):
                w = expert(q, i, e)
                for masks in (tmasks, dmasks if draft else {}):
                    if q in masks:
                        apply_block_mask_(w, masks[q][i:i + 1, e:e + 1])
                if rank is not None and tp > 1:
                    w = take_slice(w, spec_for_param(
                        q, tuple(w.shape), {"model": tp}, True), rank, tp)
                parts.append(w)
            return torch.cat(parts, dim=1)

        def with_experts(seg, si, i, draft=False):
            """A one-layer local segment with its experts (the target's,
            or the drafter's) written in."""
            seg = dict(seg)
            for j, spec in enumerate(plan[si][0]):
                s = f"slot{j}"
                if spec[2] != FFN_MOE or s not in seg:
                    continue
                slot = dict(seg[s])
                ffn = dict(slot["ffn"])
                for n in ("w1", "w2", "w3"):
                    if n in ffn:
                        ffn[n] = dict(ffn[n], w=rank_experts(
                            ("segments", si, s, "ffn", n, "w"), i, draft))
                slot["ffn"] = ffn
                seg[s] = slot
            return seg

        # pass 2: each layer (each slot of a pattern) deployed on the
        # path, cut, cast and stacked; its drafter re-pruned from it,
        # packed, cut and cast
        segs, dsegs = [], []
        tcfg = dcfg = None
        for si, (_, repeat) in enumerate(plan):
            stacks = {s: LayerStack(repeat, device) for s in slots(si)}
            dstacks = None if dsasp is None else {
                s: LayerStack(repeat, device) for s in slots(si)}
            tm, dm = one_layer(tmasks, si), one_layer(dmasks, si)
            for i, s in ((i, s) for i in range(repeat) for s in slots(si)):
                # the layer is a fresh draw or read: prune it in place
                seg = map_leaves(
                    lambda q, t, i=i: apply_block_mask_(
                        t, tmasks[q][i:i + 1]) if (
                            q in tmasks and not lm.expert_leaf(cfg, q))
                    else t, taken(si, i, s), ("segments", si))
                tree = dict(top, segments=(seg,))
                if path == "packed" and tsasp is not None:
                    served, tcfg = deploy_packed(tree, cfg, tp=tp)
                else:
                    served, tcfg = tree, tp_config(cfg, tp)
                    if path == "masked" and int8_weights:
                        served = quantize_params(served, tsasp)
                    elif path in ("bsr", "kernel") and tsasp is not None:
                        served = merge_overlay(served, bsr_overlay_from_masks(
                            served, {q: m[i:i + 1] for q, m in tm.items()
                                     if q[2] == s
                                     and not lm.expert_leaf(cfg, q)},
                            tsasp, k_max=one_layer(k_max, si)))
                tcfg = tp_config(tcfg, tp, ep)
                local = local_params({"segments": served["segments"]}, tcfg,
                                     tp, rank, ep, data_rank)["segments"][0]
                if moe:
                    local = with_experts(local, si, i)
                if path == "packed" and cdt != torch.float32:
                    local = cast_packed_values(local, cdt)
                t0 = clock("deploying", t0)
                stacks[s].add(local)    # written into the layer stack
                del local
                t0 = clock("stacking", t0)
                if dstacks is not None:
                    dseg = map_leaves(
                        lambda q, t: apply_block_mask(t, dm[q][i:i + 1])
                        if q in dm and not lm.expert_leaf(cfg, q) else t,
                        strip_packed(served)["segments"][0],
                        ("segments", 0))
                    dtree, dcfg = deploy_packed(
                        dict(top, segments=(dseg,)),
                        dataclasses.replace(tcfg, sasp=dsasp),
                        quantize=bool(draft_int8), tp=tp)
                    dcfg = tp_config(dcfg, tp, ep)
                    del dseg
                    dlocal = local_params({"segments": dtree["segments"]},
                                          dcfg, tp, rank, ep,
                                          data_rank)["segments"][0]
                    if moe:
                        dlocal = with_experts(dlocal, si, i, draft=True)
                    if cdt != torch.float32:
                        dlocal = cast_packed_values(dlocal, cdt)
                    del dtree
                    t0 = clock("deploying", t0)
                    dstacks[s].add(dlocal)
                    del dlocal
                    t0 = clock("stacking", t0)
                del seg, tree, served
            segs.append({k: v for st in stacks.values()
                         for k, v in st.result().items()})
            if dstacks is not None:
                dsegs.append({k: v for st in dstacks.values()
                              for k, v in st.result().items()})
        top = local_params(dict(top, segments=()), tcfg, tp, rank, ep,
                           data_rank)
    if verbose:
        who = "every shard kept" if rank is None else \
            f"rank {rank} keeps its shard"
        if moe:
            who += (f", experts {lo}-{hi - 1} of {E}" if ep > 1
                    else f", all {E} experts")
        if path == "packed" and tsasp is not None:
            what = (f"SASP deployed: {sparsity:.0%} tile sparsity, scope "
                    f"{scope}, {cfg.num_layers} layers packed one at a time "
                    f"into {tp}-way shard-local visit lists")
        else:
            how = "dense" if tsasp is None else \
                f"{sparsity:.0%} tile sparsity, scope {scope}"
            what = (f"--path {path} deployed ({how}): {cfg.num_layers} "
                    f"layers one at a time, cut to {tp} TP shards")
        drafter = "" if dsasp is None else \
            f", a drafter at {dsasp.sparsity:.0%} packed alike"
        print(f"{what} ({tcfg.vocab_shards} vocab shards{drafter}); {who}; "
              f"seconds: { {k: round(v, 2) for k, v in secs.items()} }")
        if path == "packed" and tsasp is not None:
            from repro_torch.core.deploy import packed_summary
            sm = packed_summary(segs)
            print(f"packed: {sm['n_packed_matrices']} matrices + "
                  f"{sm['n_fused_ffns']} fused FFNs, "
                  f"{sm['compression']:.2f}x dense bytes")
    draft = None if dsasp is None else (
        dict(top, segments=tuple(dsegs)),
        dcfg if rank is None else local_config(dcfg, tp))
    return (dict(top, segments=tuple(segs)), tcfg, local_config(tcfg, tp),
            draft)


def _sync(params):
    dev = params["embed"]["emb"].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _serve_frontend(args, params, cfg, reqs, buckets, chaos_cfg):
    """--hosts: the cluster frontend over in-process hosts, then a
    bounded drain. Returns (done, seconds, trace writer, prometheus)."""
    from repro_torch.serve.chaos import ChaosMonkey
    from repro_torch.serve.frontend import (ClusterFrontend, FrontendConfig,
                                            make_local_hosts)
    hosts = make_local_hosts(
        params, cfg, hosts=args.hosts, ranks=args.ranks or 1,
        chaos=ChaosMonkey(chaos_cfg) if chaos_cfg else None,
        trace=bool(args.trace_out), sched=scheduler_config(args, buckets))
    fe = ClusterFrontend(hosts, FrontendConfig(
        retries=args.retries, backoff_base=args.backoff,
        request_timeout=args.timeout, drain_timeout=args.drain_timeout))
    n_stream = [0]
    if args.stream:
        def _tok(req, tok):
            if n_stream[0] < 12:
                print(f"  stream: req {req.rid} += {tok}")
            n_stream[0] += 1
        fe.on_token = _tok

    def cluster_summary():
        out: dict = {}
        for h in hosts:
            for k, v in h.telemetry.registry.summary()["counters"].items():
                out[k] = out.get(k, 0) + v
        return out

    stop_rep = start_metrics_reporter(cluster_summary, args.metrics_interval)
    t0 = time.time()
    done = fe.run(reqs)
    drained, clean = fe.drain()         # bounded graceful shutdown
    done += drained
    _sync(params)
    dt = time.time() - t0
    stop_rep.set()
    fe.close()
    if args.stream:
        print(f"  … streamed {n_stream[0]} tokens incrementally")
    st = fe.stats()
    print(f"frontend: {st['hosts']} host(s) "
          f"({st['healthy']} healthy, {st['suspect']} suspect, "
          f"{st['dead']} dead), {st['done']} done, "
          f"{st['failed']} failed, {st['rejected']} rejected, "
          f"{st['retries']} retries, "
          f"{st['deduped_tokens']} deduped tokens, "
          f"drain {'clean' if clean else 'cut stragglers'}")
    for h_st in st["per_host"]:
        print(f"  host {h_st['host']}: steps={h_st['steps']} "
              f"live_ranks={h_st.get('live_ranks', 0)}/"
              f"{h_st.get('ranks', 0)} "
              f"accepted={h_st.get('accepted', 0)} "
              f"requeued={h_st.get('requeued', 0)}")
    for klass, d in st["ttft"].items():
        print(f"  ttft {klass:12s}: n={d['count']} "
              f"p50={d['p50_ms']:.1f}ms p95={d['p95_ms']:.1f}ms")
    return done, dt, fe.write_trace, fe.prometheus


if __name__ == "__main__":
    main()
