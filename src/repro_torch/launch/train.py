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
NaNs.

``--mesh DP,TP`` trains on a (data, model) mesh of DP x TP spawned
processes (``launch.mesh.run_ranks``; NCCL where every rank has a card,
gloo otherwise, host-staged where ranks share a card): each rank holds
its TP slices of the params, its ZeRO slices of the moments, and its
rows of every global batch (``train.train_step.make_mesh_train_step``);
checkpoints are the reference's format, written by world rank 0 one
gathered leaf at a time, and ``--resume`` reads each rank's slices back.
Every family trains on a mesh: a MoE layer's experts are split over
'data' (expert parallelism: each data rank draws and holds E / DP
experts, the tokens go to their experts' owners and back by all-to-alls
over 'data', each rank's aux the reference's per-shard one) and each
expert's d_ff over 'model'; an SSM's heads over 'model'.
``--mesh P,D,T`` adds a 'pod' axis: P pods of D x T ranks, the batch
split over the P x D DP ranks (pod-major), the gradients reduced over
'data' and then 'pod' (exactly, as the reference's GSPMD step), the
moments ZeRO-cut over 'data' only, so every pod holds and updates the
same slices; experts stay in EP over each pod's 'data' ranks, a replica
in every pod. ``--mesh single`` is the reference's (16, 16) mesh and
``--mesh multi`` its (2, 16, 16) (256 and 512 ranks, refused where they
are missing); the int8 TP reduction, experts that do not split over D
and an expert d_ff or SSM heads that do not split over T are refused
with the reason.

  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2,2 --reduce \\
      --sasp 0.5 --device cpu --steps 4 --ckpt-every 2 [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2,2,1 \\
      --reduce --device cpu --steps 4 --ckpt-every 2 [--resume]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
import tempfile
import time

import torch

from repro_torch.configs import SASPConfig, get_config, reduced
from repro_torch.core.sasp import build_sasp_overlay
from repro_torch.data.pipeline import DataConfig, DataState, Pipeline
from repro_torch.models import lm
from repro_torch.train.checkpoint import (CheckpointManager, restore_on_mesh,
                                         save_on_mesh)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         zero_adamw_init)
from repro_torch.train.schedule import (PreemptionHook, StragglerWatchdog,
                                        warmup_cosine)
from repro_torch.train.train_step import (make_mesh_train_step,
                                         make_train_step, mesh_layout,
                                         state_specs)

MESH_RS_AG = (
    "tp_comm='rs_ag_int8' rounds the TP reduction to int8 and has no "
    "backward in repro_torch: train with the exact all-reduce "
    "(tp_comm='ar')")


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
                    help="local (one process), DP,TP (a (data, model) "
                         "mesh of DP x TP spawned processes, e.g. 2,2), "
                         "P,D,T (a (pod, data, model) mesh, e.g. 2,2,1), "
                         "single (the reference's (16, 16)) or multi (its "
                         "(2, 16, 16))")
    ap.add_argument("--backend", choices=("auto", "nccl", "gloo"),
                    default="auto",
                    help="a mesh's transport: auto is nccl where every "
                         "rank has a card, else gloo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    args.mesh_shape = parse_mesh(args)
    return args


def model_config(args):
    cfg = get_config(args.arch)
    if args.reduce:
        cfg = reduced(cfg, layers=4, d_model=128, vocab=512)
    if args.sasp:
        cfg = dataclasses.replace(
            cfg, sasp=SASPConfig(enabled=True, block_k=32, block_n=32,
                                 sparsity=args.sasp))
    return cfg


def check_mesh_config(cfg, dp: int, tp: int) -> None:
    """Refuse, with the reason, what a training mesh cannot place: experts
    that do not split over ``dp`` data ranks, an expert d_ff or SSM heads
    that do not split over ``tp`` (``distribution.sharding.
    check_placement``), the int8 TP reduction, a d_ff or SASP tiles that
    do not split over ``tp`` (attention heads that do not split run on
    every model rank, ``distribution.sharding.heads_split``)."""
    from repro_torch.distribution.sharding import check_placement
    check_placement(cfg, tp, dp if cfg.moe is not None else 1)
    if cfg.tp_comm == "rs_ag_int8":
        raise ValueError(MESH_RS_AG)
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff {cfg.d_ff} does not split over {tp} model "
                         f"ranks")
    if cfg.sasp.enabled and (cfg.d_ff // tp) % cfg.sasp.block_n:
        raise ValueError(
            f"the {cfg.sasp.block_n}-wide SASP tiles of d_ff {cfg.d_ff} do "
            f"not split over {tp} model ranks: d_ff / tp = "
            f"{cfg.d_ff // tp} is not a multiple of the tile, so a tile "
            f"would straddle two model ranks")


def parse_mesh(args):
    """--mesh -> None (local) or (P, D, T) (P = 1 for DP,TP); the usage
    errors, with the reason: a placement or option a training mesh does
    not run, ``single`` or ``multi`` where its ranks are missing."""
    from repro_torch.launch.mesh import production_shape
    spec = args.mesh.strip()
    if spec == "local":
        return None
    if spec in ("single", "multi"):
        pod, dp, tp = production_shape(spec == "multi")
        have = (torch.cuda.device_count() if args.device.startswith("cuda")
                else os.cpu_count() or 1)
        what = "cards" if args.device.startswith("cuda") else "CPU cores"
        if have < pod * dp * tp:
            axes = (f"{pod} pod x " if pod > 1 else "") + \
                f"{dp} data x {tp} model"
            shape = (pod, dp, tp) if pod > 1 else (dp, tp)
            raise SystemExit(
                f"--mesh {spec} is the reference's {shape} mesh: it needs "
                f"{pod * dp * tp} ranks ({axes}), one a card (or a core on "
                f"the CPU); this machine has {have} {what}. Train with "
                f"--mesh DP,TP or P,D,T")
    else:
        m = re.fullmatch(r"(\d+)\s*,\s*(\d+)(?:\s*,\s*(\d+))?", spec)
        sizes = [int(g) for g in m.groups() if g is not None] if m else []
        if not m or min(sizes) < 1:
            raise SystemExit(f"--mesh expects local, single, multi or "
                             f"'DP,TP' (two positive integers, e.g. 2,2) or "
                             f"'P,D,T' (three, e.g. 2,2,1), got {spec!r}")
        pod, dp, tp = ([1] + sizes)[-3:]
    name = f"{pod},{dp},{tp}" if pod > 1 else f"{dp},{tp}"
    try:
        check_mesh_config(model_config(args), dp, tp)
    except ValueError as e:
        raise SystemExit(f"--mesh {name}: {e}")
    if args.batch % (pod * dp * args.microbatches):
        raise SystemExit(f"--batch {args.batch} does not split into "
                         f"{pod * dp} data ranks"
                         f"{f' ({pod} pods of {dp})' if pod > 1 else ''} of "
                         f"{args.microbatches} micro-batches")
    world = pod * dp * tp
    if (args.backend == "nccl" and world > (
            torch.cuda.device_count() if args.device.startswith("cuda")
            else 0)):
        raise SystemExit(f"--backend nccl needs a card per rank: {world} "
                         f"ranks, {torch.cuda.device_count()} cards")
    return pod, dp, tp


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.mesh_shape is not None:
        return train_mesh(args)
    cfg = model_config(args)

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


# ---------------------------------------------------------------------------
# --mesh DP,TP
# ---------------------------------------------------------------------------


def rank_params(cfg, layout, mesh, *, seed: int = 0, prepare=None):
    """This rank's slices of ``lm.init_params(cfg, seed=seed)``, drawn
    layer by layer (``lm.init_layer``: each layer from its own
    generators, only the data rank's experts of an expert stack split
    over 'data') and cut before the next is drawn, so no rank holds the
    whole tree; the embedding, final norm and head come whole from
    ``lm.init_top`` and are cut the same way (``layout.params``).
    ``prepare(path, leaf)``, where given, changes each whole leaf (a
    layer's, or a top leaf) before it is cut."""
    from repro_torch.core.pruning import map_leaves
    from repro_torch.distribution.sharding import take_slice
    device = mesh.device
    tp, r = mesh.shape["model"], mesh.model_rank
    experts = None
    if cfg.moe is not None and mesh.shape["data"] > 1:
        n = cfg.moe.num_experts // mesh.shape["data"]
        experts = (mesh.data_rank * n, (mesh.data_rank + 1) * n)

    def cut(prefix):
        def one(path, t):
            path = prefix + path
            if prepare is not None:
                t = prepare(path, t)
            return take_slice(t, layout.params[path], r, tp)
        return one
    params = map_leaves(cut(()), lm.init_top(cfg, seed=seed, device=device))
    segs = []
    for si, (_, repeat) in enumerate(lm.segment_plan(cfg)):
        layers = [map_leaves(cut(("segments", si)), lm.init_layer(
            cfg, si, i, seed=seed, device=device, experts=experts))
            for i in range(repeat)]
        segs.append(_stack(layers))
    params["segments"] = tuple(segs)
    return params


def _stack(trees):
    """One-layer trees -> their layer-stacked tree."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees)


def train_mesh(args) -> list:
    """--mesh DP,TP or P,D,T: spawn P x D x T processes
    (``launch.mesh.run_ranks``, a file store under the checkpoint
    directory), each ``train_rank``; return every rank's result."""
    from repro_torch.launch.mesh import init_file_in, run_ranks
    pod, dp, tp = args.mesh_shape
    spec = dict(mesh=(dp, tp), pod=pod, device=args.device,
                backend=None if args.backend == "auto" else args.backend,
                cfg=model_config(args), steps=args.steps, batch=args.batch,
                seq=args.seq, microbatches=args.microbatches, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                resume=args.resume)
    store = init_file_in(args.ckpt_dir,
                         f"mesh_store_{os.getpid()}_{time.time_ns()}")
    try:
        out = run_ranks(train_rank, pod * dp * tp, (spec, store),
                        timeout=86400)
    finally:
        if os.path.exists(store):
            os.remove(store)
    pods = f"{pod} pods x " if pod > 1 else ""
    print(f"mesh: {pod * dp * tp} processes ({pods}{dp} data x {tp} model "
          f"ranks) trained to step {out[0]['step']}")
    return out


def train_rank(rank: int, spec: dict, init_file: str) -> dict:
    """One process of ``--mesh DP,TP`` or ``P,D,T``: join the mesh, take
    its TP slices
    (drawn from seed 0, or its slices of the latest checkpoint with
    ``resume``) and ZeRO moments, build the SASP overlay on the mesh
    (``core.sasp.mesh_overlay``) and run the mesh train step on the
    pipeline's global batches; world rank 0 decides when to checkpoint
    (the watchdog's cadence, a preemption) and prints. Returns the
    losses and gradient norms of the steps it ran and its last step."""
    from repro_torch.core.sasp import mesh_overlay
    from repro_torch.distribution.sharding import local_config, tp_config
    from repro_torch.launch.mesh import make_mesh
    dp, tp = spec["mesh"]
    pod = spec.get("pod", 1)
    if spec["device"] == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // (pod * dp * tp)))
    mesh = make_mesh(dp, tp, pod=pod, rank=rank, init_file=init_file,
                     backend=spec["backend"], device=spec["device"])
    lead = mesh.rank == 0
    cfg = spec["cfg"]
    lcfg = local_config(tp_config(cfg, tp, ep=dp), tp)
    opt_cfg = AdamWConfig(lr=spec["lr"])
    layout = mesh_layout(cfg, dp, tp, opt_cfg, pod=pod)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                      global_batch=spec["batch"])
    pipe = Pipeline(dcfg, kind="lm")
    mgr = CheckpointManager(spec["ckpt_dir"], keep=3)
    hook, wd = PreemptionHook(), StragglerWatchdog()
    sched = warmup_cosine(min(30, spec["steps"] // 10 + 1), spec["steps"])

    params = rank_params(cfg, layout, mesh)
    opt = zero_adamw_init(params, layout.zero, opt_cfg, mesh)
    specs = state_specs(params, layout)
    start = 0
    if spec["resume"] and mgr.latest_step() is not None:
        with mgr.reader() as reader:
            state = restore_on_mesh(reader, {"params": params, "opt": opt},
                                    specs, mesh)
            extra = reader.extra
        params, opt = state["params"], state["opt"]
        pipe = Pipeline(dcfg, kind="lm", state=DataState.from_dict(extra))
        start = reader.step
        if lead:
            print(f"resumed from step {start} (each rank its slices)")
    overlay = None
    if cfg.sasp.enabled:
        overlay, got = mesh_overlay(params, cfg.sasp, mesh, layout.params)
        if lead:
            print(f"SASP masks: {got:.1%} sparsity (tile "
                  f"{cfg.sasp.block_k}x{cfg.sasp.block_n}), ranked over "
                  f"the whole tree")
    step_fn = make_mesh_train_step(lcfg, opt_cfg, mesh, layout,
                                   overlay=overlay, lr_schedule=sched,
                                   n_microbatches=spec["microbatches"])
    if lead:
        print(f"mesh: {mesh.shape} over {pod * dp * tp} processes, "
              f"transport {mesh.transport}", flush=True)
    losses, gnorms = [], []

    def save(step):
        save_on_mesh(mgr, step, {"params": params, "opt": opt}, specs,
                     mesh, extra=pipe.state.to_dict())

    for i in range(start, spec["steps"]):
        batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in pipe.next().items()}
        t0 = time.time()
        params, opt, m = step_fn(params, opt, batch)
        _sync(mesh.device)
        slow = wd.observe(time.time() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if lead and (i + 1) % 10 == 0:
            print(f"step {i+1:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f}{'  [SLOW]' if slow else ''}",
                  flush=True)
        # world rank 0's cadence and preemption, so every rank gathers
        flags = mesh.world_value(torch.tensor(
            [(i + 1) % wd.checkpoint_every(spec["ckpt_every"]) == 0,
             hook.requested], dtype=torch.int32, device=mesh.host_device))
        if bool(flags[0]) or bool(flags[1]):
            save(i + 1)
            if bool(flags[1]):
                if lead:
                    print("preemption requested: checkpointed, exiting")
                return dict(step=i + 1, losses=losses, grad_norms=gnorms)
    save(spec["steps"])
    if lead:
        print("done")
    return dict(step=spec["steps"], losses=losses, grad_norms=gnorms)


if __name__ == "__main__":
    main()
