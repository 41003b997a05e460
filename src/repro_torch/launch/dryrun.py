"""Dry run: trace one rank of every (architecture × input shape) cell on
the production mesh, with no card and no allocation, and report its
memory, collectives and roofline on the H100 model (the reference's
``launch/dryrun.py``, which lowers and compiles each cell with XLA).

One rank's step is traced under ``FakeTensorMode`` on a ``DryMesh``
(``distribution/context.py``): the params, optimizer state and inputs
are fake CPU tensors of the rank's shapes (``launch/specs.py``), every
collective records its calls and bytes and returns zeros of its result's
shape, and the plain PyTorch version of every kernel runs (a wrapper
launches CUDA only for a CUDA tensor), so the kernels' workspaces are not
counted. ``analysis/roofline.py`` turns the trace into a ``CellReport``:
analytic FLOPs and HBM bytes (``analysis/counters.py``), the record ×
chips, the rank's peak live bytes (``LiveBytes``), FlopCounterMode's
count. Every number is a prediction of the H100 model.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--out DIR]
  python -m repro_torch.launch.dryrun --arch jamba-1.5-large-398b --all-shapes
  flags: [--mesh DP,TP | P,D,T] (default 16,16) [--multi-pod] [--sasp S]
         [--quant] [--remat R] [--microbatches K] [--kvquant]
         [--tp-comm rs_ag_int8] [--profile tp|dp_only]

What is traced, as the reference compiles it:

* **Train cells** of every family: ``train_step.make_mesh_train_step``
  on the training layout (``train_step.mesh_layout``: an SSM's in_xbc /
  conv whole on every model rank; a MoE's expert stacks cut over 'data',
  each expert's d_ff over 'model'). The step declares even rows, so its
  MoE layers run expert parallelism with no host read
  (``distribution/moe_ep.py``): mode and capacity from the rank's shape,
  the aux averaged by a device all-gather, two all-to-alls over 'data'
  a layer (and their backward).
* **Serving cells** (prefill, decode): the rank's rows where the batch
  splits over the DP ranks; a MoE cell there cuts its experts over
  'data' and declares even rows (``specs.serve_ep``), as the reference
  runs ``moe_ffn_ep``. Where the batch does not split (``long_500k``, B =
  1) every DP rank decodes the whole batch under the reference's
  long-context layout (``cache_shardings``): each ring's capacity cut
  over (data, model) where it divides, a rank holding its block and the
  softmax combined over the blocks (an all-reduce max and two ordered
  all-gather sums a layer, recorded under 'data,model' or 'data'), and
  a MoE's experts cut over 'data' with the step declaring replicated
  rows (one ordered sum over 'data' a MoE layer).
* ``--multi-pod``: rank 0 of the reference's ``(2, 16, 16)`` mesh over
  (pod, data, model), named ``2x16x16``, 512 chips: the batch split over
  the 32 DP ranks, the gradients reduced over 'data' and then 'pod' (the
  record's 'pod' and 'pod,data' rows), a rank's params and moments
  those of the single-pod rank (no leaf is cut over 'pod'); experts in
  EP inside a pod.
* ``--profile dp_only`` (tag ``_dp_only``): the reference's small-model
  profile. Every process is a DP rank holding the whole tree; the batch
  splits over every axis; MoE runs ``moe_ffn_dp`` (each rank's own
  experts, the aux averaged over every axis: the record's 'data,model'
  row); the gradients are reduced over 'data' and then 'model'; the
  AdamW moments are cut over 'data' only, replicated over 'model'.

``main`` and ``run_all`` fail on any failed cell, as the reference's do.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import traceback
from typing import Optional, Tuple

# the reference's production mesh (repro/launch/mesh.py), (16, 16); with
# --multi-pod (2, 16, 16) (``launch.mesh.production_shape``)
PRODUCTION_MESH = (16, 16)
# a reduced cell (tests): the shape cut to this many tokens and rows
REDUCED_SEQ, REDUCED_BATCH = 128, 8


def cell_config(arch: str, *, remat: str = "full", kv_quant: bool = False,
                tp_comm: str = "ar", reduce: bool = False):
    """The cell's config as the reference's dry run builds it: bf16
    params and compute, the vocab padded to a multiple of 2048 (a real
    deployment pads the embedding so that it shards), ``reduce``: the
    family-preserving reduced config (tests)."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    vpad = -(-cfg.vocab_size // 2048) * 2048
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16", remat=remat,
                               vocab_size=vpad, kv_quant=kv_quant,
                               tp_comm=tp_comm)


def trace_step(cfg, shape, dp: int, tp: int, rank: int = 0, *,
               opt_cfg=None, overlay: bool = False, n_microbatches: int = 1,
               sasp: float = 0.0, quantize: bool = False,
               lr_schedule=None, pod: int = 1, profile: str = "tp") -> dict:
    """Trace rank ``rank``'s step of ``shape`` on a dry ``(pod, dp, tp)``
    mesh under ``FakeTensorMode``. ``opt_cfg`` (train; default int8 moments,
    as the reference's dry run), ``overlay``: the SASP overlay of
    ``cfg.sasp`` built on the mesh first (``core.sasp.mesh_masks``; its
    collectives are not the step's), ``sasp`` / ``quantize``: BSR FFNs
    (``launch/sasp_abstract.py``); ``profile``: "tp" or "dp_only" (every
    rank a DP rank of the whole tree). Returns {"record": the step's
    collectives, "held": bytes of params, optimizer state and overlay,
    "peak": the most live bytes, "counted_flops", "cfg": the traced
    config, "lcfg": the rank's}; raises the reason of a cell the port
    cannot place."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import LiveBytes
    from repro_torch.distribution.context import dry_mesh
    from repro_torch.launch import specs
    from repro_torch.launch.sasp_abstract import abstract_bsr_params
    from repro_torch.launch.train import check_mesh_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig

    train, dp_only = shape.kind == "train", profile == "dp_only"
    if train and not dp_only:
        check_mesh_config(cfg, dp, tp)
    mesh = dry_mesh(dp, tp, rank, pod=pod)
    view = mesh.flat() if dp_only else mesh
    with FakeTensorMode():
        whole = lm.init_params(cfg, device="cpu")
        if sasp > 0.0 or quantize:
            whole, cfg = abstract_bsr_params(whole, cfg, sasp,
                                             quantize=quantize,
                                             model_axis=view.shape["model"])
        opt = layout = ov = None
        if train:
            opt_cfg = opt_cfg or AdamWConfig(quantized=True)
            params, lcfg, opt, layout, ov = _train_state(
                cfg, opt_cfg, mesh, whole, overlay, profile)
        else:
            params, _, lcfg = specs.abstract_params(
                cfg, view, ep=specs.serve_ep(cfg, shape, view), whole=whole)
            lcfg = specs.serve_config(lcfg, shape, view)
        del whole
        inputs = specs.input_shardings(cfg, lcfg, shape, view,
                                       specs.input_specs(cfg, shape))
        step = specs.make_step_fn(lcfg, shape, mesh if train else view,
                                  layout, opt_cfg, ov, n_microbatches,
                                  lr_schedule)
        live = LiveBytes()
        held = live.hold(params, opt, ov)
        live.hold(inputs)
        mesh.reset_record()
        with live, FlopCounterMode(display=False) as fc:
            if train:
                step(params, opt, inputs)
            else:
                step(params, inputs)
        counted = fc.get_total_flops()
    return dict(record=mesh.record(), held=held, peak=live.peak,
                counted_flops=counted, cfg=cfg, lcfg=lcfg)


def _train_state(cfg, opt_cfg, mesh, whole, overlay: bool, profile: str):
    """(params, the rank's config, ZeRO moments, the mesh layout, the
    SASP overlay or None) of a train cell's rank, from the whole tree
    ``whole`` (under the caller's fake mode)."""
    from repro_torch.core.sasp import masks_to_overlay, mesh_masks
    from repro_torch.launch import specs
    params, lcfg, opt, layout = specs.abstract_train_state(
        cfg, opt_cfg, mesh, whole, profile)
    ov = (masks_to_overlay(mesh_masks(params, cfg.sasp, mesh,
                                      layout.params)[0])
          if overlay else None)
    return params, lcfg, opt, layout, ov


def _tag(arch, shape_name, mesh_name, sasp, quant, mb, profile, kv_quant,
         tp_comm) -> Tuple[str, str]:
    """(the JSON file's tag, the report's note), as the reference tags
    its cells."""
    tag, notes = f"{arch}_{shape_name}_{mesh_name}", []
    if sasp:
        tag += f"_sasp{int(sasp * 100)}"
        notes.append(f"sasp_bsr={sasp}")
    if quant:
        tag += "_int8"
        notes.append("int8")
    if mb > 1:
        tag += f"_mb{mb}"
        notes.append(f"mb={mb}")
    if profile != "tp":
        tag += f"_{profile}"
        notes.append(profile)
    if kv_quant:
        tag += "_kv8"
        notes.append("kv8")
    if tp_comm != "ar":
        tag += f"_{tp_comm}"
        notes.append(tp_comm)
    return tag, ";".join(notes)


def run_cell(arch: str, shape_name: str, *,
             mesh: Tuple[int, int] = PRODUCTION_MESH,
             multi_pod: bool = False, sasp_bsr_sparsity: float = 0.0,
             remat: str = "full", quant_weights: bool = False,
             n_microbatches: int = 1, profile: str = "tp",
             kv_quant: bool = False, tp_comm: str = "ar",
             out_dir: Optional[str] = None, verbose: bool = True,
             reduce: bool = False):
    """Trace one (arch × shape × mesh) cell; return its CellReport.
    ``mesh``: (DP, TP) or (P, DP, TP); ``multi_pod``: the reference's
    (2, 16, 16) instead; ``profile``: "tp" or "dp_only". ``reduce``: the
    reduced config and the shape cut to ``REDUCED_SEQ`` tokens and
    ``REDUCED_BATCH`` rows (its kind kept; at least a row a DP rank)."""
    from repro_torch.analysis.roofline import analyze_traced, format_row
    from repro_torch.configs import get_shape
    from repro_torch.launch.mesh import production_shape
    if multi_pod:
        mesh = production_shape(True)
    cfg = cell_config(arch, remat=remat, kv_quant=kv_quant,
                      tp_comm=tp_comm, reduce=reduce)
    shape = get_shape(shape_name)
    pod, dp, tp = ((1,) + tuple(mesh))[-3:]
    if reduce:                      # (at least a row a DP rank)
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, REDUCED_SEQ),
            global_batch=min(shape.global_batch,
                             max(REDUCED_BATCH, pod * dp)))
    mesh_name = "x".join(str(n) for n in mesh)
    t0 = time.time()
    tr = trace_step(cfg, shape, dp, tp, sasp=sasp_bsr_sparsity,
                    quantize=quant_weights, n_microbatches=n_microbatches,
                    pod=pod, profile=profile)
    t_trace = time.time() - t0
    tag, note = _tag(arch, shape_name, mesh_name, sasp_bsr_sparsity,
                     quant_weights, n_microbatches, profile, kv_quant,
                     tp_comm)
    rep = analyze_traced(arch, shape, mesh_name, pod * dp * tp, tr["cfg"],
                         tr["record"], tr["peak"], tr["held"],
                         tr["counted_flops"], note=note,
                         sparsity=sasp_bsr_sparsity,
                         weight_quant_bytes=1 if quant_weights else 0)
    if verbose:
        print(format_row(rep) + f"  trace={t_trace:.1f}s", flush=True)
        print(f"    rank 0: held={rep.held_memory_per_device/2**30:.2f}"
              f"GiB counted={rep.counted_flops:.3e} FLOP; collectives "
              f"{rep.coll_calls} calls, {rep.coll_breakdown} B, by axis "
              f"{rep.coll_axes} B; heads "
              f"{'replicated' if tr['lcfg'].heads_replicated else 'split'}"
              f" over 'model'; experts in {tr['lcfg'].ep_shards} EP "
              f"shard(s); rings cut over (data, model) "
              f"{tr['lcfg'].seq_mesh if tr['lcfg'].seq_cache_len else 'no'}"
              f" (prediction of the H100 model)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w",
                  encoding="utf-8") as f:
            f.write(rep.to_json())
    return rep


def run_all(out_dir: Optional[str], archs=None,
            mesh: Tuple[int, ...] = PRODUCTION_MESH, reduce: bool = False,
            verbose: bool = True, multi_pod: bool = False,
            profile: str = "tp"):
    """Every assigned arch × its shape cells; a cell that raises is
    collected as a failure (its traceback printed), as the reference's
    ``run_all`` does. Returns (reports, failures)."""
    from repro_torch.configs import (ASSIGNED_ARCHS, get_config, shapes_for,
                                     skipped_shapes_for)
    reports, failures = [], []
    for arch in archs or ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for sh in shapes_for(cfg):
            try:
                reports.append(run_cell(arch, sh.name, mesh=mesh,
                                        multi_pod=multi_pod,
                                        profile=profile, out_dir=out_dir,
                                        reduce=reduce, verbose=verbose))
            except Exception as e:   # a failed cell ends the cell only
                traceback.print_exc()
                failures.append((arch, sh.name, repr(e)))
        for sk in skipped_shapes_for(cfg):
            if verbose:
                print(f"{arch:26s} {sk:12s} SKIP (full-attention arch)",
                      flush=True)
    print(f"\n{len(reports)} cells traced, {len(failures)} failures")
    for f in failures:
        print("FAIL:", f)
    return reports, failures


def parse_mesh(spec: str) -> Tuple[int, ...]:
    try:
        sizes = tuple(int(x) for x in spec.split(","))
    except ValueError:
        sizes = ()
    if len(sizes) not in (2, 3):
        raise SystemExit(f"--mesh {spec!r}: expects 'DP,TP' or 'P,DP,TP'")
    if min(sizes) < 1:
        raise SystemExit(f"--mesh {spec!r}: sizes must be positive")
    return sizes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--all-shapes", action="store_true")
    ap.add_argument("--mesh", default="16,16")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sasp", type=float, default=0.0,
                    help="SASP BSR sparsity variant")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant", action="store_true")
    ap.add_argument("--profile", default="tp", choices=("tp", "dp_only"))
    ap.add_argument("--kvquant", action="store_true")
    ap.add_argument("--tp-comm", default="ar")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if args.all:
        _, failures = run_all(args.out, mesh=mesh, multi_pod=args.multi_pod,
                              profile=args.profile)
        return 1 if failures else 0
    if not args.arch:
        raise SystemExit("--arch is required (or --all)")
    kw = dict(mesh=mesh, multi_pod=args.multi_pod,
              sasp_bsr_sparsity=args.sasp,
              remat=args.remat, quant_weights=args.quant,
              n_microbatches=args.microbatches, profile=args.profile,
              kv_quant=args.kvquant, tp_comm=args.tp_comm, out_dir=args.out)
    if args.all_shapes:
        from repro_torch.configs import get_config, shapes_for
        for sh in shapes_for(get_config(args.arch)):
            run_cell(args.arch, sh.name, **kw)
        return 0
    if not args.shape:
        raise SystemExit("--shape is required (or --all-shapes)")
    run_cell(args.arch, args.shape, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
