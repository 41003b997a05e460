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
         [--tp-comm rs_ag_int8]

``--multi-pod`` traces rank 0 of the reference's ``(2, 16, 16)`` mesh
over (pod, data, model), named ``2x16x16``, 512 chips: the batch split
over the 32 DP ranks, the gradients reduced over 'data' and then 'pod'
(the collective record's 'pod' and 'pod,data' rows), the params and
moments a rank holds those of the single-pod rank (no leaf is cut over
'pod'). Cells the port cannot trace are refused by name: a MoE or
hybrid family's train step where 'data' > 1 (``EP_TRACE``: the
expert-parallel path reads every data rank's routing counts on the
host). An SSM family's train step traces, on the
training layout (``train_step.mesh_layout``: in_xbc / conv whole on
every model rank). A serving
cell of a MoE arch keeps every expert on every data rank, each expert's
d_ff over 'model' (the port's layout of a ``--scheduler`` deployment):
the expert-parallel path (``distribution/moe_ep.py``) reads every data
rank's routing counts on the host, which a fake trace cannot, so the
reference's ``expert_col`` split of the experts over 'data' is not
traced and a MoE rank's memory is over-counted by the experts it would
not hold.
Where the batch does not split over the DP ranks (``long_500k``, B = 1)
every DP rank decodes the whole batch against the whole cache: the port
has no sequence-parallel cache (the reference's ``cache_shardings``
splits the cache's length over (data, model) there).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import traceback
from typing import Optional, Tuple

EP_TRACE = (
    "{}: a MoE layer's train step on a mesh with 'data' > 1 runs expert "
    "parallelism, whose every call reads all data ranks' routing counts "
    "on the host (distribution/moe_ep.py:178, _Infos: the mode, the "
    "capacity and the slot positions), which a fake-tensor trace cannot "
    "give: not traced (train it on real ranks, launch/train.py --mesh)")
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
               lr_schedule=None, pod: int = 1) -> dict:
    """Trace rank ``rank``'s step of ``shape`` on a dry ``(pod, dp, tp)``
    mesh under ``FakeTensorMode``. ``opt_cfg`` (train; default int8 moments,
    as the reference's dry run), ``overlay``: the SASP overlay of
    ``cfg.sasp`` built on the mesh first (``core.sasp.mesh_masks``; its
    collectives are not the step's), ``sasp`` / ``quantize``: BSR FFNs
    (``launch/sasp_abstract.py``). Returns {"record": the step's
    collectives, "held": bytes of params, optimizer state and overlay,
    "peak": the most live bytes, "counted_flops", "cfg": the traced
    config, "lcfg": the rank's}; raises the
    named refusal of a cell the port cannot run."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import LiveBytes
    from repro_torch.distribution.context import dry_mesh
    from repro_torch.launch import specs
    from repro_torch.launch.sasp_abstract import abstract_bsr_params
    from repro_torch.launch.train import check_mesh_config
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig

    train = shape.kind == "train"
    if train:
        check_mesh_config(cfg, dp, tp)
        if cfg.moe is not None and dp > 1:
            raise ValueError(EP_TRACE.format(cfg.name))
    mesh = dry_mesh(dp, tp, rank, pod=pod)
    with FakeTensorMode():
        whole = lm.init_params(cfg, device="cpu")
        if sasp > 0.0 or quantize:
            whole, cfg = abstract_bsr_params(whole, cfg, sasp,
                                             quantize=quantize,
                                             model_axis=tp)
        opt = layout = ov = None
        if train:
            opt_cfg = opt_cfg or AdamWConfig(quantized=True)
            params, lcfg, opt, layout, ov = _train_state(
                cfg, opt_cfg, mesh, whole, overlay)
        else:
            params, _, lcfg = specs.abstract_params(cfg, mesh, whole=whole)
        del whole
        inputs = specs.input_shardings(cfg, lcfg, shape, mesh,
                                       specs.input_specs(cfg, shape))
        step = specs.make_step_fn(lcfg, shape, mesh, layout, opt_cfg, ov,
                                  n_microbatches, lr_schedule)
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


def held_train_state(cfg, dp: int, tp: int, rank: int = 0, *,
                     pod: int = 1, opt_cfg=None, overlay: bool = False
                     ) -> int:
    """Bytes that rank ``rank`` of a dry ``(pod, dp, tp)`` mesh holds of
    ``cfg``'s training state (its params, ZeRO moments and, with
    ``overlay``, its SASP masks): what ``trace_step`` counts as held,
    without tracing the step, so that a cell whose step the dry run
    cannot trace (``EP_TRACE``) still has its state's size."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.roofline import LiveBytes
    from repro_torch.distribution.context import dry_mesh
    from repro_torch.models import lm
    from repro_torch.train.optimizer import AdamWConfig
    mesh = dry_mesh(dp, tp, rank, pod=pod)
    with FakeTensorMode():
        params, _, opt, _, ov = _train_state(
            cfg, opt_cfg or AdamWConfig(quantized=True), mesh,
            lm.init_params(cfg, device="cpu"), overlay)
        return LiveBytes().hold(params, opt, ov)


def _train_state(cfg, opt_cfg, mesh, whole, overlay: bool):
    """(params, the rank's config, ZeRO moments, the mesh layout, the
    SASP overlay or None) of a train cell's rank, from the whole tree
    ``whole`` (under the caller's fake mode)."""
    from repro_torch.core.sasp import masks_to_overlay, mesh_masks
    from repro_torch.launch import specs
    params, lcfg, opt, layout = specs.abstract_train_state(cfg, opt_cfg,
                                                           mesh, whole)
    ov = (masks_to_overlay(mesh_masks(params, cfg.sasp, mesh,
                                      layout.params)[0])
          if overlay else None)
    return params, lcfg, opt, layout, ov


def _tag(arch, shape_name, mesh_name, sasp, quant, mb, kv_quant,
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
             n_microbatches: int = 1, kv_quant: bool = False,
             tp_comm: str = "ar", out_dir: Optional[str] = None,
             verbose: bool = True, reduce: bool = False):
    """Trace one (arch × shape × mesh) cell; return its CellReport.
    ``mesh``: (DP, TP) or (P, DP, TP); ``multi_pod``: the reference's
    (2, 16, 16) instead. ``reduce``: the reduced config and the shape cut
    to ``REDUCED_SEQ`` tokens and ``REDUCED_BATCH`` rows (its kind
    kept; at least a row a DP rank)."""
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
                    pod=pod)
    t_trace = time.time() - t0
    tag, note = _tag(arch, shape_name, mesh_name, sasp_bsr_sparsity,
                     quant_weights, n_microbatches, kv_quant, tp_comm)
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
              f" over 'model' (prediction of the H100 model)", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w",
                  encoding="utf-8") as f:
            f.write(rep.to_json())
    return rep


def run_all(out_dir: Optional[str], archs=None,
            mesh: Tuple[int, ...] = PRODUCTION_MESH, reduce: bool = False,
            verbose: bool = True, multi_pod: bool = False):
    """Every assigned arch × its shape cells; a cell that raises is
    collected as a failure (with the refusal's message), as the
    reference's ``run_all`` does. Returns (reports, failures)."""
    from repro_torch.configs import (ASSIGNED_ARCHS, get_config, shapes_for,
                                     skipped_shapes_for)
    reports, failures = [], []
    for arch in archs or ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for sh in shapes_for(cfg):
            try:
                reports.append(run_cell(arch, sh.name, mesh=mesh,
                                        multi_pod=multi_pod,
                                        out_dir=out_dir, reduce=reduce,
                                        verbose=verbose))
            except Exception as e:   # a failed cell ends the cell only
                if not refused(e):
                    traceback.print_exc()
                failures.append((arch, sh.name, repr(e)))
        for sk in skipped_shapes_for(cfg):
            if verbose:
                print(f"{arch:26s} {sk:12s} SKIP (full-attention arch)",
                      flush=True)
    print(f"\n{len(reports)} cells traced, {len(failures)} failures "
          f"({sum(refused(f[2]) for f in failures)} named refusals)")
    for f in failures:
        print("FAIL:", f)
    return reports, failures


def refused(err) -> bool:
    """Is this failure one of the port's named refusals (a MoE train cell
    on a mesh with 'data' > 1, ``EP_TRACE``)?"""
    return "routing counts on the host" in str(err)


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
    ap.add_argument("--kvquant", action="store_true")
    ap.add_argument("--tp-comm", default="ar")
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if args.all:
        _, failures = run_all(args.out, mesh=mesh, multi_pod=args.multi_pod)
        return 1 if any(not refused(f[2]) for f in failures) else 0
    if not args.arch:
        raise SystemExit("--arch is required (or --all)")
    kw = dict(mesh=mesh, multi_pod=args.multi_pod,
              sasp_bsr_sparsity=args.sasp,
              remat=args.remat, quant_weights=args.quant,
              n_microbatches=args.microbatches, kv_quant=args.kvquant,
              tp_comm=args.tp_comm, out_dir=args.out)
    if args.all_shapes:
        from repro_torch.configs import get_config, shapes_for
        for sh in shapes_for(get_config(args.arch)):
            run_cell(args.arch, sh.name, **kw)
        return 0
    if not args.shape:
        raise SystemExit("--shape is required (or --all-shapes)")
    try:
        run_cell(args.arch, args.shape, **kw)
    except ValueError as e:
        if refused(e):
            raise SystemExit(str(e))
        raise
    return 0


if __name__ == "__main__":
    sys.exit(main())
