"""Three-term roofline per (arch × shape × mesh) from the dry run (the
reference's ``analysis/roofline.py``), on the H100 model.

Sources:
  * FLOPs / HBM bytes — the analytic counters (``analysis.counters``),
    exactly as in the reference;
  * ``counted_flops`` — ``torch.utils.flop_counter.FlopCounterMode`` over
    the rank's fake-tensor trace (matmuls, einsums, convolutions of one
    rank), in place of the reference's ``xla_raw_flops`` (XLA's
    ``cost_analysis``); kept for reference, as there;
  * collective bytes — the rank's dry-mesh record (``analysis.comms``) ×
    chips (512 on the reference's (2, 16, 16) mesh), by kind and by axis
    ('pod' and 'pod,data' rows on a mesh of pods), every byte charged at
    the H100 model's one link rate (``NVLINK_BW``), as the reference
    charges ICI: no term for a slower link between pods;
  * per-device memory — ``LiveBytes``, the rank's live storages while the
    step is traced: the held state (params, optimizer state, inputs)
    plus every storage an op makes, freed when it dies;
  * ``fits_hbm`` against ``core.h100_model.HBM_BYTES``.
Every number is a prediction of the H100 model, not a measurement.
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from dataclasses import asdict, dataclass
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.comms import axis_bytes, collective_bytes
from repro_torch.analysis.counters import step_costs
from repro_torch.core.h100_model import HBM_BYTES, model_flops, roofline


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages alive on this rank while a step is traced:
    ``hold`` counts the state present before it (each storage once),
    then every storage an op returns is added when it first appears and
    subtracted when it dies (a ``weakref.finalize`` on the storage).
    ``peak`` is the most at any time, ``live`` the bytes now. Works on
    fake tensors: a fake storage reports the bytes the real one would
    have."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = set()

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key, n)

    def _drop(self, key, n: int) -> None:
        if key in self._seen:
            self._seen.discard(key)
            self.live -= n

    def hold(self, *trees) -> int:
        """Count the storages of ``trees`` as live; returns the bytes
        added."""
        before = self.live
        for t in tensors(trees):
            self._add(t)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._add(t)
        return out


def tensors(tree):
    """Every tensor in ``tree`` (dicts, tuples, lists, named tuples such
    as a ``QMoment``, dataclasses such as a ``BlockSparseWeight``)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from tensors(getattr(tree, f.name))


@dataclass
class CellReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                  # analytic, global per step
    bytes_hbm: float              # analytic, global per step
    bytes_coll: float             # dry record, global (= per-device × chips)
    coll_breakdown: Dict[str, int]
    coll_calls: Dict[str, int]
    peak_memory_per_device: int   # LiveBytes over the rank's trace
    held_memory_per_device: int   # params + optimizer state + inputs
    compute_s: float
    memory_s: float
    collective_s: float
    bound_s: float
    bottleneck: str
    model_flops: float            # 6·N_active·D (train) / 2·N·D (serve)
    useful_flops_frac: float      # MODEL_FLOPS / step FLOPs
    fits_hbm: bool
    counted_flops: float = 0.0    # FlopCounterMode over the rank's trace
    note: str = ""
    coll_axes: Dict[str, int] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


def analyze_traced(arch: str, shape, mesh_name: str, chips: int, cfg,
                   record, peak: int, held: int, counted_flops: float,
                   note: str = "", sparsity: float = 0.0,
                   weight_quant_bytes: int = 0) -> CellReport:
    """The counterpart of the reference's ``analyze_compiled``, on a
    traced rank: ``record`` its dry mesh's collectives, ``peak`` /
    ``held`` its ``LiveBytes``, ``counted_flops`` its FlopCounterMode
    total."""
    coll = collective_bytes(record)
    coll_global = float(sum(coll.values())) * chips
    costs = step_costs(cfg, shape, sparsity=sparsity,
                       weight_quant_bytes=weight_quant_bytes)
    terms = roofline(costs.flops, costs.bytes_hbm, coll_global, chips)
    mf = model_flops(cfg, shape)
    return CellReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops=costs.flops, bytes_hbm=costs.bytes_hbm,
        bytes_coll=coll_global,
        coll_breakdown={k: int(v) for k, v in coll.items()},
        coll_calls={k: sum(v["calls"] for v in axes.values())
                    for k, axes in record.items()},
        peak_memory_per_device=int(peak), held_memory_per_device=int(held),
        compute_s=terms.compute_s, memory_s=terms.memory_s,
        collective_s=terms.collective_s, bound_s=terms.bound_s,
        bottleneck=terms.bottleneck, model_flops=mf,
        useful_flops_frac=(mf / costs.flops) if costs.flops else 0.0,
        fits_hbm=peak <= HBM_BYTES, counted_flops=float(counted_flops),
        note=note, coll_axes=axis_bytes(record))


def format_row(r: CellReport) -> str:
    return (f"{r.arch:26s} {r.shape:12s} {r.mesh:8s} "
            f"cmp={r.compute_s*1e3:9.3f}ms mem={r.memory_s*1e3:9.3f}ms "
            f"col={r.collective_s*1e3:9.3f}ms [{r.bottleneck:10s}] "
            f"useful={min(r.useful_flops_frac, 9.99):5.1%} "
            f"peak={r.peak_memory_per_device/2**30:6.2f}GiB "
            f"fits={'Y' if r.fits_hbm else 'N'}")
