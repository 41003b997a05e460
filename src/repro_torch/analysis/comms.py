"""Collective-byte accounting from a mesh's record (the counterpart of the
reference's ``analysis/hlo.py``, which parses the compiled HLO text).

A ``distribution.context.Mesh`` records every collective it runs, and a
``DryMesh`` records the same calls without communicating:
``{kind: {axis: {"calls": n, "bytes": b}}}``, the bytes those of the
result on the rank (the reference's parser reads each op's result shape
the same way); on a mesh of pods the axes include 'pod' and the DP axes
'pod,data' (``axis_bytes``). The reference needs ``split_computations`` and
``_trip_count`` because XLA's CPU backend reports a ``while`` body once;
a mesh records every call as it runs, so nothing is counted once for
many trips. It needs ``cpu_f32_upcast_bytes`` and
``collective_f32_twin_bytes`` to undo the CPU backend's f32 copies of
bf16 buffers; the port's trace runs in the compute type and records
each collective in the type it moves, so there is no such artefact to
subtract. Those four have no counterpart here.
"""
from __future__ import annotations

from typing import Dict

Record = Dict[str, Dict[str, Dict[str, int]]]


def collective_bytes(record: Record) -> Dict[str, int]:
    """Bytes by kind (every axis), per rank."""
    return {kind: sum(v["bytes"] for v in axes.values())
            for kind, axes in record.items()}


def axis_bytes(record: Record) -> Dict[str, int]:
    """Bytes by axis ('model', 'data', 'pod', 'pod,data', 'world'; every
    kind), per rank."""
    out: Dict[str, int] = {}
    for axes in record.values():
        for axis, v in axes.items():
            out[axis] = out.get(axis, 0) + v["bytes"]
    return out


def total_collective_bytes(record: Record) -> int:
    return sum(collective_bytes(record).values())


def count_ops(record: Record, *names: str) -> Dict[str, int]:
    """Calls of each named kind (every axis)."""
    return {n: sum(v["calls"] for v in record.get(n, {}).values())
            for n in names}
