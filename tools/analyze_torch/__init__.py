"""The port's static analysis suite: ``tools/analyze`` module for module,
over ``src/repro_torch`` (README, "PyTorch/H100 port", for its rule
catalog and baseline).

Six passes over the port's implicit contracts:

1. ``trace_safety`` — host syncs of device tensors reachable from the
   port functions that play the reference's jit roots (``ROOTS``)
2. ``shim``         — ``torch.distributed`` only through
   ``distribution/context.py`` (set-up in ``launch/mesh.py``)
3. ``recompile``    — the prefill bucket budget over the launch flags
4. ``concurrency``  — declared lock-protection map for the frontend
   and scheduler
5. ``packed``       — PackedSASPWeight/PackedFFN format invariants, on
   the containers' device
6. ``telemetry``    — stats keys must be declared in DECLARED_STATS

Run ``python -m tools.analyze_torch [--strict] [--baseline FILE]
[--device D]``. Also home to :mod:`tools.analyze_torch.pages`
(``check_page_refcounts``): the runtime invariants of the refcounted
paged KV pool, every block of a cut pool included.

Imports the standard library, numpy, torch and ``repro_torch``; never
``jax``, the reference package or ``tools.analyze``.
"""

from .rules import RULES, Rule, rules_for_pass, PASS_NAMES
from .common import Finding, load_baseline, write_baseline
from .pages import check_page_refcounts

__all__ = [
    "RULES", "Rule", "Finding", "PASS_NAMES", "rules_for_pass",
    "load_baseline", "write_baseline", "run_all",
    "check_page_refcounts",
]


def run_all(root=None, passes=None, device=None):
    """Run the requested passes (default: all); ``device`` is the packed
    pass's (default "cuda"). Returns findings."""
    from . import (concurrency, packed, recompile, shim,
                   telemetry, trace_safety)
    from .common import REPO_ROOT

    root = root or REPO_ROOT
    runs = {
        "trace_safety": lambda: trace_safety.run(root),
        "shim": lambda: shim.run(root),
        "recompile": lambda: recompile.run(root),
        "concurrency": lambda: concurrency.run(root),
        "packed": lambda: packed.run(root, device=device),
        "telemetry": lambda: telemetry.run(root),
    }
    out = []
    for name in (passes or PASS_NAMES):
        out.extend(runs[name]())
    return out
