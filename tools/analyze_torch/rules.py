"""Rule registry of the port's static analyzer (``tools/analyze_torch``).

Pure data, importable without torch: the README's rule catalog for the
port is held to ``RULES`` by ``tests/test_torch_analyze.py``.

The ids are the reference's (``tools/analyze/rules.py``), read in the
port's terms: a jit body becomes the port function that plays its part
(``trace_safety.ROOTS``), a host read of a traced value a host sync of a
device tensor, ``shard_map`` a ``torch.distributed`` collective. The
reference's JIT-CLOSURE and JIT-STATIC-UNHASHABLE have no subject in the
port, which wraps nothing in ``jax.jit``, ``torch.compile`` or
``torch.jit``: they are left out (``OMITTED``).

Severities: ``error`` findings fail ``--strict`` unless baselined;
``warning`` findings are printed but never fail the run.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Rule:
    rule_id: str
    severity: str          # "error" | "warning"
    pass_name: str         # which pass emits it
    summary: str


RULES: Dict[str, Rule] = {}


def _rule(rule_id: str, severity: str, pass_name: str, summary: str) -> str:
    RULES[rule_id] = Rule(rule_id, severity, pass_name, summary)
    return rule_id


# ---- pass 1: trace safety, read as host syncs ------------------------------
TRACE_BRANCH = _rule(
    "TRACE-BRANCH", "error", "trace_safety",
    "Python-level branch (if/while/assert/ternary/comprehension guard) on "
    "a device tensor inside a function reachable from a root: the host "
    "waits for the device to read the condition.")
TRACE_COERCE = _rule(
    "TRACE-COERCE", "error", "trace_safety",
    "Host read of a device tensor (bool()/int()/float()/range()/.item()/"
    ".tolist()/.cpu()/.numpy()/.to('cpu'), not/and/or, math.*) inside a "
    "function reachable from a root.")
TRACE_HOSTCALL = _rule(
    "TRACE-HOSTCALL", "error", "trace_safety",
    "Host call inside a function reachable from a root: "
    "torch.cuda.synchronize / .synchronize(), time.*, print or np.* of a "
    "device tensor.")

# ---- pass 2: shim enforcement ----------------------------------------------
SHIM_IMPORT = _rule(
    "SHIM-IMPORT", "error", "shim",
    "torch.distributed imported, or one of its collective or "
    "point-to-point ops called, outside distribution/context.py (process-"
    "group set-up and teardown only in launch/mesh.py).")

# ---- pass 3: recompile budget ------------------------------------------------
RECOMPILE_BUDGET = _rule(
    "RECOMPILE-BUDGET", "error", "recompile",
    "Distinct prefill/decode shape count for a launch flag configuration "
    "exceeds the documented bucket budget, or a predicted shape fails to "
    "trace under FakeTensorMode.")

# ---- pass 4: concurrency -----------------------------------------------------
LOCK_UNHELD = _rule(
    "LOCK-UNHELD", "error", "concurrency",
    "Shared attribute read/written on a path that does not hold its "
    "declared owning lock.")
LOCK_ORDER = _rule(
    "LOCK-ORDER", "error", "concurrency",
    "Lock acquisition order contradicts the declared hierarchy "
    "(potential deadlock between threads).")

# ---- pass 5: packed-format invariants ----------------------------------------
PACK_CONSERVE = _rule(
    "PACK-CONSERVE", "error", "packed",
    "Visit-count conservation violated: live visits lost, duplicated, "
    "or double-counted across shards / reshard round-trips.")
PACK_PAD = _rule(
    "PACK-PAD", "error", "packed",
    "nnz padding malformed: padding visits must be zero-valued "
    "dup-last-visit entries (PackedFFN: jv == -1) and visit lists "
    "must stay (n, k) n-major sorted with every output block visited.")
PACK_DTYPE = _rule(
    "PACK-DTYPE", "error", "packed",
    "Block-table (kn, col_ptr) or global-visit-index (jv) dtype is not "
    "int32, or scales/bias are not float32.")
PACK_KIND = _rule(
    "PACK-KIND", "error", "packed",
    "shard_kind inconsistency: shards>1 without col/row kind, row "
    "shard carrying a fused activation, bias shape not matching "
    "the declared sharding, or col_ptr not the CSR offsets of kn.")

# ---- pass 6: telemetry declaration discipline ---------------------------------
TELEMETRY_DECLARED = _rule(
    "TELEMETRY-DECLARED", "error", "telemetry",
    "stats[...] key written in src/repro_torch/serve/ but not declared "
    "in repro_torch.serve.telemetry.DECLARED_STATS.")

PASS_NAMES: Tuple[str, ...] = (
    "trace_safety", "shim", "recompile", "concurrency", "packed",
    "telemetry")

# The reference's rules with no subject in the port, with the reason.
OMITTED: Dict[str, str] = {
    "JIT-CLOSURE": "the port wraps nothing in jax.jit, torch.compile or "
                   "torch.jit, so no traced closure can bake self state",
    "JIT-STATIC-UNHASHABLE": "the port declares no static arguments of a "
                             "compiled function: there is no cache key "
                             "to hash",
}


def rules_for_pass(pass_name: str) -> Tuple[Rule, ...]:
    return tuple(r for r in RULES.values() if r.pass_name == pass_name)
