"""Pass 4 — concurrency lint for the port's threaded serving layer.

The port's copy of ``tools/analyze/concurrency.py``: a declared
lock-protection map (attribute -> owning lock) for
``src/repro_torch/serve/frontend.py`` and ``serve/scheduler.py``, whose
``ClusterFrontend`` and ``ShardedScheduler`` hold the reference's
``threading.RLock`` over the same attributes, drives two checks:

* **LOCK-UNHELD** — a read/write of a protected shared attribute on a
  path that does not hold the owning lock. "Holds" is computed
  lexically (inside ``with self._lock:``) plus a fixpoint over the
  intra-class call graph: an internal method inherits the lock when
  EVERY call site (transitively) holds it; methods reachable from
  outside the class (declared ``entry_points``, or never called
  intra-class) must guard their own accesses. ``__init__`` is exempt
  (the object is not shared yet), and nested functions and lambdas are
  read as not holding the lock (a callback may run on any thread).
  Cross-object accesses (``self.sched.failed`` from the frontend) are
  flagged unless made through an owner method.

* **LOCK-ORDER** — collects ordered (held -> acquired) lock pairs
  across the heartbeat, reader-thread and drain paths (including
  cross-class edges like frontend.step -> scheduler.step) and reports
  any pair contradicting the declared hierarchy, or A->B and B->A both
  observed when no hierarchy is declared.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Set, Tuple

from .common import Finding, Module, REPO_ROOT
from .rules import LOCK_ORDER, LOCK_UNHELD

# ---------------------------------------------------------------------------
# declared lock-protection map for the port's threaded serving layer
# ---------------------------------------------------------------------------
# Per file, per class:
#   lock         -- attribute name of the owning threading.(R)Lock
#   protected    -- attributes that must only be touched under the lock
#   entry_points -- methods callable from outside the class (or from
#                   other threads); these must guard their own accesses
#   attr_classes -- local attribute -> (file, class) of a foreign object
#                   whose protected attributes must not be poked directly
REPO_LOCK_SPECS: Dict[str, Dict[str, Dict]] = {
    "src/repro_torch/serve/frontend.py": {
        "ClusterFrontend": {
            "lock": "_lock",
            "protected": {
                "trackers", "done", "failed", "rejected", "draining",
                "n_retries", "n_deduped", "_health",
            },
            "entry_points": {
                "submit", "step", "run", "drain", "revive_host",
                "stats", "unresolved", "close", "_local_sink",
            },
        },
        "LocalHost": {
            "attr_classes": {
                "sched": ("src/repro_torch/serve/scheduler.py",
                          "ShardedScheduler"),
            },
        },
    },
    "src/repro_torch/serve/scheduler.py": {
        "ShardedScheduler": {
            "lock": "_lock",
            # the reference's attributes, and two the port adds for a
            # scheduler on a mesh (``_step_mesh``): every submitted
            # request by rid, and the tokens its engine emitted in the
            # step
            "protected": {
                "n_submitted", "n_accepted", "n_shed", "n_revived",
                "n_requeued", "rejected", "failed", "prompt_hist",
                "_by_rid", "_emitted",
            },
            "entry_points": {
                "submit", "step", "revive_rank", "stats", "cancel",
                "drain_failed", "retract_request",
                "prompt_length_histogram",
            },
        },
    },
}

# Declared global acquisition hierarchy: a lock may only be acquired
# while holding locks that appear EARLIER in this list.
REPO_LOCK_ORDER: List[str] = [
    "ClusterFrontend._lock",
    "ShardedScheduler._lock",
]


class _MethodScan(ast.NodeVisitor):
    """Walk one method body tracking the lexically-held lock set."""

    def __init__(self, lock_name: Optional[str], cls_label: str,
                 attr_classes: Dict[str, Tuple[str, str]],
                 specs_by_file: Dict[str, Dict[str, Dict]]):
        self.lock_name = lock_name
        self.cls_label = cls_label
        self.attr_classes = attr_classes
        self.specs_by_file = specs_by_file
        self.held: Set[str] = set()
        # (attr, lineno, held_own_lock)
        self.accesses: List[Tuple[str, int, bool]] = []
        # (method_name, lineno, held_own_lock)
        self.self_calls: List[Tuple[str, int, bool]] = []
        # (held_lock_label, acquired_lock_label, lineno)
        self.acquire_edges: List[Tuple[str, str, int]] = []
        # foreign accesses: (target_file, target_cls, attr, lineno, guarded)
        self.foreign: List[Tuple[str, str, str, int, bool]] = []
        # cross-class method calls: (target_file, target_cls, method,
        #                            lineno, held_set)
        self.foreign_calls: List[Tuple[str, str, str, int,
                                       Tuple[str, ...]]] = []
        # every lock label this method body acquires anywhere
        self.acquired_any: Set[str] = set()

    # -- helpers ------------------------------------------------------------

    def _own_label(self) -> str:
        return "%s.%s" % (self.cls_label, self.lock_name)

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        """Label if ``expr`` is self.<lock> or self.<attr>.<foreignlock>."""
        if not isinstance(expr, ast.Attribute):
            return None
        base = expr.value
        if (isinstance(base, ast.Name) and base.id == "self"
                and expr.attr == self.lock_name):
            return self._own_label()
        if (isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and base.attr in self.attr_classes):
            tfile, tcls = self.attr_classes[base.attr]
            tspec = self.specs_by_file.get(tfile, {}).get(tcls, {})
            if expr.attr == tspec.get("lock"):
                return "%s.%s" % (tcls, expr.attr)
        return None

    # -- visitors -----------------------------------------------------------

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            label = self._lock_of(item.context_expr)
            if label is not None:
                for h in self.held:
                    if h != label:
                        self.acquire_edges.append(
                            (h, label, node.lineno))
                acquired.append(label)
                self.acquired_any.add(label)
        for item in node.items:
            if self._lock_of(item.context_expr) is None:
                self.visit(item.context_expr)
        self.held.update(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(acquired)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        base = node.value
        if isinstance(base, ast.Name) and base.id == "self":
            self.accesses.append(
                (node.attr, node.lineno, self._own_label() in self.held
                 or self.lock_name is None))
        elif (isinstance(base, ast.Attribute)
              and isinstance(base.value, ast.Name)
              and base.value.id == "self"
              and base.attr in self.attr_classes):
            tfile, tcls = self.attr_classes[base.attr]
            tspec = self.specs_by_file.get(tfile, {}).get(tcls, {})
            flabel = "%s.%s" % (tcls, tspec.get("lock"))
            self.foreign.append(
                (tfile, tcls, node.attr, node.lineno,
                 flabel in self.held))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "self"):
            self.self_calls.append(
                (fn.attr, node.lineno, self._own_label() in self.held))
        elif (isinstance(fn, ast.Attribute)
              and isinstance(fn.value, ast.Attribute)
              and isinstance(fn.value.value, ast.Name)
              and fn.value.value.id == "self"
              and fn.value.attr in self.attr_classes):
            tfile, tcls = self.attr_classes[fn.value.attr]
            self.foreign_calls.append(
                (tfile, tcls, fn.attr, node.lineno,
                 tuple(sorted(self.held))))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested defs (callbacks) inherit the lexical held set only if
        # called inline; be conservative: treat as NOT holding the lock
        saved = set(self.held)
        self.held = set()
        for stmt in node.body:
            self.visit(stmt)
        self.held = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved = set(self.held)
        self.held = set()
        self.visit(node.body)
        self.held = saved


def _scan_class(mod: Module, cls_name: str, spec: Dict,
                specs_by_file: Dict[str, Dict[str, Dict]]):
    """Per-method scan results for one class."""
    methods = mod.classes.get(cls_name, {})
    out: Dict[str, _MethodScan] = {}
    for mname, mnode in methods.items():
        sc = _MethodScan(spec.get("lock"), cls_name,
                         spec.get("attr_classes", {}), specs_by_file)
        for stmt in mnode.body:
            sc.visit(stmt)
        out[mname] = sc
    return out


def _entry_held_fixpoint(scans: Dict[str, "_MethodScan"],
                         entry_points: Set[str]) -> Dict[str, bool]:
    """entry_held[m]: is the class lock guaranteed held on every path
    that can enter m?  Entry points and never-called methods: False."""
    called_from: Dict[str, List[Tuple[str, bool]]] = {}
    for caller, sc in scans.items():
        for callee, _line, held in sc.self_calls:
            if callee in scans:
                called_from.setdefault(callee, []).append((caller, held))

    entry_held = {m: (m not in entry_points and m in called_from
                      and m != "__init__")
                  for m in scans}
    changed = True
    while changed:
        changed = False
        for m in scans:
            if not entry_held[m]:
                continue
            ok = all(held or entry_held[caller]
                     for caller, held in called_from.get(m, []))
            if not ok:
                entry_held[m] = False
                changed = True
    return entry_held


def run(root: str = REPO_ROOT,
        specs: Optional[Dict[str, Dict[str, Dict]]] = None,
        lock_order: Optional[List[str]] = None) -> List[Finding]:
    specs = REPO_LOCK_SPECS if specs is None else specs
    lock_order = REPO_LOCK_ORDER if lock_order is None else lock_order
    findings: List[Finding] = []
    edges: List[Tuple[str, str, str, int]] = []   # (rel, held, acq, line)

    all_scans: Dict[Tuple[str, str], Dict[str, _MethodScan]] = {}
    mods: Dict[str, Module] = {}
    for rel, classes in specs.items():
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        mod = Module(path, root)
        mods[rel] = mod
        for cls_name, spec in classes.items():
            all_scans[(rel, cls_name)] = _scan_class(
                mod, cls_name, spec, specs)

    for (rel, cls_name), scans in all_scans.items():
        spec = specs[rel][cls_name]
        protected: Set[str] = set(spec.get("protected", ()))
        entry_points: Set[str] = set(spec.get("entry_points", ()))
        entry_held = _entry_held_fixpoint(scans, entry_points)

        for mname, sc in scans.items():
            if mname == "__init__":
                continue
            guarded = entry_held.get(mname, False)
            if protected and spec.get("lock"):
                for attr, line, held in sc.accesses:
                    if attr in protected and not (held or guarded):
                        findings.append(Finding(
                            LOCK_UNHELD, rel, line,
                            "%s.%s touches shared attribute '%s' "
                            "without holding %s.%s"
                            % (cls_name, mname, attr, cls_name,
                               spec["lock"])))
            # cross-object pokes at another class's protected state
            for tfile, tcls, attr, line, fheld in sc.foreign:
                tspec = specs.get(tfile, {}).get(tcls, {})
                if attr in tspec.get("protected", ()) and not fheld:
                    findings.append(Finding(
                        LOCK_UNHELD, rel, line,
                        "%s.%s touches %s.%s directly — use an owner "
                        "method that holds %s.%s"
                        % (cls_name, mname, tcls, attr, tcls,
                           tspec.get("lock"))))
            # lock-order edges: lexical acquires...
            for held, acq, line in sc.acquire_edges:
                edges.append((rel, held, acq, line))
            # ...and cross-class calls made while holding our lock into
            # methods that acquire the foreign lock
            own = "%s.%s" % (cls_name, spec.get("lock")) \
                if spec.get("lock") else None
            for tfile, tcls, meth, line, held_set in sc.foreign_calls:
                tspec = specs.get(tfile, {}).get(tcls, {})
                tlock = tspec.get("lock")
                if tlock is None:
                    continue
                tscans = all_scans.get((tfile, tcls), {})
                tsc = tscans.get(meth)
                if tsc is None:
                    continue
                tlabel = "%s.%s" % (tcls, tlock)
                acquires = any(
                    acq == tlabel for _h, acq, _l in tsc.acquire_edges
                ) or any(h == tlabel for h, _a, _l in tsc.acquire_edges)
                # a method whose body has `with self._lock` at all:
                acquires = acquires or _acquires_own(tsc, tlabel)
                if not acquires:
                    continue
                for h in held_set:
                    if h != tlabel:
                        edges.append((rel, h, tlabel, line))
            # entry-held methods imply our own lock is held when they
            # run; their foreign calls were recorded with the lexical
            # held set only — add the implied edge
            if own is not None and entry_held.get(mname, False):
                for tfile, tcls, meth, line, held_set in sc.foreign_calls:
                    tspec = specs.get(tfile, {}).get(tcls, {})
                    tlock = tspec.get("lock")
                    if tlock is None:
                        continue
                    tsc = all_scans.get((tfile, tcls), {}).get(meth)
                    if tsc is None or not _acquires_own(
                            tsc, "%s.%s" % (tcls, tlock)):
                        continue
                    edges.append((rel, own, "%s.%s" % (tcls, tlock),
                                  line))

    # ---- order check ------------------------------------------------------
    rank = {label: i for i, label in enumerate(lock_order)}
    seen_pairs: Dict[Tuple[str, str], Tuple[str, int]] = {}
    for rel, held, acq, line in edges:
        seen_pairs.setdefault((held, acq), (rel, line))
        if held in rank and acq in rank and rank[acq] < rank[held]:
            findings.append(Finding(
                LOCK_ORDER, rel, line,
                "acquires %s while holding %s — contradicts the "
                "declared hierarchy %s" % (acq, held,
                                           " -> ".join(lock_order))))
    for (a, b), (rel, line) in seen_pairs.items():
        if (b, a) in seen_pairs and a < b and not (
                a in rank and b in rank):
            findings.append(Finding(
                LOCK_ORDER, rel, line,
                "inconsistent acquisition order between %s and %s "
                "(both orders observed)" % (a, b)))
    return findings


def _acquires_own(sc: _MethodScan, label: str) -> bool:
    """Does the scanned method body contain `with <lock matching label>`
    anywhere?  acquire_edges only records NESTED acquires, so re-derive
    from the recorded edges plus a cheap flag."""
    if any(acq == label for _h, acq, _l in sc.acquire_edges):
        return True
    return label in getattr(sc, "acquired_any", set())
