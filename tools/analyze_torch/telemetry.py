"""Pass 6 — telemetry declaration discipline, over the port's serving
stack.

The port's counters live behind ``Telemetry.engine_stats`` /
``CounterView`` (``src/repro_torch/serve/telemetry.py``), which exports
every declared key to Prometheus and to the merged cluster summary. A
key that is incremented but never declared in ``DECLARED_STATS``
vanishes from the export surface.

Rule TELEMETRY-DECLARED: any write (``Assign``/``AugAssign``) to
``<obj>.stats[<string constant>]`` inside ``src/repro_torch/serve/`` must
use a key present in ``repro_torch.serve.telemetry.DECLARED_STATS``.
Dynamic (non-constant) keys are ignored.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import FrozenSet, List, Optional, Sequence

from .common import Finding, Module, iter_py_files, REPO_ROOT
from .rules import TELEMETRY_DECLARED

SCAN_SUBDIRS = (os.path.join("src", "repro_torch", "serve"),)


def _declared_stats(root: str) -> FrozenSet[str]:
    """``DECLARED_STATS`` of the port under analysis (its telemetry
    module imports neither torch nor the reference)."""
    src = os.path.join(root, "src")
    added = src not in sys.path
    if added:
        sys.path.insert(0, src)
    try:
        from repro_torch.serve.telemetry import DECLARED_STATS
        return frozenset(DECLARED_STATS)
    finally:
        if added:
            sys.path.remove(src)


def _stats_key(node: ast.AST) -> Optional[str]:
    """The string key of a ``<obj>.stats[<str const>]`` target."""
    if not isinstance(node, ast.Subscript):
        return None
    base = node.value
    if not (isinstance(base, ast.Attribute) and base.attr == "stats"):
        return None
    sl = node.slice
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
        return sl.value
    return None


def _check_module(mod: Module, declared: FrozenSet[str]) -> List[Finding]:
    out: List[Finding] = []

    def check(target: ast.AST) -> None:
        key = _stats_key(target)
        if key is not None and key not in declared:
            out.append(Finding(
                TELEMETRY_DECLARED, mod.rel,
                getattr(target, "lineno", 1),
                "stats key %r written but not declared in "
                "repro_torch.serve.telemetry.DECLARED_STATS" % key))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.AugAssign):
            check(node.target)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                check(t)
    return out


def run(root: str = REPO_ROOT,
        files: Optional[Sequence[str]] = None,
        declared: Optional[FrozenSet[str]] = None) -> List[Finding]:
    if declared is None:
        declared = _declared_stats(root if files is None else REPO_ROOT)
    if files is None:
        files = []
        for sub in SCAN_SUBDIRS:
            if os.path.isdir(os.path.join(root, sub)):
                files.extend(iter_py_files(root, (sub,)))
    findings: List[Finding] = []
    for path in files:
        try:
            mod = Module(path, root)
        except SyntaxError:
            continue
        findings.extend(_check_module(mod, declared))
    return findings
