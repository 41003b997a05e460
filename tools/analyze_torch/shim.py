"""Pass 2 — shim enforcement, in the port's sense.

The reference routes every ``shard_map`` through
``distribution/context.py``. The port's counterpart is the ``Mesh`` of
``src/repro_torch/distribution/context.py``: every collective goes
through it, and it records each one for ``analysis/comms.py``. A
``torch.distributed`` call anywhere else moves bytes the record does not
see. This pass flags, outside ``context.py``:

* any import of ``torch.distributed`` (``import torch.distributed [as
  d]``, ``from torch import distributed``, ``from torch.distributed
  import ...``) — except in ``src/repro_torch/launch/mesh.py``, which
  sets up and tears down the process groups;
* any call of a collective or point-to-point op of it
  (``dist.all_reduce``, ``torch.distributed.barrier``, an op imported
  by name, ...) — in ``launch/mesh.py`` too, where only ``SETUP_OPS``
  may be called.

A use that is needed outside those files is a finding: it goes into the
baseline with its reason, and the pass is not widened to hide it.
"""

from __future__ import annotations

import ast
import glob
import os
from typing import List, Optional, Sequence

from .common import Finding, Module, iter_py_files, relpath, REPO_ROOT
from .rules import SHIM_IMPORT

CONTEXT = "src/repro_torch/distribution/context.py"
MESH = "src/repro_torch/launch/mesh.py"

# The files the pass reads: the port, its phase scripts and smoke, this
# analyzer and the port's tests.
SCAN_GLOBS = ("src/repro_torch", "tools/*_phase.py", "tools/analyze_torch",
              "chip_smoke.py", "tests/test_torch_*.py")

# process-group set-up and teardown, allowed in launch/mesh.py
SETUP_OPS = frozenset({
    "init_process_group", "new_group", "destroy_process_group",
    "is_initialized", "is_available", "get_rank", "get_world_size",
    "get_backend"})

# collective and point-to-point ops of torch.distributed
COLLECTIVE_OPS = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "all_to_all", "all_to_all_single", "broadcast", "broadcast_object_list",
    "reduce", "gather", "gather_object", "scatter", "scatter_object_list",
    "barrier", "monitored_barrier", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp", "send_object_list", "recv_object_list"})

_ROUTE = "route it through repro_torch.distribution.context.Mesh"


def _is_dist(mod_name: str) -> bool:
    return mod_name == "torch.distributed" or \
        mod_name.startswith("torch.distributed.")


class _Scan(ast.NodeVisitor):
    def __init__(self, mod: Module):
        self.mod = mod
        self.out: List[Finding] = []
        self.where: List[str] = []
        self.may_import = mod.rel in (CONTEXT, MESH)
        # local names bound to torch.distributed (or a submodule), and
        # names imported from it
        self.dist_aliases = {a for a, t in mod.import_alias.items()
                             if _is_dist(t)}
        self.torch_aliases = {a for a, t in mod.import_alias.items()
                              if t == "torch"}
        self.dist_names = {a: sym for a, (m, sym) in
                           mod.from_imports.items() if _is_dist(m)}
        self.dist_aliases |= {a for a, (m, sym) in mod.from_imports.items()
                              if m == "torch" and sym == "distributed"}

    def bad(self, node: ast.AST, what: str) -> None:
        scope = ".".join(self.where) or "<module>"
        self.out.append(Finding(SHIM_IMPORT, self.mod.rel,
                                getattr(node, "lineno", 1),
                                "%s: %s — %s" % (scope, what, _ROUTE)))

    def _scoped(self, node) -> None:
        self.where.append(node.name)
        self.generic_visit(node)
        self.where.pop()

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = _scoped

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if _is_dist(a.name) and not self.may_import:
                self.bad(node, "import of %s" % a.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        m = node.module or ""
        if self.may_import:
            return
        if _is_dist(m):
            self.bad(node, "import from %s" % m)
        elif m == "torch" and any(a.name == "distributed"
                                  for a in node.names):
            self.bad(node, "import of torch.distributed")

    def _op(self, func: ast.AST) -> Optional[str]:
        """The torch.distributed op ``func`` names, if any."""
        if isinstance(func, ast.Name):
            return self.dist_names.get(func.id)
        if not isinstance(func, ast.Attribute):
            return None
        base = func.value
        if isinstance(base, ast.Name) and base.id in self.dist_aliases:
            return func.attr
        if (isinstance(base, ast.Attribute) and base.attr == "distributed"
                and isinstance(base.value, ast.Name)
                and base.value.id in self.torch_aliases):
            return func.attr
        return None

    def visit_Call(self, node: ast.Call) -> None:
        op = self._op(node.func)
        if op is not None and self.mod.rel != CONTEXT and (
                op in COLLECTIVE_OPS
                or (self.mod.rel == MESH and op not in SETUP_OPS)):
            self.bad(node, "torch.distributed.%s() called directly" % op)
        self.generic_visit(node)


def _check_module(mod: Module) -> List[Finding]:
    sc = _Scan(mod)
    sc.visit(mod.tree)
    return sc.out


def scan_files(root: str = REPO_ROOT) -> List[str]:
    files: List[str] = []
    for pattern in SCAN_GLOBS:
        for hit in sorted(glob.glob(os.path.join(root, pattern))):
            files.extend(iter_py_files(root, (relpath(hit, root),)))
    return sorted(set(files))


def run(root: str = REPO_ROOT,
        files: Optional[Sequence[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in (scan_files(root) if files is None else files):
        try:
            mod = Module(path, root)
        except SyntaxError:
            continue
        findings.extend(_check_module(mod))
    return findings
