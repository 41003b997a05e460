"""Shared infrastructure of the port's static analyzer: findings,
baselines, and an AST corpus over the repo's Python sources.

The port's copy of ``tools/analyze/common.py``. Two differences follow
the port's idiom: the port imports many modules inside functions (to
keep import cycles apart), so a module's alias tables also take the
imports of its function bodies (a top-level import wins a clash); and a
call of a class resolves to its ``__init__``.

Nothing here imports torch.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, asdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .rules import RULES

REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))

# Parts of a path never scanned as part of the repo corpus. Fixture
# modules carry intentional violations for tests/test_torch_analyze.py.
EXCLUDE_PARTS = (
    os.path.join("tests", "fixtures", "analyze_torch"),
    os.path.join(".git", ""),
    "__pycache__",
)


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str            # repo-relative, forward slashes
    line: int
    message: str

    @property
    def severity(self) -> str:
        return RULES[self.rule].severity

    def key(self) -> Tuple[str, str, str]:
        # Baselines ignore line numbers so unrelated edits above a
        # baselined finding don't invalidate the baseline.
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return "%s:%d: %s [%s] %s" % (
            self.path, self.line, self.severity, self.rule, self.message)

    def to_json(self) -> Dict:
        d = asdict(self)
        d["severity"] = self.severity
        return d


def relpath(path: str, root: str = REPO_ROOT) -> str:
    return os.path.relpath(os.path.abspath(path), root).replace(os.sep, "/")


def iter_py_files(root: str = REPO_ROOT,
                  subdirs: Optional[Sequence[str]] = None) -> List[str]:
    """All .py files under ``root`` (or the given subdirs or files),
    excluding analyzer fixtures and caches. Returns absolute paths,
    sorted."""
    bases = [os.path.join(root, s) for s in subdirs] if subdirs else [root]
    out: List[str] = []
    for base in bases:
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__", ".git")]
            # exclusion is relative to the scan root, so pointing run()
            # AT the fixture dir (the tests) still works
            rel = os.path.relpath(dirpath, root)
            if any(part in rel for part in EXCLUDE_PARTS):
                continue
            for fn in filenames:
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(set(out))


class Module:
    """Parsed module with import-alias and symbol tables."""

    def __init__(self, path: str, root: str = REPO_ROOT):
        self.path = path
        self.rel = relpath(path, root)
        with open(path, "r", encoding="utf-8") as fh:
            self.source = fh.read()
        self.tree = ast.parse(self.source, filename=path)
        # local name -> dotted module path ("np" -> "numpy",
        # "dctx" -> "repro_torch.distribution.context")
        self.import_alias: Dict[str, str] = {}
        # local name -> (module, symbol) for `from mod import sym [as x]`
        self.from_imports: Dict[str, Tuple[str, str]] = {}
        self.functions: Dict[str, ast.AST] = {}
        self.classes: Dict[str, Dict[str, ast.AST]] = {}
        self.name = self._module_name()
        self._index()

    def _module_name(self) -> str:
        rel = self.rel[:-3]  # strip .py
        parts = rel.split("/")
        if parts and parts[0] == "src":
            parts = parts[1:]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)

    def _add_import(self, node: ast.AST, top: bool) -> None:
        def put(table, key, val):
            if top or key not in table:
                table[key] = val
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    put(self.import_alias, a.asname, a.name)
                else:
                    first = a.name.split(".")[0]
                    put(self.import_alias, first, first)
        else:
            mod = node.module or ""
            if node.level:  # relative import -> resolve against self
                base = self.name.split(".")[: -node.level]
                mod = ".".join(base + ([mod] if mod else []))
            for a in node.names:
                if a.name != "*":
                    put(self.from_imports, a.asname or a.name, (mod, a.name))

    def _index(self) -> None:
        for node in self.tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                self._add_import(node, True)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.functions[node.name] = node
            elif isinstance(node, ast.ClassDef):
                methods: Dict[str, ast.AST] = {}
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        methods[sub.name] = sub
                self.classes[node.name] = methods
        top = set(map(id, self.tree.body))
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)) \
                    and id(node) not in top:
                self._add_import(node, False)


class Corpus:
    """All modules under src/ (plus any extra files), indexed by module
    name, for cross-module call resolution."""

    def __init__(self, root: str = REPO_ROOT,
                 subdirs: Sequence[str] = ("src",)):
        self.root = root
        self.modules: Dict[str, Module] = {}
        for path in iter_py_files(root, subdirs):
            try:
                m = Module(path, root)
            except SyntaxError:
                continue
            self.modules[m.name] = m

    def module_of(self, name: str) -> Optional[Module]:
        return self.modules.get(name)

    def _symbol(self, src: Optional[Module], sym: str):
        """(module, function node, class name or None) of ``sym`` in
        ``src``: a function, or a class's ``__init__``."""
        if src is None:
            return None
        if sym in src.functions:
            return src, src.functions[sym], None
        init = src.classes.get(sym, {}).get("__init__")
        if init is not None:
            return src, init, sym
        return None

    def resolve_function(self, mod: Module, name: str):
        """Resolve a bare name in ``mod`` to (owning Module, func node,
        class or None), following `from x import f` chains. Returns None
        if not a corpus-level function or class."""
        r = self._symbol(mod, name)
        if r is not None:
            return r
        if name in mod.from_imports:
            src_mod_name, sym = mod.from_imports[name]
            return self._symbol(self.modules.get(src_mod_name), sym)
        return None

    def resolve_attr_function(self, mod: Module, obj: str, attr: str):
        """Resolve ``obj.attr(...)`` where obj is an imported module
        alias."""
        target = mod.import_alias.get(obj)
        if target is None and obj in mod.from_imports:
            # `from repro_torch.models import lm` -> from_imports["lm"] =
            # ("repro_torch.models", "lm"); the symbol may be a module.
            src_mod, sym = mod.from_imports[obj]
            target = src_mod + "." + sym
        if target is None:
            return None
        return self._symbol(self.modules.get(target), attr)


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---- baseline ---------------------------------------------------------------

def load_baseline(path: str) -> List[Tuple[str, str, str]]:
    if not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return [(e["rule"], e["path"], e["message"])
            for e in data.get("findings", [])]


def write_baseline(path: str, findings: Iterable[Finding]) -> None:
    data = {"findings": [
        {"rule": f.rule, "path": f.path, "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))]}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
