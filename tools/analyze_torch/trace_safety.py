"""Pass 1 — trace safety, read as host syncs of device tensors.

The reference flags host/trace confusion inside functions reachable
from a ``jax.jit`` root. The port runs eagerly: the same constructs do
not fail, they stall the host until the device has caught up, and a
step that syncs cannot be captured in a CUDA graph. So the port keeps
the reference's rule ids and reads them as host syncs:

* **TRACE-BRANCH** — Python-level control flow (``if``/``while``/
  ``assert``/ternary/comprehension guard) whose condition is a device
  tensor.
* **TRACE-COERCE** — host reads of a device tensor: ``bool()``/
  ``int()``/``float()``/``range()``/``.item()``/``.tolist()``/
  ``.cpu()``/``.numpy()``/``.to("cpu")``, ``not``/``and``/``or`` on one,
  ``math.*`` of one, ``torch.equal``/``torch.allclose``.
* **TRACE-HOSTCALL** — host calls: ``torch.cuda.synchronize`` (every
  ``.synchronize()``), ``time.*``, ``print`` of a device tensor, ``np.*``
  of one.

Torch has no ``jax.jit`` to discover roots by, so the pass declares
``ROOTS``: one row per jit site of the reference (its file:line), with
the port function that plays its part and that function's static
parameters (host values: a config, a numpy block table, a slot index);
every other parameter holds device tensors. Where a port function mixes
host planning with device work, unlike a jit body, the host syncs it
makes are findings: they go into the baseline with their reason, and
no root is narrowed to hide them.

The analysis is the reference's: a cross-module, per-parameter taint
propagation to a fixpoint. The call graph follows import aliases (also
those imported inside a function), ``self.`` method calls and class
constructors (an object is tainted when its ``__init__`` stores a
tainted value); function values passed to ``checkpoint``/``vmap``-like
combinators run with every parameter tainted. A torch call yields a
tensor (tainted) unless it returns host data (``torch.finfo``,
``torch.cuda.current_stream``, ...); a method of a tainted value yields
a tainted value unless it reads metadata (``.size()``, ``.dim()``,
``.data_ptr()``, ...). Static: ``.shape``/``.ndim``/``.dtype``/
``.device`` reads, the packed containers' static fields, ``is None``
tests, ``in`` on containers, ``len()``, and the attributes of ``self``
(as in the reference: the engine's device state on ``self`` is not
followed).
"""

from __future__ import annotations

import ast
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from .common import Corpus, Finding, Module, dotted_name, REPO_ROOT
from .rules import TRACE_BRANCH, TRACE_COERCE, TRACE_HOSTCALL


class Root(NamedTuple):
    site: str                   # the reference's jit site, file:line
    what: str
    path: str                   # the port function's file
    func: str                   # "Class.method" or "function"
    static: Tuple[str, ...]     # its host (untainted) parameters


_ENG = "src/repro_torch/serve/engine.py"
_SG = "src/repro_torch/kernels/sasp_gemm/"
ROOTS: Tuple[Root, ...] = (
    Root("src/repro/serve/engine.py:310", "paged decode", _ENG,
         "Engine._paged_decode_step", ("cfg", "bt")),
    Root("src/repro/serve/engine.py:313", "paged prefill", _ENG,
         "Engine._paged_rows", ("slots", "past", "dests", "kind")),
    Root("src/repro/serve/engine.py:315", "paged prefill with past", _ENG,
         "Engine._paged_rows", ("slots", "past", "dests", "kind")),
    Root("src/repro/serve/engine.py:318", "decode", _ENG,
         "Engine._decode_step", ("cfg",)),
    Root("src/repro/serve/engine.py:319", "prefill", _ENG,
         "Engine._prefill_and_write", ("all_slots",)),
    Root("src/repro/serve/engine.py:321", "sample", _ENG,
         "sample_tokens", ("gen",)),
    Root("src/repro/serve/engine.py:325", "snapshot", _ENG,
         "Engine._snapshot", ("slot",)),
    Root("src/repro/serve/engine.py:327", "restore", _ENG,
         "Engine._restore_slot", ("slot", "req")),
    Root("src/repro/serve/engine.py:369", "draft decode", _ENG,
         "Engine._draft_decode", ()),
    Root("src/repro/serve/engine.py:372", "verify", _ENG,
         "Engine._paged_spec_verify", ("past_bt", "dests")),
    Root("src/repro/kernels/sasp_gemm/ops.py:198", "fused FFN",
         _SG + "fused_ffn.py", "fused_ffn", ("act",)),
    Root("src/repro/kernels/sasp_gemm/ops.py:251", "tile-skip GEMM",
         _SG + "gemm.py", "sasp_gemm", ("n", "act", "group_nb")),
    Root("src/repro/kernels/sasp_gemm/ops.py:307", "masked-grid GEMM",
         _SG + "masked.py", "masked_matmul", ()),
    Root("src/repro/kernels/int8_gemm/ops.py:13", "int8 GEMM",
         "src/repro_torch/kernels/int8_gemm/gemm.py", "int8_gemm", ()),
    Root("src/repro/kernels/flash_attn/ops.py:13", "flash attention",
         "src/repro_torch/kernels/flash_attn/ops.py", "mha", ("window",)),
)

# Attribute reads that yield STATIC (host) values even on device tensors
# and packed containers: tensor metadata + the containers' static fields.
STATIC_ATTRS = {
    "shape", "ndim", "dtype", "device", "is_cuda", "layout", "itemsize",
    "requires_grad", "size", "block", "shards", "shard_kind", "act",
    "nnz", "nv", "k_max", "d_model", "d_ff", "block_f", "held",
}
# Tensor methods that read metadata, not values.
STATIC_METHODS = {
    "size", "dim", "numel", "nelement", "element_size", "stride",
    "is_contiguous", "data_ptr", "get_device", "is_floating_point",
    "is_complex", "storage_offset", "type",
}
# torch functions that return host data without reading a tensor.
TORCH_HOST_FUNCS = {
    "finfo", "iinfo", "device", "Size", "is_tensor", "is_floating_point",
    "is_complex", "get_default_dtype", "promote_types", "result_type",
    "can_cast", "is_grad_enabled", "no_grad", "enable_grad",
    "inference_mode", "set_grad_enabled", "Generator", "is_available",
    "current_device", "device_count", "current_stream", "default_stream",
    "get_device_name", "get_device_properties", "stream", "Stream",
    "Event", "memory_allocated", "max_memory_allocated",
    "memory_reserved", "get_rank", "get_world_size", "is_initialized",
    "is_compiling", "is_scripting", "get_num_threads",
}
# torch functions that return a Python value read from tensors.
TORCH_COERCIONS = {"equal", "allclose", "is_nonzero"}

# torch combinators whose function-valued arguments run on tensors
COMBINATOR_SUFFIXES = ("checkpoint", "vmap", "grad", "vjp", "jvp", "cond")

HOST_TIME_MODULES = ("time", "datetime")
COERCING_BUILTINS = {"bool", "int", "float", "complex", "range"}
TENSOR_METHOD_COERCIONS = {"item", "tolist", "cpu", "numpy", "__bool__",
                           "__int__", "__float__", "__index__"}
# methods that put a value into a container named by a local
CONTAINER_MUTATORS = {"append", "extend", "insert", "add", "update"}


class FuncInfo:
    def __init__(self, module: Module, node: ast.AST,
                 cls: Optional[str] = None):
        self.module = module
        self.node = node
        self.cls = cls

    @property
    def label(self) -> str:
        n = getattr(self.node, "name", "<lambda>")
        return "%s%s" % (("%s." % self.cls) if self.cls else "", n)

    def params(self) -> List[str]:
        a = self.node.args
        names = [p.arg for p in getattr(a, "posonlyargs", [])]
        names += [p.arg for p in a.args]
        names += [p.arg for p in a.kwonlyargs]
        return names

    @property
    def is_method(self) -> bool:
        return self.cls is not None and not self.is_static

    @property
    def is_static(self) -> bool:
        for d in getattr(self.node, "decorator_list", []):
            if isinstance(d, ast.Name) and d.id in ("staticmethod",
                                                    "classmethod"):
                return True
        return False

    def call_params(self) -> List[str]:
        """Parameters a caller fills (``self`` of a method left out)."""
        params = self.params()
        if self.is_method and params and params[0] == "self":
            params = params[1:]
        return params


# A taint is False (host value), True (a device tensor, or a container
# that may hold one), a frozenset (an object whose listed attributes hold
# device values) or a tuple of taints (a tuple or list by position; a
# comprehension's sequence is the 1-tuple of its item's taint).


def _flat(t):
    """The taint of a value as a whole: a tuple joins its items; an
    object with device attributes stays itself."""
    if isinstance(t, tuple):
        out = False
        for e in t:
            out = _join(out, _flat(e))
        return out
    return t


def _join(a, b):
    if a is True or b is True:
        return True
    if not a:
        return b
    if not b:
        return a
    if isinstance(a, tuple) and isinstance(b, tuple) and len(a) == len(b):
        return tuple(_join(x, y) for x, y in zip(a, b))
    a, b = _flat(a), _flat(b)
    if a is True or b is True:
        return True
    return (a or frozenset()) | (b or frozenset())


def _dev(t) -> bool:
    """Is the value a device tensor (or a container of them)?"""
    return _flat(t) is True


def _elem(t):
    """The taint of one item of an iterated value."""
    if isinstance(t, tuple):
        out = False
        for e in t:
            out = _join(out, e)
        return out
    return t


class _Analyzer:
    def __init__(self, corpus: Corpus):
        self.corpus = corpus
        self.findings: Dict[Tuple, Finding] = {}
        # id(node) -> (FuncInfo, {param: taint})
        self.state: Dict[int, Tuple[FuncInfo, Dict[str, object]]] = {}
        self.queue: List[int] = []
        # (id(node), taints) -> the taint of the result: the return
        # value, or for a constructor the object's device attributes
        self._ret: Dict[Tuple, object] = {}
        self._ret_probing: Set[Tuple] = set()
        self.probing = 0                # >0: suppress finding emission

    # -- worklist -----------------------------------------------------------

    def add_root(self, fi: FuncInfo, taints: Dict[str, object]) -> None:
        if self.probing:
            return                      # probes must not seed reachability
        key = id(fi.node)
        taints = {p: t for p, t in taints.items() if t}
        if key in self.state:
            prev = self.state[key][1]
            merged = dict(prev)
            for p, t in taints.items():
                merged[p] = _join(prev.get(p, False), t)
            if merged == prev:
                return
            self.state[key] = (fi, merged)
        else:
            self.state[key] = (fi, taints)
        if key not in self.queue:
            self.queue.append(key)

    def solve(self) -> List[Finding]:
        steps = 0
        while self.queue and steps < 20000:
            steps += 1
            key = self.queue.pop()
            fi, taints = self.state[key]
            self._analyze(fi, dict(taints))
        return sorted(self.findings.values(),
                      key=lambda f: (f.path, f.line, f.rule))

    def emit(self, rule: str, mod: Module, line: int, msg: str) -> None:
        if self.probing:
            return
        f = Finding(rule, mod.rel, line, msg)
        self.findings[(f.rule, f.path, f.line, f.message)] = f

    def result_of(self, fi: FuncInfo, taints: Dict[str, object]):
        """The taint of ``fi``'s result for these parameter taints: its
        return value's, or a constructor's device attributes (a
        frozenset). Helper predicates over static config structure
        return host results; call sites then stay branchable."""
        taints = {p: t for p, t in taints.items() if t}
        key = (id(fi.node), frozenset(taints.items()))
        if key in self._ret:
            return self._ret[key]
        if key in self._ret_probing:
            return True                 # recursion: conservative
        self._ret_probing.add(key)
        self.probing += 1
        try:
            walker = _BodyWalker(self, fi, dict(taints))
            if isinstance(fi.node, ast.Lambda):
                result = walker.expr(fi.node.body)
            else:
                walker.run(fi.node.body)
                result = walker.ret
                if fi.node.name == "__init__":
                    result = frozenset(walker.self_fields) or False
        finally:
            self.probing -= 1
            self._ret_probing.discard(key)
        self._ret[key] = result
        return result

    # -- function body analysis --------------------------------------------

    def _analyze(self, fi: FuncInfo, taints: Dict[str, object]) -> None:
        body = fi.node.body if not isinstance(fi.node, ast.Lambda) \
            else [ast.Expr(fi.node.body)]
        _BodyWalker(self, fi, taints).run(body)

    # -- call resolution ----------------------------------------------------

    def resolve_call(self, fi: FuncInfo,
                     func: ast.AST) -> Optional[FuncInfo]:
        mod = fi.module
        if isinstance(func, ast.Name):
            r = self.corpus.resolve_function(mod, func.id)
            return None if r is None else FuncInfo(*r)
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name):
                if base.id == "self" and fi.cls:
                    methods = mod.classes.get(fi.cls, {})
                    if func.attr in methods:
                        return FuncInfo(mod, methods[func.attr], fi.cls)
                    return None
                r = self.corpus.resolve_attr_function(
                    mod, base.id, func.attr)
                if r is not None:
                    return FuncInfo(*r)
        return None

    @staticmethod
    def bind_args(callee: FuncInfo, pos: List, kw: Dict[str, object]
                  ) -> Dict[str, object]:
        params = callee.call_params()
        taints: Dict[str, object] = {}
        for i, t in enumerate(pos):
            if t and i < len(params):
                taints[params[i]] = t
        for name, t in kw.items():
            if t and name in params:
                taints[name] = t
        return taints

    def mark_all_tainted(self, callee: FuncInfo) -> None:
        self.add_root(callee, dict.fromkeys(callee.call_params(), True))


class _BodyWalker:
    """Single-function abstract interpreter over taint."""

    def __init__(self, an: _Analyzer, fi: FuncInfo, env: Dict[str, object]):
        self.an = an
        self.fi = fi
        self.mod = fi.module
        self.env = env
        self.local_funcs: Dict[str, ast.AST] = {}
        self.ret = False
        self.self_fields: Set[str] = set()  # self attributes given a
        #                                     device value

    # ---- entry ------------------------------------------------------------

    def run(self, body: Sequence[ast.stmt]) -> None:
        for stmt in body:
            self.stmt(stmt)

    def _flag(self, rule: str, node: ast.AST, what: str) -> None:
        self.an.emit(rule, self.mod, node.lineno,
                     "%s: %s" % (self.fi.label, what))

    def _test(self, node: ast.AST, what: str) -> None:
        if _dev(self.expr(node)):
            self._flag(TRACE_BRANCH, node, what)

    # ---- statements -------------------------------------------------------

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.local_funcs[node.name] = node
            return
        if isinstance(node, ast.If):
            self._test(node.test, "`if` on a device tensor")
            for b in node.body + node.orelse:
                self.stmt(b)
        elif isinstance(node, ast.While):
            self._test(node.test, "`while` on a device tensor")
            for b in node.body + node.orelse:
                self.stmt(b)
        elif isinstance(node, ast.Assert):
            self._test(node.test, "`assert` on a device tensor")
        elif isinstance(node, ast.For):
            self._bind_target(node.target, self._iter_elem(node.iter))
            for b in node.body + node.orelse:
                self.stmt(b)
        elif isinstance(node, ast.Assign):
            t = self.expr(node.value)
            for tgt in node.targets:
                self._bind_target(tgt, t)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self._bind_target(node.target, self.expr(node.value))
        elif isinstance(node, ast.AugAssign):
            t = self.expr(node.value)
            if isinstance(node.target, ast.Name):
                old = self.env.get(node.target.id, False)
                if isinstance(node.op, ast.Add) and isinstance(
                        old, tuple) and isinstance(t, tuple):
                    self._set(node.target.id, old + t)   # list += list
                else:
                    self._set(node.target.id, _join(_flat(old), _flat(t)))
            else:
                self._bind_target(node.target, t)
        elif isinstance(node, ast.Return):
            if node.value is not None:
                self.ret = _join(self.ret, self.expr(node.value))
        elif isinstance(node, ast.Expr):
            self.expr(node.value)
        elif isinstance(node, ast.With):
            for item in node.items:
                self.expr(item.context_expr)
            for b in node.body:
                self.stmt(b)
        elif isinstance(node, ast.Try):
            for b in (node.body + node.orelse + node.finalbody):
                self.stmt(b)
            for h in node.handlers:
                for b in h.body:
                    self.stmt(b)
        elif isinstance(node, ast.Raise):
            if node.exc is not None:
                self.expr(node.exc)
        # Pass/Import/Global/Delete/etc: nothing on the device

    def _set(self, name: str, t) -> None:
        if t:
            self.env[name] = t
        else:
            self.env.pop(name, None)

    def _bind_target(self, tgt: ast.AST, t) -> None:
        if isinstance(tgt, ast.Name):
            self._set(tgt.id, t)
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            elts = tgt.elts
            if (isinstance(t, tuple) and len(t) == len(elts)
                    and not any(isinstance(e, ast.Starred) for e in elts)):
                for e, et in zip(elts, t):
                    self._bind_target(e, et)
                return
            for e in elts:
                self._bind_target(e, _elem(t))
        elif isinstance(tgt, ast.Attribute):
            if (_flat(t) and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self.self_fields.add(tgt.attr)
        elif isinstance(tgt, ast.Subscript):
            # d[k] = tensor: the container now holds a device value
            self.expr(tgt.slice)
            if isinstance(tgt.value, ast.Name) and _dev(t):
                self._set(tgt.value.id, True)
        elif isinstance(tgt, ast.Starred):
            self._bind_target(tgt.value, _elem(t))

    def _iter_elem(self, it: ast.AST):
        """The taint of one item of ``for x in it``."""
        if isinstance(it, ast.Call):
            fname = dotted_name(it.func) or ""
            if fname == "zip" and not it.keywords:
                return tuple(self._iter_elem(a) for a in it.args)
            if fname == "enumerate" and it.args:
                return (False, self._iter_elem(it.args[0]))
            if (isinstance(it.func, ast.Attribute)
                    and it.func.attr in ("items", "keys", "values")):
                base = _flat(self.expr(it.func.value))
                return {"items": (False, base), "keys": False,
                        "values": base}[it.func.attr]
        return _elem(self.expr(it))

    # ---- nested functions -------------------------------------------------

    def _analyze_nested(self, node: ast.AST,
                        all_tainted: bool) -> None:
        fi = FuncInfo(self.mod, node, self.fi.cls)
        env = dict(self.env)            # closure sees enclosing taint
        if all_tainted:
            env.update(dict.fromkeys(fi.params(), True))
        walker = _BodyWalker(self.an, fi, env)
        walker.local_funcs = dict(self.local_funcs)
        if isinstance(node, ast.Lambda):
            walker.expr(node.body)
        else:
            walker.run(node.body)

    def _maybe_function_value(self, node: ast.AST) -> Optional[object]:
        """A function-valued expression: nested def / lambda / corpus
        function reference."""
        if isinstance(node, ast.Lambda):
            return node
        if isinstance(node, ast.Name):
            if node.id in self.local_funcs:
                return self.local_funcs[node.id]
            r = self.an.corpus.resolve_function(self.mod, node.id)
            if r is not None:
                return FuncInfo(*r)
        if isinstance(node, ast.Attribute):
            fi = self.an.resolve_call(self.fi, node)
            if fi is not None:
                return fi
        if isinstance(node, ast.Call):
            # partial(f, ...) / checkpoint(f) passed as the callee
            name = dotted_name(node.func)
            if name and name.split(".")[-1] in (
                    "partial", "checkpoint", "remat"):
                return self._maybe_function_value(
                    node.args[0]) if node.args else None
        return None

    def _mark_function_value_tainted(self, val: object) -> None:
        if isinstance(val, FuncInfo):
            self.an.mark_all_tainted(val)
        elif isinstance(val, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
            self._analyze_nested(val, all_tainted=True)

    # ---- expressions (return: taint) --------------------------------------

    def expr(self, node: ast.AST):
        if node is None or isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Name):
            return self.env.get(node.id, False)
        if isinstance(node, ast.Attribute):
            base = self.expr(node.value)
            if node.attr in STATIC_ATTRS:
                return False
            if isinstance(base, frozenset):
                return node.attr in base
            return _flat(base)
        if isinstance(node, ast.Subscript):
            self.expr(node.slice)
            base = self.expr(node.value)
            sl = node.slice
            if (isinstance(base, tuple) and isinstance(sl, ast.Constant)
                    and isinstance(sl.value, int)
                    and -len(base) <= sl.value < len(base)):
                return base[sl.value]
            return _elem(base) if isinstance(base, tuple) else _flat(base)
        if isinstance(node, ast.Call):
            return self.call(node)
        if isinstance(node, ast.BoolOp):
            ts = [self.expr(v) for v in node.values]
            # `a or {}`: a container's default, not a tensor's truth
            last = node.values[-1]
            default = (isinstance(last, (ast.Dict, ast.List, ast.Tuple))
                       and not getattr(last, "elts", getattr(
                           last, "keys", None)))
            # `a and b` reads the truth of every operand but the last
            if not default and any(_dev(t) for t in ts[:-1]):
                self._flag(TRACE_COERCE, node,
                           "and/or reads a device tensor's truth (use "
                           "torch.logical_and/or or torch.where)")
            out = False
            for t in ts:
                out = _join(out, t)
            return out
        if isinstance(node, ast.UnaryOp):
            t = _flat(self.expr(node.operand))
            if t is True and isinstance(node.op, ast.Not):
                self._flag(TRACE_COERCE, node,
                           "`not` reads a device tensor's truth (use "
                           "torch.logical_not)")
            return t is True
        if isinstance(node, ast.BinOp):
            left, right = self.expr(node.left), self.expr(node.right)
            if isinstance(node.op, ast.Add) and isinstance(
                    left, tuple) and isinstance(right, tuple):
                return left + right
            return _dev(left) or _dev(right)
        if isinstance(node, ast.Compare):
            ts = [self.expr(node.left)] + [self.expr(c)
                                           for c in node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                   ast.NotIn)) for op in node.ops):
                return False            # identity/containment: static
            return any(_dev(t) for t in ts)
        if isinstance(node, ast.IfExp):
            self._test(node.test, "ternary on a device tensor (use "
                       "torch.where)")
            return _join(self.expr(node.body), self.expr(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(self.expr(e) for e in node.elts)
        if isinstance(node, ast.Set):
            return _dev(tuple(self.expr(e) for e in node.elts))
        if isinstance(node, ast.Dict):
            return _dev(tuple(self.expr(v) for v in
                              list(node.keys) + list(node.values)
                              if v is not None))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self._bind_target(gen.target, self._iter_elem(gen.iter))
                for cond in gen.ifs:
                    self._test(cond, "comprehension guard on a device "
                               "tensor")
            if isinstance(node, ast.DictComp):
                return _dev(self.expr(node.key)) or _dev(
                    self.expr(node.value))
            # a sequence of items alike: a 1-tuple of the item's taint
            # (indexing, unpacking and iterating read the item)
            return (self.expr(node.elt),)
        if isinstance(node, ast.Starred):
            return _elem(self.expr(node.value))
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.expr(v.value)
            return False
        if isinstance(node, ast.Lambda):
            return False                # analyzed when invoked/passed
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.expr(part)
            return False
        return False

    # ---- calls ------------------------------------------------------------

    def _call_local(self, sub: ast.AST, arg_ts: List, kw_ts: Dict):
        """Run a nested def / lambda on these argument taints (the
        closure sees the enclosing function's)."""
        fi = FuncInfo(self.mod, sub, self.fi.cls)
        env = dict(self.env)
        for p in fi.params():
            env.pop(p, None)
        env.update(self.an.bind_args(fi, arg_ts, kw_ts))
        walker = _BodyWalker(self.an, fi, env)
        walker.local_funcs = dict(self.local_funcs)
        if isinstance(sub, ast.Lambda):
            return walker.expr(sub.body)
        walker.run(sub.body)
        return walker.ret

    def _call_value(self, fexpr: ast.AST, arg_ts: List, kw_ts: Dict):
        """``(f if c else wrap(f))(args)``: each local function the
        callee expression names, directly or as an argument of the
        wrapper that returns it, runs on ``args``."""
        if isinstance(fexpr, ast.Name) and fexpr.id in self.local_funcs:
            return self._call_local(self.local_funcs[fexpr.id], arg_ts,
                                    kw_ts)
        if isinstance(fexpr, ast.IfExp):
            self._test(fexpr.test, "ternary on a device tensor (use "
                       "torch.where)")
            return _join(self._call_value(fexpr.body, arg_ts, kw_ts),
                         self._call_value(fexpr.orelse, arg_ts, kw_ts))
        out = _dev(self.expr(fexpr)) or any(
            _dev(t) for t in list(arg_ts) + list(kw_ts.values()))
        if isinstance(fexpr, ast.Call):
            for a in fexpr.args:
                if isinstance(a, ast.Name) and a.id in self.local_funcs:
                    out = _join(out, self._call_local(
                        self.local_funcs[a.id], arg_ts, kw_ts))
        return out

    def _module_of(self, alias: str) -> str:
        """The module a root name refers to ("" for none)."""
        if alias in self.mod.import_alias:
            return self.mod.import_alias[alias]
        if alias in self.mod.from_imports:
            m, sym = self.mod.from_imports[alias]
            return m + "." + sym
        return ""

    def call(self, node: ast.Call):
        arg_ts = [self.expr(a) for a in node.args]
        kw_ts = {kw.arg: self.expr(kw.value) for kw in node.keywords
                 if kw.arg is not None}
        for kw in node.keywords:
            if kw.arg is None:
                self.expr(kw.value)
        any_dev = any(_dev(t) for t in arg_ts) or any(
            _dev(t) for t in kw_ts.values())
        func = node.func
        name = dotted_name(func) or ""
        short = name.split(".")[-1]

        # builtins ----------------------------------------------------------
        if isinstance(func, ast.Name) and func.id not in self.local_funcs \
                and not self._module_of(func.id) \
                and func.id not in self.mod.functions \
                and func.id not in self.mod.classes:
            if func.id in COERCING_BUILTINS and any_dev:
                self._flag(TRACE_COERCE, node, "%s() reads a device "
                           "tensor on the host" % func.id)
                return False
            if func.id in ("len", "isinstance", "hasattr", "id",
                           "getattr", "repr", "str", "type", "print",
                           "callable"):
                if func.id == "print" and any_dev:
                    self._flag(TRACE_HOSTCALL, node, "print() of a device "
                               "tensor reads it on the host")
                return False
            if func.id in ("tuple", "list") and len(arg_ts) == 1:
                return arg_ts[0] if isinstance(arg_ts[0], tuple) \
                    else _flat(arg_ts[0])
            if func.id in ("min", "max", "sum", "abs", "sorted",
                           "zip", "enumerate", "tuple", "list",
                           "dict", "set", "reversed"):
                return any_dev

        # methods of a value ------------------------------------------------
        base = False
        if isinstance(func, ast.Attribute):
            base = self.expr(func.value)
            if func.attr == "synchronize":
                self._flag(TRACE_HOSTCALL, node, ".synchronize() waits "
                           "for the device")
                return False
            if _dev(base) and func.attr in TENSOR_METHOD_COERCIONS:
                self._flag(TRACE_COERCE, node, ".%s() reads a device "
                           "tensor on the host" % func.attr)
                return False
            if _dev(base) and func.attr == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in list(node.args) + [kw.value for kw in
                                                node.keywords]):
                self._flag(TRACE_COERCE, node, ".to('cpu') reads a "
                           "device tensor on the host")
                return False
            if base and func.attr in STATIC_METHODS:
                return False
            if func.attr in CONTAINER_MUTATORS and isinstance(
                    func.value, ast.Name):
                if any_dev:                 # xs.append(tensor)
                    self._set(func.value.id, True)
                return False
            if func.attr in ("keys",):
                return False
            if func.attr in ("get", "pop", "setdefault", "values",
                             "items", "copy"):
                return _join(_flat(base), any_dev)

        # module classification --------------------------------------------
        root_alias = name.split(".")[0] if name else ""
        target = self._module_of(root_alias)
        top = target.split(".")[0]
        is_torch = top == "torch" or (root_alias == "torch" and not target)

        if top in HOST_TIME_MODULES:
            self._flag(TRACE_HOSTCALL, node, "%s() runs on the host"
                       % name)
            return False
        if top == "math" and any_dev:
            self._flag(TRACE_COERCE, node, "math.%s reads a device tensor "
                       "on the host (use torch)" % short)
            return False
        if top == "numpy" and any_dev:
            self._flag(TRACE_HOSTCALL, node, "numpy call %s on a device "
                       "tensor copies it to the host" % name)
            return False
        if is_torch:
            if short in TORCH_COERCIONS and any_dev:
                self._flag(TRACE_COERCE, node, "torch.%s() returns a host "
                           "value read from device tensors" % short)
                return False
            if short in COMBINATOR_SUFFIXES:
                for a in list(node.args) + [kw.value
                                            for kw in node.keywords]:
                    val = self._maybe_function_value(a)
                    if val is not None:
                        self._mark_function_value_tainted(val)
            return short not in TORCH_HOST_FUNCS    # torch ops: tensors

        # partial over a corpus/local function: propagate bound args -------
        if short == "partial" and node.args:
            val = self._maybe_function_value(node.args[0])
            if isinstance(val, FuncInfo):
                self.an.add_root(val, self.an.bind_args(
                    val, arg_ts[1:], kw_ts))
            elif val is not None:
                self._analyze_nested(val, all_tainted=any_dev)
            return False

        # local nested function call, or a computed callee ----------------
        if isinstance(func, ast.Name) and func.id in self.local_funcs:
            return self._call_local(self.local_funcs[func.id], arg_ts,
                                    kw_ts)
        if isinstance(func, (ast.IfExp, ast.Call)):
            return self._call_value(func, arg_ts, kw_ts)

        # corpus-resolved call: propagate per-parameter taint ---------------
        callee = self.an.resolve_call(self.fi, func)
        if callee is not None:
            taints = self.an.bind_args(callee, arg_ts, kw_ts)
            self.an.add_root(callee, taints)
            return self.an.result_of(callee, taints)
        # unresolvable: conservatively taint-propagating, no flag
        if isinstance(base, frozenset):
            return True                 # a method of an object on device
        return any_dev or _dev(base)


# ---------------------------------------------------------------------------
# roots
# ---------------------------------------------------------------------------

def _module_name(path: str) -> str:
    parts = path[:-3].split("/")
    if parts[0] == "src":
        parts = parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def resolve_root(corpus: Corpus, root: Root) -> FuncInfo:
    """The port function of ``root``; raises where it no longer exists
    (the table must follow the code)."""
    mod = corpus.module_of(_module_name(root.path))
    cls, _, fn = root.func.rpartition(".")
    node = None
    if mod is not None:
        node = (mod.classes.get(cls, {}) if cls else mod.functions).get(fn)
    if node is None:
        raise ValueError("trace_safety root %s (%s, for %s) not found"
                         % (root.func, root.path, root.site))
    fi = FuncInfo(mod, node, cls or None)
    unknown = set(root.static) - set(fi.call_params())
    if unknown:
        raise ValueError("trace_safety root %s names static parameters "
                         "it does not have: %s" % (root.func,
                                                   sorted(unknown)))
    return fi


def _seed_roots(an: _Analyzer, corpus: Corpus,
                roots: Sequence[Root]) -> int:
    for root in roots:
        fi = resolve_root(corpus, root)
        an.add_root(fi, {p: True for p in fi.call_params()
                         if p not in root.static})
    return len(roots)


def run(root: str = REPO_ROOT,
        subdirs: Sequence[str] = ("src",),
        roots: Sequence[Root] = ROOTS) -> List[Finding]:
    corpus = Corpus(root, subdirs)
    an = _Analyzer(corpus)
    _seed_roots(an, corpus, roots)
    return an.solve()
