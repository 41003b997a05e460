"""Pass 3 — recompile-budget checker, over the port's engine.

The reference's jitted admission is bounded because prefill shapes are
bucketed (DESIGN.md §12). The port compiles nothing, but the same bucket
table bounds how many shapes its kernels are launched at and how many
graphs a later CUDA-graph capture of the step would need: with a table,
every admission group is padded to ``(batch_slots, bucket)``, so at most
``len(buckets)`` prefill shapes plus one exact shape per tail length
beyond the largest bucket, and one decode shape per batch. This pass:

* sweeps the config space reachable from ``src/repro_torch/launch/
  serve.py``'s flag domains (bucket tables × slots × mesh shapes, the
  defaults parsed out of its argparse AST so flag changes are tracked),
* predicts the distinct shape set with the PRODUCTION bucketing code
  (``Engine._bucket_len`` on a shell instance — no parallel
  reimplementation that could drift),
* checks every predicted shape by running ``lm.prefill`` /
  ``lm.decode_step`` under ``FakeTensorMode`` on fake params (as
  ``launch/dryrun.py`` traces a step: no device, no kernel build), and
* emits RECOMPILE-BUDGET when the predicted distinct-shape count
  exceeds the documented budget, or a shape fails to trace.

The reference's jit-cache-key hazards (JIT-CLOSURE, JIT-STATIC-
UNHASHABLE) have no subject in the port (``rules.OMITTED``).
``predict_prefill_shapes`` / ``budget_for`` are importable by tests,
which hold them to the reference's and to an engine run's shapes.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .common import Finding, REPO_ROOT
from .rules import RECOMPILE_BUDGET

LAUNCH_REL = "src/repro_torch/launch/serve.py"
ENGINE_REL = "src/repro_torch/serve/engine.py"

# flag domains: bucket specs a user can pass × slots × mesh shapes
BUCKET_SPECS = ("4", "2", "32,64,128", None)
MESH_DOMAIN = ((1, 1), (2, 1), (1, 2))


# ---------------------------------------------------------------------------
# static prediction (shared with tests)
# ---------------------------------------------------------------------------

def predict_prefill_shapes(buckets: Optional[Sequence[int]],
                           batch_slots: int, lengths: Sequence[int],
                           engine_cls=None) -> Set[Tuple[int, int]]:
    """Distinct (rows, padded_len) admission shapes the Engine runs for
    prompts of the given lengths, through the production bucketing code
    (``engine_cls._bucket_len``, default the port's ``Engine``).

    With buckets, every group admission pads to all ``batch_slots`` rows
    and the group max length rounds up to a bucket, so the shape of a
    group is ``(B, bucket_len(max lens))`` — and since the group max is
    itself one of the lengths, the set over singleton lengths covers
    every reachable group shape. Without buckets shapes are exact and
    unbounded; callers get one shape per distinct length (solo
    admissions, rows=1) as a lower bound.
    """
    if engine_cls is None:
        from repro_torch.serve.engine import Engine as engine_cls
    if not buckets:
        return {(1, int(L)) for L in lengths}
    shell = engine_cls.__new__(engine_cls)      # no params/caches needed
    shell.buckets = tuple(sorted({int(b) for b in buckets}))
    return {(int(batch_slots), engine_cls._bucket_len(shell, int(L)))
            for L in lengths}


def budget_for(buckets: Optional[Sequence[int]], cache_len: int) -> int:
    """Documented admission-shape budget: one shape per bucket plus one
    exact shape per tail length beyond the largest bucket (DESIGN.md
    §12's 'rare tail')."""
    if not buckets:
        return int(cache_len)
    bs = sorted({int(b) for b in buckets})
    tail = max(0, int(cache_len) - bs[-1])
    return len(bs) + tail


# ---------------------------------------------------------------------------
# launch flag-domain extraction (argparse AST)
# ---------------------------------------------------------------------------

def _flag_defaults(root: str) -> Tuple[Dict[str, object], int]:
    """The ``add_argument`` defaults of the flags that shape the
    admission, read from the launcher without importing it, and the line
    of its ``--buckets`` flag."""
    path = os.path.join(root, LAUNCH_REL)
    out: Dict[str, object] = {"--slots": 4, "--cache-len": 256}
    line = 1
    try:
        with open(path, "r", encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
    except OSError:
        return out, line
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"
                and node.args
                and isinstance(node.args[0], ast.Constant)):
            continue
        flag = node.args[0].value
        if flag == "--buckets":
            line = node.lineno
        if flag not in ("--slots", "--cache-len"):
            continue
        for kw in node.keywords:
            if kw.arg == "default" and isinstance(kw.value, ast.Constant):
                out[flag] = kw.value.value
    return out, line


def budget_findings(root: str = REPO_ROOT, engine_cls=None
                    ) -> List[Finding]:
    """RECOMPILE-BUDGET over the flag domains, with ``engine_cls``'s
    bucketing (default the port's ``Engine``)."""
    from repro_torch.launch.serve import parse_buckets

    defaults, line = _flag_defaults(root)
    cache_len = int(defaults["--cache-len"])
    findings: List[Finding] = []
    lengths = range(1, cache_len + 1)
    for spec in BUCKET_SPECS:
        buckets = parse_buckets(spec, cache_len)
        if not buckets:
            continue
        budget = budget_for(buckets, cache_len)
        for slots in (1, int(defaults["--slots"])):
            shapes = predict_prefill_shapes(buckets, slots, lengths,
                                            engine_cls)
            # shapes are mesh-invariant by construction; the budget must
            # hold at every mesh point (rank_bucket_tables gives every
            # DP rank the same table)
            for dp, tp in MESH_DOMAIN:
                if len(shapes) > budget:
                    findings.append(Finding(
                        RECOMPILE_BUDGET, LAUNCH_REL, line,
                        "--buckets %s --slots %d --mesh %d,%d: %d "
                        "distinct admission shapes > budget %d"
                        % (spec, slots, dp, tp, len(shapes), budget)))
                    break
    return findings


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def run(root: str = REPO_ROOT) -> List[Finding]:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import parse_buckets
    from repro_torch.models import lm

    findings = budget_findings(root)
    defaults, _ = _flag_defaults(root)
    cache_len = int(defaults["--cache-len"])
    slots = int(defaults["--slots"])
    cfg = reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=64)
    eval_cache_len = 64

    def fails(fn) -> Optional[str]:
        try:
            with FakeTensorMode():
                fn(lm.init_params(cfg, device="cpu"))
            return None
        except Exception as e:          # a shape that does not trace
            return "%s: %s" % (type(e).__name__, e)

    def prefill(B: int, S: int):
        def fn(p):
            toks = torch.zeros((B, S), dtype=torch.int32)
            poss = torch.arange(S, dtype=torch.int32).expand(B, S)
            lm.prefill(p, cfg, toks, cache_len=eval_cache_len,
                       positions=poss)
        return fn

    checked: Set[Tuple[int, int]] = set()
    for spec in BUCKET_SPECS:
        buckets = parse_buckets(spec, cache_len)
        # a bounded sample of the predicted shapes (bucketed tables are
        # small; tail / exact shapes are sampled)
        sample = sorted(predict_prefill_shapes(
            buckets, slots, range(1, cache_len + 1)))[:8]
        for B, S in sample:
            S = min(S, eval_cache_len)
            if (B, S) in checked:
                continue
            checked.add((B, S))
            err = fails(prefill(B, S))
            if err:
                findings.append(Finding(
                    RECOMPILE_BUDGET, ENGINE_REL, 1,
                    "admission shape (%d, %d) fails to trace: %s"
                    % (B, S, err)))

    # decode: exactly one shape per batch size
    def decode(p):
        caches = lm.init_caches(p, cfg, slots, eval_cache_len)
        lm.decode_step(p, cfg, torch.zeros((slots, 1), dtype=torch.int32),
                       torch.zeros((slots,), dtype=torch.int32), caches)
    err = fails(decode)
    if err:
        findings.append(Finding(
            RECOMPILE_BUDGET, ENGINE_REL, 1,
            "decode shape fails to trace: %s" % err))
    return findings
