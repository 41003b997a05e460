"""The port's static analysis suite (``tools/analyze_torch``), case for
case the reference's tests/test_analyze.py: every pass proven on a
seeded fixture in torch idiom under tests/fixtures/analyze_torch/ (the
*_bad.py module gives its finding, the *_clean.py twin none), the
packed validators on the port's own containers, and the repo under
``--strict`` against ``baseline.json``, whose entries each carry a
reason in the README's catalog. ``check_page_refcounts`` holds after
speculative, preempt / spill / share and cut-pool runs of the port's
engine and catches each broken invariant. The comparisons with the
reference's analyzer are in tests/test_torch_analyze_parity.py."""
import ast
import collections
import copy
import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.analyze_torch import (PASS_NAMES, check_page_refcounts,  # noqa: E402
                                 run_all)
from tools.analyze_torch import (concurrency, packed, recompile,  # noqa: E402
                                 shim, telemetry, trace_safety)
from tools.analyze_torch.common import (Corpus, Finding,  # noqa: E402
                                        load_baseline, write_baseline)
from tools.analyze_torch.rules import OMITTED, RULES  # noqa: E402
from tools.analyze_torch.trace_safety import Root  # noqa: E402

from repro_torch.configs import SASPConfig, get_config, reduced  # noqa: E402
from repro_torch.core.deploy import deploy_packed  # noqa: E402
from repro_torch.core.pruning import prune_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

FIX = os.path.join(REPO, "tests", "fixtures", "analyze_torch")
BASELINE = os.path.join(REPO, "tools", "analyze_torch", "baseline.json")
torch.set_num_threads(1)


def _rules(findings):
    return {f.rule for f in findings}


def _fixture(name):
    spec = importlib.util.spec_from_file_location(
        "fixture_" + name, os.path.join(FIX, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# pass 1: trace safety (host syncs)
# ---------------------------------------------------------------------------

def _roots(path, funcs):
    return tuple(Root("fixture", f, path, f, static)
                 for f, static in funcs)


BAD_ROOTS = _roots("trace_bad.py", (
    ("branches_on_tensor", ("n",)), ("coerces_tensor", ()),
    ("reads_item", ()), ("host_clock", ()), ("waits_for_device", ()),
    ("calls_helper", ())))
CLEAN_ROOTS = _roots("trace_clean.py", (
    ("branches_on_shape", ("n",)), ("selects_on_device", ()),
    ("static_branch", ("flag",)), ("reads_metadata", ()),
    ("container_default", ())))


def test_trace_safety_fixture_true_positives():
    found = trace_safety.run(FIX, subdirs=("trace_bad.py",),
                             roots=BAD_ROOTS)
    assert _rules(found) == {"TRACE-BRANCH", "TRACE-COERCE",
                             "TRACE-HOSTCALL"}, found
    assert all(f.path.endswith("trace_bad.py") for f in found), found
    # every seeded function gives its finding, the helper reached
    # through a call included, and nothing else
    flagged = {f.message.split(":")[0] for f in found}
    assert flagged == {"branches_on_tensor", "coerces_tensor", "reads_item",
                       "host_clock", "waits_for_device",
                       "helper_reads"}, found


def test_trace_safety_clean_twin_silent():
    found = trace_safety.run(FIX, subdirs=("trace_clean.py",),
                             roots=CLEAN_ROOTS)
    assert found == [], found


def test_trace_safety_static_parameter_is_not_a_tensor():
    """The same function as a root with its flag declared a tensor: the
    branch on it is a host sync."""
    roots = _roots("trace_clean.py", (("static_branch", ()),))
    found = trace_safety.run(FIX, subdirs=("trace_clean.py",), roots=roots)
    assert _rules(found) == {"TRACE-BRANCH"}, found


def test_trace_safety_root_table_follows_the_code():
    """A root that names a missing function, or a static parameter the
    function does not have, is an analyzer error, not a silent skip."""
    with pytest.raises(ValueError, match="not found"):
        trace_safety.run(FIX, subdirs=("trace_bad.py",), roots=_roots(
            "trace_bad.py", (("no_such_function", ()),)))
    with pytest.raises(ValueError, match="static parameters"):
        trace_safety.run(FIX, subdirs=("trace_bad.py",), roots=_roots(
            "trace_bad.py", (("coerces_tensor", ("nope",)),)))


def test_trace_safety_repo_reaches_serving_stack():
    """The repo run has real coverage: the engine's roots reach the
    model's prefill and decode, the MoE EP layer and every main-path
    kernel wrapper; its findings are the baselined host syncs."""
    corpus = Corpus(REPO, ("src",))
    an = trace_safety._Analyzer(corpus)
    assert trace_safety._seed_roots(an, corpus, trace_safety.ROOTS) == 15
    findings = an.solve()
    reached = {fi.label for fi, _t in an.state.values()}
    for name in ("decode_step", "prefill", "prefill_with_past",
                 "attn_apply_full", "attn_apply_decode", "ffn_apply",
                 "moe_ffn_ep", "sample_tokens", "fused_ffn", "sasp_gemm",
                 "int8_gemm", "mha", "launch_bshd", "Engine._restore_slot",
                 "gather_block_tables", "scatter_written_pages"):
        assert name in reached, name
    assert len(reached) > 150, len(reached)
    keys = {f.key() for f in findings}
    assert keys <= set(load_baseline(BASELINE)), findings
    assert ("TRACE-COERCE", "src/repro_torch/distribution/moe_ep.py",
            "_Infos.__init__: .cpu() reads a device tensor on the host"
            ) in keys


def _tree_copy(dst):
    """The port, its analyzer and the files the passes read, in ``dst``."""
    for rel in ("src/repro_torch", "tools/analyze_torch"):
        shutil.copytree(os.path.join(REPO, rel), os.path.join(dst, rel),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "tools", "__init__.py"),
                os.path.join(dst, "tools", "__init__.py"))


def _strict(root, passes):
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "tools.analyze_torch", "--strict",
         "--passes", passes], cwd=root, capture_output=True, text=True,
        env=env, timeout=300)


def test_new_host_sync_in_a_root_fails_strict(tmp_path):
    """In a copy of the tree, a ``.item()`` added to the decode step's
    body is a finding outside the baseline: ``--strict`` exits 1 and
    names it; the unedited copy exits 0."""
    root = str(tmp_path)
    _tree_copy(root)
    ok = _strict(root, "trace_safety,concurrency")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    eng = os.path.join(root, "src", "repro_torch", "serve", "engine.py")
    with open(eng, encoding="utf-8") as fh:
        src = fh.read()
    anchor = "        logits, self.caches = lm.decode_step(params, cfg, " \
             "toks, pos,\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, "        if pos.max().item() > 1 << 30:\n"
                      "            raise ValueError(pos)\n" + anchor)
    with open(eng, "w", encoding="utf-8") as fh:
        fh.write(src)
    bad = _strict(root, "trace_safety,concurrency")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "Engine._decode_step: .item() reads a device tensor" in \
        bad.stdout and "[NEW]" in bad.stdout, bad.stdout


# ---------------------------------------------------------------------------
# pass 2: shim enforcement
# ---------------------------------------------------------------------------

def test_shim_fixture_true_positive():
    found = shim.run(REPO, files=[os.path.join(FIX, "shim_bad.py")])
    assert _rules(found) == {"SHIM-IMPORT"}, found
    assert len(found) == 2, found          # the import and the collective


def test_shim_clean_twin_silent():
    found = shim.run(REPO, files=[os.path.join(FIX, "shim_clean.py")])
    assert found == [], found


def test_shim_allows_the_context_and_mesh_setup(tmp_path):
    ctx = os.path.join(REPO, "src", "repro_torch", "distribution",
                       "context.py")
    mesh = os.path.join(REPO, "src", "repro_torch", "launch", "mesh.py")
    assert shim.run(REPO, files=[ctx, mesh]) == []
    # launch/mesh.py may import torch.distributed and set groups up, but
    # a collective there is a finding
    fake = tmp_path / "src" / "repro_torch" / "launch" / "mesh.py"
    fake.parent.mkdir(parents=True)
    fake.write_text("import torch.distributed as dist\n\n\n"
                    "def join(n):\n"
                    "    dist.init_process_group('gloo', world_size=n)\n"
                    "    dist.barrier()\n")
    found = shim.run(str(tmp_path), files=[str(fake)])
    assert [f.message.split(": ")[1] for f in found] == [
        "torch.distributed.barrier() called directly — route it through "
        "repro_torch.distribution.context.Mesh"], found


def test_shim_scans_the_port_its_scripts_and_tests():
    rels = {os.path.relpath(p, REPO).replace(os.sep, "/")
            for p in shim.scan_files(REPO)}
    for rel in ("chip_smoke.py", "tools/analyze_torch/shim.py",
                "tools/depth_phase.py", "tests/test_torch_analyze.py",
                "src/repro_torch/distribution/context.py"):
        assert rel in rels, rel
    assert not any(r.startswith(("src/repro/", "tests/fixtures/"))
                   for r in rels)


# ---------------------------------------------------------------------------
# pass 3: recompile budget
# ---------------------------------------------------------------------------

def test_recompile_budget_math():
    """budget_for/predict_prefill_shapes agree with the documented
    model: one shape per bucket plus exact tail shapes."""
    buckets = (8, 16, 32, 64)
    shapes = recompile.predict_prefill_shapes(buckets, 2, range(1, 65))
    assert shapes == {(2, b) for b in buckets}
    assert len(shapes) <= recompile.budget_for(buckets, 64)
    # tail lengths beyond the largest bucket run exact shapes
    shapes = recompile.predict_prefill_shapes((8, 16), 2, range(1, 33))
    assert (2, 20) in shapes
    assert len(shapes) <= recompile.budget_for((8, 16), 32)


def test_recompile_budget_fixture_pair():
    """RECOMPILE-BUDGET over the launch flag sweep with an engine whose
    bucketing regressed to exact shapes; none with its clean twin."""
    bad = recompile.budget_findings(REPO, _fixture("recompile_bad").Engine)
    assert _rules(bad) == {"RECOMPILE-BUDGET"}, bad
    assert any("--buckets 4 --slots 4" in f.message for f in bad), bad
    clean = recompile.budget_findings(
        REPO, _fixture("recompile_clean").Engine)
    assert clean == [], clean


def test_recompile_budget_detects_broken_bucketing(monkeypatch):
    """The production bucketing disabled: the predicted shape count
    blows the documented budget, and the pass says so."""
    monkeypatch.setattr(Engine, "_bucket_len", lambda self, L: int(L))
    buckets = (8, 16, 32, 64)
    shapes = recompile.predict_prefill_shapes(buckets, 2, range(1, 65))
    assert len(shapes) > recompile.budget_for(buckets, 64)
    assert _rules(recompile.budget_findings(REPO)) == {"RECOMPILE-BUDGET"}


def test_recompile_shape_that_does_not_trace_is_a_finding(monkeypatch):
    """Every sampled prefill shape runs under FakeTensorMode: a prefill
    that fails to trace at a shape is reported at that shape."""
    real = lm.prefill

    def prefill(params, cfg, tokens, **kw):
        if tokens.shape[1] > 32:
            torch.zeros(2, 3) @ torch.zeros(4, 5)   # a shape error
        return real(params, cfg, tokens, **kw)
    monkeypatch.setattr(lm, "prefill", prefill)
    found = recompile.run(REPO)
    assert found and all("fails to trace" in f.message
                         for f in found), found
    assert {f.message.split(")")[0] for f in found} == {
        "admission shape (4, 64"}, found


def test_jit_rules_have_no_subject_in_the_port():
    """JIT-CLOSURE and JIT-STATIC-UNHASHABLE are left out because the
    port compiles nothing: no jax.jit, torch.compile or torch.jit call
    in src/repro_torch."""
    assert set(OMITTED) == {"JIT-CLOSURE", "JIT-STATIC-UNHASHABLE"}
    assert not set(OMITTED) & set(RULES)
    corpus = Corpus(REPO, ("src/repro_torch",))
    hits = []
    for mod in corpus.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Attribute) and (
                    node.attr in ("compile", "jit")
                    and isinstance(node.value, ast.Name)
                    and mod.import_alias.get(node.value.id, node.value.id)
                    in ("torch", "jax")):
                hits.append((mod.rel, node.lineno))
    assert len(corpus.modules) > 60
    assert hits == [], hits


# ---------------------------------------------------------------------------
# pass 4: concurrency lint
# ---------------------------------------------------------------------------

FIX_LOCK_SPECS = {
    "lock_bad.py": {
        "Peer": {
            "lock": "_lock",
            "protected": {"inbox"},
            "entry_points": {"push"},
        },
        "Worker": {
            "lock": "_lock",
            "protected": {"count"},
            "entry_points": {"increment", "forward"},
            "attr_classes": {"peer": ("lock_bad.py", "Peer")},
        },
    },
}
FIX_LOCK_ORDER = ["Peer._lock", "Worker._lock"]


def _clean_lock_specs():
    specs = {"lock_clean.py": {
        cls: dict(spec) for cls, spec in
        FIX_LOCK_SPECS["lock_bad.py"].items()}}
    specs["lock_clean.py"]["Worker"] = dict(
        specs["lock_clean.py"]["Worker"],
        attr_classes={"peer": ("lock_clean.py", "Peer")})
    return specs


def test_concurrency_fixture_true_positives():
    found = concurrency.run(FIX, specs=FIX_LOCK_SPECS,
                            lock_order=FIX_LOCK_ORDER)
    assert _rules(found) == {"LOCK-UNHELD", "LOCK-ORDER"}, found
    unheld = [f for f in found if f.rule == "LOCK-UNHELD"]
    assert any("count" in f.message for f in unheld), unheld


def test_concurrency_clean_twin_silent():
    found = concurrency.run(FIX, specs=_clean_lock_specs(),
                            lock_order=FIX_LOCK_ORDER)
    assert found == [], found


def test_concurrency_repo_serving_layer():
    """The port's frontend and scheduler: one finding, the baselined
    token callback of a mesh scheduler's engine (a lambda, which the
    pass reads as holding no lock)."""
    found = concurrency.run(REPO)
    assert [(f.rule, f.path, f.message) for f in found] == [(
        "LOCK-UNHELD", "src/repro_torch/serve/scheduler.py",
        "ShardedScheduler._build_engine touches shared attribute "
        "'_emitted' without holding ShardedScheduler._lock")], found


def test_concurrency_sees_an_unguarded_write(tmp_path):
    """A counter of the port's scheduler written off the lock, in a copy
    of the file, is a new finding."""
    rel = "src/repro_torch/serve/scheduler.py"
    with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
        src = fh.read()
    anchor = "    def _now(self) -> float:\n"
    assert src.count(anchor) == 1
    src = src.replace(anchor, "    def bump(self):\n"
                      "        self.n_shed += 1\n\n" + anchor)
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True)
    dst.write_text(src)
    specs = {rel: concurrency.REPO_LOCK_SPECS[rel]}
    found = concurrency.run(str(tmp_path), specs=specs)
    assert any("ShardedScheduler.bump touches shared attribute 'n_shed'"
               in f.message for f in found), found


# ---------------------------------------------------------------------------
# pass 5: packed-format invariants (the port's own containers; the
# corruptions shared with the reference are in the parity file)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def deployed():
    sasp = SASPConfig(enabled=True, block_k=16, block_n=16, sparsity=0.5,
                      scope="all")
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=64),
        sasp=sasp)
    pruned, _ = prune_params(lm.init_params(cfg, device="cpu"), sasp)
    return {tp: deploy_packed(pruned, cfg, tp=tp)[0] for tp in (1, 2)}


def _first(tree, kind):
    return next(c for _k, c in packed.packed_leaves(tree)
                if type(c).__name__ == kind)


def test_packed_clean_containers_validate(deployed):
    for tree in deployed.values():
        leaves = list(packed.packed_leaves(tree))
        assert len(leaves) >= 4, leaves
        assert packed.validate_params_tree(tree) == []


def test_packed_col_ptr_checked(deployed):
    """The port's derived ``col_ptr``: int32, and the CSR offsets of kn."""
    pw = _first(deployed[1], "PackedSASPWeight")
    bad = dataclasses.replace(pw, col_ptr=pw.col_ptr.to(torch.int64))
    assert {r for r, _ in packed.validate_packed_weight(bad)} == {
        "PACK-DTYPE"}
    stale = pw.col_ptr.clone()
    stale[..., 1] += 1
    assert {r for r, _ in packed.validate_packed_weight(
        dataclasses.replace(pw, col_ptr=stale))} == {"PACK-KIND"}


def test_packed_repo_deployments_clean():
    """The real pass, on the CPU here: pack + deploy the reduced model
    across shardings and check every container and the conservation."""
    assert packed.run(REPO, device="cpu") == []


def test_packed_pass_refuses_the_cpu_by_default():
    """Without a card the pass stops unless asked for the CPU; so does
    the CLI (exit 2, the internal-error code)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        packed.run(REPO)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "tools.analyze_torch", "--passes",
         "packed"], cwd=REPO, capture_output=True, text=True, env=env,
        timeout=300)
    assert res.returncode == 2, res.stdout + res.stderr
    assert "--device cpu" in res.stderr


# ---------------------------------------------------------------------------
# pass 6: telemetry declaration discipline
# ---------------------------------------------------------------------------

def test_telemetry_fixture_true_positives():
    found = telemetry.run(
        FIX, files=[os.path.join(FIX, "telemetry_bad.py")])
    assert _rules(found) == {"TELEMETRY-DECLARED"}, found
    keys = {f.message.split("'")[1] for f in found}
    assert keys == {"bogus_counter", "mystery_gauge"}, found


def test_telemetry_clean_twin_silent():
    found = telemetry.run(
        FIX, files=[os.path.join(FIX, "telemetry_clean.py")])
    assert found == [], found


def test_telemetry_repo_serving_layer_clean():
    """Every stats[...] write in src/repro_torch/serve/ is declared — and
    the scan has real coverage (the engine alone writes a dozen keys)."""
    assert telemetry.run(REPO) == []
    eng = os.path.join(REPO, "src", "repro_torch", "serve", "engine.py")
    with open(eng, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    writes = [n for n in ast.walk(tree)
              if isinstance(n, (ast.Assign, ast.AugAssign))
              and telemetry._stats_key(
                  n.target if isinstance(n, ast.AugAssign)
                  else n.targets[0]) is not None]
    assert len(writes) >= 8, len(writes)


# ---------------------------------------------------------------------------
# the CLI: registry, baseline, strict gate, catalog
# ---------------------------------------------------------------------------

def test_rule_registry_covers_all_findings():
    fix_findings = (
        trace_safety.run(FIX, subdirs=("trace_bad.py",), roots=BAD_ROOTS)
        + shim.run(REPO, files=[os.path.join(FIX, "shim_bad.py")])
        + recompile.budget_findings(REPO,
                                    _fixture("recompile_bad").Engine)
        + concurrency.run(FIX, specs=FIX_LOCK_SPECS,
                          lock_order=FIX_LOCK_ORDER)
        + telemetry.run(FIX,
                        files=[os.path.join(FIX, "telemetry_bad.py")]))
    assert _rules(fix_findings) == set(RULES) - {
        "PACK-CONSERVE", "PACK-PAD", "PACK-DTYPE", "PACK-KIND"}
    for f in fix_findings:
        assert f.rule in RULES, f
        assert f.severity == "error"
        assert f.render()
    assert set(PASS_NAMES) == {r.pass_name for r in RULES.values()}


def test_baseline_roundtrip(tmp_path):
    f1 = Finding("SHIM-IMPORT", "a.py", 3, "m1")
    f2 = Finding("LOCK-UNHELD", "b.py", 7, "m2")
    p = tmp_path / "baseline.json"
    write_baseline(str(p), [f1, f2])
    keys = set(load_baseline(str(p)))
    assert f1.key() in keys and f2.key() in keys
    # line numbers are not part of the key: moving a finding does not
    # invalidate its baseline entry
    assert Finding("SHIM-IMPORT", "a.py", 99, "m1").key() in keys


def test_repo_strict_is_clean_against_the_baseline():
    """The gate: every pass over the repo (the packed pass on the CPU)
    finds nothing beyond baseline.json, and every baseline entry is
    still found (none stale), one entry per finding."""
    findings = run_all(device="cpu")
    baseline = load_baseline(BASELINE)
    assert len(baseline) == len(set(baseline)) == len(findings)
    fresh = [f for f in findings if f.key() not in set(baseline)]
    assert fresh == [], fresh
    assert {f.key() for f in findings} == set(baseline)


def _readme_catalog():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        text = fh.read()
    start = text.index("### The port's analyzer")
    end = text.index("\n## ", start)
    return text[start:end]


def test_readme_catalog_is_the_registry():
    """The README's rule table lists exactly RULES, the two left-out
    rules with their reason, and every baselined finding with its rule,
    file and function and a reason."""
    cat = _readme_catalog()
    rows = [ln for ln in cat.splitlines() if ln.startswith("| `")]
    ids = {re.match(r"\| `([A-Z-]+)`", ln).group(1) for ln in rows
           if re.match(r"\| `([A-Z-]+)` \| (trace_safety|shim|recompile|"
                       r"concurrency|packed|telemetry) \|", ln)}
    assert ids == set(RULES), ids ^ set(RULES)
    for rid in OMITTED:
        assert re.search(r"`%s`[^\n]*left out" % rid, cat), rid
    entries = collections.Counter(
        (rule, path, re.split(r"[: ]", message)[0])
        for rule, path, message in load_baseline(BASELINE))
    for (rule, path, scope), n in entries.items():
        hit = [ln for ln in rows if f"`{rule}`" in ln and f"`{path}:" in ln
               and f"`{scope}`" in ln]
        assert len(hit) == n, (rule, path, scope)
        for ln in hit:
            assert len(ln.split("|")[-2].strip()) > 40, ln  # a reason


# ---------------------------------------------------------------------------
# check_page_refcounts: the paged pool's runtime invariants
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=64),
        sasp=SASPConfig())
    return cfg, lm.init_params(cfg, device="cpu")


def _reqs(specs):
    return [Request(rid=i, prompt=np.asarray(p, np.int32),
                    max_new_tokens=n) for i, p, n in specs]


def _drive_checked(eng, errs, blocks=None):
    done = []
    while eng.has_work():
        done.extend(eng.step())
        errs.extend(check_page_refcounts(eng.pool))
        if blocks is not None:
            blocks.update(eng.pool._of.values())
    return done


@pytest.fixture(scope="module")
def runs(dense):
    """The port's speculative, preempt / spill / share and cut-pool
    engines after their runs, with the errors found after every step."""
    cfg, params = dense
    rng = np.random.default_rng(3)
    shared = rng.integers(0, 64, size=(17,))
    out = {}

    # speculative: a drafter at 75%, scratch pages every round
    eng = Engine(params, cfg, batch_slots=2, cache_len=64, kv_pages=20,
                 kv_page_len=8, draft_sparsity=0.75)
    errs = []
    for r in _reqs([(i, rng.integers(0, 64, size=(9 + 5 * i,)), 10)
                    for i in range(3)]):
        eng.submit(r)
    _drive_checked(eng, errs)
    out["spec"] = (eng, errs)

    # preempt / spill / share: two requests fork a shared prompt, a long
    # prompt preempts the running one, its pages spill and fault back
    eng = Engine(params, cfg, batch_slots=1, cache_len=64, kv_pages=8,
                 kv_page_len=8, kv_host_pages=10, kv_share=True)
    a, b, c = _reqs([(0, shared, 12), (1, np.concatenate([shared, [3]]), 12),
                     (2, rng.integers(0, 64, size=(40,)), 3)])
    errs = []
    eng.submit(a)
    for _ in range(4):
        eng.step()
        errs.extend(check_page_refcounts(eng.pool))
    eng.queue.insert(0, eng.preempt_slot(0))
    eng.submit(b)
    for _ in range(2):
        eng.step()
        errs.extend(check_page_refcounts(eng.pool))
    eng.queue.insert(0, c)
    eng.queue.insert(1, eng.preempt_slot(0))
    _drive_checked(eng, errs)
    out["share"] = (eng, errs)

    # the pool cut over 'data' (the meshless twin: both blocks here)
    eng = Engine(params, cfg, batch_slots=4, cache_len=64, kv_pages=24,
                 kv_page_len=8, data_shards=2, kv_share=True)
    errs, blocks = [], set()
    for r in _reqs([(i, np.concatenate([shared, [i]]), 6)
                    for i in range(6)]):
        eng.submit(r)
    _drive_checked(eng, errs, blocks)
    assert blocks == {0, 1}             # both blocks held requests
    out["cut"] = (eng, errs)
    return out


@pytest.mark.parametrize("name", ["spec", "share", "cut"])
def test_page_refcounts_hold_after_runs(runs, name):
    eng, errs = runs[name]
    assert errs == [], errs[:5]
    assert check_page_refcounts(eng.pool) == []
    eng.pool.check()                    # the pool's own asserts agree
    mem = eng.memory_stats()
    if name == "spec":
        assert eng.stats["spec_rounds"] >= 1
    if name == "share":
        assert mem.spills >= 1 and mem.faults >= 1 and mem.prefix_hits >= 1
    if name == "cut":
        assert eng.pool.blocks == 2 and mem.prefix_hits >= 1


def _alloc_with_pages():
    """An allocator with prefix sharing holding two requests' pages, one
    page of them shared."""
    from repro_torch.serve.memory import PageAllocator
    a = PageAllocator(range(2, 14), host_slots=4, watermark_cap=12,
                      slot_pages=4, share=True)
    keys = (b"p0", b"p1")
    assert a.admit_prefix(1, 3, keys)[0]
    a.register_prefix(1, keys)
    assert a.admit_prefix(2, 3, keys)[0]
    assert check_page_refcounts(a) == []
    assert max(a.rc.values()) == 2 and a.free_dev
    return a


def test_page_check_catches_a_leaked_page():
    a = _alloc_with_pages()
    a.free_dev.pop()
    assert any("leaked or double-owned" in e
               for e in check_page_refcounts(a))


def test_page_check_catches_a_double_reference():
    a = _alloc_with_pages()
    rid, refs = next(iter(a.tables.items()))
    p = next(e[1] for e in refs if e is not None and e[0] == "dev")
    a.tables[rid] = list(refs) + [("dev", p)]   # rc not raised with it
    assert any("refcount != block-table references" in e
               for e in check_page_refcounts(a))


def test_page_check_catches_a_breached_watermark():
    a = _alloc_with_pages()
    a.cap = a.used_dev - 1
    assert any("watermark breached" in e for e in check_page_refcounts(a))


def test_page_check_catches_a_registered_scratch_page():
    from repro_torch.serve.memory import _RadixNode
    a = _alloc_with_pages()
    rid = next(iter(a.resident))
    p = a.free_dev.pop()
    a.scratch[rid] = {a.NB - 1: p}
    node = _RadixNode()
    node.page = p
    a._node_of[p] = node
    errs = check_page_refcounts(a)
    assert any(f"scratch page {p} owned or registered" in e
               for e in errs), errs


def test_page_check_catches_a_request_in_the_wrong_block(runs):
    eng, _ = runs["cut"]
    pool = eng.pool
    a0 = copy.deepcopy(pool.allocs[0])
    if not a0.tables:
        a0.admit(99, 2)
    rid = next(iter(a0.tables))
    fake = types.SimpleNamespace(
        allocs=[a0, copy.deepcopy(pool.allocs[1])], n_device=pool.n_device,
        blocks=pool.blocks, _of={**pool._of, rid: 1})
    errs = check_page_refcounts(fake)
    assert any(f"block 0: rid {rid} has a table here but the pool maps "
               f"it to block 1" in e for e in errs), errs
    # and a block's allocator holding another block's page ids
    fake._of = {r: 0 for r in a0.tables}
    fake.allocs = [fake.allocs[1], fake.allocs[1]]
    assert any(e.startswith("block 0: allocator pages")
               for e in check_page_refcounts(fake))
