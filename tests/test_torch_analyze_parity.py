"""The port's analyzer (``tools/analyze_torch``) held to the reference's
(``tools/analyze``) on the same inputs: the same pruned weights deployed
by both packages at the reference pass's (tp, quantize, fuse_ffn) points
validate clean in both, give the same container paths and live visit
sets, and every corruption, applied alike to both packages' containers,
gives the same set of rule ids. The prefill shape prediction and budget
equal the reference's over a flag sweep, and a port engine run measures
exactly the predicted shapes. The roots table covers every jit site of
the reference, and the lock map keeps the reference's."""
import copy
import dataclasses
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tools.analyze import concurrency as r_concurrency  # noqa: E402
from tools.analyze import packed as r_packed  # noqa: E402
from tools.analyze import recompile as r_recompile  # noqa: E402
from tools.analyze import telemetry as r_telemetry  # noqa: E402
from tools.analyze_torch import (concurrency, packed, recompile,  # noqa: E402
                                 telemetry, trace_safety)

from repro.core.deploy import deploy_packed, reshard_packed  # noqa: E402
from repro.core.pruning import prune_params  # noqa: E402
from repro.core.sparse import PackedFFN as RFFN  # noqa: E402
from repro.core.sparse import PackedSASPWeight as RWeight  # noqa: E402
from repro.serve.engine import Engine as REngine  # noqa: E402
from repro_torch.configs import SASPConfig, get_config, reduced  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from torch_parity import model, to_np  # noqa: E402

# the reference pass's deployments (tools/analyze/packed.py::run)
POINTS = {
    "tp=1": dict(fuse_ffn=True),
    "tp=2": dict(fuse_ffn=True, tp=2),
    "tp=2,unfused": dict(fuse_ffn=False, tp=2),
    "tp=1,int8": dict(quantize=True),
}
TAGS = tuple(POINTS) + ("reshard 1->2", "reshard 2->1")


@pytest.fixture(scope="module")
def deploys():
    """{tag: (reference tree in numpy, port tree)} of the same pruned
    reduced qwen3-32b (scope all, 50% of the 16x16 tiles)."""
    cfg, tcfg, params, tparams = model(scope="all", sparsity=0.5)
    pruned, _ = prune_params(params, cfg.sasp)
    tpruned, _ = t_pruning.prune_params(tparams, tcfg.sasp)
    ref = {t: deploy_packed(pruned, cfg, **kw)[0] for t, kw in POINTS.items()}
    mine = {t: t_deploy.deploy_packed(tpruned, tcfg, **kw)[0]
            for t, kw in POINTS.items()}
    for tag, src, tp in (("reshard 1->2", "tp=1", 2),
                         ("reshard 2->1", "tp=2", 1)):
        ref[tag] = reshard_packed(ref[src], cfg, tp=tp)
        mine[tag] = t_deploy.reshard_packed(mine[src], tcfg, tp=tp)
    return {t: (to_np(ref[t]), mine[t]) for t in TAGS}


def _ref_leaves(tree):
    is_packed = lambda x: isinstance(x, (RWeight, RFFN))  # noqa: E731
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_packed)[0]
            if is_packed(leaf)}


@pytest.mark.parametrize("tag", TAGS)
def test_packed_deployments_validate_alike(deploys, tag):
    """Both validators find nothing; the containers sit at the same key
    paths; each container's live visit set is the same in both."""
    ref, mine = deploys[tag]
    assert r_packed.validate_params_tree(ref) == []
    assert packed.validate_params_tree(mine) == []
    rl, ml = _ref_leaves(ref), dict(packed.packed_leaves(mine))
    assert set(rl) == set(ml) and len(ml) >= 5, set(rl) ^ set(ml)
    for key, rc in rl.items():
        if isinstance(rc, RWeight):
            assert r_packed.live_visit_sets(rc) == \
                packed.live_visit_sets(ml[key]), key
        else:
            assert r_packed.live_ffn_sets(rc) == \
                packed.live_ffn_sets(ml[key]), key


def _list0(a, nd):
    """The first visit list of a (…, *list dims) array (a view)."""
    return a.reshape((-1,) + a.shape[a.ndim - nd:])[0]


def _swap_ends(f):
    kn, vals = f["kn"].copy(), f["vals"].copy()
    k0, v0 = _list0(kn, 2), _list0(vals, 3)
    k0[:, [0, -1]] = k0[:, [-1, 0]]
    v0[[0, -1]] = v0[[-1, 0]]
    return {"kn": kn, "vals": vals}


def _dirty_pad(f):
    kn, vals = f["kn"].copy(), f["vals"].copy()
    k0, v0 = _list0(kn, 2), _list0(vals, 3)
    k0[:, -1] = k0[:, -2]
    v0[-1] = 1
    return {"kn": kn, "vals": vals}


def _dup_nonzero(f):
    kn = f["kn"].copy()
    k0 = _list0(kn, 2)
    if k0.shape[1] < 2:
        return {}
    k0[:, 1] = k0[:, 0]
    return {"kn": kn}


def _k_range(f):
    kn = f["kn"].copy()
    _list0(kn, 2)[0, 0] = 10 ** 6
    return {"kn": kn}


def _n_zero(f):
    kn = f["kn"].copy()
    _list0(kn, 2)[1, :] = 0
    return {"kn": kn}


def _f64(name):
    def mutate(f):
        return {} if f[name] is None else {name: f[name].astype(np.float64)}
    return mutate


W_CORRUPTIONS = {
    "kn_int64": lambda f: {"kn": f["kn"].astype(np.int64)},
    "unsort": _swap_ends,
    "dirty_pad": _dirty_pad,
    "dup_nonzero": _dup_nonzero,
    "k_range": _k_range,
    "n_all_zero": _n_zero,
    "wrong_block": lambda f: {"block": (f["block"][0] // 2, f["block"][1])},
    "no_kind": lambda f: {"shards": 2, "shard_kind": None},
    "kind_on_one": lambda f: {"shards": 1, "shard_kind": "col"},
    "act_on_rows": lambda f: {"act": "silu"},
    "scale_f64": _f64("scale"),
    "bias_f64": _f64("bias"),
}


def _pad_hole(f):
    jv = f["jv"].copy()
    _list0(jv, 1)[0] = -1
    return {"jv": jv}


def _dup_visit(f):
    jv = f["jv"].copy()
    j0 = _list0(jv, 1)
    if len(j0) < 2:
        return {}
    j0[1] = j0[0]
    return {"jv": jv}


def _jv_range(f):
    jv = f["jv"].copy()
    _list0(jv, 1)[0] = 10 ** 6
    return {"jv": jv}


def _pad_values(f):
    jv, w2v = f["jv"].copy(), f["w2v"].copy()
    _list0(jv, 1)[-1] = -1
    _list0(w2v, 3)[-1] = 1
    return {"jv": jv, "w2v": w2v}


def _cross_shard(f):
    if f["shards"] == 1:
        return {}
    jv = f["jv"].copy()
    lists = jv.reshape(-1, jv.shape[-1])
    lists[1, 0] = lists[0, 0]
    return {"jv": jv}


F_CORRUPTIONS = {
    "no_jv": lambda f: {"jv": None},
    "jv_int64": lambda f: {"jv": f["jv"].astype(np.int64)},
    "pad_hole": _pad_hole,
    "dup_visit": _dup_visit,
    "jv_range": _jv_range,
    "pad_values": _pad_values,
    "cross_shard": _cross_shard,
    "b2_split": lambda f: {"b2": np.stack([f["b2"], f["b2"]], axis=-2)},
    "s1_f64": _f64("s1"),
}

W_FIELDS = ("vals", "kn", "scale", "bias", "block", "shards", "shard_kind",
            "act")
F_FIELDS = ("w1v", "w3v", "w2v", "b1", "b3", "b2", "s1", "s3", "s2", "jv",
            "shards")


def _fields(c, names, np_of):
    return {n: np_of(getattr(c, n)) for n in names}


def _corrupt_both(rc, pc, mutate, names):
    """The same mutation on copies of both containers: numpy fields of
    the reference's, tensors of the port's (a weight's ``col_ptr`` is
    derived again from a changed kn, as the port derives it at load)."""
    def host(v):
        if isinstance(v, torch.Tensor):
            return v.numpy()
        return np.array(v) if isinstance(v, np.ndarray) else v
    changes = mutate(_fields(rc, names, host))
    mine = mutate(_fields(pc, names, host))
    r2 = copy.copy(rc)
    for k, v in changes.items():
        setattr(r2, k, v)
    tchanges = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                for k, v in mine.items()}
    if "kn" in tchanges:
        tchanges["col_ptr"] = None
    p2 = dataclasses.replace(pc, **tchanges)
    return r2, p2


def _containers(deploys, tag):
    ref, mine = deploys[tag]
    rl, ml = _ref_leaves(ref), dict(packed.packed_leaves(mine))
    ws = [k for k in rl if isinstance(rl[k], RWeight)
          and k.endswith(("['wq']", "['wo']", "['w2']"))]
    fs = [k for k in rl if isinstance(rl[k], RFFN)]
    return rl, ml, ws, fs


@pytest.mark.parametrize("tag", TAGS)
def test_packed_corruptions_give_the_same_rule_ids(deploys, tag):
    rl, ml, ws, fs = _containers(deploys, tag)
    assert ws, tag
    seen = set()
    for key in ws:
        for name, mutate in W_CORRUPTIONS.items():
            r2, p2 = _corrupt_both(rl[key], ml[key], mutate, W_FIELDS)
            want = {r for r, _ in r_packed.validate_packed_weight(r2)}
            got = {r for r, _ in packed.validate_packed_weight(p2)}
            assert got == want, (tag, key, name, got, want)
            seen |= got
            if name in ("kn_int64", "k_range", "wrong_block"):
                assert got, (tag, key, name)
    for key in fs:
        for name, mutate in F_CORRUPTIONS.items():
            r2, p2 = _corrupt_both(rl[key], ml[key], mutate, F_FIELDS)
            want = {r for r, _ in r_packed.validate_packed_ffn(r2)}
            got = {r for r, _ in packed.validate_packed_ffn(p2)}
            assert got == want, (tag, key, name, got, want)
            seen |= got
            if name in ("no_jv", "jv_int64", "jv_range", "b2_split"):
                assert got, (tag, key, name)
    assert seen == {"PACK-CONSERVE", "PACK-PAD", "PACK-DTYPE",
                    "PACK-KIND"}, (tag, seen)


def test_packed_run_is_clean_in_both():
    """Both analyzer passes over their own package's deployments."""
    assert packed.run(REPO, device="cpu") == []
    assert r_packed.run(REPO) == []


# ---------------------------------------------------------------------------
# recompile budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache_len", [64, 256])
@pytest.mark.parametrize("spec", ["4", "2", "32,64,128", "8,16,32,64",
                                  None])
def test_budget_equals_reference(spec, cache_len):
    from repro.launch.serve import parse_buckets as r_parse
    from repro_torch.launch.serve import parse_buckets as t_parse
    try:
        want = r_parse(spec, cache_len)
    except SystemExit:
        with pytest.raises(SystemExit):
            t_parse(spec, cache_len)
        return
    buckets = t_parse(spec, cache_len)
    assert (None if buckets is None else tuple(buckets)) == (
        None if want is None else tuple(want))
    assert recompile.budget_for(buckets, cache_len) == \
        r_recompile.budget_for(want, cache_len)
    lengths = range(1, cache_len + 1)
    for slots in (1, 2, 4):
        assert recompile.predict_prefill_shapes(buckets, slots, lengths) \
            == r_recompile.predict_prefill_shapes(want, slots, lengths)


def test_flag_domains_equal_reference():
    """The port's launcher parses to the reference's defaults."""
    assert recompile._flag_defaults(REPO)[0] == \
        r_recompile._flag_defaults(REPO)


def test_broken_bucketing_caught_alike(monkeypatch):
    for cls in (Engine, REngine):
        monkeypatch.setattr(cls, "_bucket_len", lambda self, L: int(L))
    buckets = (8, 16, 32, 64)
    got = recompile.predict_prefill_shapes(buckets, 2, range(1, 65))
    want = r_recompile.predict_prefill_shapes(buckets, 2, range(1, 65))
    assert got == want
    assert len(got) > recompile.budget_for(buckets, 64)
    assert recompile.budget_findings(REPO)


@pytest.fixture(scope="module")
def dense_port():
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=64),
        sasp=SASPConfig())
    return cfg, t_lm.init_params(cfg, device="cpu")


def _measured(eng, specs):
    shapes = set()
    run = eng._run_prefill

    def counting(toks, poss, all_slots, reqs, valid):
        shapes.add(tuple(np.shape(toks)))
        return run(toks, poss, all_slots, reqs, valid)
    eng._run_prefill = counting
    eng.run([Request(rid=i, prompt=np.asarray(p, np.int32),
                     max_new_tokens=2) for i, p in enumerate(specs)])
    return shapes


def test_engine_measures_the_predicted_shapes(dense_port):
    """One solo admission a bucket: the port engine's measured prefill
    shapes equal the prediction (the port's and the reference's); 12
    random prompts on 2 slots stay inside it, every shape (2, bucket)."""
    cfg, params = dense_port
    buckets = (8, 16, 32, 64)
    rng = np.random.default_rng(6)
    lengths = (4, 12, 20, 40)
    eng = Engine(params, cfg, batch_slots=1, cache_len=64, buckets=buckets)
    got = _measured(eng, [rng.integers(0, 64, size=(n,)) for n in lengths])
    assert got == recompile.predict_prefill_shapes(buckets, 1, lengths) \
        == r_recompile.predict_prefill_shapes(buckets, 1, lengths) \
        == {(1, b) for b in buckets}
    prompts = [rng.integers(0, 64, size=(int(rng.integers(2, 60)),))
               for _ in range(12)]
    eng = Engine(params, cfg, batch_slots=2, cache_len=64, buckets=buckets)
    got = _measured(eng, prompts)
    assert got <= recompile.predict_prefill_shapes(
        buckets, 2, [len(p) for p in prompts])
    assert all(g == 2 and s in buckets for g, s in got), got
    assert len(got) <= recompile.budget_for(buckets, 64)


# ---------------------------------------------------------------------------
# trace safety, concurrency, telemetry: the reference's subjects
# ---------------------------------------------------------------------------

def _jit_sites():
    out = set()
    for rel in ("src/repro/serve/engine.py",
                "src/repro/kernels/sasp_gemm/ops.py",
                "src/repro/kernels/int8_gemm/ops.py",
                "src/repro/kernels/flash_attn/ops.py"):
        with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if "jax.jit" in line:
                    out.add(f"{rel}:{i}")
    return out


def test_roots_cover_every_jit_site_of_the_reference():
    """One row per ``jax.jit`` of the reference's engine and kernel
    wrappers (the paged prefill and its suffix form share a port
    function), each row naming a port function that exists."""
    sites = [r.site for r in trace_safety.ROOTS]
    assert len(sites) == len(set(sites))
    assert set(sites) == _jit_sites()
    from tools.analyze_torch.common import Corpus
    corpus = Corpus(REPO, ("src/repro_torch",))
    for root in trace_safety.ROOTS:
        trace_safety.resolve_root(corpus, root)


def test_lock_map_keeps_the_reference():
    """Each class the reference's lock map names has its counterpart in
    the port's, with the same lock and entry points and every protected
    attribute; the port adds two, both attributes of its scheduler."""
    port = {rel.replace("repro_torch", "repro"): spec
            for rel, spec in concurrency.REPO_LOCK_SPECS.items()}
    assert set(port) == set(r_concurrency.REPO_LOCK_SPECS)
    added = set()
    for rel, classes in r_concurrency.REPO_LOCK_SPECS.items():
        assert set(port[rel]) == set(classes)
        for cls, spec in classes.items():
            mine = port[rel][cls]
            assert mine.get("lock") == spec.get("lock")
            assert mine.get("entry_points") == spec.get("entry_points")
            assert set(mine.get("protected", ())) >= set(
                spec.get("protected", ()))
            added |= set(mine.get("protected", ())) - set(
                spec.get("protected", ()))
            assert {k: (f.replace("repro_torch", "repro"), c) for k, (f, c)
                    in mine.get("attr_classes", {}).items()} == \
                spec.get("attr_classes", {})
    assert added == {"_by_rid", "_emitted"}
    with open(os.path.join(REPO, "src/repro_torch/serve/scheduler.py"),
              encoding="utf-8") as fh:
        src = fh.read()
    for attr in added:
        assert re.search(r"self\.%s\b" % attr, src), attr
    assert concurrency.REPO_LOCK_ORDER == r_concurrency.REPO_LOCK_ORDER


def test_telemetry_fixtures_and_declarations_alike():
    from repro.serve.telemetry import DECLARED_STATS as ref_stats
    from repro_torch.serve.telemetry import DECLARED_STATS as port_stats
    assert port_stats == ref_stats
    fix = os.path.join(REPO, "tests", "fixtures")
    want = r_telemetry.run(fix, files=[os.path.join(
        fix, "analyze", "telemetry_bad.py")])
    got = telemetry.run(fix, files=[os.path.join(
        fix, "analyze_torch", "telemetry_bad.py")])
    assert [(f.rule, f.line, f.message.split("'")[1]) for f in got] == \
        [(f.rule, f.line, f.message.split("'")[1]) for f in want]
