"""Tensor-parallel serving of the port on a 2-process gloo mesh (CPU):
every model rank's engine — its local tree (one shard of each
container), its local heads and caches, the 'model' all-reduces, model
rank 0's token broadcast — against the port's own tp=2 shard loop in one
process: streams and every decode step's logits bit for bit, fused and
per-matrix FFN, contiguous and paged (int8 KV too), on every rank, with
scope ffn too (dense attention sliced by the rules); the
rs+int8-ag reduction within the reference's 2e-2 of the exact one, its
int8 rows equal to a numpy version of the same formula; a rank's tree
built layer by layer (``build_rank_params``) equal to its shard of the
whole build at tp 1, 2 and 4; and the serve launcher's --mesh path, with
--ckpt-dir (a reference checkpoint, held to the reference's engine) and
with --stream --trace-out --metrics-dump. Imports no jax at its top
(only those two tests do, inside): the ranks are spawned processes that
import this module."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SASPConfig, get_config, reduced  # noqa: E402
from repro_torch.core import deploy as t_deploy  # noqa: E402
from repro_torch.core.pruning import prune_params  # noqa: E402
from repro_torch.distribution import context as dctx  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.mesh import init_file_in  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh, run_ranks  # noqa: E402
from repro_torch.models import ffn as ffn_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

TP = 2
# (fused FFN, engine options, int8 KV, scope)
SCENARIOS = {
    "fused-contiguous": (True, {}, False, "all"),
    "fused-paged": (True, dict(kv_pages=24, kv_page_len=8), False, "all"),
    "matrix-contiguous": (False, {}, False, "all"),
    "matrix-paged": (False, dict(kv_pages=24, kv_page_len=8), False, "all"),
    "fused-int8kv": (True, {}, True, "all"),
    # dense attention sliced by the rules (wo's partial all-reduced); the
    # shard loop runs the same slices (cfg.tp_shards), so bit for bit too
    "fused-scope-ffn": (True, {}, False, "ffn"),
}


def _model(fused: bool, int8_kv: bool, scope: str = "all"):
    """The reduced qwen3 of the reference's mesh worker (2 layers, d 64,
    vocab 128, 25% of the 8x8 tiles, scope all), port-initialised from
    seed 0, packed at tp=2 (every shard in the tree)."""
    sasp = SASPConfig(enabled=True, block_k=8, block_n=8, sparsity=0.25,
                      scope=scope)
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128),
        sasp=sasp, kv_quant=int8_kv)
    params = lm.init_params(cfg, seed=0, device="cpu")
    pruned, _ = prune_params(params, sasp)
    return t_deploy.deploy_packed(pruned, cfg, fuse_ffn=fused, tp=TP)


def _requests():
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 128, size=(8 + 7 * i,))
                    .astype(np.int32), max_new_tokens=6) for i in range(3)]


def record_decode_logits(eng) -> list:
    """Every target decode step's (B, V) logits, cloned as they come."""
    steps = []

    def wrap(fn):
        def recorded(params, cfg, *a):
            out = fn(params, cfg, *a)
            if params is eng.params:
                steps.append(out.clone())
            return out
        return recorded

    eng._decode_step = wrap(eng._decode_step)
    eng._paged_decode_step = wrap(eng._paged_decode_step)
    return steps


def _serve(params, cfg, opts, mesh=None):
    """(streams, every decode step's logits, the allocator's page tables
    after each step or None)."""
    eng = Engine(params, cfg, batch_slots=2, cache_len=64, mesh=mesh,
                 **opts)
    steps = record_decode_logits(eng)
    for r in _requests():
        eng.submit(r)
    done, tables = [], []
    while eng.has_work():
        done += eng.step()
        if eng.pool is not None:
            tables.append(repr(sorted(eng.pool.allocs[0].tables.items())))
    return ({r.rid: [int(t) for t in r.out_tokens] for r in done},
            [s.numpy().copy() for s in steps], tables or None)


def _rs_ag_case(mesh):
    """A partial (M, d) of this rank reduced by ``_rs_ag_int8``, with the
    exact sum and this rank's int8 rows (before the all-gather)."""
    gen = torch.Generator().manual_seed(11)
    parts = [torch.randn((5, 64), generator=gen) for _ in range(TP)]
    mine = parts[mesh.model_rank]
    with dctx.use_mesh(mesh):
        got = ffn_mod._rs_ag_int8(mine, torch.float32)
        y_rs = dctx.psum_scatter(mine, 1)
    return dict(parts=[p.numpy() for p in parts], got=got.numpy(),
                y_rs=y_rs.numpy())


def rank_scenarios(rank: int, init_file: str) -> dict:
    """One model rank: every scenario on the mesh, and the rs+int8-ag
    case."""
    torch.set_num_threads(1)
    mesh = make_test_mesh(TP, rank=rank, init_file=init_file)
    out = {"rs_ag": _rs_ag_case(mesh)}
    for name, (fused, opts, int8_kv, scope) in SCENARIOS.items():
        params, cfg = _model(fused, int8_kv, scope)
        out[name] = _serve(local_params(params, cfg, TP, rank),
                           local_config(cfg, TP), opts, mesh=mesh)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    store = init_file_in(str(tmp_path_factory.mktemp("mesh")))
    return run_ranks(rank_scenarios, TP, (store,), timeout=110)


@pytest.mark.timeout(120)
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_mesh_engine_equals_shard_loop(ranks, name):
    """Every rank's streams, decode logits (bit for bit, packed or dense
    attention) and page tables against the tp=2 shard loop in one
    process."""
    fused, opts, int8_kv, scope = SCENARIOS[name]
    params, cfg = _model(fused, int8_kv, scope)
    slot = params["segments"][0]["slot0"]
    grp = slot["ffn"]["sasp_fused"] if fused else \
        slot["ffn"]["sasp_packed"]["w2"]
    assert grp.shards == TP                     # the sharding engaged
    assert scope == "ffn" or slot["mixer"]["sasp_packed"]["wo"].shards == TP
    streams, steps, tables = _serve(params, cfg, opts)
    assert len(steps) > 0
    scale = max(float(np.abs(s).max()) for s in steps)
    for r, res in enumerate(ranks):
        got_streams, got_steps, got_tables = res[name]
        assert got_streams == streams, (r, got_streams, streams)
        assert len(got_steps) == len(steps)
        for a, b in zip(got_steps, steps):
            assert float(np.abs(a - b).max()) <= 1e-5 * scale, r
            assert a.dtype == b.dtype and np.array_equal(a, b), r
        # the allocator's moves are host-side: the same on every rank
        assert got_tables == tables
    if int8_kv:
        # int8 KV with local heads: the tp=1 engine's greedy streams
        p1 = t_deploy.reshard_packed(params, cfg, tp=1)
        assert _serve(p1, cfg, opts)[0] == streams


@pytest.mark.timeout(120)
def test_rs_ag_int8_within_bound_and_rows_equal_numpy(ranks):
    """The reference's bound (tests/test_distribution.py: 2e-2 of the
    exact reduction), and the int8 rows and scales of the same formula in
    numpy on the exact fp32 sum."""
    case = ranks[0]["rs_ag"]
    exact = np.sum(np.stack(case["parts"]), axis=0, dtype=np.float32)
    d = exact.shape[1] // TP
    q_rows, scales = [], []
    for r in range(TP):
        y = exact[:, r * d:(r + 1) * d]
        scale = np.maximum(np.abs(y).max(axis=1, keepdims=True),
                           np.float32(1e-12)) / np.float32(127.0)
        q_rows.append(np.clip(np.round(y / scale), -127, 127)
                      .astype(np.int8))
        scales.append(scale.astype(np.float32))
    want = np.concatenate([q.astype(np.float32) * s
                           for q, s in zip(q_rows, scales)], axis=1)
    for r, res in enumerate(ranks):
        got = res["rs_ag"]["got"]
        np.testing.assert_array_equal(res["rs_ag"]["y_rs"],
                                      exact[:, r * d:(r + 1) * d])
        np.testing.assert_array_equal(got, want)
        err = np.abs(got - exact).max() / np.abs(exact).max()
        assert err <= 2e-2, err


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def _spread(cfg):
    """``host_worker.spread_output_scales`` as a ``prepare`` hook: wo and
    w2 times sqrt(2 L), in place, as each stacked leaf is drawn."""
    f = max(1.0, (2 * cfg.num_layers) ** 0.5)

    def prepare(path, t):
        if path[-3:] in (("mixer", "wo", "w"), ("ffn", "w2", "w")):
            t.mul_(f)
        return t
    return prepare


# (scope, int8 weights, compute type, sparsity, spread output scales)
RANK_BUILDS = {
    "all-fp32": ("all", False, "float32", 0.5, False),
    "all-bf16-spread": ("all", False, "bfloat16", 0.5, True),
    "ffn-int8-bf16": ("ffn", True, "bfloat16", 0.25, False),
    "all-sasp0": ("all", False, "bfloat16", 0.0, False),
}


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list(RANK_BUILDS))
def test_rank_build_equals_local_params(name, tp):
    """``build_rank_params`` (each layer drawn, pruned, packed and cut to
    the rank's shard before the next) equals ``local_params`` of the
    whole build, leaf for leaf and bit for bit, on every rank at tp 1, 2
    and 4: the global tile selection, the per-layer nnz padding, the
    casts and the vocab-sharded table."""
    from repro_torch.serve.host_worker import spread_output_scales
    scope, int8, compute, sparsity, spread = RANK_BUILDS[name]
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-32b"), layers=3, d_model=128, vocab=256),
        compute_dtype=compute)
    with torch.no_grad():
        params = lm.init_params(cfg, seed=0, device="cpu")
        if spread:
            params = spread_output_scales(params, cfg)
        whole, wcfg = t_serve.build_serving_params(
            params, cfg, path="packed", sparsity=sparsity, scope=scope,
            int8_weights=int8, verbose=False, tp=tp)
    assert wcfg.vocab_shards == tp
    for rank in range(tp):
        got, gcfg, lcfg, _ = t_serve.build_rank_params(
            cfg, tp=tp, rank=rank, device="cpu", sparsity=sparsity,
            scope=scope, int8_weights=int8,
            prepare=_spread(cfg) if spread else None)
        assert gcfg == wcfg and lcfg == local_config(wcfg, tp)
        assert got["embed"]["emb"].shape[0] == cfg.vocab_size // tp
        want = list(_leaves(local_params(whole, wcfg, tp, rank)))
        have = list(_leaves(got))
        assert [p for p, _ in have] == [p for p, _ in want]
        for (path, a), (_, b) in zip(have, want):
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), path
            else:
                assert a == b, path


def launcher_rank(rank: int, spec: dict, init_file: str) -> dict:
    """A ``--mesh`` rank as the launcher's ``serve_rank`` builds and
    serves it, with every decode step's logits kept."""
    mesh = t_serve.join_mesh(rank, spec, init_file)
    params, cfg, lcfg, _ = t_serve.build_rank_params(
        spec["cfg"], tp=TP, rank=mesh.model_rank, device=mesh.device,
        **spec["build"])
    eng = Engine(params, lcfg, mesh=mesh, **spec["engine"])
    steps = record_decode_logits(eng)
    done = eng.run(t_serve.mesh_requests(spec, cfg.vocab_size))
    return dict(transport=mesh.transport, steps=[s.numpy() for s in steps],
                streams={r.rid: [int(t) for t in r.out_tokens]
                         for r in done})


@pytest.mark.timeout(120)
@pytest.mark.parametrize("sasp", ["0.5", "0"])
def test_launcher_mesh_serves_shard_loop_streams(tmp_path, monkeypatch,
                                                 sasp):
    """``serve --mesh 1,2 --path packed --scope all --device cpu``: two
    spawned ranks, equal streams on both and every decode step's logits
    (``launcher_rank``), bit for bit the launcher's own params served
    meshless at tp=2 (the shard loop); at ``--sasp 0`` those are the
    dense params, as in the reference. ``--ranks`` other than the mesh's
    DP size is the reference's ``check_ranks`` error; ``--path masked``
    and a drafter serve on a mesh; MoE and SSM stacks are refused, naming
    their ROADMAP item."""
    argv = ["--mesh", "1,2", "--sasp", sasp, "--path", "packed",
            "--scope", "all", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--slots", "2", "--cache-len", "64"]
    spec = t_serve.mesh_spec(t_serve.parse_args(argv))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the ranks inherit it
    results = t_serve.serve_mesh(spec, launcher_rank,
                                 store_dir=str(tmp_path), timeout=110)
    cfg = reduced(get_config("qwen3-32b"), layers=4, d_model=128, vocab=512)
    with torch.no_grad():
        params, cfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path="packed",
            sparsity=float(sasp), scope="all", verbose=False, tp=2)
    eng = Engine(params, cfg, batch_slots=2, cache_len=64)
    steps = record_decode_logits(eng)
    done = eng.run(t_serve.synthetic_requests(3, cfg.vocab_size, 4))
    want = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    if sasp == "0":
        assert "sasp_fused" not in params["segments"][0]["slot0"]["ffn"]
        assert cfg.tp_shards == 2 and not cfg.sasp.enabled
    for res in results:
        assert res["transport"] == "gloo"
        assert res["streams"] == want
        assert len(res["steps"]) == len(steps) > 0
        for a, b in zip(res["steps"], steps):
            assert a.dtype == b.numpy().dtype
            assert np.array_equal(a, b.numpy())
    for bad, item in ((["--mesh", "2,1", "--ranks", "3"],
                       "exceeds the mesh's DP size 2"),
                      (["--mesh", "2,2", "--scheduler", "--ranks", "1"],
                       "conflicts with the mesh's DP size 2"),
                      (["--mesh", "3,1", "--slots", "3", "--arch",
                        "granite-moe-1b-a400m"],
                       "4 experts do not split over 3 data ranks")):
        with pytest.raises(SystemExit, match=item):
            t_serve.parse_args(bad + ["--sasp", "0.5", "--path", "packed"])
    # MoE and SSM stacks parse on a mesh (their serving:
    # tests/test_torch_family_mesh.py)
    for arch in ("mamba2-780m", "granite-moe-1b-a400m"):
        args = t_serve.parse_args(["--mesh", "1,2", "--arch", arch])
        assert t_serve.mesh_spec(args)["mesh"] == (1, 2)
    for path in ("masked", "dense", "bsr", "kernel"):
        args = t_serve.parse_args(["--mesh", "1,2", "--sasp", "0.5",
                                   "--path", path])
        assert t_serve.mesh_spec(args)["build"]["path"] == path
    args = t_serve.parse_args(["--mesh", "1,2", "--sasp", "0.5", "--path",
                               "packed", "--kv-pages", "8",
                               "--draft-sparsity", "0.75", "--draft-int8"])
    assert t_serve.mesh_spec(args)["build"]["draft_sparsity"] == 0.75
    # a checkpoint, streaming, the trace and the metrics serve on a mesh
    args = t_serve.parse_args(["--mesh", "1,2", "--sasp", "0.5", "--path",
                               "packed", "--ckpt-dir", str(tmp_path),
                               "--stream", "--trace-out", "t.json",
                               "--metrics-dump", "m.prom",
                               "--metrics-interval", "1"])
    spec = t_serve.mesh_spec(args)
    assert spec["build"]["ckpt_dir"] == str(tmp_path)
    assert spec["serve"] == dict(stream=True, trace_out="t.json",
                                 metrics_dump="m.prom", metrics_interval=1.0)


def _launcher_argv(*extra):
    return ["--mesh", "1,2", "--sasp", "0.5", "--path", "packed",
            "--scope", "all", "--device", "cpu", "--requests", "3",
            "--max-new", "4", "--slots", "2", "--cache-len", "64",
            *extra]


@pytest.mark.timeout(180)
def test_launcher_mesh_restores_a_reference_checkpoint(tmp_path,
                                                       monkeypatch):
    """``serve --mesh 1,2 --ckpt-dir``: the launcher's reduced qwen3-32b,
    every weight times 3 (streams that depend on the prompt), written by
    the reference's ``CheckpointManager``; each of 2 gloo ranks restores
    it layer by layer, and both serve the greedy streams of the
    reference's engine on its own packed build of the restored params,
    resharded to tp=2 (no mesh)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.core import deploy as r_deploy
    from repro.launch.serve import build_serving_params
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest
    from repro.train.checkpoint import CheckpointManager as RManager
    cfg = r_reduced(r_get_config("qwen3-32b"), layers=4, d_model=128,
                    vocab=512)
    params = jax.tree.map(lambda a: a * 3.0,
                          r_lm.init_params(jax.random.PRNGKey(0), cfg))
    ckpt = tmp_path / "ckpt"
    RManager(str(ckpt)).save(9, {"params": params})
    restored, _ = RManager(str(ckpt)).restore(
        jax.eval_shape(lambda: {"params": params}))
    rp, rcfg = build_serving_params(restored["params"], cfg, path="packed",
                                    sparsity=0.5, scope="all", verbose=False)
    rp = r_deploy.reshard_packed(rp, rcfg, tp=2)
    want = REngine(rp, rcfg, batch_slots=2, cache_len=64).run(
        [RRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=4)
         for r in t_serve.synthetic_requests(3, cfg.vocab_size, 4)])
    want = {r.rid: [int(t) for t in r.out_tokens] for r in want}
    assert len({tuple(s) for s in want.values()}) > 1
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the ranks inherit it
    spec = t_serve.mesh_spec(t_serve.parse_args(
        _launcher_argv("--ckpt-dir", str(ckpt))))
    results = t_serve.serve_mesh(spec, store_dir=str(tmp_path),
                                 timeout=150)
    for res in results:
        assert res["transport"] == "gloo"
        assert res["streams"] == want


@pytest.mark.timeout(180)
def test_launcher_mesh_streams_traces_and_dumps_metrics(tmp_path,
                                                        monkeypatch, capfd):
    """``serve --mesh 1,2 --stream --trace-out --metrics-dump``: every
    rank steps the streaming loop and serves the streams the shard loop
    serves without streaming; model rank 0 alone prints the streamed
    tokens and writes the trace (Chrome trace events) and the Prometheus
    text (the engine's declared counters)."""
    import json

    from repro_torch.serve.engine import _STAT_KEYS
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the ranks inherit it
    spec = t_serve.mesh_spec(t_serve.parse_args(_launcher_argv(
        "--stream", "--trace-out", str(trace), "--metrics-dump", str(prom))))
    results = t_serve.serve_mesh(spec, store_dir=str(tmp_path),
                                 timeout=150)
    cfg = reduced(get_config("qwen3-32b"), layers=4, d_model=128, vocab=512)
    with torch.no_grad():
        params, cfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path="packed",
            sparsity=0.5, scope="all", verbose=False, tp=2)
    done = Engine(params, cfg, batch_slots=2, cache_len=64).run(
        t_serve.synthetic_requests(3, cfg.vocab_size, 4))
    want = {r.rid: [int(t) for t in r.out_tokens] for r in done}
    assert [r["streams"] for r in results] == [want, want]
    assert results[0]["wrote"] == [str(trace), str(prom)]
    assert results[1]["wrote"] == []
    out = capfd.readouterr().out
    assert out.count("streamed 12 tokens incrementally") == 1
    assert out.count("stream: req") == 12
    events = json.loads(trace.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert any(e.get("name") == "token" for e in events)
    text = prom.read_text()
    for key in ("admitted", "decode_steps"):
        assert key in _STAT_KEYS
        assert f"serve_{key}_total" in text, key
