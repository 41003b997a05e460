"""Data parallelism of the port on gloo meshes of spawned processes (CPU):
the sharded scheduler with one rank per DP rank of a (2, 2) and a (2, 1)
mesh, each rank a TP group of its own processes, against the reference's
meshless 2-rank scheduler over the same containers (streams and the rank
that served each request; the workload of tests/dist_worker.py's
``mode_sched_mesh``); one ``Engine`` on a (2, 2) mesh with its slots
split over 'data' against the reference's meshless engine (streams, and
every decode step's logits within 1e-4; ``mode_packed_serve_mesh``'s
workload), and on a (2, 1) mesh with a paged pool (cut over 'data'
where the reference's rule cuts it, else replicated); EDF with
preemption, buckets and ``stream()`` taking the same decisions in every
process; a raise in data rank 1's step contained as the meshless port
scheduler contains it; and the launcher's ``--mesh DP,TP --scheduler``
and its usage errors. Imports no jax at its top: the
ranks are spawned processes that import this module."""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distribution.sharding import (local_config,  # noqa: E402
                                               local_params)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.launch.mesh import init_file_in, make_mesh  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.serve.scheduler import ShardedScheduler  # noqa: E402
from test_torch_tp_mesh import record_decode_logits  # noqa: E402

DEPLOY = dict(path="packed", sparsity=0.25, block_k=8, block_n=8,
              scope="all", verbose=False)
# mode_sched_mesh: 6 requests > 2 ranks x 2 slots
BUDGETS = [8, 8, 4, 5, 6, 3]
SCHED = dict(slots_per_rank=2, cache_len=64)


def port_config():
    return reduced(get_config("qwen3-32b"), layers=2, d_model=64, vocab=128)


def deployed(np_params, tp: int):
    """The port's packed deployment of the bridged weights at ``tp``
    (every shard: the shard loop's tree)."""
    with torch.no_grad():
        return t_serve.build_serving_params(
            bridge.from_numpy(np_params, device="cpu"), port_config(),
            tp=tp, **DEPLOY)


def sched_requests(eos_rid=None, eos=None):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 128, size=(6 + 4 * i,)).astype(np.int32)
               for i in range(6)]
    return [Request(rid=i, prompt=p, max_new_tokens=b,
                    eos_id=eos if i == eos_rid else None)
            for i, (p, b) in enumerate(zip(prompts, BUDGETS))]


def engine_requests():
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 128, size=(8 + 7 * i,))
                    .astype(np.int32), max_new_tokens=6) for i in range(3)]


def qos_requests():
    """Four long batch requests, then two short interactive ones that
    arrive once every slot is busy, so that each rank preempts."""
    rng = np.random.default_rng(5)
    batch = [Request(rid=i, prompt=rng.integers(0, 128, size=(6 + 3 * i,))
                     .astype(np.int32), max_new_tokens=10)
             for i in range(4)]
    inter = [Request(rid=4 + i, prompt=rng.integers(0, 128, size=(5,))
                     .astype(np.int32), max_new_tokens=3,
                     slo="interactive", deadline=0.01) for i in range(2)]
    return batch, inter


def faulty_decode(eng, after=3):
    """The engine's decode raises from its ``after``-th call on."""
    calls = {"n": 0}
    orig = eng._decode_step

    def faulty(*a, **k):
        calls["n"] += 1
        if calls["n"] >= after:
            raise RuntimeError("injected shard fault")
        return orig(*a, **k)

    eng._decode_step = faulty


def streams(reqs):
    return {r.rid: [int(t) for t in r.out_tokens] for r in reqs}


def plain_stats(st):
    """``stats()`` without the TTFT quantiles (times)."""
    return {k: v for k, v in st.items() if k != "ttft"}


def _rank_tree(np_params, tp, mesh):
    params, cfg = deployed(np_params, tp)
    return local_params(params, cfg, tp, mesh.model_rank), \
        local_config(cfg, tp)


def _sched_run(params, cfg, mesh, eos_rid, eos, profile="tp", **kw):
    sched = ShardedScheduler(params, cfg, mesh=mesh, profile=profile,
                             sched=SchedulerConfig(**SCHED, **kw))
    done = sched.run(sched_requests(eos_rid, eos))
    st = sched.stats()
    return dict(streams=streams(done), served={r.rid: r.rank for r in done},
                refills=sum(r["continuous_refills"] for r in st["per_rank"]),
                ranks=st["ranks"], local=sched._me)


def dp_rank(rank: int, spec: dict, init_file: str) -> dict:
    """One process of a (DP, TP) gloo mesh: every case of ``spec`` on
    it."""
    torch.set_num_threads(1)
    dp, tp = spec["shape"]
    mesh = make_mesh(dp, tp, rank=rank, init_file=init_file,
                     backend="gloo", device="cpu")
    out = {}
    params, cfg = _rank_tree(spec["sched_params"], tp, mesh)
    eos_rid, eos = spec["eos"]
    out["sched"] = _sched_run(params, cfg, mesh, eos_rid, eos)
    out["sched_paged"] = _sched_run(params, cfg, mesh, eos_rid, eos,
                                    kv_pages=24, kv_page_len=8)
    if "dp_only" in spec["cases"]:
        p1, c1 = _rank_tree(spec["sched_params"], 1, mesh.flat())
        out["dp_only"] = _sched_run(p1, c1, mesh, eos_rid, eos,
                                    profile="dp_only")
    if "qos" in spec["cases"]:
        sched = ShardedScheduler(
            params, cfg, mesh=mesh, sched=SchedulerConfig(
                **SCHED, policy="edf", preempt=True, buckets=(16, 32, 64)))
        batch, inter = qos_requests()
        for r in batch:
            assert sched.submit(r)
        for _ in range(2):
            sched.step()
        order = list(sched.stream(inter))
        # then three more, arriving over time (every process reads world
        # rank 0's clock, so they are submitted alike)
        later = [dataclasses.replace(r, rid=6 + i, out_tokens=[])
                 for i, r in enumerate(sched_requests()[:3])]
        sched.run(later, arrivals=[0.0, 0.05, 0.1])
        reqs = batch + inter + later
        out["qos"] = dict(streams=streams(reqs), order=order,
                          served={r.rid: r.rank for r in reqs},
                          preempted={r.rid: r.preemptions for r in reqs},
                          stats=plain_stats(sched.stats()))
    if "raise" in spec["cases"]:
        sched = ShardedScheduler(params, cfg, mesh=mesh,
                                 sched=SchedulerConfig(slots_per_rank=1,
                                                       cache_len=64))
        if sched._me == 1:
            faulty_decode(sched.shards[1])
        reqs = sched_requests()
        done = sched.run(reqs)
        out["raise"] = dict(streams=streams(done),
                            served={r.rid: r.rank for r in done},
                            requeues={r.rid: r.requeues for r in reqs},
                            status={r.rid: r.status for r in reqs},
                            stats=plain_stats(sched.stats()))
    eparams, ecfg = _rank_tree(spec["engine_params"], tp, mesh)
    for name, kw in spec["engines"].items():
        out[name] = _engine_case(eparams, ecfg, mesh, kw)
    return out


def _engine_case(eparams, ecfg, mesh, kw) -> dict:
    """One ``Engine`` on the mesh with options ``kw``: its run (streams,
    layout, decode logits) and a kept-KV preemption's."""
    out = {}
    eng = Engine(eparams, ecfg, mesh=mesh, batch_slots=2, cache_len=64,
                 **kw)
    steps = record_decode_logits(eng)
    done = eng.run(engine_requests())
    out["engine"] = dict(streams=streams(done), layout=eng.layout,
                         data_rank=mesh.data_rank,
                         steps=[s.numpy() for s in steps])
    # request 0's slot preempted with its KV kept after two steps: it
    # resumes in slot 1, another data rank's when the slots are split
    eng = Engine(eparams, ecfg, mesh=mesh, batch_slots=2, cache_len=64,
                 **kw)
    reqs = engine_requests()
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    eng.queue.append(eng.preempt_slot(0, keep_kv=True))
    resumed_in = None
    while eng.has_work():
        eng.step()
        if resumed_in is None and reqs[0] in eng.slot_req:
            resumed_in = eng.slot_req.index(reqs[0])
    mem = eng.memory_stats()
    out["engine_preempt"] = dict(
        streams=streams(reqs), resumes=eng.stats["resumes"],
        resumed_in=resumed_in, moved=None if mem is None else mem.moved_pages)
    return out


# ---------------------------------------------------------------------------
# the reference's side (the parent process only)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The reference's weights (``mode_sched_mesh``'s, times 3, and
    ``mode_packed_serve_mesh``'s) as numpy, its meshless deployments,
    the EOS pick, its meshless 2-rank scheduler over the tp=2 and tp=1
    containers, and its meshless engine's streams and decode logits."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as r_get_config
    from repro.configs import reduced as r_reduced
    from repro.core import deploy as r_deploy
    from repro.launch.serve import build_serving_params
    from repro.models import lm as r_lm
    from repro.serve.engine import Engine as REngine
    from repro.serve.engine import Request as RRequest
    from repro.serve.scheduler import SchedulerConfig as RConfig
    from repro.serve.scheduler import ShardedScheduler as RScheduler

    cfg0 = r_reduced(r_get_config("qwen3-32b"), layers=2, d_model=64,
                     vocab=128)
    params0 = r_lm.init_params(jax.random.PRNGKey(0), cfg0)
    amp = jax.tree.map(lambda a: a * 3.0, params0)
    to_np = lambda t: jax.tree.map(np.asarray, t)      # noqa: E731
    deploy = {k: v for k, v in DEPLOY.items()}
    sp1, sc = build_serving_params(amp, cfg0, **deploy)
    sp2 = r_deploy.reshard_packed(sp1, sc, tp=2)

    def rreqs(eos_rid=None, eos=None):
        return [RRequest(rid=r.rid, prompt=r.prompt,
                         max_new_tokens=r.max_new_tokens, eos_id=r.eos_id)
                for r in sched_requests(eos_rid, eos)]

    # the EOS: a token first seen mid-decode in a solo stream (request 1,
    # the reference's pick, first)
    reqs = rreqs()
    pick = None
    for e in (1, 0):
        s = [int(t) for t in REngine(sp2, sc, batch_slots=1, cache_len=64)
             .run([reqs[e]])[0].out_tokens]
        at = next((i for i in range(1, len(s) - 1) if s[i] not in s[:i]),
                  None)
        if at is not None:
            pick = (e, int(s[at]), at)
            break
    assert pick is not None, "no solo stream with a fresh mid-decode token"

    def rsched(params):
        sched = RScheduler(params, sc, ranks=2,
                           sched=RConfig(slots_per_rank=2, cache_len=64))
        done = sched.run(rreqs(pick[0], pick[1]))
        return dict(streams=streams(done),
                    served={r.rid: r.rank for r in done})

    p1, c1 = build_serving_params(params0, cfg0, **deploy)
    ref_steps = []
    decode = r_lm.decode_step

    def recorded(params, cfg, *a):
        logits, caches = decode(params, cfg, *a)
        jax.debug.callback(lambda lg: ref_steps.append(np.asarray(lg)),
                           logits[:, 0], ordered=True)
        return logits, caches

    r_lm.decode_step = recorded
    try:
        done = REngine(p1, c1, batch_slots=2, cache_len=64).run(
            [RRequest(rid=r.rid, prompt=r.prompt, max_new_tokens=6)
             for r in engine_requests()])
    finally:
        r_lm.decode_step = decode
    return dict(sched_np=to_np(amp), engine_np=to_np(params0), eos=pick,
                sched={2: rsched(sp2), 1: rsched(sp1)},
                engine=dict(streams=streams(done), steps=ref_steps))


def _run_mesh(reference, tmp_path_factory, shape, cases, engines):
    spec = dict(shape=shape, cases=cases, engines=engines,
                sched_params=reference["sched_np"],
                engine_params=reference["engine_np"],
                eos=reference["eos"][:2])
    store = init_file_in(str(tmp_path_factory.mktemp("dp")))
    return run_ranks(dp_rank, shape[0] * shape[1], (spec, store),
                     timeout=200)


@pytest.fixture(scope="module")
def mesh22(reference, tmp_path_factory):
    return _run_mesh(reference, tmp_path_factory, (2, 2),
                     ("dp_only", "qos", "raise"), {"split": {}})


# ``kv_pages``, or (``kv_pages``, ``kv_watermark``), of the paged cases
PAGED_CASES = (24, 23, 16, (24, 0.6))


def _pool_options(kv) -> dict:
    pages, mark = kv if isinstance(kv, tuple) else (kv, 1.0)
    return dict(kv_pages=pages, kv_page_len=8, kv_watermark=mark)


@pytest.fixture(scope="module")
def mesh21(reference, tmp_path_factory):
    return _run_mesh(reference, tmp_path_factory, (2, 1), (),
                     {kv: _pool_options(kv) for kv in PAGED_CASES})


# ---------------------------------------------------------------------------
# (i) the scheduler against the reference's meshless 2-rank scheduler
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kv", ["sched", "sched_paged"])
@pytest.mark.parametrize("shape", ["2x2", "2x1"])
def test_dp_scheduler_equals_reference_meshless_scheduler(
        reference, mesh22, mesh21, shape, kv):
    """Every process's streams and served ranks are the reference's
    meshless ``ShardedScheduler(ranks=2)`` over the containers at the
    mesh's TP (``reshard_packed(tp=2)`` for (2, 2)); an EOS frees a slot
    mid-decode and it is refilled; both ranks serve."""
    res, tp = (mesh22, 2) if shape == "2x2" else (mesh21, 1)
    want = reference["sched"][tp]
    eos_rid, eos, eos_at = reference["eos"]
    assert len(want["streams"][eos_rid]) == eos_at + 1   # EOS mid-decode
    assert set(want["served"].values()) == {0, 1}
    for r, out in enumerate(res):
        got = out[kv]
        assert got["ranks"] == 2 and got["local"] == r // tp
        assert got["streams"] == want["streams"], r
        assert got["served"] == want["served"], r
        assert got["refills"] >= 1


@pytest.mark.timeout(300)
def test_dp_only_profile_serves_a_rank_per_process(reference, mesh22):
    """``profile="dp_only"`` on the (2, 2) mesh: 4 scheduler ranks of one
    process each over the tp=1 tree, every process with the streams and
    served ranks of the port's meshless ``ShardedScheduler(ranks=4)``."""
    params, cfg = deployed(reference["sched_np"], 1)
    eos_rid, eos, _ = reference["eos"]
    sched = ShardedScheduler(params, cfg, ranks=4,
                             sched=SchedulerConfig(**SCHED))
    done = sched.run(sched_requests(eos_rid, eos))
    want = dict(streams=streams(done), served={r.rid: r.rank for r in done})
    assert set(want["served"].values()) == {0, 1, 2, 3}
    for r, out in enumerate(mesh22):
        got = out["dp_only"]
        assert got["ranks"] == 4 and got["local"] == r
        assert {k: got[k] for k in want} == want


# ---------------------------------------------------------------------------
# (ii) one engine on a mesh against the reference's meshless engine
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
def test_dp_engine_split_slots_equals_reference_engine(reference, mesh22):
    """``Engine(mesh=(2, 2))``, 2 slots: one slot a data rank; greedy
    streams equal, and every decode step's rows within 1e-4 of the
    reference's meshless engine's; again with request 0 preempted with
    its KV kept and resumed in the other data rank's slot."""
    want = reference["engine"]
    for r, out in enumerate(mesh22):
        out = out["split"]
        got = out["engine"]
        assert got["layout"] == "slots split over data"
        assert got["streams"] == want["streams"], r
        d = got["data_rank"]
        assert len(got["steps"]) == len(want["steps"]) > 0
        for a, b in zip(got["steps"], want["steps"]):
            assert a.shape == (1, b.shape[-1])
            assert float(np.abs(a[0] - b[d]).max()) <= 1e-4
        # a kept-KV resume in the other data rank's slot: its rows were
        # broadcast from the data rank that saved them
        pre = out["engine_preempt"]
        assert pre["resumes"] == 1 and pre["resumed_in"] == 1
        assert pre["streams"] == want["streams"], r


@pytest.mark.timeout(300)
@pytest.mark.parametrize("kv_pages,layout", [
    (24, "slots and pages split over data"),    # P = 26 cuts over D = 2
    (23, "replicated over data"),               # P = 25 does not
    # P = 18 cuts, but block 0's 7 usable pages hold no 8-page ring
    pytest.param(16, "replicated over data", id="16-block-under-a-ring"),
    # block 0's cap floor(11 x 0.6) = 6 pages holds no 8-page ring
    pytest.param((24, 0.6), "replicated over data",
                 id="24-watermark-0.6")])
def test_dp_engine_paged_is_replicated_with_equal_streams(
        reference, mesh21, kv_pages, layout):
    """``Engine(mesh=(2, 1), batch_slots=2, cache_len=64, kv_pages=N,
    kv_page_len=8)``: where the reference's rule cuts the pool's P = N +
    2 pages over 'data' and every block's watermark cap holds one slot's
    8-page ring, each data rank runs its own slot on its own block of
    pages, and request 0's kept KV moves to the other block when it
    resumes in slot 1; where the rule does not cut, or a block is too
    small, every data rank runs the whole engine. Either way the
    reference's meshless streams, the kept-KV preemption's too."""
    for out in mesh21:
        out = out[kv_pages]
        assert out["engine"]["layout"] == layout
        assert out["engine"]["streams"] == reference["engine"]["streams"]
        pre = out["engine_preempt"]
        assert pre["resumes"] == 1
        assert pre["streams"] == reference["engine"]["streams"]
        if kv_pages == 24:
            assert pre["resumed_in"] == 1 and pre["moved"] > 0
        else:
            assert pre["moved"] == 0


# ---------------------------------------------------------------------------
# (iii) every process decides alike; (iv) a raise on data rank 1
# ---------------------------------------------------------------------------


@pytest.mark.timeout(300)
def test_dp_qos_decisions_equal_in_every_process(reference, mesh22):
    """EDF with preemption, buckets and ``stream()``, then arrivals over
    time: every process reports the same served ranks, preemptions,
    token order and stats; each rank preempts; every stream equals that
    request served alone (the port's ``Engine(batch_slots=1)`` on the
    shard loop's tree)."""
    first = mesh22[0]["qos"]
    for out in mesh22[1:]:
        assert out["qos"] == first
    assert sum(first["preempted"].values()) >= 2
    assert first["stats"]["preemptions"] >= 2
    assert set(first["served"].values()) == {0, 1}
    params, cfg = deployed(reference["sched_np"], 2)
    batch, inter = qos_requests()
    later = [dataclasses.replace(r, rid=6 + i)
             for i, r in enumerate(sched_requests()[:3])]
    solo = {r.rid: streams(Engine(params, cfg, batch_slots=1, cache_len=64)
                           .run([r]))[r.rid] for r in batch + inter + later}
    assert first["streams"] == solo
    # stream() yields each request's tokens from its submission (the
    # interactive ones) or from the start of streaming, in order
    for rid, s in first["streams"].items():
        if rid >= 6:
            continue
        got = [t for r, t in first["order"] if r == rid]
        assert got == s[len(s) - len(got):]
        assert rid < 4 or got == s


@pytest.mark.timeout(300)
def test_dp_rank_raise_contained_as_meshless(reference, mesh22):
    """Data rank 1's decode raises from its 3rd call in both of its
    processes: every process marks it dead and requeues the same
    requests; streams, served ranks, requeues and ``stats()`` equal the
    meshless port scheduler's under the same injection, and the streams
    equal each request served alone."""
    params, cfg = deployed(reference["sched_np"], 2)
    sched = ShardedScheduler(params, cfg, ranks=2, sched=SchedulerConfig(
        slots_per_rank=1, cache_len=64))
    faulty_decode(sched.shards[1])
    reqs = sched_requests()
    done = sched.run(reqs)
    want = dict(streams=streams(done), served={r.rid: r.rank for r in done},
                requeues={r.rid: r.requeues for r in reqs},
                status={r.rid: r.status for r in reqs},
                stats=plain_stats(sched.stats()))
    assert want["stats"]["requeued"] >= 1 and want["stats"]["live_ranks"] == 1
    assert set(want["status"].values()) == {"done"}
    solo = {r.rid: streams(Engine(params, cfg, batch_slots=1, cache_len=64)
                           .run([dataclasses.replace(
                               r, out_tokens=[], status="new", rank=None,
                               requeues=0, t_submit=None, t_first=None,
                               t_done=None, t_deadline=None, done=False,
                               _resume_pos=None)]))[r.rid] for r in reqs}
    assert want["streams"] == solo
    for out in mesh22:
        assert out["raise"] == want


@pytest.mark.timeout(60)
def test_dp_submeshes_list_each_rank_and_its_processes():
    """``dp_submeshes``: under "tp" a DP rank per data index, its TP group
    of processes; under "dp_only" a rank per process; ``dp_mesh`` views
    the mesh as that grid."""
    from repro_torch.distribution.context import Mesh
    from repro_torch.distribution.sharding import dp_mesh, dp_submeshes
    mesh = Mesh({"data": 2, "model": 2}, 3, "gloo", torch.device("cpu"))
    assert dp_submeshes(mesh) == [(0, (0, 1)), (1, (2, 3))]
    assert dp_submeshes(mesh, "dp_only") == [(0, (0,)), (1, (1,)),
                                             (2, (2,)), (3, (3,))]
    assert dp_mesh(mesh) is mesh
    flat = dp_mesh(mesh, "dp_only")
    assert flat.shape == {"data": 4, "model": 1} and flat.data_rank == 3
    sub = mesh.submesh()
    assert sub.shape == {"data": 1, "model": 2} and sub.model_rank == 1
    with pytest.raises(ValueError, match="profile"):
        dp_submeshes(mesh, "fsdp")


# ---------------------------------------------------------------------------
# (v) the launcher
# ---------------------------------------------------------------------------


@pytest.mark.timeout(200)
def test_launcher_mesh_scheduler_and_usage_errors(tmp_path, monkeypatch,
                                                  capfd):
    """``serve --mesh 2,1 --scheduler --device cpu``: two spawned
    processes, each a scheduler rank, serve the streams of the
    launcher's meshless 2-rank scheduler on the same build, from the same
    ranks, and world rank 0 alone prints the scheduler's summary;
    ``--ranks`` against the mesh's DP size and ``--hosts`` with ``--mesh``
    are the reference's usage errors."""
    argv = ["--mesh", "2,1", "--scheduler", "--sasp", "0.5", "--path",
            "packed", "--scope", "all", "--device", "cpu", "--requests", "5",
            "--max-new", "4", "--slots", "2", "--cache-len", "64"]
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the ranks inherit it
    results = t_serve.serve_mesh(t_serve.mesh_spec(t_serve.parse_args(argv)),
                                 store_dir=str(tmp_path), timeout=150)
    cfg = reduced(get_config("qwen3-32b"), layers=4, d_model=128, vocab=512)
    from repro_torch.models import lm
    with torch.no_grad():
        params, cfg = t_serve.build_serving_params(
            lm.init_params(cfg, seed=0, device="cpu"), cfg, path="packed",
            sparsity=0.5, scope="all", verbose=False)
    sched = ShardedScheduler(params, cfg, ranks=2, sched=SchedulerConfig(
        slots_per_rank=2, cache_len=64))
    done = sched.run(t_serve.synthetic_requests(5, cfg.vocab_size, 4))
    for res in results:
        assert res["streams"] == streams(done)
        assert res["served"] == {r.rid: r.rank for r in done}
    assert set(results[0]["served"].values()) == {0, 1}
    out = capfd.readouterr().out
    assert out.count("scheduler: 2 rank(s), 5/5 admitted") == 1
    assert out.count("  rank stats: ") == 2
    for bad, msg in (
            (["--mesh", "2,2", "--ranks", "3"],
             "--ranks 3 exceeds the mesh's DP size 2 (mesh {'data': 2, "
             "'model': 2}): each scheduler rank needs its own DP slice"),
            (["--mesh", "2,2", "--ranks", "1"],
             "--ranks 1 conflicts with the mesh's DP size 2: under a mesh "
             "the DP axis decides the rank count; drop --ranks"),
            (["--mesh", "1,2", "--hosts", "2"],
             "--hosts serves in-process hosts without a mesh; drop "
             "--mesh")):
        with pytest.raises(SystemExit, match=re.escape(msg)):
            t_serve.parse_args(bad + ["--sasp", "0.5", "--path", "packed"])
