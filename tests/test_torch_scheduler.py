"""The port's sharded scheduler (``repro_torch.serve.scheduler``), one case
for each case of the reference's tests/test_scheduler.py, on the same
weights bridged through numpy (the reduced qwen3-32b, fp32, every weight
times 3): continuous refill after EOS (dense and packed), two ranks,
admission control, SJF, EDF and aging, preemption in both modes, rank
failure with and without requeue, the poison request, a raise inside
admission, total failure, revive, deadline shedding, spill-aware
routing, the drain baseline, streaming, and the number of distinct
prefill shapes under buckets. Every greedy stream is held to each
request alone through the port's ``Engine(batch_slots=1)`` and the
reference's (``torch_parity.SoloOracle``, which also holds those two
equal)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import prefill_bucket_table  # noqa: E402
from repro_torch.launch.serve import rank_bucket_tables  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.serve.scheduler import ShardedScheduler  # noqa: E402
from torch_parity import SoloOracle, amp_model  # noqa: E402

V = 64


@pytest.fixture(scope="module")
def dense():
    model = amp_model()
    return model[1], model[3], SoloOracle(model)


@pytest.fixture(scope="module")
def packed():
    model = amp_model(packed=True)
    return model[1], model[3], SoloOracle(model)


def _sched(cfg, params, ranks=1, **kw):
    kw.setdefault("cache_len", 64)
    return ShardedScheduler(params, cfg, ranks=ranks,
                            sched=SchedulerConfig(**kw))


def _streams(reqs):
    return {r.rid: list(r.out_tokens) for r in reqs}


def _prompt(rng, n):
    return rng.integers(0, V, size=(n,)).astype(np.int32)


@pytest.mark.parametrize("weights", ["dense", "packed"])
def test_eos_freed_slot_refilled_bit_identical(weights, request):
    """Continuous refill: one request stops early on EOS, its slot is
    refilled from the queue while another still decodes, and every stream
    equals its solo one. The EOS request and its token come from a solo
    stream that HAS a token not seen before, after position 0 (the
    reference's own scenario picks request 1, whose packed solo stream
    has none, and stops there with StopIteration)."""
    cfg, params, solo = request.getfixturevalue(weights)
    rng = np.random.default_rng(0)
    prompts = [_prompt(rng, 6 + 3 * i) for i in range(3)]
    budgets = [8, 8, 4]
    pick = None
    for e in (1, 0):                    # the reference's choice first
        s = solo.stream(prompts[e], budgets[e])
        at = next((i for i in range(1, len(s) - 1) if s[i] not in s[:i]),
                  None)
        if at is not None:
            pick = (e, at, int(s[at]))
            break
    assert pick is not None, (
        "no seeded prompt of the scenario has a solo stream with a fresh "
        "token after position 0: the EOS refill cannot be staged")
    e, eos_at, eos = pick
    other = 1 - e
    reqs = [Request(rid=i, prompt=p, max_new_tokens=b,
                    eos_id=eos if i == e else None)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    want = solo.of(reqs)
    assert len(want[e]) == eos_at + 1          # EOS fires mid-decode

    sched = _sched(cfg, params, slots_per_rank=2)
    for r in reqs:
        assert sched.submit(r)
    eng = sched.shards[0]
    done, refilled_while_active = [], False
    while sched.has_work():
        finished = sched.step()
        done.extend(finished)
        if any(f.rid == e for f in finished):
            done.extend(sched.step())
            occupants = {r.rid for r in eng.slot_req if r is not None}
            refilled_while_active = {other, 2} <= occupants
    assert refilled_while_active
    assert eng.stats["continuous_refills"] >= 1
    assert _streams(done) == want
    for r in done:
        assert r.t_submit is not None and r.t_done is not None
        assert r.latency is not None and r.latency > 0


def test_two_ranks_share_traffic_and_stay_isolated(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=_prompt(rng, 5 + i),
                    max_new_tokens=3 + (2 * i) % 5) for i in range(6)]
    want = solo.of(reqs)
    sched = _sched(cfg, params, ranks=2, slots_per_rank=2)
    done = sched.run(list(reqs))
    assert _streams(done) == want
    st = sched.stats()
    assert all(r["admitted"] > 0 for r in st["per_rank"])
    assert {r.rank for r in done} == {0, 1}
    # both ranks serve the same params tensors: nothing was copied
    a, b = (e.params["embed"]["emb"] for e in sched.shards)
    assert a is b


def test_admission_control_rejects_beyond_max_queue(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=_prompt(rng, 6), max_new_tokens=3)
            for i in range(5)]
    sched = _sched(cfg, params, slots_per_rank=1, max_queue=2)
    accepted = [sched.submit(r) for r in reqs]
    assert accepted == [True, True, True, False, False]
    done = sched.run([])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert _streams(done) == solo.of(reqs[:3])
    st = sched.stats()
    assert st["rejected"] == 2 and st["accepted"] == 3
    assert [r.rid for r in sched.rejected] == [3, 4]
    assert all(r.status == "rejected" for r in sched.rejected)


def test_sjf_policy_runs_shortest_queued_request_first(dense):
    cfg, params, solo = dense
    prompt = np.arange(1, 7, dtype=np.int32)
    budgets = {0: 8, 1: 2, 2: 4}

    def completion_order(policy):
        sched = _sched(cfg, params, slots_per_rank=1, policy=policy)
        reqs = [Request(rid=i, prompt=prompt, max_new_tokens=n)
                for i, n in budgets.items()]
        for r in reqs:
            sched.submit(r)
        done = sched.run([])
        assert _streams(done) == solo.of(reqs)
        return [r.rid for r in done]

    assert completion_order("fcfs") == [0, 1, 2]
    assert completion_order("sjf") == [1, 2, 0]


@pytest.mark.parametrize("mode", ["kv", "reprefill"])
def test_preempt_resume_bit_identical(dense, mode):
    """An interactive request evicts a mid-decode batch request; the
    victim resumes (KV kept, or re-prefill of prompt + tokens) and both
    streams equal their solo ones; the interactive request retires
    first."""
    cfg, params, solo = dense
    rng = np.random.default_rng(4)
    batch = Request(rid=0, prompt=_prompt(rng, 8), max_new_tokens=12,
                    slo="batch")
    inter = Request(rid=1, prompt=_prompt(rng, 6), max_new_tokens=3,
                    slo="interactive", deadline=0.01)
    want = solo.of([batch, inter])
    sched = _sched(cfg, params, slots_per_rank=1, policy="edf",
                   preempt=True, preempt_mode=mode)
    assert sched.submit(batch)
    for _ in range(4):
        sched.step()
    assert sched.submit(inter)
    done = []
    while sched.has_work():
        done.extend(sched.step())
    st = sched.stats()
    assert st["preemptions"] >= 1
    assert st["per_rank"][0]["resumes"] >= 1
    assert batch.preemptions >= 1 and inter.preemptions == 0
    order = [r.rid for r in done]
    assert order.index(1) < order.index(0), order
    assert _streams(done) == want
    assert batch.status == "done" and inter.status == "done"
    assert batch._kv is None


def test_edf_orders_by_deadline_and_aging_prevents_starvation(dense):
    cfg, params, solo = dense
    prompt = np.arange(1, 7, dtype=np.int32)

    def completion_order(aging):
        sched = _sched(cfg, params, slots_per_rank=1, policy="edf",
                       aging=aging)
        reqs = [Request(rid=0, prompt=prompt, max_new_tokens=2,
                        slo="batch")]
        reqs += [Request(rid=i, prompt=prompt, max_new_tokens=2,
                         slo="interactive", deadline=0.05) for i in (1, 2)]
        for r in reqs:
            sched.submit(r)
        done = sched.run([])
        assert _streams(done) == solo.of(reqs)
        return [r.rid for r in done]

    assert completion_order(aging=0.0) == [1, 2, 0]
    assert completion_order(aging=1e9) == [0, 1, 2]


def _faulty_decode(eng, after=3, msg="injected shard fault"):
    """The rank's decode raises from its ``after``-th call on (the shard
    dies mid-load): a Python exception, the containable kind."""
    calls = {"n": 0}
    orig = eng._decode_step

    def faulty(*a, **k):
        calls["n"] += 1
        if calls["n"] >= after:
            raise RuntimeError(msg)
        return orig(*a, **k)

    eng._decode_step = faulty


def _six(seed):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=_prompt(rng, 6), max_new_tokens=6)
            for i in range(6)]


def test_rank_failure_requeues_inflight_bit_identical(dense):
    cfg, params, solo = dense
    reqs = _six(5)
    want = solo.of(reqs)
    sched = _sched(cfg, params, ranks=2, slots_per_rank=1)
    eng0 = sched.shards[0]
    _faulty_decode(eng0)
    done = sched.run(reqs)
    st = sched.stats()
    assert st["live_ranks"] == 1 and eng0.dead
    assert st["requeued"] >= 1
    assert not sched.failed
    assert len(done) == len(reqs)
    assert _streams(done) == want
    assert all(r.status == "done" for r in reqs)
    assert not eng0.queue
    assert max(r.requeues for r in reqs) >= 1
    assert sched.shards[1].stats["admitted"] >= len(done)


def test_rank_failure_terminal_without_requeue(dense):
    cfg, params, solo = dense
    reqs = _six(5)
    want = solo.of(reqs)
    sched = _sched(cfg, params, ranks=2, slots_per_rank=1,
                   requeue_inflight=False)
    eng0 = sched.shards[0]
    _faulty_decode(eng0)
    done = sched.run(reqs)
    st = sched.stats()
    assert st["live_ranks"] == 1 and eng0.dead
    assert len(sched.failed) >= 1
    for r in sched.failed:
        assert r.status == "failed"
        assert "injected shard fault" in r.error
    assert len(done) + len(sched.failed) == len(reqs)
    assert all(r.status == "done" for r in done)
    assert {r.rid: want[r.rid] for r in done} == _streams(done)
    assert not eng0.queue
    assert sched.shards[1].stats["admitted"] >= len(done)


def test_max_requeues_bounds_poison_request(dense):
    cfg, params, _ = dense
    rng = np.random.default_rng(14)
    req = Request(rid=0, prompt=_prompt(rng, 6), max_new_tokens=8)
    sched = _sched(cfg, params, ranks=4, slots_per_rank=1, max_requeues=2)
    for eng in sched.shards:
        _faulty_decode(eng, after=2, msg="poison")
    done = sched.run([req])
    assert not done
    assert req.status == "failed" and "requeue(s) exhausted" in req.error
    assert req.requeues == 3
    assert sched.stats()["requeued"] == 2


def test_rank_failure_during_admission_requeues_popped_requests(dense):
    """A raise inside admission (the prefill pass) loses no popped
    request: they go back to the queue and re-route to the survivor."""
    cfg, params, solo = dense
    rng = np.random.default_rng(8)
    reqs = [Request(rid=i, prompt=_prompt(rng, 6), max_new_tokens=4)
            for i in range(6)]
    want = solo.of(reqs)
    sched = _sched(cfg, params, ranks=2, slots_per_rank=1)
    eng0 = sched.shards[0]
    calls = {"n": 0}
    orig = eng0._run_prefill

    def faulty(*a):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("injected prefill fault")
        return orig(*a)

    eng0._run_prefill = faulty
    done = sched.run(reqs)
    assert eng0.dead and not eng0.queue
    assert len(done) + len(sched.failed) == len(reqs)
    assert all(r.status in ("done", "failed") for r in reqs)
    assert {r.rid: want[r.rid] for r in done} == _streams(done)


def test_total_failure_resolves_every_request(dense):
    cfg, params, _ = dense
    rng = np.random.default_rng(10)
    reqs = [Request(rid=i, prompt=_prompt(rng, 6), max_new_tokens=4)
            for i in range(5)]
    sched = _sched(cfg, params, slots_per_rank=1)
    sched.shards[0]._decode_step = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("total failure"))
    done = sched.run(reqs, arrivals=[0.0, 0.0, 0.0, 5.0, 9.0])
    assert len(done) + len(sched.failed) == len(reqs)
    assert all(r.status in ("done", "failed") for r in reqs)
    assert all(r.error for r in sched.failed)


def test_preempt_effective_under_fcfs_policy(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(9)

    def mk(rid, new, slo, dl):
        return Request(rid=rid, prompt=_prompt(rng, 6), max_new_tokens=new,
                       slo=slo, deadline=dl)

    sched = _sched(cfg, params, slots_per_rank=1, policy="fcfs",
                   preempt=True)
    running, queued_batch = mk(0, 10, "batch", 30.0), mk(1, 4, "batch", 30.0)
    inter = mk(2, 2, "interactive", 0.01)
    want = solo.of([running, queued_batch, inter])
    sched.submit(running)
    sched.step()
    sched.submit(queued_batch)
    sched.submit(inter)
    done = []
    while sched.has_work():
        done.extend(sched.step())
    assert sched.stats()["preemptions"] >= 1
    order = [r.rid for r in done]
    assert order.index(2) < order.index(0), order
    assert order.index(2) < order.index(1), order
    assert _streams(done) == want


def test_prefill_shapes_bounded_by_buckets_under_random_lengths(dense):
    """The port's counterpart of the reference's jit-cache case: with
    bucketed admission, 50 random prompt lengths take at most
    len(buckets) distinct prefill shapes, each (B, bucket), and the
    streams equal the unbucketed engine's and the solo ones. An integer
    ``buckets`` gives every rank the launcher's geometric table."""
    cfg, params, solo = dense
    buckets = (8, 16, 32, 64)
    rng = np.random.default_rng(6)
    prompts = [_prompt(rng, int(rng.integers(2, 60))) for _ in range(50)]

    def run(eng):
        shapes = set()
        orig = eng._run_prefill

        def counting(toks, poss, all_slots, reqs, valid):
            shapes.add(tuple(np.shape(toks)))
            return orig(toks, poss, all_slots, reqs, valid)

        eng._run_prefill = counting
        done = eng.run([Request(rid=i, prompt=p, max_new_tokens=2)
                        for i, p in enumerate(prompts)])
        return _streams(done), shapes

    plain, _ = run(Engine(params, cfg, batch_slots=2, cache_len=64))
    bucketed, shapes = run(Engine(params, cfg, batch_slots=2, cache_len=64,
                                  buckets=buckets))
    assert bucketed == plain
    assert len(shapes) <= len(buckets), shapes
    assert all(g == 2 and s in buckets for g, s in shapes), shapes
    for i in (0, 17, 42):               # a sample against the oracle
        assert plain[i] == solo.stream(prompts[i], 2)

    sched = _sched(cfg, params, ranks=2, slots_per_rank=2, buckets=4)
    assert sched.bucket_tables == rank_bucket_tables(2, 64, 4)
    assert sched.bucket_tables[0] == prefill_bucket_table(64, 4) == (16, 32,
                                                                     64)
    shapes = set()
    for eng in sched.shards:
        orig = eng._run_prefill

        def counting(toks, *a, _orig=orig):
            shapes.add(tuple(np.shape(toks)))
            return _orig(toks, *a)

        eng._run_prefill = counting
    reqs = [Request(rid=i, prompt=p, max_new_tokens=2)
            for i, p in enumerate(prompts[:20])]
    done = sched.run(reqs)
    assert _streams(done) == {r.rid: plain[r.rid] for r in reqs}
    assert {s for _, s in shapes} <= set(sched.bucket_tables[0]), shapes


def test_scheduler_streaming_matches_out_tokens(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=_prompt(rng, 5 + i), max_new_tokens=4)
            for i in range(4)]
    want = solo.of(reqs)
    sched = _sched(cfg, params, ranks=2, slots_per_rank=1)
    per = {}
    for rid, tok in sched.stream(reqs):
        per.setdefault(rid, []).append(tok)
    assert per == want
    assert _streams(reqs) == want
    assert all(r.done and r.status == "done" for r in reqs)
    for e in sched.shards:
        assert e.on_token is None


def test_deadline_shed_improves_interactive_attainment(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(12)

    def mk(rid, slo, dl, new):
        return Request(rid=rid, prompt=_prompt(rng, 6), max_new_tokens=new,
                       slo=slo, deadline=dl)

    def attainment(shed):
        sched = _sched(cfg, params, slots_per_rank=1, max_queue=3,
                       shed=shed)
        for i in range(5):
            sched.submit(mk(i, "batch", 30.0, 8))
        inter = [mk(10 + i, "interactive", 10.0, 2) for i in range(3)]
        for r in inter:
            sched.submit(r)
        done = sched.run([])
        assert _streams(done) == solo.of(done)
        ids = {r.rid for r in done}
        met = sum(1 for r in inter if r.rid in ids and r.latency <= 10.0)
        return met / len(inter), sched

    fcfs_att, _ = attainment("count")
    edf_att, s1 = attainment("deadline")
    assert fcfs_att == 0.0
    assert edf_att == 1.0, s1.stats()
    assert s1.n_shed >= 3
    for r in s1.rejected:
        assert r.status == "rejected" and r.slo == "batch"


def test_revive_rank_rebuilds_dead_shard_and_serves_again(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(13)
    reqs = [Request(rid=i, prompt=_prompt(rng, 6 + i), max_new_tokens=4)
            for i in range(3)]
    sched = _sched(cfg, params, slots_per_rank=2)
    eng0 = sched.shards[0]
    eng0._decode_step = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("injected rank death"))
    sched.run(reqs[:1])
    assert eng0.dead and sched.stats()["live_ranks"] == 0
    assert eng0.stats["admitted"] == 1 and eng0.stats["deaths"] == 1
    assert not sched.submit(reqs[1])
    assert reqs[1].status == "failed"

    revived = sched.revive_rank(0)
    assert revived is sched.shards[0] and not revived.dead
    assert sched.stats()["live_ranks"] == 1
    assert sched.stats()["revived"] == 1
    done = sched.run([reqs[2]])
    assert len(done) == 1 and done[0].out_tokens == solo.of(reqs[2:])[2]
    assert revived.stats["admitted"] == 2
    assert revived.stats["deaths"] == 1


def test_revive_rank_refuses_live_shard_and_mesh_is_not_ported(dense):
    """A live rank is not rebuilt; on a mesh (ported since: tests/
    test_torch_dp_mesh.py) ``ranks=`` other than the DP size is the
    reference's ValueError."""
    from repro_torch.distribution.context import Mesh
    cfg, params, _ = dense
    sched = _sched(cfg, params, slots_per_rank=1)
    with pytest.raises(ValueError, match="alive"):
        sched.revive_rank(0)
    mesh = Mesh({"data": 2, "model": 1}, 0, "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="ranks=3 conflicts with the "
                       "mesh's 2 DP rank"):
        ShardedScheduler(params, cfg, mesh=mesh, ranks=3,
                         sched=SchedulerConfig(cache_len=64))
    with pytest.raises(ValueError, match="ranks=2 conflicts with the "
                       "mesh's 4 DP rank"):
        ShardedScheduler(params, cfg, mesh=dataclasses.replace(
            mesh, shape={"data": 2, "model": 2}), ranks=2,
            profile="dp_only", sched=SchedulerConfig(cache_len=64))


def test_route_steers_away_from_rank_mid_spill(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(15)

    def mk(rid, plen, new):
        return Request(rid=rid, prompt=_prompt(rng, plen),
                       max_new_tokens=new)

    def build(paged):
        kv = dict(kv_pages=8, kv_page_len=8) if paged else {}
        sched = _sched(cfg, params, ranks=2, slots_per_rank=2, **kv)
        sched.shards[0].submit(mk(0, 40, 4))
        sched.shards[1].submit(mk(1, 8, 40))
        sched.step()
        return sched

    newcomer = mk(2, 30, 4)
    paged = build(paged=True)
    assert paged.shards[0].outstanding_tokens() \
        < paged.shards[1].outstanding_tokens()
    h0 = paged.shards[0].route_headroom_tokens()
    assert h0 is not None and h0 < len(newcomer.prompt)
    assert paged._route(newcomer) is paged.shards[1]
    assert paged.submit(newcomer) and newcomer.rank == 1
    done = paged.run([])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert _streams(done) == solo.of(done)
    for e in paged.shards:
        e.pool.check()

    contig = build(paged=False)
    assert contig.shards[0].route_headroom_tokens() is None
    assert contig._route(newcomer) is contig.shards[0]


def test_drain_baseline_takes_more_steps_than_continuous(dense):
    cfg, params, solo = dense
    rng = np.random.default_rng(3)
    mx = [8, 3, 6, 4, 7]
    prompts = [_prompt(rng, 5 + i) for i in range(5)]

    def steps(drain):
        sched = _sched(cfg, params, slots_per_rank=2, drain=drain)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=m)
                for i, (p, m) in enumerate(zip(prompts, mx))]
        done = sched.run(reqs)
        assert _streams(done) == solo.of(reqs)
        return sched.stats()["per_rank"][0]["decode_steps"]

    assert steps(drain=True) > steps(drain=False)
