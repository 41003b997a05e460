"""The port's cluster frontend (``repro_torch.serve.frontend``) and chaos
(``repro_torch.serve.chaos``): the chaos grammar and schedules against
the reference's copy, then the cases of the reference's
tests/test_frontend.py — in-process host kill with retry, a step failure
that escalates, a suspect host that recovers, the watchdog, graceful
drain and its expiry, revive with replay, fixed kill / revive schedules
over contiguous and paged sharing pools, a kill with a shared fan-out in
flight — and a ``kill -9`` of a real ``host_worker`` process. Greedy
streams are held to each request alone through the port's and the
reference's ``Engine(batch_slots=1)`` on the same bridged weights
(``torch_parity.SoloOracle``); no token index is delivered twice. Time-
driven cases (watchdog, backoff) run on an injected frontend clock, so
no margin depends on the machine's load."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import chaos as ref_chaos  # noqa: E402
from repro_torch.serve import chaos as t_chaos  # noqa: E402
from repro_torch.serve import frontend as fe_mod  # noqa: E402
from repro_torch.serve.chaos import ChaosConfig, ChaosMonkey  # noqa: E402
from repro_torch.serve.engine import Request  # noqa: E402
from repro_torch.serve.frontend import ClusterFrontend  # noqa: E402
from repro_torch.serve.frontend import FrontendConfig  # noqa: E402
from repro_torch.serve.frontend import SubprocessHost  # noqa: E402
from repro_torch.serve.frontend import make_local_hosts  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from torch_parity import SoloOracle, amp_model  # noqa: E402

SCHED = SchedulerConfig(slots_per_rank=2, cache_len=64)
SCHED_SHARE = SchedulerConfig(slots_per_rank=2, cache_len=64,
                              kv_pages=12, kv_page_len=8,
                              kv_host_pages=8, kv_share=True)


@pytest.fixture(scope="module")
def setup():
    """(port cfg, port params, request specs, solo streams, oracle): the
    reference's eight requests and their solo streams, held equal in both
    packages."""
    model = amp_model()
    oracle = SoloOracle(model)
    rng = np.random.default_rng(0)
    specs = [(rng.integers(0, 64, size=(5 + 3 * i,)).astype(np.int32),
              4 + (3 * i) % 5) for i in range(8)]
    solo = {i: oracle.stream(p, m) for i, (p, m) in enumerate(specs)}
    return model[1], model[3], specs, solo, oracle


def _mk(specs, idx=None, rid_base=0):
    idx = range(len(specs)) if idx is None else idx
    return [Request(rid=rid_base + i, prompt=specs[i][0],
                    max_new_tokens=specs[i][1]) for i in idx]


def _collector(delivered):
    return lambda req, tok: delivered.setdefault(req.rid, []).append(tok)


class _Clock:
    """An injected frontend clock: ``sleep`` advances it, ticks advance
    it by hand. Engines and schedulers keep the real clock."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, s)


# ----------------------------------------------------------------------
# chaos, against the reference's copy
# ----------------------------------------------------------------------
CHAOS_SPECS = ["kill:0@12, raise:1@3,drop-hb:0@5x3,slow:1@0.02,seed:7",
               "drop-hb:2@4", "", "kill:0@4,seed:3", " ,kill:1@1,",
               "KILL:0@2", "explode:0@1", "kill:0@soon", "drop-hb:0@3xq",
               "slow:1@fast", "seed:x", "kill:@3"]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_parse_chaos_spec_equals_reference(spec):
    try:
        want = ref_chaos.parse_chaos_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            t_chaos.parse_chaos_spec(spec)
        assert str(got.value) == str(e)
        assert "grammar" in str(got.value)
        return
    got = t_chaos.parse_chaos_spec(spec)
    assert vars(got) == vars(want)


def test_chaos_monkey_fires_on_the_reference_steps():
    kw = dict(seed=3, kill_at_step={0: 5, 2: 1}, raise_in_decode={1: 2},
              drop_heartbeat={0: (3, 2), 1: (4, -1)}, slow_host={1: 0.5})
    ref = ref_chaos.ChaosMonkey(ref_chaos.ChaosConfig(**kw))
    mine = t_chaos.ChaosMonkey(t_chaos.ChaosConfig(**kw))
    for step in range(0, 12):
        for host in range(3):
            for hook in ("kill_due", "decode_raise_due",
                         "heartbeat_dropped"):
                assert getattr(mine, hook)(host, step) == \
                    getattr(ref, hook)(host, step), (hook, host, step)
            assert mine.delay_s(host) == ref.delay_s(host)
    assert [mine.rng.random() for _ in range(5)] == \
        [ref.rng.random() for _ in range(5)]
    # the reference's own case
    m = ChaosMonkey(ChaosConfig(seed=3, kill_at_step={0: 5},
                                raise_in_decode={1: 2},
                                drop_heartbeat={0: (3, 2)},
                                slow_host={1: 0.5}))
    assert not m.kill_due(0, 4) and not m.kill_due(1, 99)
    assert m.kill_due(0, 5) and not m.kill_due(0, 6)
    assert m.decode_raise_due(1, 7) and not m.decode_raise_due(1, 8)
    assert [m.heartbeat_dropped(0, s) for s in range(1, 7)] == \
        [False, False, True, True, False, False]


def test_frontend_backoff_draws_equal_reference():
    """Same seed, same jitter: the retry delays of the two frontends."""
    from repro.serve.frontend import ClusterFrontend as RefFrontend
    from repro.serve.frontend import FrontendConfig as RefConfig

    class Stub:
        host_id, telemetry = 0, None

        def set_sink(self, fn):
            pass

    cfg = dict(backoff_base=0.02, backoff_cap=0.5, rng_seed=11)
    ref = RefFrontend([Stub()], RefConfig(**cfg))
    mine = ClusterFrontend([Stub()], FrontendConfig(**cfg))
    assert [mine._backoff(a) for a in range(1, 9)] == \
        [ref._backoff(a) for a in range(1, 9)]


# ----------------------------------------------------------------------
# host death -> retry -> exact resume
# ----------------------------------------------------------------------
def test_kill_host_mid_load_bit_identical(setup):
    cfg, params, specs, solo, _ = setup
    hosts = make_local_hosts(params, cfg, hosts=2, sched=SCHED,
                             chaos=ChaosMonkey(ChaosConfig(
                                 kill_at_step={0: 3})))
    delivered = {}
    fe = ClusterFrontend(
        hosts, FrontendConfig(retries=2, backoff_base=0.001, rng_seed=1),
        on_token=_collector(delivered))
    reqs = _mk(specs)
    completed = fe.run(reqs)
    assert hosts[0].killed and fe._state(0) == "dead"
    assert not fe.failed and not fe.rejected
    assert {r.rid: r.out_tokens for r in completed} == solo
    assert delivered == solo
    assert fe.n_retries >= 1
    st = fe.stats()
    assert st["dead"] == 1 and st["done"] == len(reqs)
    assert st["unresolved"] == 0


def test_step_failure_escalates_and_retries_elsewhere(setup):
    cfg, params, specs, solo, _ = setup
    hosts = make_local_hosts(params, cfg, hosts=2, sched=SCHED,
                             chaos=ChaosMonkey(ChaosConfig(
                                 raise_in_decode={0: 2})))
    delivered = {}
    fe = ClusterFrontend(hosts, FrontendConfig(retries=2,
                                               backoff_base=0.001),
                         on_token=_collector(delivered))
    completed = fe.run(_mk(specs, range(6)))
    want = {i: solo[i] for i in range(6)}
    assert {r.rid: r.out_tokens for r in completed} == want
    assert delivered == want
    assert not fe.failed and fe.n_retries >= 1
    assert hosts[0].sched.shards[0].dead
    assert fe._state(0) == "dead"


def test_suspect_host_recovers_without_losing_its_work(setup):
    cfg, params, specs, solo, _ = setup
    hosts = make_local_hosts(params, cfg, hosts=2, sched=SCHED,
                             chaos=ChaosMonkey(ChaosConfig(
                                 drop_heartbeat={0: (2, 2)})))
    fe = ClusterFrontend(hosts, FrontendConfig(suspect_after=1,
                                               dead_after=3))
    states = []
    completed = fe.run(_mk(specs, range(6)),
                       on_tick=lambda t: states.append(fe._state(0)))
    assert {r.rid: r.out_tokens for r in completed} == \
        {i: solo[i] for i in range(6)}
    assert "suspect" in states and "dead" not in states
    assert fe._state(0) == "healthy"
    assert fe.n_retries == 0
    assert hosts[0].sched.stats()["accepted"] > 0


def test_watchdog_fails_hung_request_without_stalling_others(
        setup, monkeypatch):
    """On an injected frontend clock (0.5 s a tick): the request that
    cannot finish inside its 8 s budget is cancelled out of its slot and
    failed at tick 17, mid-decode; the requests on the other host finish
    on their solo streams long before. No margin depends on real time."""
    cfg, params, specs, solo, oracle = setup
    clock = _Clock()
    monkeypatch.setattr(fe_mod, "time", clock)
    hosts = make_local_hosts(params, cfg, hosts=2, sched=SCHED)
    rng = np.random.default_rng(9)
    hung = Request(rid=100, prompt=rng.integers(0, 64, size=(8,))
                   .astype(np.int32), max_new_tokens=10_000)
    fe = ClusterFrontend(hosts, FrontendConfig(request_timeout=8.0,
                                               retries=1,
                                               backoff_base=0.001))

    def tick(t):
        clock.t += 0.5

    completed = fe.run([hung] + _mk(specs, range(4)), on_tick=tick)
    assert {r.rid: r.out_tokens for r in completed} == \
        {i: solo[i] for i in range(4)}
    assert fe.failed == [hung]
    assert "watchdog" in hung.error and hung.status == "failed"
    assert not fe.trackers[100].replayable
    assert 0 < len(hung.out_tokens) < 10_000
    assert hung.out_tokens == oracle.stream(hung.prompt, 60)[
        :len(hung.out_tokens)]
    assert hosts[1].sched.stats()["accepted"] == 4
    assert not hosts[0].sched.has_work()


def test_graceful_drain_under_load_and_expiry(setup):
    cfg, params, specs, solo, _ = setup
    hosts = make_local_hosts(params, cfg, hosts=2, sched=SCHED)
    fe = ClusterFrontend(hosts, FrontendConfig(drain_timeout=120.0))
    reqs = _mk(specs)
    for r in reqs:
        assert fe.submit(r)
    fe.step()
    fe.step()
    completed, clean = fe.drain()
    assert clean and not fe.unresolved()
    assert {r.rid: r.out_tokens for r in fe.done} == solo
    late = Request(rid=99, prompt=specs[0][0], max_new_tokens=4)
    assert not fe.submit(late)
    assert late.status == "rejected" and late in fe.rejected

    fe2 = ClusterFrontend(hosts, FrontendConfig())
    reqs2 = _mk(specs, range(4), rid_base=200)
    for r in reqs2:
        assert fe2.submit(r)
    fe2.step()
    completed2, clean2 = fe2.drain(timeout=0.0)
    assert not clean2 and not fe2.unresolved()
    assert len(fe2.done) + len(fe2.failed) == 4
    assert all("drain timeout" in r.error for r in fe2.failed)
    assert not hosts[0].sched.has_work() and not hosts[1].sched.has_work()


def test_revive_host_replays_retryable_failures(setup):
    cfg, params, specs, solo, _ = setup
    hosts = make_local_hosts(params, cfg, hosts=1, sched=SCHED,
                             chaos=ChaosMonkey(ChaosConfig(
                                 raise_in_decode={0: 2})))
    delivered = {}
    fe = ClusterFrontend(hosts, FrontendConfig(retries=1,
                                               backoff_base=0.001),
                         on_token=_collector(delivered))
    completed = fe.run(_mk(specs, range(4)))
    assert not completed
    assert len(fe.failed) == 4
    assert all(fe.trackers[r.rid].replayable for r in fe.failed)
    assert fe._state(0) == "dead"

    fe.revive_host(0)
    assert fe._state(0) == "healthy" and not fe.failed
    eng = hosts[0].sched.shards[0]
    assert not eng.dead and eng.stats["deaths"] == 1
    completed = fe.run([])
    want = {i: solo[i] for i in range(4)}
    assert {r.rid: r.out_tokens for r in completed} == want
    assert delivered == want
    assert eng.stats["admitted"] >= 4
    assert fe.stats()["done"] == 4 and fe.stats()["failed"] == 0


# ----------------------------------------------------------------------
# fixed kill / revive schedules
# ----------------------------------------------------------------------
def _check_pools(fe):
    """The allocator's own check() over every live paged shard: no leaked
    page, no double free, refcount == table references."""
    for h in fe.hosts.values():
        for eng in h.sched.shards:
            if not eng.dead and eng.pool is not None:
                eng.pool.check()


def _run_schedule(setup, schedule, n_reqs=5, sched=SCHED):
    cfg, params, specs, solo, _ = setup
    hosts = make_local_hosts(params, cfg, hosts=2, sched=sched)
    delivered = {}
    fe = ClusterFrontend(
        hosts, FrontendConfig(retries=3, backoff_base=0.001, rng_seed=7),
        on_token=_collector(delivered))

    def on_tick(t):
        cycled = False
        for op, h in schedule.get(t, []):
            if op == "kill":
                fe.hosts[h].killed = True
                cycled = True
            elif op == "revive" and fe._state(h) == "dead":
                fe.revive_host(h)
                cycled = True
        if cycled:
            _check_pools(fe)

    fe.run(_mk(specs, range(n_reqs)), on_tick=on_tick)
    _check_pools(fe)
    resolved = fe.done + fe.failed + fe.rejected
    assert len(resolved) == n_reqs
    assert {r.rid for r in resolved} == set(range(n_reqs))
    for rid, toks in delivered.items():
        assert toks == solo[rid][:len(toks)]
    for r in fe.done:
        assert r.out_tokens == solo[r.rid]
        assert delivered[r.rid] == solo[r.rid]
    for r in fe.failed:
        assert r.error
    return fe


@pytest.mark.parametrize("sched", [SCHED, SCHED_SHARE],
                         ids=["contiguous", "paged_share"])
def test_chaos_schedules_fixed_twin(setup, sched):
    fe = _run_schedule(setup, {2: [("kill", 0)]}, sched=sched)
    assert fe.n_retries >= 1 and not fe.failed
    fe = _run_schedule(setup, {1: [("kill", 1)], 4: [("revive", 1)],
                               6: [("kill", 0)]}, sched=sched)
    assert fe.n_retries >= 1 and not fe.failed


def test_chaos_kill_with_shared_fanout_in_flight(setup):
    cfg, params, _, _, oracle = setup
    rng = np.random.default_rng(41)
    prompt = rng.integers(0, 64, size=(19,)).astype(np.int32)
    want = oracle.stream(prompt, 8)
    reqs = [Request(rid=i, prompt=prompt.copy(), max_new_tokens=8)
            for i in range(6)]
    hosts = make_local_hosts(params, cfg, hosts=2, sched=SCHED_SHARE)
    delivered = {}
    fe = ClusterFrontend(
        hosts, FrontendConfig(retries=3, backoff_base=0.001, rng_seed=7),
        on_token=_collector(delivered))

    def on_tick(t):
        if t == 3 and not fe.hosts[0].killed:
            fe.hosts[0].killed = True
            _check_pools(fe)

    done = fe.run(reqs, on_tick=on_tick)
    _check_pools(fe)
    assert not fe.failed and not fe.rejected
    assert {r.rid: r.out_tokens for r in done} == {i: want
                                                   for i in range(6)}
    assert delivered == {i: want for i in range(6)}
    mem = hosts[1].sched.shards[0].memory_stats()
    assert mem.device_used == mem.cached_pages


# ----------------------------------------------------------------------
# a real kill -9 of a host_worker process
# ----------------------------------------------------------------------
@pytest.mark.timeout(300)
def test_kill9_subprocess_host_mid_load(setup, tmp_path):
    """SIGKILL a ``python -m repro_torch.serve.host_worker`` process
    mid-load (on the CPU, over the bridged weights saved to a file).
    Every request resolves; streams and per-token delivery equal an
    undisturbed one-worker run and the solo oracle of both packages;
    nothing double-streams; every child has exited at the end."""
    cfg, params, specs, solo, _ = setup
    path = os.path.join(str(tmp_path), "params.pt")
    torch.save(params, path)
    spec = dict(device="cpu", params_file=path, layers=2, d_model=64,
                vocab=64, slots=2, cache_len=64)
    want = {i: solo[i] for i in range(6)}

    ref_host = SubprocessHost(0, spec=dict(spec, seed=0))
    ref_fe = ClusterFrontend([ref_host], FrontendConfig())
    try:
        ref = {r.rid: r.out_tokens
               for r in ref_fe.run(_mk(specs, range(6)))}
    finally:
        ref_fe.close()
    assert ref == want

    hosts = [SubprocessHost(0, spec=dict(spec, seed=0)),
             SubprocessHost(1, spec=dict(spec, seed=1))]
    delivered = {}
    fe = ClusterFrontend(hosts, FrontendConfig(retries=2,
                                               backoff_base=0.001),
                         on_token=_collector(delivered))
    killed = []

    def on_tick(t):
        if t == 3 and not killed:
            assert any(tr.host_id == 0 for tr in fe.unresolved())
            hosts[0].kill()
            killed.append(t)

    try:
        completed = fe.run(_mk(specs, range(6)), on_tick=on_tick)
    finally:
        fe.close()
    assert killed and not hosts[0].alive and fe._state(0) == "dead"
    assert {r.rid: r.out_tokens for r in completed} == ref
    assert delivered == ref
    assert not fe.failed and not fe.rejected
    assert fe.n_retries >= 1
    for h in [ref_host] + hosts:
        assert h.proc.poll() is not None      # no child left behind
    assert hosts[0].proc.returncode == -9


# ----------------------------------------------------------------------
# the launcher's serving-tier flags
# ----------------------------------------------------------------------
def test_launcher_scheduler_and_frontend_flags(capsys, tmp_path):
    """Every scheduler / frontend flag of the reference's launcher is
    accepted with its meaning (summary lines, trace and metrics files),
    and its usage errors stay loud."""
    from repro_torch.launch import serve as t_serve
    base = ["--sasp", "0.5", "--path", "packed", "--scope", "all",
            "--requests", "4", "--max-new", "3", "--slots", "2",
            "--cache-len", "64", "--device", "cpu"]
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    t_serve.main(base + [
        "--scheduler", "--ranks", "2", "--slots-per-rank", "2",
        "--max-queue", "8", "--admission", "edf", "--aging", "0.05",
        "--preempt", "--preempt-mode", "reprefill", "--shed", "deadline",
        "--interactive-every", "2", "--buckets", "2",
        "--trace-out", str(trace), "--metrics-dump", str(prom),
        "--metrics-interval", "30"])
    out = capsys.readouterr().out
    assert "scheduler: 2 rank(s), 4/4 admitted" in out
    assert "interactive : n=2" in out and "ttft batch" in out
    assert "4 requests, 12 tokens" in out
    with open(trace) as fh:
        assert json.load(fh)["traceEvents"]
    assert 'serve_admitted_total{rank="1"}' in prom.read_text()
    t_serve.main(base + ["--scheduler", "--drain"])
    assert "drain baseline" in capsys.readouterr().out
    t_serve.main(base + [
        "--hosts", "2", "--chaos", "kill:0@2,seed:3", "--retries", "2",
        "--backoff", "0.001", "--timeout", "600", "--drain-timeout", "60",
        "--stream"])
    out = capsys.readouterr().out
    assert ("frontend: 2 host(s) (1 healthy, 0 suspect, 1 dead), 4 done, "
            "0 failed, 0 rejected") in out
    assert "drain clean" in out and "streamed 12 tokens" in out
    for argv, msg in ((["--chaos", "kill:0@2"], "add --hosts"),
                      (["--hosts", "2", "--chaos", "kill:0@x"], "grammar"),
                      (["--hosts", "0"], "--hosts must be >= 1"),
                      (["--scheduler", "--ranks", "0"],
                       "--ranks must be >= 1")):
        with pytest.raises(SystemExit, match=msg):
            t_serve.main(base + argv)
