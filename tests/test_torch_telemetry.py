"""The port's telemetry (``repro_torch.serve.telemetry``, a copy of the
reference's) against the reference on the same observations — quantiles,
histogram merges, TTFT merges, counter views, Prometheus text byte for
byte, Chrome trace events — and the engine's contract with tracing armed:
streams, every decode step's logits and the generator's state are bit
for bit the same with tracing on and off (plain, paged, shared-prefix,
speculative and sampled runs), a preempt / spill / resume run is traced
end to end, a chaos kill's trace carries the recovery, and decode tokens
feed the per-path gauges. Greedy streams are also held to the reference's
engine with the same options on the same bridged weights."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                      # the fixed twin below still runs
    HAVE_HYPOTHESIS = False

from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import telemetry as R  # noqa: E402
from repro_torch.serve import telemetry as T  # noqa: E402
from repro_torch.serve.chaos import ChaosConfig, ChaosMonkey  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.engine import _exec_path_label  # noqa: E402
from repro_torch.serve.frontend import ClusterFrontend  # noqa: E402
from repro_torch.serve.frontend import FrontendConfig  # noqa: E402
from repro_torch.serve.frontend import make_local_hosts  # noqa: E402
from repro_torch.serve.scheduler import SchedulerConfig  # noqa: E402
from repro_torch.serve.scheduler import ShardedScheduler  # noqa: E402
from torch_parity import SoloOracle, amp_model  # noqa: E402

BOTH = pytest.mark.parametrize("M", [R, T], ids=["reference", "port"])


# ---------------------------------------------------------------------------
# the copy against the reference, on the same observations
# ---------------------------------------------------------------------------


def test_pcts_ms_and_nearest_rank_equal_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 7, 19, 20, 100):
        lats = sorted(rng.exponential(0.1, size=n).tolist())
        xs = sorted(lats)
        legacy = tuple(xs[min(len(xs) - 1, int(len(xs) * q))] * 1e3
                       for q in (0.5, 0.95))
        assert T.pcts_ms(lats) == R.pcts_ms(lats) == legacy
        for q in (0.0, 0.25, 0.99, 1.0):
            assert T.nearest_rank(lats, q) == R.nearest_rank(lats, q)
    with pytest.raises(ValueError):
        T.nearest_rank([], 0.5)


def _snap(M, vals, bounds=None):
    h = M.Histogram(M.TTFT_BOUNDS_S if bounds is None else bounds)
    for v in vals:
        h.observe(v)
    return h.snapshot()


def _fields(s):
    return (s.bounds, s.counts, s.count, s.total, s.vmin, s.vmax)


def _same(x, y):
    assert (x.bounds, x.counts, x.count, x.vmin, x.vmax) == \
        (y.bounds, y.counts, y.count, y.vmin, y.vmax)
    assert x.total == pytest.approx(y.total)


def _assert_merge_laws(a_vals, b_vals, c_vals):
    for M in (T, R):
        a, b, c = (_snap(M, v) for v in (a_vals, b_vals, c_vals))
        _same(a.merge(b), b.merge(a))
        _same(a.merge(b).merge(c), a.merge(b.merge(c)))
        union = _snap(M, list(a_vals) + list(b_vals) + list(c_vals))
        _same(c.merge(a).merge(b), union)
        for q in (0.5, 0.95, 0.99):
            assert a.merge(b).merge(c).quantile(q) == union.quantile(q)
    # the same merges give the same snapshots in both packages
    ta, tb, tc = (_snap(T, v) for v in (a_vals, b_vals, c_vals))
    ra, rb, rc = (_snap(R, v) for v in (a_vals, b_vals, c_vals))
    assert _fields(tc.merge(ta).merge(tb)) == _fields(rc.merge(ra).merge(rb))
    assert tc.merge(ta).as_dict() == rc.merge(ra).as_dict()


def test_hist_merge_laws_fixed_twin():
    rng = np.random.default_rng(1)
    for _ in range(25):
        groups = [rng.exponential(0.2,
                                  size=int(rng.integers(0, 40))).tolist()
                  for _ in range(3)]
        _assert_merge_laws(*groups)


if HAVE_HYPOTHESIS:
    @settings(max_examples=40, deadline=None)
    @given(*(st.lists(st.floats(min_value=0.0, max_value=100.0,
                                allow_nan=False), max_size=30)
             for _ in range(3)))
    def test_hist_merge_laws_property(a_vals, b_vals, c_vals):
        _assert_merge_laws(a_vals, b_vals, c_vals)


@BOTH
def test_hist_quantile_semantics(M):
    bounds = (1.0, 2.0, 4.0)
    assert M.HistSnapshot.empty(bounds).quantile(0.5) is None
    assert _snap(M, [0.5], bounds).quantile(0.5) == 1.0
    assert _snap(M, [1.5, 1.6, 1.7], bounds).quantile(0.5) == 2.0
    assert _snap(M, [9.0, 11.0], bounds).quantile(0.95) == 11.0
    with pytest.raises(ValueError, match="different bucket bounds"):
        _snap(M, [1.0], bounds).merge(_snap(M, [1.0], (1.0, 2.0)))
    with pytest.raises(ValueError, match="strictly increasing"):
        M.Histogram((2.0, 1.0))
    d = _snap(M, [0.5, 3.0], bounds).as_dict()
    assert d["count"] == 2 and d["min"] == 0.5 and d["max"] == 3.0


def test_merged_ttft_stats_equal_reference_and_order_independent():
    out = {}
    for M in (R, T):
        t1, t2 = M.Telemetry(), M.Telemetry()
        for v in (0.002, 0.003, 0.004):
            t1.observe_ttft("interactive", v)
        for v in (0.2, 0.4):
            t2.observe_ttft("interactive", v)
        t2.observe_ttft("batch", 1.3)
        ab = M.merged_ttft_stats([t1, t2])
        assert ab == M.merged_ttft_stats([t2, t1])
        assert ab["interactive"]["count"] == 5
        assert ab["batch"]["count"] == 1
        assert t1.ttft_stats()["interactive"]["count"] == 3
        out[M] = ab
    assert out[T] == out[R]


def _events_sans_time(tracer):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in tracer.events()]


def test_tracer_ring_never_exceeds_capacity():
    got = {}
    for M in (R, T):
        tr = M.SpanTracer(capacity=16, enabled=True)
        for i in range(50):
            tr.instant(f"ev{i}", tid=0)
        assert len(tr) == 16 and tr.dropped == 50 - 16
        assert [e["name"] for e in tr.events()] == \
            [f"ev{i}" for i in range(34, 50)]
        got[M] = _events_sans_time(tr)
    assert got[T] == got[R]


def test_tracer_disabled_is_inert():
    tr = T.SpanTracer(capacity=8, enabled=False)
    assert tr.t0() == 0.0
    tr.instant("x")
    tr.complete("y", 0.0)
    assert len(tr) == 0 and tr.events() == []


def _check_chrome(trace):
    """The Chrome trace-event object format's invariants."""
    assert set(trace) == {"traceEvents", "displayTimeUnit"}
    assert trace["displayTimeUnit"] == "ms"
    for ev in trace["traceEvents"]:
        assert isinstance(ev["name"], str) and ev["name"]
        assert isinstance(ev["cat"], str)
        assert isinstance(ev["ts"], (int, float))
        assert isinstance(ev["pid"], int)
        assert isinstance(ev["tid"], int)
        assert isinstance(ev["args"], dict)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
        else:
            assert ev["ph"] == "i" and ev["s"] == "g"
    return [e["name"] for e in trace["traceEvents"]]


def test_chrome_trace_equal_reference(tmp_path):
    files = {}
    for M in (R, T):
        tr = M.SpanTracer(capacity=64, enabled=True)
        tr.instant("submit", tid=1, rid=7)
        t0 = tr.t0()
        tr.complete("prefill", t0, tid=1, tokens=12)
        tr.instant("admit", tid=0, cat="sched")
        path = tmp_path / f"{M.__name__}.json"
        assert tr.write(str(path)) == 3
        with open(path) as fh:
            files[M] = json.load(fh)
        assert _check_chrome(files[M]) == ["submit", "prefill", "admit"]
    for a, b in zip(files[T]["traceEvents"], files[R]["traceEvents"]):
        assert sorted(a) == sorted(b)
        assert {k: v for k, v in a.items() if k not in ("ts", "dur")} == \
            {k: v for k, v in b.items() if k not in ("ts", "dur")}


@BOTH
def test_counter_view_surface(M):
    reg = M.MetricsRegistry()
    view = reg.counter_scope(rank=0).declare(["admitted", "failed"])
    view["admitted"] += 2
    view.update(failed=1)
    view["memory"] = {"pages": 4}
    assert dict(view, extra=9)["extra"] == 9
    assert view["memory"] == {"pages": 4}
    assert ("memory", 4) not in view.int_items()
    again = reg.counter_scope(rank=0).declare(["admitted", "failed"])
    assert again is view and again["admitted"] == 2
    assert repr(view).startswith("CounterView(")


def _drive_registry(M):
    reg = M.MetricsRegistry()
    for rank in (1, 0):
        view = reg.counter_scope(rank=rank).declare(["admitted", "failed"])
        view["admitted"] += 3 + rank
        view["memory"] = {"pages": 4}
    reg.gauge("serve_queue_depth", 5)
    reg.gauge("serve_none_gauge", lambda: None)
    reg.gauge("serve_depth", 2.5, host="1")
    for slo, vals in (("interactive", (0.05, 0.5, 3.0)), ("batch", (40.0,))):
        for v in vals:
            reg.histogram("serve_ttft_seconds", (0.1, 1.0),
                          slo=slo).observe(v)
    reg.register_collector(lambda: {"serve_custom_total": 7}, key="c")
    reg.register_collector(lambda: {"serve_custom_total": 8}, key="c")
    reg.register_collector(lambda: {'serve_kv_spills{rank="0"}': 2})
    return reg


def test_registry_prometheus_text_equal_reference():
    text, ref = _drive_registry(T).prometheus(), \
        _drive_registry(R).prometheus()
    assert text == ref                  # byte for byte
    assert 'serve_admitted_total{rank="0"} 3' in text
    assert "# TYPE serve_admitted_total counter" in text
    assert "serve_queue_depth 5" in text
    assert "serve_none_gauge" not in text
    assert 'le="0.1"' in text and 'le="+Inf"' in text
    assert 'serve_ttft_seconds_count{slo="interactive"} 3' in text
    assert "serve_custom_total 8" in text
    assert "serve_custom_total 7" not in text
    assert _drive_registry(T).summary() == _drive_registry(R).summary()


def test_path_gauges_rates_and_accept_ema_equal_reference():
    for M in (R, T):
        tel = M.Telemetry()
        assert tel.tok_s("packed") == 0.0
        tel.note_tokens("packed", 40)
        assert tel.tok_s("packed") > 0.0
        text = tel.prometheus()
        assert 'serve_path_tok_s{path="packed"}' in text
        assert "serve_spec_accept_ema" not in text
        tel.note_spec_round(3, 4)
        assert tel.accept_ema.value == pytest.approx(0.75)
        tel.note_spec_round(0, 0)
        assert "serve_spec_accept_ema 0.75" in tel.prometheus()
    rates = {}
    for M in (R, T):
        r, e = M.RollingRate(window_s=2.0), M.Ema(alpha=0.3)
        for t, n in ((0.0, 5), (0.5, 0), (1.0, 7), (2.5, 3)):
            r.add(n, t=t)
        rates[M] = (r.per_s(now=2.6), r.per_s(now=9.0),
                    [e.update(x) for x in (0.1, 0.9, 0.4)])
    assert rates[T] == rates[R]
    assert T.DECLARED_STATS == R.DECLARED_STATS
    assert T.PATH_LABELS == R.PATH_LABELS


# ---------------------------------------------------------------------------
# the engine with tracing on and off
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def amp():
    return amp_model()


def _mk_requests(cls, n, rng, max_new=6, temperature=0.0):
    return [cls(rid=i, prompt=rng.integers(0, 64, size=(int(
        rng.integers(4, 30)),)).astype(np.int32), max_new_tokens=max_new,
        temperature=temperature if i % 2 else 0.0) for i in range(n)]


def _recording(eng):
    """Every target decode step's logits, cloned as they come."""
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


CASES = {
    "plain": {},
    "paged": dict(kv_pages=16, kv_page_len=8),
    "share": dict(kv_pages=16, kv_page_len=8, kv_share=True),
    "spec": dict(kv_pages=16, kv_page_len=8, draft_sparsity=0.75,
                 draft_k=4),
    "sampled": dict(kv_pages=16, kv_page_len=8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_bit_identical_with_tracing(amp, case):
    """Tracing on and off: equal streams, every decode step's logits bit
    for bit, equal generator state after the run; greedy streams equal
    the reference engine's with the same options. ``sampled`` draws at
    temperature 0.8 on every second request."""
    cfg, tcfg, params, tparams = amp
    kw = CASES[case]
    temp = 0.8 if case == "sampled" else 0.0

    def drive(trace):
        rng = np.random.default_rng(0)
        eng = Engine(tparams, tcfg, batch_slots=2, cache_len=64,
                     telemetry=T.Telemetry(trace=trace), **kw)
        steps = _recording(eng)
        done = eng.run(_mk_requests(Request, 5, rng, temperature=temp))
        return ({r.rid: r.out_tokens for r in done}, steps,
                eng._gen.get_state(), eng)

    ref_streams, ref_steps, ref_state, _ = drive(False)
    got, steps, state, eng = drive(True)
    assert got == ref_streams
    assert len(steps) == len(ref_steps) > 0
    assert all(torch.equal(a, b) for a, b in zip(steps, ref_steps))
    assert torch.equal(state, ref_state)
    names = set(_check_chrome(eng.telemetry.tracer.chrome()))
    assert {"submit", "admit", "prefill", "token"} <= names, names
    if "draft_sparsity" in kw:
        assert "spec_round" in names, names
        assert eng.telemetry.accept_ema.value is not None
    if temp == 0.0:
        rng = np.random.default_rng(0)
        want = ref_engine.Engine(params, cfg, batch_slots=2, cache_len=64,
                                 **kw).run(_mk_requests(ref_engine.Request,
                                                        5, rng))
        assert got == {r.rid: [int(t) for t in r.out_tokens] for r in want}


def test_preempt_spill_resume_traced_and_bit_identical(amp, tmp_path):
    """The forced preempt -> spill -> fault cycle with the tracer armed:
    streams equal the solo oracle, the written trace carries the whole
    lifecycle, TTFT saw both classes, and the Prometheus text holds the
    per-rank counters and the pool's serve_kv_* gauges."""
    cfg, tcfg, params, tparams = amp
    solo = SoloOracle(amp)
    rng = np.random.default_rng(4)
    batch = Request(rid=0, prompt=rng.integers(0, 64, size=(18,))
                    .astype(np.int32), max_new_tokens=14, slo="batch")
    inter = Request(rid=1, prompt=rng.integers(0, 64, size=(40,))
                    .astype(np.int32), max_new_tokens=3,
                    slo="interactive", deadline=0.01)
    want = solo.of([batch, inter])
    sched = ShardedScheduler(
        tparams, tcfg, ranks=1,
        sched=SchedulerConfig(slots_per_rank=1, cache_len=64,
                              policy="edf", preempt=True,
                              preempt_mode="kv", kv_pages=8,
                              kv_page_len=8, kv_host_pages=8),
        telemetry=T.Telemetry(trace=True))
    assert sched.submit(batch)
    for _ in range(4):
        sched.step()
    assert sched.submit(inter)
    done = []
    while sched.has_work():
        done.extend(sched.step())
        sched.shards[0].pool.check()
    assert {r.rid: r.out_tokens for r in done} == want
    assert sched.stats()["preemptions"] >= 1
    path = tmp_path / "sched_trace.json"
    sched.telemetry.write_trace(str(path))
    with open(path) as fh:
        names = set(_check_chrome(json.load(fh)))
    assert {"submit", "admit", "prefill", "token", "preempt",
            "spill", "resume"} <= names, names
    ttft = sched.stats()["ttft"]
    assert ttft["interactive"]["count"] >= 1
    assert ttft["batch"]["count"] >= 1
    text = sched.telemetry.prometheus()
    assert 'serve_preemptions_total{rank="0"} 1' in text
    mem = sched.shards[0].memory_stats()
    assert f'serve_kv_spills{{rank="0"}} {mem.spills}' in text
    assert mem.spills >= 1 and mem.faults >= 1


def test_chaos_kill_trace_loads_and_carries_recovery(amp, tmp_path):
    """A kill:0@3 chaos run, then a revive: one loadable trace whose
    events span both hosts (pids 0, 1) and the frontend's own retry /
    death / revive instants (pid -1), time-sorted; per-host Prometheus
    series; merged TTFT; streams equal the solo oracle."""
    cfg, tcfg, params, tparams = amp
    solo = SoloOracle(amp)
    rng = np.random.default_rng(0)
    reqs = _mk_requests(Request, 6, rng, max_new=4)
    want = solo.of(reqs)
    hosts = make_local_hosts(
        tparams, tcfg, hosts=2,
        sched=SchedulerConfig(slots_per_rank=2, cache_len=64),
        chaos=ChaosMonkey(ChaosConfig(kill_at_step={0: 3})), trace=True)
    fe = ClusterFrontend(hosts, FrontendConfig(retries=2,
                                               backoff_base=0.001,
                                               rng_seed=1))
    completed = fe.run(reqs)
    assert {r.rid: r.out_tokens for r in completed} == want
    assert fe.n_retries >= 1
    fe.revive_host(0)
    path = tmp_path / "chaos_trace.json"
    n = fe.write_trace(str(path))
    with open(path) as fh:
        trace = json.load(fh)
    assert len(trace["traceEvents"]) == n
    names = set(_check_chrome(trace))
    assert {"submit", "admit", "prefill", "token", "host_kill",
            "host_dead", "retry", "host_revive"} <= names, names
    assert {-1, 0, 1} <= {e["pid"] for e in trace["traceEvents"]}
    ts = [e["ts"] for e in trace["traceEvents"]]
    assert ts == sorted(ts)
    text = fe.prometheus()
    assert 'host="0"' in text and 'host="1"' in text
    assert "serve_frontend_retries_total" in text
    ttft = fe.stats()["ttft"]
    assert sum(d["count"] for d in ttft.values()) >= len(reqs)


def test_exec_path_labels_feed_gauges(amp):
    """The port's path label equals the reference's on the same configs;
    packed containers read "packed"; decode tokens land on the engine's
    label."""
    from repro.configs import SASPConfig as RSASP
    from repro_torch.configs import SASPConfig as TSASP
    cfg, tcfg, params, tparams = amp
    cases = [({}, {}), (dict(enabled=True, block_k=8, block_n=8,
                             sparsity=0.25), {}),
             (dict(enabled=True, block_k=8, block_n=8, sparsity=0.25,
                   quantize=True), {}),
             (dict(enabled=True, block_k=8, block_n=8, sparsity=0.25,
                   path="bsr"), {})]
    for kw, _ in cases:
        want = ref_engine._exec_path_label(
            params, dataclasses.replace(cfg, sasp=RSASP(**kw)))
        assert _exec_path_label(
            tparams, dataclasses.replace(tcfg, sasp=TSASP(**kw))) == want
    _, pcfg, _, pparams = amp_model(packed=True)
    assert _exec_path_label(pparams, pcfg) == "packed"
    eng = Engine(tparams, tcfg, batch_slots=1, cache_len=64)
    assert eng.path_label == "dense"
    eng.run(_mk_requests(Request, 1, np.random.default_rng(2), max_new=4))
    assert eng.telemetry.tok_s("dense") > 0.0
    peng = Engine(pparams, pcfg, batch_slots=1, cache_len=64)
    peng.run(_mk_requests(Request, 1, np.random.default_rng(2), max_new=4))
    assert peng.telemetry.tok_s("packed") > 0.0
    assert 'serve_path_tok_s{path="packed"}' in peng.telemetry.prometheus()
