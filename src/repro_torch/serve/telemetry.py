"""Serving telemetry of the port (``repro.serve.telemetry``, copied:
the port imports nothing of the reference package). One measurement
substrate for the whole serving stack, three pieces and one facade:

* :class:`MetricsRegistry` — counters (declare-if-absent, exposed to the
  engine as the :class:`CounterView` mapping that ``Engine.stats`` is),
  gauges (values or callables, sampled at export), and fixed-bucket
  :class:`Histogram`\\ s whose :class:`HistSnapshot`\\ s merge
  associatively — per-rank snapshots combine in any order and
  nearest-rank quantiles are read off the merged bucket counts. Exports
  Prometheus text exposition.
* :class:`SpanTracer` — a bounded ring buffer (``deque(maxlen=…)``) of
  host-side events: submit/admit/prefill/preempt/spill/resume/draft-
  verify round/token emission/host death/revive. Timestamps are
  ``time.monotonic()`` taken on the host around launches — the tracer
  never reads a device tensor, never synchronises the device and never
  draws from a generator, so streams, logits and the engine's generator
  state are bit-identical with tracing on or off. Exports Chrome
  trace-event JSON (the ``traceEvents`` array format) loadable in
  Perfetto / ``chrome://tracing``.
* Per-path gauges: rolling tok/s per execution path
  (dense/masked/bsr/kernel/packed/int8/draft) and the spec-decode
  acceptance EMA.

Every hook is gated so a disabled tracer costs one attribute check. The
module is pure host Python (no torch): its Prometheus lines and Chrome
event keys are the reference's, byte for byte, on the same inputs.
"""
from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from collections import deque
from collections.abc import MutableMapping
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

# ---------------------------------------------------------------------------
# declared counter keys
# ---------------------------------------------------------------------------

# Every string key incremented/assigned through a ``stats[...]``
# subscript in the serving stack appears here: the registry's
# declaration table (an undeclared key is metric drift — a counter
# nothing exports, or a typo silently splitting a metric).
DECLARED_STATS = frozenset({
    # engine lifecycle
    "decode_steps", "admitted", "continuous_refills",
    "prefill_tokens", "prefill_tokens_skipped", "reprefill_tokens",
    "generated_tokens",
    # preemption / failure containment
    "preemptions", "resumes", "failed", "requeued", "cancelled",
    "deaths",
    # speculative decoding
    "spec_rounds", "spec_draft_tokens", "spec_accepted_tokens",
    "spec_fallbacks",
    # non-counter side objects surfaced through the same mapping
    "memory",
})

# execution-path labels for the rolling tok/s gauges
PATH_LABELS = ("dense", "masked", "bsr", "kernel", "packed", "int8",
               "draft")


# ---------------------------------------------------------------------------
# nearest-rank quantiles (shared by benches, launch CLI, histograms)
# ---------------------------------------------------------------------------

def nearest_rank(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank quantile of an ASCENDING-sorted sequence: the value
    at index ``min(n-1, int(n*q))`` (clamped)."""
    n = len(sorted_vals)
    if n == 0:
        raise ValueError("nearest_rank of an empty sequence")
    return sorted_vals[min(n - 1, int(n * q))]


def pcts_ms(lats: Sequence[float]) -> Tuple[float, float]:
    """(p50, p95) in milliseconds from ASCENDING-sorted latencies in
    seconds (nearest-rank, clamped)."""
    return (nearest_rank(lats, 0.5) * 1e3,
            nearest_rank(lats, 0.95) * 1e3)


# ---------------------------------------------------------------------------
# fixed-bucket histograms with mergeable snapshots
# ---------------------------------------------------------------------------

# default TTFT bucket bounds (seconds): log-spaced from 1 ms to 30 s,
# the +inf overflow bucket is implicit
TTFT_BOUNDS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


@dataclass(frozen=True)
class HistSnapshot:
    """Immutable histogram state: per-bucket counts (the last slot is
    the +inf overflow bucket) plus count/sum/min/max. ``merge`` is an
    element-wise add, hence associative AND commutative — per-rank (or
    per-host) snapshots combine in any order to the same result, which
    is what lets scheduler/frontend stats aggregate without a total
    order on when each shard was sampled."""
    bounds: Tuple[float, ...]
    counts: Tuple[int, ...]          # len(bounds) + 1
    count: int
    total: float
    vmin: float                       # +inf when empty
    vmax: float                       # -inf when empty

    @staticmethod
    def empty(bounds: Tuple[float, ...]) -> "HistSnapshot":
        return HistSnapshot(bounds, (0,) * (len(bounds) + 1), 0, 0.0,
                            float("inf"), float("-inf"))

    def merge(self, other: "HistSnapshot") -> "HistSnapshot":
        if self.bounds != other.bounds:
            raise ValueError(
                f"merging histograms with different bucket bounds: "
                f"{self.bounds} vs {other.bounds}")
        return HistSnapshot(
            self.bounds,
            tuple(a + b for a, b in zip(self.counts, other.counts)),
            self.count + other.count, self.total + other.total,
            min(self.vmin, other.vmin), max(self.vmax, other.vmax))

    def quantile(self, q: float) -> Optional[float]:
        """Nearest-rank quantile resolved to a bucket bound: the upper
        bound of the bucket holding rank ``min(n-1, int(n*q))`` (the
        same clamped rank as :func:`nearest_rank`), with the overflow
        bucket answering ``vmax`` (the only exact value it knows).
        None when empty."""
        if self.count == 0:
            return None
        rank = min(self.count - 1, int(self.count * q))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if rank < seen:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.vmax)
        return self.vmax                                # unreachable

    def as_dict(self) -> Dict:
        return {"count": self.count, "total": self.total,
                "min": None if self.count == 0 else self.vmin,
                "max": None if self.count == 0 else self.vmax,
                "p50": self.quantile(0.5), "p95": self.quantile(0.95)}


class Histogram:
    """Fixed-bucket histogram. ``observe`` is a bisect + two adds —
    cheap enough for per-request paths; snapshots are taken under the
    registry lock so a concurrent observe never tears one."""

    def __init__(self, bounds: Sequence[float] = TTFT_BOUNDS_S):
        b = tuple(float(x) for x in bounds)
        if list(b) != sorted(set(b)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing, got {bounds}")
        self.bounds = b
        self._counts = [0] * (len(b) + 1)
        self._count = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        self._counts[bisect_left(self.bounds, v)] += 1
        self._count += 1
        self._total += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def snapshot(self) -> HistSnapshot:
        return HistSnapshot(self.bounds, tuple(self._counts),
                            self._count, self._total, self._min,
                            self._max)


# ---------------------------------------------------------------------------
# rolling rates + EMA (the autotuner-facing gauges)
# ---------------------------------------------------------------------------

class RollingRate:
    """Windowed events/sec: a deque of (monotonic t, n) pairs trimmed
    to the window on read. ``add`` is an append; ``per_s`` divides the
    surviving event mass by the window."""

    def __init__(self, window_s: float = 5.0):
        self.window_s = float(window_s)
        self._events: deque = deque()

    def add(self, n: int, t: Optional[float] = None) -> None:
        if n:
            self._events.append((time.monotonic() if t is None else t,
                                 n))

    def per_s(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        horizon = now - self.window_s
        ev = self._events
        while ev and ev[0][0] < horizon:
            ev.popleft()
        return sum(n for _, n in ev) / self.window_s


class Ema:
    """Exponential moving average; ``value`` is None until the first
    update (so a never-speculating engine reports no acceptance rather
    than a fake 0)."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = float(alpha)
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.alpha * x
                      + (1.0 - self.alpha) * self.value)
        return self.value


# ---------------------------------------------------------------------------
# counters: the backward-compatible Engine.stats view
# ---------------------------------------------------------------------------

class CounterView(MutableMapping):
    """A registry-backed mapping with the exact surface the ad-hoc
    ``Engine.stats`` dict used to have: ``stats["k"] += 1``,
    ``stats.update(...)``, ``dict(stats, extra=...)``, int values, plus
    the one non-int entry (``stats["memory"]``) routed to an object
    side-store so Prometheus export only sees scalars.

    ``declare`` is declare-IF-ABSENT: re-declaring (a revived rank
    rebuilding its engine against the same scoped view) never zeroes
    counters that survived the outage — ``ShardedScheduler.revive_rank``
    depends on that continuity."""

    def __init__(self, labels: Tuple[Tuple[str, str], ...] = ()):
        self.labels = labels
        self._ints: Dict[str, int] = {}
        self._objs: Dict[str, object] = {}

    def declare(self, keys: Iterable[str]) -> "CounterView":
        for k in keys:
            self._ints.setdefault(k, 0)
        return self

    def __getitem__(self, k):
        if k in self._objs:
            return self._objs[k]
        return self._ints[k]

    def __setitem__(self, k, v):
        if isinstance(v, int) and not isinstance(v, bool):
            self._objs.pop(k, None)
            self._ints[k] = v
        else:
            self._ints.pop(k, None)
            self._objs[k] = v

    def __delitem__(self, k):
        if k in self._objs:
            del self._objs[k]
        else:
            del self._ints[k]

    def __iter__(self):
        yield from self._ints
        yield from self._objs

    def __len__(self):
        return len(self._ints) + len(self._objs)

    def __repr__(self):
        return f"CounterView({dict(self)!r})"

    def int_items(self) -> List[Tuple[str, int]]:
        return list(self._ints.items())


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------

def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _labels_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Unified registry: counter scopes, gauges, histograms, and
    export-time collectors; renders Prometheus text exposition. The
    lock guards STRUCTURE (creating scopes/series at declare time and
    snapshotting at export time) — per-event increments on an existing
    CounterView/Histogram are plain dict/list ops under the GIL, which
    keeps the hot path at dictionary-increment cost."""

    def __init__(self):
        self._lock = threading.Lock()
        self._scopes: Dict[Tuple, CounterView] = {}
        self._gauges: Dict[Tuple[str, Tuple], object] = {}
        self._hists: Dict[Tuple[str, Tuple], Histogram] = {}
        self._collectors: Dict[object,
                               Callable[[], Dict[str, float]]] = {}

    # -- counters ------------------------------------------------------
    def counter_scope(self, **labels) -> CounterView:
        """The CounterView for this label set, created on first use and
        RETURNED AGAIN on every later call — a revived rank's rebuilt
        engine re-acquires the same live counters its predecessor
        incremented."""
        key = _labels_key(labels)
        with self._lock:
            if key not in self._scopes:
                self._scopes[key] = CounterView(key)
            return self._scopes[key]

    # -- gauges --------------------------------------------------------
    def gauge(self, name: str, fn_or_value, **labels) -> None:
        """Register a gauge: a number, or a zero-arg callable sampled at
        export time (rolling rates / EMAs export through callables so
        the value is always current)."""
        with self._lock:
            self._gauges[(name, _labels_key(labels))] = fn_or_value

    # -- histograms ----------------------------------------------------
    def histogram(self, name: str,
                  bounds: Sequence[float] = TTFT_BOUNDS_S,
                  **labels) -> Histogram:
        key = (name, _labels_key(labels))
        with self._lock:
            if key not in self._hists:
                self._hists[key] = Histogram(bounds)
            return self._hists[key]

    def histogram_snapshots(self, name: str
                            ) -> Dict[Tuple[Tuple[str, str], ...],
                                      HistSnapshot]:
        with self._lock:
            return {lk: h.snapshot() for (n, lk), h in
                    self._hists.items() if n == name}

    # -- collectors ----------------------------------------------------
    def register_collector(self, fn: Callable[[], Dict[str, float]],
                           key: Optional[object] = None) -> None:
        """``fn() -> {prometheus_line_head: value}`` merged at export —
        the pool/scheduler/frontend attribute counters export through
        these without giving up their lock-checked attributes. A
        ``key`` makes registration idempotent: re-registering (a
        revived rank rebuilding its engine) REPLACES the predecessor's
        collector instead of exporting a dead object forever."""
        with self._lock:
            self._collectors[key if key is not None else object()] = fn

    # -- export --------------------------------------------------------
    def prometheus(self) -> str:
        """Prometheus text exposition of everything registered. Counter
        keys render as ``serve_<key>_total``; gauges and collector
        entries render under their registered names; histograms emit
        the standard ``_bucket``/``_sum``/``_count`` triplet."""
        with self._lock:
            scopes = list(self._scopes.items())
            gauges = list(self._gauges.items())
            hists = [(k, h.snapshot()) for k, h in self._hists.items()]
            collectors = list(self._collectors.values())
        out: List[str] = []
        seen_types = set()

        def head(name: str, kind: str) -> None:
            if name not in seen_types:
                seen_types.add(name)
                out.append(f"# TYPE {name} {kind}")

        for _key, view in scopes:
            for k, v in sorted(view.int_items()):
                name = f"serve_{k}_total"
                head(name, "counter")
                out.append(f"{name}{_fmt_labels(view.labels)} {v}")
        for (name, lk), fv in sorted(gauges):
            v = fv() if callable(fv) else fv
            if v is None:
                continue
            head(name, "gauge")
            out.append(f"{name}{_fmt_labels(lk)} {v}")
        for (name, lk), snap in sorted(hists, key=lambda kv: kv[0]):
            head(name, "histogram")
            cum = 0
            for b, c in zip(snap.bounds, snap.counts):
                cum += c
                out.append(f'{name}_bucket{_fmt_labels(lk + (("le", repr(b)),))} {cum}')
            out.append(f'{name}_bucket{_fmt_labels(lk + (("le", "+Inf"),))} {snap.count}')
            out.append(f"{name}_sum{_fmt_labels(lk)} {snap.total}")
            out.append(f"{name}_count{_fmt_labels(lk)} {snap.count}")
        for fn in collectors:
            for line_head, v in sorted(fn().items()):
                out.append(f"{line_head} {v}")
        return "\n".join(out) + "\n"

    def summary(self) -> Dict[str, object]:
        """Small plain-dict view for periodic console dumps
        (``--metrics-interval``): aggregated counters + sampled
        gauges."""
        with self._lock:
            scopes = list(self._scopes.values())
            gauges = list(self._gauges.items())
        counters: Dict[str, int] = {}
        for view in scopes:
            for k, v in view.int_items():
                counters[k] = counters.get(k, 0) + v
        sampled = {}
        for (name, lk), fv in gauges:
            v = fv() if callable(fv) else fv
            if v is not None:
                sampled[name + _fmt_labels(lk)] = v
        return {"counters": counters, "gauges": sampled}


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

class SpanTracer:
    """Bounded ring buffer of host-side trace events. Disabled (the
    default) every hook returns after ONE attribute check, and ``t0``
    skips the clock read entirely — the hot path stays free. Enabled,
    an event is a clock read + a tuple append into a ``deque(maxlen)``
    (the bound: memory can never grow past ``capacity`` events however
    long the server runs — oldest events fall off).

    Events carry monotonic timestamps only; nothing here reads a device
    value or forces a sync. Export is Chrome trace-event JSON
    (``ph="X"`` complete spans, ``ph="i"`` instants with global scope)
    — load the file in Perfetto (ui.perfetto.dev) or
    ``chrome://tracing``. pid = host, tid = rank, so a cluster run lays
    out as one row per rank grouped by host."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self.buf: deque = deque(maxlen=self.capacity)
        self.dropped = 0                 # events pushed out of the ring

    # -- hot-path hooks ------------------------------------------------
    def t0(self) -> float:
        """Span start stamp; 0.0 (never read) when disabled."""
        return time.monotonic() if self.enabled else 0.0

    def instant(self, name: str, *, pid: int = 0, tid: int = 0,
                cat: str = "serve", **args) -> None:
        if not self.enabled:
            return
        if len(self.buf) == self.capacity:
            self.dropped += 1
        self.buf.append(("i", name, cat, time.monotonic(), 0.0, pid,
                         tid, args))

    def complete(self, name: str, t0: float, *, pid: int = 0,
                 tid: int = 0, cat: str = "serve", **args) -> None:
        """A ``ph="X"`` span from ``t0`` (a :meth:`t0` stamp) to now."""
        if not self.enabled:
            return
        if len(self.buf) == self.capacity:
            self.dropped += 1
        self.buf.append(("X", name, cat, t0, time.monotonic() - t0,
                         pid, tid, args))

    # -- export --------------------------------------------------------
    def __len__(self) -> int:
        return len(self.buf)

    def events(self) -> List[Dict]:
        """Chrome trace-event dicts (timestamps/durations in µs)."""
        out = []
        for ph, name, cat, ts, dur, pid, tid, args in list(self.buf):
            ev = {"name": name, "ph": ph, "cat": cat,
                  "ts": ts * 1e6, "pid": pid, "tid": tid,
                  "args": dict(args)}
            if ph == "X":
                ev["dur"] = dur * 1e6
            else:
                ev["s"] = "g"            # instants: global scope
            out.append(ev)
        return out

    def chrome(self) -> Dict:
        return {"traceEvents": self.events(),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> int:
        """Write the Chrome trace JSON; returns the event count."""
        trace = self.chrome()
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])


# ---------------------------------------------------------------------------
# facade
# ---------------------------------------------------------------------------

class Telemetry:
    """One measurement context shared down a serving stack: the
    frontend, its hosts' schedulers, their rank engines, and each
    engine's page pool all hold the SAME Telemetry, so counters land in
    one registry and spans in one ring buffer. An Engine built without
    one creates a private default (tracing off) — solo engines stay
    zero-config."""

    def __init__(self, *, trace: bool = False,
                 trace_capacity: int = 65536,
                 rate_window_s: float = 5.0, ema_alpha: float = 0.2):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(capacity=trace_capacity,
                                 enabled=trace)
        self._rates: Dict[str, RollingRate] = {}
        self._rate_window_s = float(rate_window_s)
        self.accept_ema = Ema(alpha=ema_alpha)
        self.registry.gauge("serve_spec_accept_ema",
                            lambda: self.accept_ema.value)

    # -- engine counters -----------------------------------------------
    def engine_stats(self, rank: int = 0) -> CounterView:
        return self.registry.counter_scope(rank=rank)

    # -- per-path throughput gauges ------------------------------------
    def note_tokens(self, path: str, n: int) -> None:
        """Credit ``n`` freshly emitted tokens to an execution path —
        the rolling per-path tok/s gauges."""
        r = self._rates.get(path)
        if r is None:
            r = self._rates[path] = RollingRate(self._rate_window_s)
            self.registry.gauge("serve_path_tok_s",
                                (lambda rr=r: rr.per_s()), path=path)
        r.add(n)

    def tok_s(self, path: str) -> float:
        r = self._rates.get(path)
        return 0.0 if r is None else r.per_s()

    # -- speculative acceptance ----------------------------------------
    def note_spec_round(self, accepted: int, drafted: int) -> None:
        if drafted > 0:
            self.accept_ema.update(accepted / drafted)

    # -- TTFT ----------------------------------------------------------
    def observe_ttft(self, slo: str, seconds: float) -> None:
        self.registry.histogram("serve_ttft_seconds",
                                TTFT_BOUNDS_S, slo=slo) \
            .observe(seconds)

    def ttft_stats(self) -> Dict[str, Dict]:
        """{slo_class: {count, p50_ms, p95_ms}} from the merged TTFT
        histogram snapshots (merge order irrelevant — associative)."""
        return merged_ttft_stats([self])

    # -- convenience ---------------------------------------------------
    def prometheus(self) -> str:
        return self.registry.prometheus()

    def write_trace(self, path: str) -> int:
        return self.tracer.write(path)


def merged_ttft_stats(telemetries: Iterable["Telemetry"]
                      ) -> Dict[str, Dict]:
    """Merge TTFT histograms across any number of Telemetry instances
    (per-host registries in the cluster frontend) into
    ``{slo: {count, p50_ms, p95_ms}}``. Snapshot merge is associative
    and commutative, so host/visit order cannot change the answer."""
    by_slo: Dict[str, HistSnapshot] = {}
    for tel in telemetries:
        snaps = tel.registry.histogram_snapshots("serve_ttft_seconds")
        for lk, snap in snaps.items():
            slo = dict(lk).get("slo", "unknown")
            prev = by_slo.get(slo)
            by_slo[slo] = snap if prev is None else prev.merge(snap)
    out: Dict[str, Dict] = {}
    for slo, snap in by_slo.items():
        p50, p95 = snap.quantile(0.5), snap.quantile(0.95)
        out[slo] = {"count": snap.count,
                    "p50_ms": None if p50 is None else p50 * 1e3,
                    "p95_ms": None if p95 is None else p95 * 1e3}
    return out
