"""Sharded request scheduler of the port (``repro.serve.scheduler``):
continuous batching and QoS over per-rank :class:`Engine` shards.

* **Admission control** — a bounded front queue: ``submit`` rejects
  (returns False) once the waiting backlog exceeds ``max_queue`` beyond
  the free capacity (free slots, capped by page-pool headroom on paged
  engines), so overload sheds new traffic instead of growing tail
  latency without bound. Within a rank's queue the policy orders
  requests: FCFS (arrival order), SJF (shortest remaining work first —
  prompt + decode budget) or EDF (earliest effective deadline first).
* **SLO classes and aging** — each request carries an SLO class
  (``interactive`` / ``batch``) and a latency target; ``submit`` stamps
  the absolute deadline (the request's ``deadline`` or the class default
  of ``slo_latency``). Under ``policy="edf"`` queues order by the
  effective deadline ``t_deadline - aging * wait``; ``aging > 0`` drifts
  a waiting request's key earlier, so neither EDF nor SJF (the same
  credit in tokens) starves a long request forever.
* **Preemption** — with ``preempt=True``, a rank whose slots are all busy
  and whose best waiting request is interactive with an earlier
  effective deadline than the worst running batch request preempts that
  victim at step granularity (``Engine.preempt_slot``: KV kept, or
  re-prefill resume); its greedy stream continues exactly.
  ``max_preemptions`` bounds thrash.
* **Per-rank engine shards** — one :class:`Engine` per rank, each with
  its own slots (and page pool), all on one device and all over the
  SAME params tensors (built once by the caller; no rank copies them).
  Ranks step independently. On a mesh (``mesh=``), one rank per DP rank
  of the mesh (``distribution.sharding.dp_submeshes``; ``profile``
  "tp": the 'data' axis, each rank a TP group; "dp_only": every process
  a rank), each the engine of its own processes: see "Ranks on a mesh"
  below.
* **Failure containment** — a rank whose step raises a Python exception
  is marked dead: its queued requests re-route to live ranks, its
  in-flight requests requeue there with an exact re-prefill resume
  (``requeue_inflight``, bounded by ``max_requeues``) or fail with the
  error attached. A CUDA fault is contained only across processes: an
  illegal address or device assert poisons the CUDA context of every
  rank (and every in-process host) in the process, which is why the
  frontend's :class:`~repro_torch.serve.frontend.SubprocessHost` exists.
  ``revive_rank`` rebuilds a dead shard and re-admits it to routing.
* **Shedding** — ``shed="deadline"`` evicts the waiting request least
  likely to meet its deadline (batch before interactive) on overflow
  instead of rejecting the newcomer.
* **Continuous batching** — each engine refills slots freed by EOS or
  budget from its queue mid-decode; ``drain=True`` switches every shard
  to the drain-batch baseline.
* **Streaming** — ``run(..., on_token=fn)`` calls ``fn(request, token)``
  as each token is sampled on any rank; ``stream(requests)`` yields
  ``(rid, token)``. Per-rank bucket tables (``buckets=``) bound the
  number of distinct prefill shapes under random traffic.

Routing is latency-aware least-outstanding-work: batch requests go to the
rank with the fewest pending tokens; interactive requests key on pending
interactive tokens first, total load as tie-break, ties to the lowest
rank; a paged rank whose headroom cannot cover the request's prefill
(mid-spill) loses to any rank with headroom.

The contract is the engine's: slots are isolated, so every request's
greedy stream equals running it alone through ``Engine(batch_slots=1)``
whichever rank or slot served it, whatever it shared a batch with, and
across preemption and requeue. Logits are not held bit for bit across
different row counts: ``torch.matmul`` orders an M-row product by M.

``submit`` / ``step`` / ``stats`` / ``cancel`` run under one reentrant
lock, so the frontend's heartbeat and reader threads may call them; every
device op stays inside ``Engine.step`` / ``preempt_slot`` on the engine's
own stream, and nothing here reads a device value.

Ranks on a mesh: every process runs this same scheduler over the same
global view, so every process makes the same decisions — routing, queue
order, preemption, shedding, arrivals — and the collectives of the
engines never part. The view of another DP rank's engine is a
:class:`PeerShard`: its queue, slots, positions, counters and pool
headroom, moved by the bookkeeping the engine itself runs (submit,
preempt, evacuate, cancel) and, after each step, overwritten by what
that rank's engine did. ``step`` (1) reads the clock once, world rank
0's value broadcast (``Mesh.world_value``; ``submit`` and the arrival
loop read it the same way); (2) sorts and preempts on every live rank
and steps this process's own engine, a raise caught and kept; (3)
all-gathers over 'data' one record a rank: the tokens it emitted in
order, the requests it finished, its queue, slots and positions, the
state of every request it holds, its counters and pool headroom, and
the raise's type and message; (4) applies every other rank's record to
its peer and replays every rank's tokens to the sink in rank order;
(5) contains each rank that raised, in rank order, as one rank does
(``_on_rank_failure``: every process marks it dead and requeues the same
requests). One difference of timing from the meshless loop: ranks step
at once, so requests requeued off a dead rank join a lower rank's queue
in the next step, where the meshless loop lets a later rank admit them
in the same one. A process that dies outright (a signal) ends the run
through ``launch.mesh.run_ranks``' lost-rank check. The frontend's hosts
do not run on a mesh.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, \
    Tuple

import numpy as np
import torch

from repro_torch.serve.engine import (_STAT_KEYS, Engine, Request,
                                      _exec_path_label)
from repro_torch.serve.memory import MemoryStats
from repro_torch.serve.telemetry import Telemetry

POLICIES = ("fcfs", "sjf", "edf")
PREEMPT_MODES = ("kv", "reprefill")
SHED_POLICIES = ("count", "deadline")
# default per-class latency targets (seconds) when a request carries no
# explicit deadline
DEFAULT_SLO_LATENCY = {"interactive": 0.5, "batch": 30.0}


@dataclass
class SchedulerConfig:
    slots_per_rank: int = 4
    cache_len: int = 512
    # reject once this many requests wait beyond free slot capacity
    # (None = unbounded admission)
    max_queue: Optional[int] = None
    policy: str = "fcfs"              # "fcfs" | "sjf" | "edf"
    drain: bool = False               # drain-batch baseline (ablation)
    rng_seed: int = 0
    # --- QoS ----------------------------------------------------------
    # anti-starvation credit per second waited, in the policy's native
    # unit (seconds of deadline for edf, tokens of cost for sjf);
    # 0 = pure EDF/SJF
    aging: float = 0.0
    # per-class default latency targets; None = DEFAULT_SLO_LATENCY
    slo_latency: Optional[Dict[str, float]] = None
    preempt: bool = False             # interactive may evict batch
    preempt_mode: str = "kv"          # "kv" snapshot | "reprefill"
    max_preemptions: int = 4          # per-request preemption cap
    preempt_margin: float = 0.0       # required deadline gap (seconds)
    # prefill shape bucketing: an int builds the geometric table per
    # rank (launch.serve.rank_bucket_tables); a sequence is an explicit
    # table of lengths; None = exact shapes
    buckets: Optional[object] = None
    # overload shedding once max_queue overflows: "count" rejects the
    # newcomer; "deadline" sheds the waiting request
    # LEAST likely to meet its deadline — batch class before
    # interactive, then smallest slack per unit of remaining work — so
    # interactive SLO attainment holds under overload
    shed: str = "count"
    # --- failure recovery ---------------------------------------------
    # a dead rank's IN-FLIGHT requests requeue to live ranks with their
    # emitted-token snapshot armed for an exact re-prefill resume
    # (False = they fail terminally); max_requeues bounds how
    # often one request may survive a rank death before it fails for
    # real (a poison request that kills every rank it lands on must not
    # take the whole tier down with it)
    requeue_inflight: bool = True
    max_requeues: int = 2
    # --- paged KV -----------------------------------------------------
    # device pages per rank engine (None = contiguous per-slot rings);
    # page length in tokens (None = tile-aligned default); high-
    # watermark fraction of device pages that may stay resident; host-
    # RAM spill pool size in pages
    kv_pages: Optional[int] = None
    kv_page_len: Optional[int] = None
    kv_watermark: float = 1.0
    kv_host_pages: int = 0
    # --- prefix sharing -----------------------------------------------
    # refcounted prefix sharing over the paged pool: admission maps a
    # new prompt's full pages onto already-resident identical pages and
    # prefills only the suffix; min_pages gates how many whole pages
    # must match before sharing is worth the bookkeeping
    kv_share: bool = False
    kv_share_min_pages: int = 1
    # --- speculative decoding -----------------------------------------
    # self-speculation over the sparsity ladder: each rank engine packs
    # a drafter from the SAME weights at draft_sparsity (optionally
    # int8) and runs draft-k/verify-1 rounds on greedy requests.
    # Speculation engages for batch-class SLOs only by default (the
    # draft round adds per-step latency variance interactive traffic
    # should not pay); draft_interactive opts interactive in too.
    draft_sparsity: Optional[float] = None
    draft_k: int = 4
    draft_int8: bool = False
    draft_interactive: bool = False
    # periodic cross-request dedup sweep (0 = off; needs kv_share)
    kv_dedup_every: int = 0


class RankStepError(RuntimeError):
    """A DP rank's step raised, as every process of a mesh sees it: the
    message is the type and message of what the rank raised."""


class PeerShard:
    """Another DP rank's engine as this process sees it: the host state
    the scheduler reads (queue, slots, positions, counters, pool
    headroom), no device state. Submit, preempt, evacuate, fail and
    cancel run the engine's own bookkeeping on it; :meth:`apply` then
    sets it to what the rank's engine did in a step."""

    # the engine's host bookkeeping, over this view's queue and slots
    submit = Engine.submit
    _free_slots = Engine._free_slots
    slot_states = Engine.slot_states
    outstanding_tokens = Engine.outstanding_tokens
    n_free = Engine.n_free
    has_work = Engine.has_work
    _release_slot = Engine._release_slot
    evacuate_inflight = Engine.evacuate_inflight
    fail_inflight = Engine.fail_inflight
    cancel = Engine.cancel

    def __init__(self, rank: int, batch_slots: int, telemetry: Telemetry,
                 path_label: str):
        self.rank = rank
        self.B = batch_slots
        self.dead = False
        self.pool = None
        self.telemetry = telemetry
        self._trace = telemetry.tracer
        self.stats = telemetry.engine_stats(rank).declare(_STAT_KEYS)
        self.path_label = path_label
        self.queue: List[Request] = []
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.pos = np.zeros((batch_slots,), np.int32)
        self._finished_at_admission: List[Request] = []
        self.on_token = None
        self._memory: Optional[dict] = None
        self._headroom: Optional[int] = None
        self._admissible: Optional[int] = None

    def preempt_slot(self, slot: int, *, keep_kv: bool = True) -> Request:
        """``Engine.preempt_slot``'s bookkeeping (the rank's own engine
        keeps the KV)."""
        req = self.slot_req[slot]
        req._resume_pos = int(self.pos[slot])
        req.preemptions += 1
        req.status = "queued"
        self.slot_req[slot] = None
        self.stats["preemptions"] += 1
        return req

    def admission_capacity(self) -> int:
        free = self.n_free()
        return free if self._admissible is None \
            else min(free, self._admissible)

    def route_headroom_tokens(self) -> Optional[int]:
        return self._headroom

    def memory_stats(self) -> Optional[MemoryStats]:
        if self._memory is None:
            return None
        return MemoryStats(**{f.name: self._memory[f.name]
                              for f in dataclasses.fields(MemoryStats)})

    def apply(self, rec: dict, by_rid: Dict[int, Request]):
        """Set this view to the rank's ``step_record``: the emitted
        tokens appended, every request it holds as the rank left it (a
        first token's TTFT observed), its queue, slots, positions,
        counters and pool headroom."""
        for rid, tok in rec["emitted"]:
            by_rid[rid].out_tokens.append(tok)
        for rid, status, done, resume, pre, t_first, t_done, error in \
                rec["requests"]:
            req = by_rid[rid]
            if req.t_first is None and t_first is not None \
                    and req.t_submit is not None:
                self.telemetry.observe_ttft(req.slo, t_first - req.t_submit)
            req.status, req.done, req._resume_pos = status, done, resume
            req.preemptions, req.error = pre, error
            req.t_first, req.t_done = t_first, t_done
        self.queue = [by_rid[i] for i in rec["queue"]]
        self.slot_req = [None if i is None else by_rid[i]
                         for i in rec["slots"]]
        self.pos = np.asarray(rec["pos"], np.int32)
        self._finished_at_admission = [by_rid[i] for i in rec["fin_adm"]]
        n = rec["stats"]["generated_tokens"] - self.stats["generated_tokens"]
        if n > 0:
            self.telemetry.note_tokens(self.path_label, n)
        for k, v in rec["stats"].items():
            self.stats[k] = v
        self._memory = rec["memory"]
        self._headroom = rec["headroom"]
        self._admissible = rec["admissible"]


def step_record(eng: Engine, emitted: List[Tuple[int, int]],
                finished: List[Request], err: Optional[BaseException]
                ) -> dict:
    """What a DP rank's engine did in a step, as its peers apply it
    (:meth:`PeerShard.apply`): JSON values only."""
    held = (list(eng.queue) + [r for r in eng.slot_req if r is not None]
            + list(finished) + list(eng._finished_at_admission))
    mem = eng.memory_stats()
    return dict(
        raised=None if err is None else f"{type(err).__name__}: {err}",
        emitted=emitted, finished=[r.rid for r in finished],
        fin_adm=[r.rid for r in eng._finished_at_admission],
        queue=[r.rid for r in eng.queue],
        slots=[None if r is None else r.rid for r in eng.slot_req],
        pos=[int(p) for p in eng.pos],
        requests=[[r.rid, r.status, r.done, r._resume_pos, r.preemptions,
                   r.t_first, r.t_done, r.error] for r in held],
        stats=dict(eng.stats),
        memory=None if mem is None else mem.as_dict(),
        headroom=eng.route_headroom_tokens(),
        admissible=(None if eng.pool is None
                    else eng.pool.admissible_requests()))


class ShardedScheduler:
    """Admission-controlled request queue over per-rank engine shards.

    ``ranks``: the number of engine shards when meshless, all on the
    device of ``params`` and all over the same params tensors. ``mesh``
    (``distribution.context.Mesh``, this process's place): one rank per
    DP rank of the mesh under ``profile`` ("tp" or "dp_only"), this
    process's own an engine on its TP group over ``params`` (its local
    tree), the others :class:`PeerShard` views; ``ranks``, if given, must
    equal the DP size. ``draft``: a prebuilt drafter (its tree and
    config, a mesh rank's local ones) for every engine, where
    ``sched.draft_sparsity`` would otherwise have each engine build its
    own from ``params``' dense masters (on a mesh, a MoE's drafter with
    every expert, as its target: ``launch.serve.build_rank_params``).
    A rank's page pool stays whole on its submesh: 'data' collapses to
    1 there, and the reference's rule cuts nothing
    (``distribution.sharding.pool_axes``).
    """

    def __init__(self, params, cfg, *, sched: Optional[SchedulerConfig]
                 = None, mesh=None, ranks: Optional[int] = None,
                 profile: str = "tp",
                 telemetry: Optional[Telemetry] = None, draft=None):
        # one registry/tracer per scheduler: rank engines share it (the
        # rank label disambiguates), but two schedulers (= two hosts in
        # the cluster frontend) never share counter scopes
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry()
        self.sched = sched or SchedulerConfig()
        for name, val, allowed in (
                ("policy", self.sched.policy, POLICIES),
                ("preempt_mode", self.sched.preempt_mode, PREEMPT_MODES),
                ("shed", self.sched.shed, SHED_POLICIES)):
            if val not in allowed:
                raise ValueError(f"{name}={val!r} not in {allowed}")
        # on a mesh: the grid of DP ranks, this process's rank, its
        # engine's mesh, every submitted request by rid, and the tokens
        # its engine emits in a step
        self._dp = None
        if mesh is not None:
            from repro_torch.distribution.sharding import (dp_mesh,
                                                           dp_submeshes)
            n = len(dp_submeshes(mesh, profile))
            if ranks is not None and ranks != n:
                raise ValueError(
                    f"ranks={ranks} conflicts with the mesh's {n} DP "
                    f"rank(s) — under a mesh the DP axis decides; omit "
                    f"ranks")
            self._dp = dp_mesh(mesh, profile)
            self._me = self._dp.data_rank
            self._engine_mesh = (self._dp.submesh()
                                 if self._dp.shape["model"] > 1 else None)
            self._by_rid: Dict[int, Request] = {}
            self._emitted: List[Tuple[int, int]] = []
        else:
            n = 1 if ranks is None else int(ranks)
            if n < 1:
                raise ValueError(f"ranks={ranks} must be >= 1")
        self.bucket_tables = self._resolve_buckets(n)
        # kept for engine-raise recovery (revive_rank rebuilds a shard)
        self._params = params
        self._cfg = cfg
        self._draft = draft
        self._sink: Optional[Callable[[Request, int], None]] = None
        self.shards = [self._build_engine(r) for r in range(n)]
        # guards the shared mutable state below (counters, terminal
        # lists, histogram) against the cluster frontend's threads —
        # heartbeat/reader threads call submit/step/stats concurrently.
        # Reentrant: step() -> _on_rank_failure() -> submit() re-enters.
        self._lock = threading.RLock()
        self.rejected: List[Request] = []
        self.failed: List[Request] = []
        self.n_submitted = 0
        self.n_accepted = 0
        self.n_shed = 0                 # victims evicted by shed policy
        self.n_revived = 0
        self.n_requeued = 0             # in-flight survivors of a rank death
        # observed prompt-length histogram (what a bucket table is
        # fitted to)
        self.prompt_hist: Counter = Counter()

    def _build_engine(self, r: int) -> Engine:
        s = self.sched
        if self._dp is not None and r != self._me:
            return PeerShard(r, s.slots_per_rank, self.telemetry,
                             _exec_path_label(self._params, self._cfg))
        eng = Engine(self._params, self._cfg,
                     batch_slots=s.slots_per_rank,
                     cache_len=s.cache_len, rng_seed=s.rng_seed + r,
                     admission="drain" if s.drain else "continuous",
                     rank=r, buckets=self.bucket_tables[r],
                     kv_pages=s.kv_pages, kv_page_len=s.kv_page_len,
                     kv_watermark=s.kv_watermark,
                     kv_host_pages=s.kv_host_pages,
                     kv_share=s.kv_share,
                     kv_share_min_pages=s.kv_share_min_pages,
                     draft_sparsity=s.draft_sparsity,
                     draft_k=s.draft_k, draft_int8=s.draft_int8,
                     draft_interactive=s.draft_interactive,
                     kv_dedup_every=s.kv_dedup_every,
                     telemetry=self.telemetry,
                     mesh=None if self._dp is None else self._engine_mesh,
                     draft=self._draft)
        if self._dp is None:
            eng.on_token = self._sink
        else:                           # replayed in rank order by step
            eng.on_token = lambda req, tok: self._emitted.append(
                (req.rid, int(tok)))
        return eng

    def revive_rank(self, rank: int) -> Engine:
        """Engine-raise recovery: rebuild a dead rank's engine shard —
        fresh caches / page pool over the same params — and re-admit it
        to the routing set. In-flight requests the dead shard failed
        stay failed (already resolved) — the frontend replays the
        retryable ones; new
        traffic routes to the revived shard immediately. The revived
        engine inherits the dead one's cumulative serving counters
        (plus a bumped ``deaths`` count), so per-rank stats stay
        continuous across the outage instead of resetting to zero."""
        with self._lock:
            old = self.shards[rank]
            if not old.dead:
                raise ValueError(f"rank {rank} is alive — refusing to "
                                 f"rebuild a serving engine shard")
            assert not old.queue, "dead rank still holds queued requests"
            eng = self._build_engine(rank)
            # stats continuity: cumulative counters (incl. the death
            # that took the shard down) carry over; the stale "memory"
            # snapshot does not (the new pool reports its own)
            eng.stats.update({k: v for k, v in old.stats.items()
                              if isinstance(v, int)})
            self.shards[rank] = eng
            self.n_revived += 1
            self.telemetry.tracer.instant("revive_rank", tid=rank)
            return self.shards[rank]

    def _resolve_buckets(self, ranks: int
                         ) -> Tuple[Optional[Tuple[int, ...]], ...]:
        b = self.sched.buckets
        if b is None:
            return (None,) * ranks
        if isinstance(b, int):
            from repro_torch.launch.serve import rank_bucket_tables
            return rank_bucket_tables(ranks, self.sched.cache_len,
                                      n_buckets=b)
        table = tuple(sorted(int(x) for x in b))
        return (table,) * ranks

    # ------------------------------------------------------------------
    @property
    def ranks(self) -> int:
        return len(self.shards)

    def _live(self) -> List[Engine]:
        return [e for e in self.shards if not e.dead]

    def queued(self) -> int:
        """Requests admitted but not yet occupying a slot."""
        return sum(len(e.queue) for e in self.shards)

    def has_work(self) -> bool:
        return any(e.has_work() for e in self._live())

    def outstanding_tokens(self, slo: Optional[str] = None) -> int:
        """Host-level load: total pending work across live ranks."""
        return sum(e.outstanding_tokens(slo) for e in self._live())

    def cancel(self, rid: int) -> Optional[Request]:
        """Remove a request from whichever rank holds it (queued or
        mid-decode), releasing its slot/pages. Status is left to the
        caller — the frontend's watchdog marks it failed, a drain
        hand-off requeues it elsewhere. None if no rank holds ``rid``."""
        with self._lock:
            for e in self.shards:
                req = e.cancel(rid)
                if req is not None:
                    return req
            return None

    def set_on_token(self, fn: Optional[Callable[[Request, int], None]]):
        """Install a streaming sink OUTSIDE run()/stream() — for callers
        (the cluster frontend) that drive step() directly. The sink
        survives rank revives."""
        self._set_sink(fn)

    # -- QoS priorities ------------------------------------------------
    def _now(self) -> float:
        """``time.monotonic()``; on a mesh world rank 0's, so that every
        process stamps, orders, ages and sheds alike."""
        t = time.monotonic()
        if self._dp is None:
            return t
        x = torch.tensor([t], dtype=torch.float64,
                         device=self._dp.host_device)
        return float(self._dp.world_value(x)[0])

    def _slo_target(self, req: Request) -> float:
        if req.deadline is not None:
            return req.deadline
        lat = self.sched.slo_latency or DEFAULT_SLO_LATENCY
        return lat.get(req.slo, DEFAULT_SLO_LATENCY["batch"])

    def _deadline_key(self, req: Request, now: float) -> float:
        """Effective deadline: absolute deadline minus aging credit for
        time already waited. Used by EDF ordering AND the preemption
        test (whatever the queue policy)."""
        sub = req.t_submit if req.t_submit is not None else now
        dl = req.t_deadline if req.t_deadline is not None \
            else sub + self._slo_target(req)
        return dl - self.sched.aging * max(0.0, now - sub)

    def _priority(self, req: Request, now: float) -> float:
        """Queue-ordering key (smaller = sooner) for the active policy."""
        p = self.sched.policy
        if p == "sjf":
            sub = req.t_submit if req.t_submit is not None else now
            return req.cost_estimate() \
                - self.sched.aging * max(0.0, now - sub)
        if p == "edf":
            return self._deadline_key(req, now)
        return req.t_submit if req.t_submit is not None else now

    def _route(self, req: Request) -> Engine:
        """Latency-aware least outstanding work (ties to lowest rank),
        steered by page-pool residency: a paged rank whose headroom
        below the spill watermark cannot cover this request's prefill
        is mid-spill (or one admission away from it) — admitting there
        buys a host-RAM round-trip per cold page, so such ranks lose to
        ANY rank with headroom regardless of queue depth. Contiguous
        ranks have no spill pressure and always count as having
        headroom."""
        live = self._live()
        need = len(req.prompt) + max(0, len(req.out_tokens) - 1)

        def pressed(e: Engine) -> int:
            h = e.route_headroom_tokens()
            return 0 if h is None or h >= need else 1

        if req.slo == "interactive":
            return min(live, key=lambda e: (
                pressed(e), e.outstanding_tokens("interactive"),
                e.outstanding_tokens(), e.rank))
        return min(live, key=lambda e: (pressed(e),
                                        e.outstanding_tokens(), e.rank))

    def submit(self, req: Request) -> bool:
        """Admission control + routing. False = rejected (queue full or
        no live rank). The cap counts WAITING work net of ABSORBABLE
        capacity — free slots, further capped by page-pool headroom on
        paged-KV engines (a free slot with no pages behind it absorbs
        nothing). Under ``shed="deadline"`` an overflow evicts the
        waiting request least likely to meet its deadline instead of
        always rejecting the newcomer."""
        with self._lock:
            self.n_submitted += 1
            self.prompt_hist[len(req.prompt)] += 1
            now = self._now()
            if self._dp is not None:
                self._by_rid[req.rid] = req
            if req.t_submit is None:
                req.t_submit = now
            if req.t_deadline is None:
                req.t_deadline = req.t_submit + self._slo_target(req)
            if not self._live():
                req.status = "failed"
                req.error = "no live engine shards"
                req._kv = None          # release any snapshot memory
                self.failed.append(req)
                return False
            cap = self.sched.max_queue
            if cap is not None:
                free = sum(e.admission_capacity() for e in self._live())
                if self.queued() - free >= cap:
                    victim = req
                    if self.sched.shed == "deadline":
                        victim = self._shed_victim(req, now)
                    if victim is req:
                        req.status = "rejected"
                        self.rejected.append(req)
                        return False
                    # evict the queued victim, admit the newcomer
                    for e in self._live():
                        if victim in e.queue:
                            e.queue.remove(victim)
                            break
                    victim.status = "rejected"
                    victim._kv = None
                    self.rejected.append(victim)
                    self.n_shed += 1
            self.n_accepted += 1
            self._route(req).submit(req)
            return True

    def _shed_victim(self, incoming: Request, now: float) -> Request:
        """Deadline-aware shedding: among every WAITING
        request (each live rank's queue, plus the newcomer), pick the
        one least likely to meet its deadline — batch class sheds
        before interactive, then smallest slack per unit of remaining
        work (a request that will blow its deadline anyway wastes the
        least SLO value when dropped)."""
        cands = [r for e in self._live() for r in e.queue
                 if r._resume_pos is None]      # never shed mid-decode
        cands.append(incoming)

        def key(r: Request):
            dl = r.t_deadline if r.t_deadline is not None \
                else now + self._slo_target(r)
            slack = dl - now
            return (0 if r.slo == "batch" else 1,
                    slack / max(1, r.cost_estimate()))

        return min(cands, key=key)

    # -- preemption ----------------------------------------------------
    def _maybe_preempt(self, eng: Engine, now: float):
        """Evict the worst-running batch-class request when an
        interactive request with a strictly earlier effective deadline
        waits and no slot is free. At most one eviction per rank per
        step; victims re-queue (and re-sort) like fresh arrivals."""
        if not self.sched.preempt or not eng.queue or eng.n_free() > 0:
            return
        head = min(eng.queue, key=lambda r: self._deadline_key(r, now))
        if head.slo != "interactive":
            return
        cands = [(i, r) for i, r in enumerate(eng.slot_req)
                 if r is not None and r.slo == "batch"
                 and r.preemptions < self.sched.max_preemptions]
        if not cands:
            return
        slot, victim = max(cands,
                           key=lambda c: self._deadline_key(c[1], now))
        if (self._deadline_key(head, now) + self.sched.preempt_margin
                < self._deadline_key(victim, now)):
            # the freed slot must go to the triggering head, not to
            # whatever sits at queue[0] under the active policy — move
            # it to the front, and the victim to the back
            i = next(i for i, r in enumerate(eng.queue) if r is head)
            eng.queue.insert(0, eng.queue.pop(i))
            eng.queue.append(eng.preempt_slot(
                slot, keep_kv=self.sched.preempt_mode == "kv"))

    # -- failure containment -------------------------------------------
    def _fail(self, req: Request, error: str):
        req.status = "failed"
        req.error = error
        req.t_done = time.monotonic()
        req._kv = None                  # release any snapshot memory
        self.failed.append(req)

    def _on_rank_failure(self, eng: Engine, err: BaseException
                         ) -> List[Request]:
        """Contain a raising shard. Its QUEUED (not-yet-started)
        requests re-route to live ranks; its IN-FLIGHT requests requeue
        there too with an exact re-prefill resume armed
        (``requeue_inflight`` — a rank death becomes a latency blip, not
        a terminal error), unless a request has
        already survived ``max_requeues`` rank deaths (poison
        containment) or requeueing is disabled — those fail terminally
        with the error attached. Returns requests that had already
        COMPLETED at admission inside the raising step — they are done,
        not casualties."""
        eng.dead = True
        eng.stats["deaths"] += 1
        self.telemetry.tracer.instant(
            "rank_death", tid=eng.rank, error=type(err).__name__)
        done_at_admission = list(eng._finished_at_admission)
        eng._finished_at_admission = []
        requeue, eng.queue = list(eng.queue), []
        if self.sched.requeue_inflight:
            for req in eng.evacuate_inflight():
                req.requeues += 1
                if req.requeues <= self.sched.max_requeues:
                    self.n_requeued += 1
                    requeue.append(req)
                else:
                    self._fail(req, f"rank {eng.rank} died "
                               f"({type(err).__name__}: {err}); "
                               f"{self.sched.max_requeues} requeue(s) "
                               "exhausted")
                    eng.stats["failed"] += 1
        else:
            self.failed.extend(eng.fail_inflight(err))
        live = self._live()
        for req in requeue:
            if live:
                # a KV snapshot taken on the dead rank's caches cannot
                # restore elsewhere — drop it; _resume_pos survives, so
                # the new rank resumes by re-prefill (still exact)
                req._kv = None
                self._route(req).submit(req)
            else:
                self._fail(req, f"rank {eng.rank} died "
                           f"({type(err).__name__}: {err}); "
                           "no live shards to re-route to")
        return done_at_admission

    def step(self) -> List[Request]:
        """One decode step on every live rank that has work; returns the
        requests retired this step (any rank). Applies queue policy
        (re-sorting time-varying priorities) and preemption first."""
        with self._lock:
            if self._dp is not None:
                return self._step_mesh()
            finished: List[Request] = []
            now = time.monotonic()
            for eng in self.shards:
                if eng.dead:
                    continue
                try:
                    self._order_and_preempt(eng, now)
                    if not eng.has_work():
                        continue
                    finished.extend(eng.step())
                except Exception as err:  # noqa: BLE001 — containment
                    finished.extend(self._on_rank_failure(eng, err))
            return finished

    def _order_and_preempt(self, eng: Engine, now: float):
        """The queue policy's order, then preemption. Inside the
        caller's containment: the KV snapshot in ``preempt_slot`` is a
        device op and can raise like a step."""
        if self.sched.policy != "fcfs" and len(eng.queue) > 1:
            eng.queue.sort(key=lambda r: self._priority(r, now))
        self._maybe_preempt(eng, now)

    def _step_mesh(self) -> List[Request]:
        """``step`` on a mesh (module docstring, "Ranks on a mesh")."""
        now = self._now()
        local = self.shards[self._me]
        self._emitted = []
        done: List[Request] = []
        err = None
        for eng in self.shards:
            if eng.dead:
                continue
            try:
                self._order_and_preempt(eng, now)
                if eng is local and eng.has_work():
                    done = eng.step()
            except Exception as e:  # noqa: BLE001 — containment
                if eng is not local:
                    raise               # a peer's bookkeeping cannot fail
                err = e
        records = self._exchange(step_record(local, self._emitted, done, err))
        live = [(eng, rec) for eng, rec in zip(self.shards, records)
                if not eng.dead]
        for eng, rec in live:
            if eng is not local:
                eng.apply(rec, self._by_rid)
            if self._sink is not None:
                for rid, tok in rec["emitted"]:
                    self._sink(self._by_rid[rid], tok)
        finished: List[Request] = []
        for eng, rec in live:
            if rec["raised"] is not None:
                finished.extend(self._on_rank_failure(
                    eng, RankStepError(rec["raised"])))
            else:
                finished.extend(self._by_rid[i] for i in rec["finished"])
        return finished

    def _exchange(self, rec: dict) -> List[dict]:
        """Every DP rank's record, in rank order: JSON bytes all-gathered
        over 'data' (their lengths first)."""
        data = json.dumps(rec).encode()
        dev = self._dp.host_device
        sizes = self._dp.data_all_gather(torch.tensor(
            [len(data)], dtype=torch.int64, device=dev))[:, 0].tolist()
        buf = torch.zeros((max(sizes),), dtype=torch.uint8, device=dev)
        buf[:len(data)] = torch.frombuffer(bytearray(data),
                                           dtype=torch.uint8)
        got = self._dp.data_all_gather(buf).cpu().numpy()
        return [json.loads(got[r, :n].tobytes()) for r, n in enumerate(sizes)]

    # -- serving loops -------------------------------------------------
    def _set_sink(self, fn: Optional[Callable[[Request, int], None]]):
        self._sink = fn                 # revived shards inherit the sink
        if self._dp is None:            # on a mesh step replays to it
            for e in self.shards:
                e.on_token = fn

    def _serve_loop(self, requests: Sequence[Request],
                    arrivals: Optional[Sequence[float]]
                    ) -> Iterator[List[Request]]:
        """Shared arrival/step loop: submits each request when its time
        comes (``arrivals`` in seconds from start, e.g. Poisson offsets;
        omitted = everything up front), yields the requests retired by
        each step. Stops when nothing is pending or every rank died."""
        timed = arrivals is not None      # (not truth-tested: numpy ok)
        order = sorted(range(len(requests)),
                       key=lambda i: arrivals[i] if timed else 0.0)
        t0 = self._now() if timed else 0.0
        i = 0
        while i < len(order) or self.has_work():
            if not self._live():
                # total failure: the not-yet-submitted arrivals must
                # still resolve — submit routes them to self.failed
                while i < len(order):
                    self.submit(requests[order[i]])
                    i += 1
                return
            now = self._now() - t0 if timed else 0.0
            while i < len(order) and (
                    not timed or arrivals[order[i]] <= now):
                self.submit(requests[order[i]])
                i += 1
            if not self.has_work():
                if i < len(order):      # idle until the next arrival
                    time.sleep(max(0.0, arrivals[order[i]] - now))
                continue
            yield self.step()

    def run(self, requests: Sequence[Request],
            arrivals: Optional[Sequence[float]] = None,
            on_token: Optional[Callable[[Request, int], None]] = None
            ) -> List[Request]:
        """Serve ``requests`` to completion; returns the COMPLETED ones.
        Rejected requests land on ``self.rejected``, failed ones (dead
        rank) on ``self.failed`` — neither is waited for. ``on_token``
        streams every sampled token as ``fn(request, token)``."""
        self._set_sink(on_token)
        try:
            done: List[Request] = []
            for finished in self._serve_loop(requests, arrivals):
                done.extend(finished)
            return done
        finally:
            self._set_sink(None)

    def stream(self, requests: Sequence[Request],
               arrivals: Optional[Sequence[float]] = None
               ) -> Iterator[Tuple[int, int]]:
        """Per-token iterator over the whole sharded serving loop:
        yields ``(rid, token)`` in sampling order as decode steps retire
        across ranks. Completed/rejected/failed requests are found where
        :meth:`run` leaves them (the request objects themselves,
        ``self.rejected``, ``self.failed``)."""
        buf: List[Tuple[int, int]] = []
        self._set_sink(lambda req, tok: buf.append((req.rid, tok)))
        try:
            for _ in self._serve_loop(requests, arrivals):
                while buf:
                    yield buf.pop(0)
        finally:
            self._set_sink(None)

    def prompt_length_histogram(self) -> Dict[int, int]:
        """Observed prompt lengths (all submissions, admitted or not):
        what a bucket table is fitted to."""
        with self._lock:
            return dict(self.prompt_hist)

    # -- owner methods for frontend bookkeeping ------------------------
    def drain_failed(self) -> List[Request]:
        """Hand terminal failures off to the caller (the cluster
        frontend escalates them into its retry ladder) and clear the
        list — under the scheduler's lock, so a concurrent submit's
        no-live-shards failure is either in this batch or the next,
        never lost."""
        with self._lock:
            out, self.failed[:] = list(self.failed), []
            return out

    def retract_request(self, req: Request) -> bool:
        """Withdraw a non-admitted request's terminal bookkeeping
        (``rejected`` or ``failed``) because the CALLER owns its fate —
        the cluster frontend re-routes or resolves it itself. Returns
        True if the request was found on either list."""
        with self._lock:
            if req in self.rejected:
                self.rejected.remove(req)
                return True
            if req in self.failed:
                self.failed.remove(req)
                return True
            return False

    def stats(self) -> Dict:
        """Per-rank serving counters + global admission/QoS counters.
        Paged-KV ranks carry a ``memory`` dict (MemoryStats)."""
        def rank_stats(e: Engine) -> Dict:
            d = dict(e.stats, queue=len(e.queue),
                     free_slots=e.n_free(),
                     slots=e.slot_states(), dead=e.dead)
            mem = e.memory_stats()
            if mem is not None:
                d["memory"] = mem.as_dict()
            return d

        with self._lock:
            headrooms = [e.route_headroom_tokens()
                         for e in self._live()]
            return {
                "ranks": self.ranks,
                "live_ranks": len(self._live()),
                "submitted": self.n_submitted,
                "accepted": self.n_accepted,
                "rejected": len(self.rejected),
                "shed": self.n_shed,
                "revived": self.n_revived,
                "requeued": self.n_requeued,
                "failed": len(self.failed),
                "prompt_lengths_seen": sum(self.prompt_hist.values()),
                "preemptions": sum(e.stats["preemptions"]
                                   for e in self.shards),
                # host-level aggregates the cluster frontend routes on
                "outstanding_tokens": self.outstanding_tokens(),
                "inflight": sum(e.B - e.n_free()
                                for e in self._live()),
                "headroom_tokens": (None if all(h is None
                                                for h in headrooms)
                                    else sum(h for h in headrooms
                                             if h is not None)),
                # TTFT (t_first - t_submit) quantiles per SLO class,
                # observed by the engines at first-token stamp time
                "ttft": self.telemetry.ttft_stats(),
                "per_rank": [rank_stats(e) for e in self.shards],
            }
