"""Fault-tolerant cluster frontend of the port (``repro.serve.frontend``)
over per-host schedulers.

N independent hosts — each a :class:`~repro_torch.serve.scheduler.
ShardedScheduler` — become one serving surface that keeps answering
while hosts die, stall and come back:

* **Heartbeat health checks** — every frontend tick pings each host.
  ``suspect_after`` consecutive misses stop NEW routing to the host (it
  may still finish what it holds); ``dead_after`` misses — or a host
  that is positively dead (process exited, every rank dead) — mark it
  dead and trigger evacuation. A suspect host that answers again is
  healthy again, so a transient stall costs routing preference, not its
  in-flight work.
* **Idempotent retry with backoff** — a dead host's queued AND in-flight
  requests re-submit to live hosts, each delayed by
  ``backoff_base * 2**attempt`` (capped, ± seeded jitter), at most
  ``retries`` times. :meth:`~repro_torch.serve.engine.Request.
  mark_resumable` arms the exact re-prefill resume from the emitted
  tokens, so a retried request CONTINUES its stream and greedy streams
  equal an undisturbed run.
* **Exactly-once token delivery** — a token reaches the caller's sink
  only when it is the next undelivered index of its request, so replays
  never double-stream. One request, one resolution: ``done``,
  ``rejected`` or ``failed``.
* **Watchdog** — a per-request wall-clock budget (``request_timeout``):
  an overdue request is cancelled out of its host and failed.
* **Graceful drain** — :meth:`ClusterFrontend.drain` stops admission and
  serves what is in flight, bounded by ``drain_timeout``.
* **Revive + replay** — :meth:`ClusterFrontend.revive_host` rebuilds a
  dead host's dead ranks, resets its health and replays every retryable
  failure with a fresh attempt budget.

Two host flavours behind one interface: :class:`LocalHost` wraps an
in-process scheduler (with optional :mod:`~repro_torch.serve.chaos`
hooks), and :class:`SubprocessHost` speaks a line-JSON protocol to a
``python -m repro_torch.serve.host_worker`` child process, so a host can
be ``kill -9``-ed mid-load. In-process hosts share one CUDA context: a
Python exception in a rank is contained, a CUDA fault is not (it poisons
every host of the process); a subprocess host contains both. Heartbeats
and stats read host state only — no device value, no synchronise — so a
busy host never looks dead.
"""
from __future__ import annotations

import json
import os
import queue
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.chaos import ChaosMonkey
from repro_torch.serve.engine import Request
from repro_torch.serve.scheduler import SchedulerConfig, ShardedScheduler
from repro_torch.serve.telemetry import Telemetry, merged_ttft_stats

HOST_STATES = ("healthy", "suspect", "dead")
OUTCOMES = ("done", "rejected", "failed")


@dataclass
class FrontendConfig:
    # --- retry ladder -------------------------------------------------
    retries: int = 2                # re-submissions after host failures
    backoff_base: float = 0.02     # seconds; attempt k waits base*2^k
    backoff_cap: float = 2.0       # ceiling on any single delay
    backoff_jitter: float = 0.25   # ± uniform fraction of the delay
    # --- health ladder ------------------------------------------------
    suspect_after: int = 1         # missed beats -> stop new routing
    dead_after: int = 3            # missed beats -> dead + evacuate
    # --- timeouts -----------------------------------------------------
    request_timeout: Optional[float] = None   # per-request wall clock
    drain_timeout: float = 30.0
    rng_seed: int = 0              # backoff jitter (deterministic)


class _Tracker:
    """Frontend-side lifecycle record for one request: which host holds
    it, how many delivery attempts it has burned, how many tokens the
    caller has been handed (the dedup cursor), and its one-and-only
    resolution."""
    __slots__ = ("req", "host_id", "attempts", "retry_at", "delivered",
                 "outcome", "replayable", "t0")

    def __init__(self, req: Request, now: float):
        self.req = req
        self.host_id: Optional[int] = None
        self.attempts = 0              # host submissions so far
        self.retry_at: Optional[float] = None   # due time when unrouted
        self.delivered = 0             # tokens handed to the sink
        self.outcome: Optional[str] = None      # None until resolved
        self.replayable = False        # revive_host may resurrect it
        self.t0 = now                  # watchdog epoch


# ----------------------------------------------------------------------
# host handles
# ----------------------------------------------------------------------
class LocalHost:
    """In-process host: one :class:`ShardedScheduler` plus optional
    chaos hooks. ``step()`` returns ``(finished_rids,
    failed_[(rid, err)], token_events)`` — token events are empty here
    (local tokens flow through the streaming sink directly); the tuple
    shape matches :class:`SubprocessHost`."""

    def __init__(self, host_id: int, scheduler: ShardedScheduler, *,
                 chaos: Optional[ChaosMonkey] = None):
        self.host_id = host_id
        self.sched = scheduler
        self.telemetry = scheduler.telemetry
        self.chaos = chaos
        self.steps = 0                  # local step counter (chaos keys)
        self.killed = False             # chaos hard-kill latch

    @property
    def alive(self) -> bool:
        return not self.killed and bool(self.sched._live())

    def set_sink(self, fn: Optional[Callable[[Request, int], None]]):
        self.sched.set_on_token(fn)

    def heartbeat(self) -> bool:
        if self.killed:
            return False
        if self.chaos is not None and self.chaos.heartbeat_dropped(
                self.host_id, self.steps):
            self.telemetry.tracer.instant("hb_drop", cat="chaos",
                                          step=self.steps)
            return False
        return bool(self.sched._live())

    def headroom_tokens(self) -> Optional[int]:
        """Best single live rank's spill headroom — a request lands on
        ONE rank, so the max (not the sum) decides admissibility.
        With prefix sharing this is *effective* headroom: each engine
        counts shared physical pages once and adds evictable cached
        pages back in, so routing sees the capacity a
        new request could actually claim."""
        hs = [e.route_headroom_tokens() for e in self.sched._live()]
        hs = [h for h in hs if h is not None]
        return max(hs) if hs else None

    def submit(self, req: Request) -> str:
        """'ok' | 'rejected' (admission control) | 'dead' (no live
        ranks — the frontend retries elsewhere). The scheduler's own
        terminal bookkeeping for non-admitted requests is undone here:
        the FRONTEND owns their fate."""
        if self.killed or not self.sched._live():
            return "dead"
        if self.sched.submit(req):
            return "ok"
        self.sched.retract_request(req)
        return "rejected" if req.status == "rejected" else "dead"

    def step(self) -> Tuple[List[int], List[Tuple[int, str]],
                            List[Tuple[int, int, int]]]:
        if self.killed:
            return [], [], []
        self.steps += 1
        if self.chaos is not None:
            if self.chaos.kill_due(self.host_id, self.steps):
                self.telemetry.tracer.instant("host_kill", cat="chaos",
                                              step=self.steps)
                self.killed = True      # hard death: strands its work
                return [], [], []
            d = self.chaos.delay_s(self.host_id)
            if d > 0:
                time.sleep(d)
            if self.chaos.decode_raise_due(self.host_id, self.steps):
                live = self.sched._live()
                if live:                # next decode on this rank raises;
                    def _boom(*a, **k):  # revive_rank rebuilds the engine
                        raise RuntimeError("chaos: injected decode fault")
                    live[0]._decode_step = _boom
                    live[0]._paged_decode_step = _boom
        finished = self.sched.step()
        # terminal scheduler failures (requeues exhausted, no live
        # shards) escalate to the frontend, which owns their fate —
        # drain them off the host's list under the scheduler's lock
        failed = [(r.rid, r.error or "rank failure")
                  for r in self.sched.drain_failed()]
        return [r.rid for r in finished], failed, []

    def cancel(self, rid: int) -> Optional[Request]:
        return self.sched.cancel(rid)

    def evacuate(self, rids: Sequence[int]):
        """Purge the given requests from this (dead) host so its
        scheduler holds no references to objects the frontend is about
        to hand elsewhere — a later revive must not resume stale
        copies."""
        for rid in rids:
            self.sched.cancel(rid)

    def revive(self):
        for r, eng in enumerate(self.sched.shards):
            if eng.dead:
                self.sched.revive_rank(r)
        self.killed = False

    def close(self):
        pass

    def stats(self) -> Dict:
        d = self.sched.stats()
        d["host"] = self.host_id
        d["steps"] = self.steps
        return d


def host_worker_cmd(spec: Optional[Dict] = None) -> List[str]:
    """The command of a :class:`SubprocessHost`'s child:
    ``python -m repro_torch.serve.host_worker '<spec json>'``."""
    return [sys.executable, "-m", "repro_torch.serve.host_worker",
            json.dumps(spec or {})]


def host_worker_env(env: Optional[Dict[str, str]] = None
                    ) -> Dict[str, str]:
    """``env`` (default: this process's) with the directory that holds
    ``repro_torch`` first on PYTHONPATH, so ``-m`` finds the package."""
    out = dict(os.environ if env is None else env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in out.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return out


class SubprocessHost:
    """A host in its own OS process (``python -m
    repro_torch.serve.host_worker``, started with fork+exec): newline-
    JSON commands on stdin, ``EV {json}`` events on stdout, read by a
    daemon thread so a hung or killed worker can never block the
    frontend loop past the rpc timeout. The parent applies streamed
    token events to its own canonical :class:`Request` objects (the
    shadow state IS the resume snapshot — after ``kill -9``, a
    replacement submission carries ``out_tokens`` and resumes exactly).
    Any protocol breakdown — EOF, broken pipe, rpc timeout, nonzero exit
    — latches ``killed``; the frontend's health ladder does the rest.

    ``cmd`` defaults to :func:`host_worker_cmd` of ``spec`` (the
    worker's model and scheduler knobs, see ``host_worker``). A killed
    worker is waited for before anything else starts, so its device
    memory is free again."""

    def __init__(self, host_id: int, cmd: Optional[Sequence[str]] = None,
                 *, spec: Optional[Dict] = None,
                 env: Optional[Dict[str, str]] = None,
                 ready_timeout: float = 600.0,
                 step_timeout: float = 300.0,
                 hb_timeout: float = 60.0):
        self.host_id = host_id
        self.cmd = list(cmd) if cmd is not None else host_worker_cmd(spec)
        self.env = host_worker_env(env)
        self.ready_timeout = ready_timeout
        self.step_timeout = step_timeout
        self.hb_timeout = hb_timeout
        self.killed = False
        self.steps = 0
        self._pending: List[Dict] = []  # events read while awaiting acks
        self._spawn()

    # -- process + reader ------------------------------------------------
    def _spawn(self):
        self.proc = subprocess.Popen(
            self.cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1, env=self.env)
        self._q: "queue.Queue[Optional[str]]" = queue.Queue()
        t = threading.Thread(target=self._read_loop,
                             args=(self.proc.stdout, self._q), daemon=True)
        t.start()
        self._pending = []
        if self._wait_for({"ready"}, self.ready_timeout) is None:
            raise RuntimeError(
                f"frontend host {self.host_id} worker failed to start: "
                f"{self.cmd}")

    @staticmethod
    def _read_loop(stream, q):
        try:
            for line in stream:
                q.put(line)
        except ValueError:              # stream closed under the reader
            pass
        q.put(None)                     # EOF sentinel

    @property
    def alive(self) -> bool:
        return not self.killed and self.proc.poll() is None

    def _send(self, **obj) -> bool:
        if not self.alive:
            return False
        try:
            self.proc.stdin.write(json.dumps(obj) + "\n")
            self.proc.stdin.flush()
            return True
        except (BrokenPipeError, OSError, ValueError):
            self.killed = True
            return False

    def _next_event(self, timeout: float) -> Optional[Dict]:
        deadline = time.monotonic() + timeout
        while True:
            try:
                line = self._q.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                return None             # rpc timeout: treat as hung
            if line is None:
                self.killed = True      # EOF: the process is gone
                return None
            line = line.strip()
            if not line.startswith("EV "):
                continue                # stray runtime chatter
            try:
                return json.loads(line[3:])
            except json.JSONDecodeError:
                continue

    def _wait_for(self, kinds, timeout: float) -> Optional[Dict]:
        """Read events until one of ``kinds``; everything else (tok/
        done/failed arriving ahead of an ack) buffers for the next
        ``step()`` harvest. None = timeout or EOF → host is dead."""
        deadline = time.monotonic() + timeout
        while True:
            ev = self._next_event(max(0.0, deadline - time.monotonic()))
            if ev is None:
                self.killed = True
                return None
            if ev.get("ev") in kinds:
                return ev
            self._pending.append(ev)

    # -- host interface --------------------------------------------------
    def heartbeat(self) -> bool:
        if not self._send(cmd="ping"):
            return False
        return self._wait_for({"pong"}, self.hb_timeout) is not None

    def headroom_tokens(self) -> Optional[int]:
        return None                     # not worth the protocol chatter

    def submit(self, req: Request) -> str:
        ok = self._send(
            cmd="submit", rid=req.rid,
            prompt=[int(t) for t in req.prompt],
            resume=[int(t) for t in req.out_tokens],
            max_new=req.max_new_tokens, temperature=req.temperature,
            eos=req.eos_id, slo=req.slo)
        if not ok:
            return "dead"
        ev = self._wait_for({"submitted"}, self.hb_timeout)
        if ev is None:
            return "dead"
        if ev.get("ok", True):
            return "ok"
        # non-admission: admission-control shed vs worker ranks dead
        return "rejected" if ev.get("status") == "rejected" else "dead"

    def step(self) -> Tuple[List[int], List[Tuple[int, str]],
                            List[Tuple[int, int, int]]]:
        if not self._send(cmd="step"):
            return [], [], []
        self.steps += 1
        events, self._pending = self._pending, []
        while True:
            ev = self._next_event(self.step_timeout)
            if ev is None:
                self.killed = True      # hung/killed mid-step
                return [], [], []
            if ev.get("ev") == "stepped":
                break
            events.append(ev)
        fin, failed, toks = [], [], []
        for ev in events:
            kind = ev.get("ev")
            if kind == "tok":
                toks.append((ev["rid"], ev["i"], ev["tok"]))
            elif kind == "done":
                fin.append(ev["rid"])
            elif kind == "failed":
                failed.append((ev["rid"], ev.get("error", "worker failure")))
        return fin, failed, toks

    def cancel(self, rid: int):
        if self._send(cmd="cancel", rid=rid):
            self._wait_for({"cancelled"}, self.hb_timeout)
        return None

    def evacuate(self, rids: Sequence[int]):
        pass                            # the process is gone with them

    def set_sink(self, fn):
        pass                            # tokens arrive as step events

    def kill(self):
        """SIGKILL the worker and reap it — the chaos primitive. The pid
        is waited for, so the worker's device memory is back before a
        replacement starts."""
        self.killed = True
        try:
            os.kill(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass
        self.proc.wait(timeout=60.0)
        self._close_pipes()

    def _close_pipes(self):
        for f in (self.proc.stdin, self.proc.stdout):
            try:
                f.close()
            except (OSError, ValueError):
                pass

    def revive(self):
        self.kill()                     # ensure the old process is gone
        self.killed = False
        self._spawn()

    def close(self):
        if self.proc.poll() is None:
            self._send(cmd="exit")
            try:
                self.proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self._close_pipes()
        self.killed = True

    def stats(self) -> Dict:
        return {"host": self.host_id, "steps": self.steps,
                "alive": self.alive}


def make_local_hosts(params, cfg, *, hosts: int = 2,
                     sched: Optional[SchedulerConfig] = None,
                     ranks: int = 1, chaos: Optional[ChaosMonkey] = None,
                     trace: bool = False) -> List[LocalHost]:
    """Build N in-process hosts, each its own ShardedScheduler over
    ``ranks`` engine shards, all over the same params tensors (rng seeds
    offset per host so hosts are distinct engines, which greedy decoding
    never observes). Each host
    gets its OWN Telemetry (same-rank engines on different hosts must
    not share counter scopes); ``trace`` arms every host's span
    tracer — the frontend merges the ring buffers at export."""
    sched = sched or SchedulerConfig()
    out = []
    for h in range(hosts):
        s = replace(sched, rng_seed=sched.rng_seed + h * max(1, ranks))
        out.append(LocalHost(
            h, ShardedScheduler(params, cfg, sched=s, ranks=ranks,
                                telemetry=Telemetry(trace=trace)),
            chaos=chaos))
    return out


# ----------------------------------------------------------------------
# the frontend
# ----------------------------------------------------------------------
class ClusterFrontend:
    """Routes requests across hosts; owns every request's lifecycle
    (exactly-once resolution, exactly-once token delivery) no matter
    which hosts fail underneath. See module docstring for semantics."""

    def __init__(self, hosts: Sequence, cfg: Optional[FrontendConfig]
                 = None, *, on_token: Optional[
                     Callable[[Request, int], None]] = None,
                 telemetry: Optional[Telemetry] = None):
        assert hosts, "a frontend needs at least one host"
        ids = [h.host_id for h in hosts]
        assert len(set(ids)) == len(ids), f"duplicate host ids: {ids}"
        self.hosts: Dict[int, object] = {h.host_id: h for h in hosts}
        self.cfg = cfg or FrontendConfig()
        self.on_token = on_token
        self.rng = random.Random(self.cfg.rng_seed)
        # the frontend's OWN registry/tracer — retry/health/watchdog
        # events land here, host events stay in the hosts' rings and
        # merge at export. Default: trace iff any host traces.
        if telemetry is None:
            telemetry = Telemetry(trace=any(
                getattr(h, "telemetry", None) is not None
                and h.telemetry.tracer.enabled for h in hosts))
        self.telemetry = telemetry
        self._trace = telemetry.tracer
        self.telemetry.registry.register_collector(
            self._cluster_metrics, key="cluster")
        # guards trackers/outcome lists/health against concurrent
        # callers (submit from a caller thread while run()/step() ticks;
        # stats from a monitor). Reentrant: a LocalHost step fires
        # _local_sink inline while step() already holds the lock.
        self._lock = threading.RLock()
        self.trackers: Dict[int, _Tracker] = {}
        self.done: List[Request] = []
        self.failed: List[Request] = []
        self.rejected: List[Request] = []
        self.draining = False
        self.n_retries = 0              # re-submissions actually made
        self.n_deduped = 0              # duplicate token events dropped
        self._health = {h.host_id: {"state": "healthy", "misses": 0}
                        for h in hosts}
        for h in hosts:
            h.set_sink(self._local_sink)

    # -- views -----------------------------------------------------------
    def unresolved(self) -> List[_Tracker]:
        with self._lock:
            return [t for t in self.trackers.values()
                    if t.outcome is None]

    def _state(self, hid: int) -> str:
        return self._health[hid]["state"]

    def _routable(self) -> List:
        return [h for h in self.hosts.values()
                if self._state(h.host_id) == "healthy" and h.alive]

    def _exhausted(self) -> bool:
        return not any(h.alive and self._state(h.host_id) != "dead"
                       for h in self.hosts.values())

    def _outstanding(self, hid: int, slo: Optional[str] = None) -> int:
        return sum(t.req.cost_estimate() for t in self.trackers.values()
                   if t.outcome is None and t.host_id == hid
                   and (slo is None or t.req.slo == slo))

    # -- routing (mirrors ShardedScheduler._route at host granularity) ---
    def _route(self, req: Request):
        cands = self._routable()
        if not cands:
            return None
        need = len(req.prompt) + max(0, len(req.out_tokens) - 1)

        def pressed(h) -> int:
            hr = h.headroom_tokens()
            return 0 if hr is None or hr >= need else 1

        if req.slo == "interactive":
            return min(cands, key=lambda h: (
                pressed(h), self._outstanding(h.host_id, "interactive"),
                self._outstanding(h.host_id), h.host_id))
        return min(cands, key=lambda h: (
            pressed(h), self._outstanding(h.host_id), h.host_id))

    # -- resolution (exactly once) ---------------------------------------
    def _resolve(self, tr: _Tracker, outcome: str):
        assert tr.outcome is None, \
            f"request {tr.req.rid} resolved twice ({tr.outcome} -> {outcome})"
        tr.outcome = outcome
        {"done": self.done, "failed": self.failed,
         "rejected": self.rejected}[outcome].append(tr.req)

    def _fail(self, tr: _Tracker, error: str, *, replayable: bool):
        req = tr.req
        req.status = "failed"
        req.error = error
        req.t_done = time.monotonic()
        req._kv = None
        tr.replayable = replayable
        self._resolve(tr, "failed")

    def _reject(self, tr: _Tracker, reason: str):
        tr.req.status = "rejected"
        tr.req.error = reason
        self._resolve(tr, "rejected")

    # -- token delivery (exactly once) -----------------------------------
    def _local_sink(self, req: Request, tok: int):
        with self._lock:
            tr = self.trackers.get(req.rid)
            if tr is None or tr.outcome is not None:
                return
            if len(req.out_tokens) == tr.delivered + 1:
                tr.delivered += 1
                if self.on_token is not None:
                    self.on_token(req, tok)
            else:
                self.n_deduped += 1

    def _remote_token(self, tr: _Tracker, i: int, tok: int):
        """Apply one worker token event to the parent's shadow request.
        ``i`` is the GLOBAL output index, so replays after a resume
        (i < delivered) dedup away and the sink sees each index once."""
        if tr.outcome is not None:
            return
        if i == len(tr.req.out_tokens):
            tr.req.out_tokens.append(tok)
        if i == tr.delivered:
            tr.delivered += 1
            if self.on_token is not None:
                self.on_token(tr.req, tok)
        elif i < tr.delivered:
            self.n_deduped += 1

    # -- submission / retry ladder ---------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit a request to the cluster. False = resolved on the spot
        as rejected (draining, or a host's admission control shed it);
        True = the frontend owns it until it resolves. With no routable
        host RIGHT NOW the request waits at the frontend and routes
        when one recovers (or fails when every host is gone)."""
        with self._lock:
            now = time.monotonic()
            tr = _Tracker(req, now)
            assert req.rid not in self.trackers, \
                f"duplicate rid {req.rid}"
            self.trackers[req.rid] = tr
            if self.draining:
                self._reject(tr, "frontend is draining")
                return False
            if req.t_submit is None:
                req.t_submit = now
            return self._dispatch(tr)

    def _dispatch(self, tr: _Tracker) -> bool:
        """Try to place a request on a host now; park it on the retry
        timer otherwise."""
        host = self._route(tr.req)
        if host is None:
            tr.host_id = None
            if tr.retry_at is None:
                tr.retry_at = time.monotonic()  # due as soon as possible
            return True
        tr.attempts += 1
        if tr.attempts > 1:
            self.n_retries += 1
        verdict = host.submit(tr.req)
        if verdict == "ok":
            tr.host_id = host.host_id
            tr.retry_at = None
            return True
        if verdict == "rejected":
            self._reject(tr, f"host {host.host_id} admission control")
            return False
        # 'dead': the host failed under us between health check and
        # submit — count the miss and put the request on the ladder
        self._health[host.host_id]["misses"] += 1
        self._schedule_retry(tr, f"host {host.host_id} died at submit")
        return tr.outcome is None

    def _backoff(self, attempt: int) -> float:
        d = min(self.cfg.backoff_cap,
                self.cfg.backoff_base * (2.0 ** max(0, attempt - 1)))
        return d * (1.0 + self.cfg.backoff_jitter
                    * (2.0 * self.rng.random() - 1.0))

    def _schedule_retry(self, tr: _Tracker, reason: str):
        """A host failed while holding this request: arm an exact
        resume and either park it for a backed-off re-submission or,
        with the attempt budget spent, fail it (replayable — a revive
        can resurrect it)."""
        tr.host_id = None
        if tr.attempts > self.cfg.retries:
            self._fail(tr, f"{reason}; {self.cfg.retries} retr"
                       f"{'y' if self.cfg.retries == 1 else 'ies'} "
                       "exhausted", replayable=True)
            return
        req = tr.req
        req.mark_resumable()
        req.status = "queued"
        tr.retry_at = time.monotonic() + self._backoff(tr.attempts)
        self._trace.instant("retry", pid=-1, rid=req.rid,
                            attempt=tr.attempts, reason=reason)

    def _flush_retries(self, now: float):
        for tr in self.unresolved():
            if tr.host_id is None and tr.retry_at is not None \
                    and tr.retry_at <= now:
                self._dispatch(tr)

    # -- health ladder ----------------------------------------------------
    def _beat(self):
        for hid, host in self.hosts.items():
            st = self._health[hid]
            if st["state"] == "dead":
                continue
            if not host.alive:
                self._mark_dead(hid, "host process/ranks gone")
                continue
            if host.heartbeat():
                st["misses"] = 0
                st["state"] = "healthy"
                continue
            st["misses"] += 1
            if st["misses"] >= self.cfg.dead_after or not host.alive:
                self._mark_dead(hid, f"{st['misses']} missed heartbeats")
            elif st["misses"] >= self.cfg.suspect_after:
                st["state"] = "suspect"

    def _mark_dead(self, hid: int, why: str):
        self._health[hid]["state"] = "dead"
        self._trace.instant("host_dead", pid=-1, host=hid, why=why)
        host = self.hosts[hid]
        stranded = [t for t in self.unresolved() if t.host_id == hid]
        host.evacuate([t.req.rid for t in stranded])
        for tr in stranded:
            self._schedule_retry(tr, f"host {hid} dead ({why})")

    # -- watchdog ----------------------------------------------------------
    def _watchdog(self, now: float):
        if self.cfg.request_timeout is None:
            return
        for tr in self.unresolved():
            if now - tr.t0 <= self.cfg.request_timeout:
                continue
            if tr.host_id is not None:
                self.hosts[tr.host_id].cancel(tr.req.rid)
            self._trace.instant("watchdog_cancel", pid=-1,
                                rid=tr.req.rid)
            self._fail(tr, f"watchdog: exceeded {self.cfg.request_timeout}"
                       "s wall clock", replayable=False)

    # -- the tick ----------------------------------------------------------
    def step(self) -> List[Request]:
        """One frontend tick: health checks, watchdog, due retries, one
        scheduler step on every live host. Returns requests completed
        this tick."""
        with self._lock:
            now = time.monotonic()
            self._beat()
            self._watchdog(now)
            self._flush_retries(now)
            out: List[Request] = []
            for hid, host in self.hosts.items():
                if self._state(hid) == "dead" or not host.alive:
                    continue
                fin, failed, toks = host.step()
                for rid, i, tok in toks:
                    tr = self.trackers.get(rid)
                    if tr is not None:
                        self._remote_token(tr, i, tok)
                for rid in fin:
                    tr = self.trackers.get(rid)
                    if tr is None or tr.outcome is not None:
                        continue
                    req = tr.req
                    if not req.done:    # subprocess host: stamp shadow
                        req.done = True
                        req.status = "done"
                        req.t_done = time.monotonic()
                    self._resolve(tr, "done")
                    out.append(req)
                for rid, err in failed:
                    tr = self.trackers.get(rid)
                    if tr is not None and tr.outcome is None:
                        tr.req.status = "queued"  # frontend owns it
                        self._schedule_retry(tr, f"host {hid}: {err}")
            return out

    def _host_busy(self) -> bool:
        return any(t.host_id is not None for t in self.unresolved())

    def _next_due(self) -> Optional[float]:
        due = [t.retry_at for t in self.unresolved()
               if t.host_id is None and t.retry_at is not None]
        return min(due) if due else None

    # -- serving loops -----------------------------------------------------
    def run(self, requests: Sequence[Request],
            arrivals: Optional[Sequence[float]] = None,
            on_token: Optional[Callable[[Request, int], None]] = None,
            *, on_tick: Optional[Callable[[int], None]] = None
            ) -> List[Request]:
        """Serve ``requests`` to completion (``arrivals``: offsets in
        seconds, e.g. Poisson; omitted = all up front). Returns the
        COMPLETED requests; rejected/failed ones land on
        ``self.rejected``/``self.failed``. Every submitted request
        resolves exactly once even if every host dies. ``on_tick``
        (tick index) lets tests drive chaos from the loop."""
        if on_token is not None:
            self.on_token = on_token
        timed = arrivals is not None
        order = sorted(range(len(requests)),
                       key=lambda i: arrivals[i] if timed else 0.0)
        t0 = time.monotonic()
        i = 0
        tick = 0
        completed: List[Request] = []
        while True:
            # the tick's work runs under the lock; the idle sleep below
            # runs OUTSIDE it, so concurrent submit()/stats() callers
            # are never blocked behind a sleeping loop
            sleep_for: Optional[float] = None
            with self._lock:
                if i >= len(order) and not self.unresolved():
                    break
                if self._exhausted():
                    self._beat()            # record deaths in health
                    while i < len(order):   # arrivals must resolve
                        self.submit(requests[order[i]])
                        i += 1
                    for tr in self.unresolved():
                        self._fail(tr, "no live hosts", replayable=True)
                    break
                now = time.monotonic() - t0
                while i < len(order) and (
                        not timed or arrivals[order[i]] <= now):
                    self.submit(requests[order[i]])
                    i += 1
                if on_tick is not None:
                    on_tick(tick)
                completed.extend(self.step())
                tick += 1
                if not self._host_busy():
                    # idle: nothing decoding anywhere — sleep toward
                    # the next arrival or retry timer, not spinning
                    waits = []
                    if i < len(order) and timed:
                        waits.append(t0 + arrivals[order[i]]
                                     - time.monotonic())
                    due = self._next_due()
                    if due is not None:
                        waits.append(due - time.monotonic())
                    if waits:
                        sleep_for = min(0.05, max(0.0, min(waits)))
            if sleep_for is not None:
                time.sleep(sleep_for)
        return completed

    def drain(self, timeout: Optional[float] = None
              ) -> Tuple[List[Request], bool]:
        """Graceful shutdown: stop admission (new submits reject),
        serve everything in flight to completion — retries and host
        hand-offs stay live — bounded by ``timeout`` (default
        ``drain_timeout``). At the deadline stragglers are cancelled
        out of their hosts and failed, so drain itself always
        terminates. Returns ``(completed_during_drain, clean)`` where
        ``clean`` means nothing was cut off."""
        with self._lock:
            self.draining = True
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.cfg.drain_timeout)
        completed: List[Request] = []
        while time.monotonic() < deadline:
            # per-iteration lock scope: a long drain must not starve
            # concurrent stats()/submit() (which now reject) callers
            with self._lock:
                if not self.unresolved() or self._exhausted():
                    break
                completed.extend(self.step())
        with self._lock:
            leftovers = self.unresolved()
            for tr in leftovers:
                if tr.host_id is not None:
                    self.hosts[tr.host_id].cancel(tr.req.rid)
                self._fail(tr, "drain timeout expired", replayable=True)
        return completed, not leftovers

    def close(self):
        for h in self.hosts.values():
            h.close()

    # -- revive + replay ---------------------------------------------------
    def revive_host(self, host_id: int, *, replay: bool = True):
        """Bring a dead host back (rebuild dead ranks in-process,
        respawn the worker for subprocess hosts), reset its health, and
        — the other half of ``revive_rank`` — replay every
        RETRYABLE failure (retries exhausted / no-live-hosts; never
        watchdog kills) back into the pool with a fresh attempt budget:
        restored capacity also restores the requests the outage cost."""
        with self._lock:
            host = self.hosts[host_id]
            host.revive()
            host.set_sink(self._local_sink)
            self._health[host_id] = {"state": "healthy", "misses": 0}
            self._trace.instant("host_revive", pid=-1, host=host_id)
            if not replay:
                return
            for tr in list(self.trackers.values()):
                if tr.outcome != "failed" or not tr.replayable:
                    continue
                self.failed.remove(tr.req)
                tr.outcome = None
                tr.replayable = False
                tr.attempts = 0
                tr.t0 = time.monotonic()  # a replay restarts its clock
                req = tr.req
                req.error = None
                req.t_done = None
                req.mark_resumable()
                req.status = "queued"
                self._dispatch(tr)

    # -- telemetry export --------------------------------------------------
    def _host_telemetries(self) -> List[Telemetry]:
        return [h.telemetry for h in self.hosts.values()
                if getattr(h, "telemetry", None) is not None]

    def _cluster_metrics(self) -> Dict[str, float]:
        """Collector on the frontend registry: per-host counter sums
        (the ``host`` label keeps same-rank series from colliding) plus
        the frontend's own lifecycle counters."""
        out: Dict[str, float] = {}
        with self._lock:
            out["serve_frontend_retries_total"] = self.n_retries
            out["serve_frontend_deduped_tokens_total"] = self.n_deduped
            for st in HOST_STATES:
                n = sum(1 for h in self.hosts
                        if self._state(h) == st)
                out[f'serve_frontend_hosts{{state="{st}"}}'] = n
            tels = list(self.hosts.items())
        for hid, h in tels:
            tel = getattr(h, "telemetry", None)
            if tel is None:
                continue
            for k, v in tel.registry.summary()["counters"].items():
                out[f'serve_{k}_total{{host="{hid}"}}'] = v
        return out

    def trace_events(self) -> List[Dict]:
        """Chrome trace events merged across the frontend's own ring
        (pid = -1) and every host's ring (pid rewritten to the host
        id), time-sorted — one Perfetto track group per host, one row
        per rank."""
        evs = self.telemetry.tracer.events()
        for hid, h in self.hosts.items():
            tel = getattr(h, "telemetry", None)
            if tel is None or tel.tracer is self.telemetry.tracer:
                continue
            for e in tel.tracer.events():
                e["pid"] = hid
                evs.append(e)
        evs.sort(key=lambda e: e["ts"])
        return evs

    def write_trace(self, path: str) -> int:
        trace = {"traceEvents": self.trace_events(),
                 "displayTimeUnit": "ms"}
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        return len(trace["traceEvents"])

    def prometheus(self) -> str:
        """Cluster-level text exposition: the frontend registry (whose
        cluster collector folds in per-host counter sums)."""
        return self.telemetry.prometheus()

    def stats(self) -> Dict:
        with self._lock:
            states = [self._state(h) for h in self.hosts]
            return {
                "hosts": len(self.hosts),
                "healthy": states.count("healthy"),
                "suspect": states.count("suspect"),
                "dead": states.count("dead"),
                "submitted": len(self.trackers),
                "done": len(self.done),
                "failed": len(self.failed),
                "rejected": len(self.rejected),
                "unresolved": len(self.unresolved()),
                "retries": self.n_retries,
                "deduped_tokens": self.n_deduped,
                "delivered_tokens": sum(t.delivered
                                        for t in self.trackers.values()),
                # cluster-wide TTFT per SLO class (associative
                # snapshot merge across host registries)
                "ttft": merged_ttft_stats(self._host_telemetries()),
                "per_host": [h.stats() for h in self.hosts.values()],
            }
