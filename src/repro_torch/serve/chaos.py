"""Deterministic fault injection for the serving tier of the port
(``repro.serve.chaos``, copied: the port imports nothing of the
reference package). Python's ``random`` drives both copies, so the same
seed fires the same faults on the same steps in each.

The cluster frontend (``serve/frontend.py``) must keep every request's
exactly-once/bit-identical guarantees while hosts die, stall, and drop
heartbeats — properties that only show up under faults. This module
provides the faults: a seeded, schedule-driven :class:`ChaosMonkey`
whose hooks the in-process :class:`~repro_torch.serve.frontend.LocalHost`
consults at well-defined points of its step loop. Every hook is a pure
function of ``(host_id, step)`` plus a seeded RNG, so a chaos run is
exactly reproducible — the same schedule produces the same kill at the
same step with the same backoff jitter draw every time, which is what
lets tests assert bit-identical recovery instead of "it usually works".

Four fault families (mirroring what real multi-host serving sees):

* ``kill`` — the whole host hard-dies at local step N (the in-process
  analogue of ``kill -9``: it stops stepping, stops answering
  heartbeats, and strands whatever it held). Real SIGKILL coverage
  comes from subprocess hosts (``repro_torch.serve.host_worker``); this hook
  gives the same observable behavior without fork/exec cost.
* ``raise`` — one live rank's decode raises at step N, exercising the
  scheduler's rank containment + requeue path *inside* a host that
  stays up (a partial failure, not a host death).
* ``drop-hb`` — the host answers ``n`` consecutive heartbeats with
  silence starting at step N while continuing to serve, exercising the
  suspect→recover and suspect→dead ladders independently of real
  failure.
* ``slow`` — every step is delayed by a fixed number of seconds (a
  straggler host), exercising the per-request watchdog.

Schedules come from :class:`ChaosConfig` directly or from the compact
CLI spec grammar used by ``launch/serve.py --chaos``::

    kill:HOST@STEP          raise:HOST@STEP
    drop-hb:HOST@STEP[xN]   slow:HOST@SECONDS       seed:K

comma-separated, e.g. ``"kill:0@12,slow:1@0.02,seed:7"``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class ChaosConfig:
    """A deterministic fault schedule. Host ids index the frontend's
    host list; steps are the HOST's local step counter (starting at 1
    on its first ``step()``), so a schedule is independent of how many
    ticks the frontend spends on other hosts."""
    seed: int = 0
    # host -> local step at which the host hard-dies
    kill_at_step: Dict[int, int] = field(default_factory=dict)
    # host -> local step at which one live rank's decode raises
    raise_in_decode: Dict[int, int] = field(default_factory=dict)
    # host -> (from_step, n_beats): miss n consecutive heartbeats
    # starting at from_step (n < 0 = forever)
    drop_heartbeat: Dict[int, Tuple[int, int]] = field(
        default_factory=dict)
    # host -> seconds of added latency per step (straggler)
    slow_host: Dict[int, float] = field(default_factory=dict)


class ChaosMonkey:
    """Runtime for a :class:`ChaosConfig` schedule. One-shot hooks
    (``kill_due``, ``decode_raise_due``) fire exactly once per host;
    the seeded RNG is exposed for callers that want reproducible
    randomness tied to the same schedule (property tests draw their
    kill/revive schedules from it)."""

    def __init__(self, cfg: Optional[ChaosConfig] = None):
        self.cfg = cfg or ChaosConfig()
        self.rng = random.Random(self.cfg.seed)
        self._killed: set = set()
        self._raised: set = set()

    def kill_due(self, host_id: int, step: int) -> bool:
        """True exactly once: at (or after — a host may skip steps while
        suspect) the scheduled kill step for this host."""
        at = self.cfg.kill_at_step.get(host_id)
        if at is None or host_id in self._killed or step < at:
            return False
        self._killed.add(host_id)
        return True

    def decode_raise_due(self, host_id: int, step: int) -> bool:
        """True exactly once at the scheduled raise step."""
        at = self.cfg.raise_in_decode.get(host_id)
        if at is None or host_id in self._raised or step < at:
            return False
        self._raised.add(host_id)
        return True

    def heartbeat_dropped(self, host_id: int, step: int) -> bool:
        """True while the host's scheduled heartbeat blackout covers
        ``step`` (the host's current local step at ping time)."""
        win = self.cfg.drop_heartbeat.get(host_id)
        if win is None:
            return False
        start, n = win
        if step < start:
            return False
        return n < 0 or step < start + n

    def delay_s(self, host_id: int) -> float:
        return self.cfg.slow_host.get(host_id, 0.0)


def parse_chaos_spec(spec: str) -> ChaosConfig:
    """Parse the ``--chaos`` CLI grammar (module docstring) into a
    :class:`ChaosConfig`. Empty/None spec = no faults."""
    cfg = ChaosConfig()
    if not spec:
        return cfg
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition(":")
        kind = kind.strip().lower()
        try:
            if kind == "seed":
                cfg.seed = int(rest)
                continue
            host_s, _, arg = rest.partition("@")
            host = int(host_s)
            if kind == "kill":
                cfg.kill_at_step[host] = int(arg)
            elif kind == "raise":
                cfg.raise_in_decode[host] = int(arg)
            elif kind == "drop-hb":
                step_s, _, n_s = arg.partition("x")
                cfg.drop_heartbeat[host] = (int(step_s),
                                            int(n_s) if n_s else -1)
            elif kind == "slow":
                cfg.slow_host[host] = float(arg)
            else:
                raise ValueError(f"unknown chaos fault {kind!r}")
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"bad chaos spec entry {part!r}: {e} — grammar is "
                "kill:H@N, raise:H@N, drop-hb:H@N[xM], slow:H@SECS, "
                "seed:K") from e
    return cfg
