"""LR schedule, straggler watchdog and preemption hook
(``repro.train.schedule``)."""
from __future__ import annotations

import dataclasses
import math
import signal
from typing import Callable

import torch


def warmup_cosine(warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> Callable:
    """Returns ``lr_scale(step)`` in [min_ratio, 1] as a 0-d fp32 tensor
    on the step's device (a number gives a CPU tensor)."""

    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / step.new_tensor(max(warmup_steps, 1)),
                           max=1.0)
        t = torch.clamp((step - warmup_steps)
                        / step.new_tensor(max(total_steps - warmup_steps,
                                              1)), 0, 1)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(
            math.pi * t))
        return warm * cos

    return fn


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags a step slower than ``threshold``
    times the running mean, and tightens the checkpoint cadence when the
    step time's variation rises, so a straggler that turns into a failure
    loses less work."""

    alpha: float = 0.05
    threshold: float = 2.0           # step flagged if > threshold × EWMA
    ewma: float = 0.0
    ewvar: float = 0.0
    slow_steps: int = 0
    total_steps: int = 0

    def observe(self, step_time_s: float) -> bool:
        self.total_steps += 1
        if self.ewma == 0.0:
            self.ewma = step_time_s
            return False
        slow = step_time_s > self.threshold * self.ewma
        if slow:
            self.slow_steps += 1
        d = step_time_s - self.ewma
        self.ewma += self.alpha * d
        self.ewvar = (1 - self.alpha) * (self.ewvar + self.alpha * d * d)
        return slow

    @property
    def cv(self) -> float:
        """Coefficient of variation: rising CV -> tighten ckpt cadence."""
        return (self.ewvar ** 0.5 / self.ewma) if self.ewma else 0.0

    def checkpoint_every(self, base: int, floor: int = 10) -> int:
        """Adaptive cadence: halve the interval when CV doubles."""
        scale = max(1.0, self.cv / 0.1)
        return max(floor, int(base / scale))


class PreemptionHook:
    """SIGTERM -> request a checkpoint at the next step boundary."""

    def __init__(self):
        self.requested = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass                      # not the main thread

    def _handler(self, signum, frame):
        self.requested = True
