"""Straggler detection / mitigation hooks — torch port of
``repro.train.straggler`` (pure Python, the same policy).

On a multi-node fleet the collectives run in lock step, so
mitigation happens at the *orchestration* layer: detect slow steps,
then (a) re-balance host data shards, (b) evict-and-replace the slow
host (elastic restart from the last checkpoint — see checkpoint.py), or
(c) proceed with a hot spare.  This module implements the detection
policy (EMA + robust z-score over step wall times) and the decision
state machine; it is clock-injectable so the policy itself is
unit-tested deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerPolicy:
    ema_alpha: float = 0.1
    threshold: float = 2.0          # step is slow if > threshold * EMA
    patience: int = 3               # consecutive slow steps before acting
    warmup_steps: int = 5           # ignore compile/first steps


class StepMonitor:
    """Records step durations; flags sustained stragglers."""

    def __init__(self, policy: StragglerPolicy = StragglerPolicy(),
                 clock: Callable[[], float] = time.monotonic):
        self.policy = policy
        self.clock = clock
        self.ema: Optional[float] = None
        self.n = 0
        self.slow_streak = 0
        self.history: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = self.clock()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt = self.clock() - self._t0
        self._t0 = None
        self.record(dt)
        return dt

    def record(self, dt: float):
        self.n += 1
        self.history.append(dt)
        if self.n <= self.policy.warmup_steps:
            return
        if self.ema is None:
            self.ema = dt
            return
        if dt > self.policy.threshold * self.ema:
            self.slow_streak += 1
        else:
            self.slow_streak = 0
            self.ema = (1 - self.policy.ema_alpha) * self.ema \
                + self.policy.ema_alpha * dt

    @property
    def should_mitigate(self) -> bool:
        """True when the patience budget of consecutive slow steps is
        exhausted — the caller should checkpoint + rebalance/evict."""
        return self.slow_streak >= self.policy.patience

    def stats(self) -> dict:
        return {"n": self.n, "ema": self.ema,
                "slow_streak": self.slow_streak,
                "last": self.history[-1] if self.history else None}
