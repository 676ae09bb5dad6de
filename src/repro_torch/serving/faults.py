"""Seeded, deterministic fault injection for the serving stack — the
torch port's own copy of ``repro.serving.faults`` (numpy only: the same
seed draws the same schedule in both packages).

The engine's fault tolerance (bucket circuit breaker, deadline
shedding, plan-cache fallback, drain/recovery — DESIGN.md §5) is only
trustworthy if every failure mode can be *forced*, reproducibly, in a
test.  ``FaultPlan`` is that seam: one seeded object injected into the
engine (``Engine(faults=...)``) and the load generator
(``run_poisson(faults=...)``, ``--chaos``) that decides — from its own
``numpy`` RNG stream, so the *traffic* streams stay bit-identical with
and without faults — when to raise.

Fault classes (``FAULT_CLASSES``):

  * ``compile_fail``  — a bucket's warmup/compile raises
    ``InjectedFault`` for its first N attempts (per-bucket countdown;
    exercises the circuit breaker + quarantine-then-recover path);
  * ``kernel_loss``   — a wave in flight loses its kernel route
    mid-decode (raises at a drawn step; exercises session reset +
    request re-route with no lost completions);
  * ``plan_cache_corrupt`` — the harness truncates/garbles the plan
    cache file before engine construction (``corrupt_json_file``;
    exercises the ``plan_policy="cache"`` → ``"auto"`` fallback);
  * ``slow_wave``     — every Nth wave reports a clock-skewed
    (inflated) wall time, driving the engine's ``est_wave_s`` up
    (exercises deadline shedding + admission control);
  * ``malformed``     — the load generator submits malformed requests
    (empty prompt, zero decode budget, unfittable prompt) *in
    addition to* the normal stream (exercises admission validation).

Determinism: decisions are drawn from ``default_rng(seed)`` in call
order, so the same seed + the same call sequence reproduces the same
fault schedule; ``log`` records every injection for assertions.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_CLASSES = ("compile_fail", "kernel_loss", "plan_cache_corrupt",
                 "slow_wave", "malformed")


class InjectedFault(RuntimeError):
    """An injected failure; ``kind`` names the fault class."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"injected fault: {kind}"
                         + (f" ({detail})" if detail else ""))
        self.kind = kind
        self.detail = detail


@dataclasses.dataclass
class WaveFaults:
    """One wave's fault schedule, drawn once at wave start."""
    fail_at_step: Optional[int] = None
    skew_s: float = 0.0


@dataclasses.dataclass
class FaultPlan:
    """Seeded fault schedule; inject into the engine and loadgen.

    ``compile_failures`` maps a bucket key (or ``"*"`` for every
    bucket) to how many consecutive warmup attempts fail before the
    bucket compiles cleanly — the countdown is per bucket, so with
    ``{"*": 2}`` every bucket fails twice, quarantines (threshold
    permitting), then recovers on its cooldown probe.
    """
    seed: int = 0
    compile_failures: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    kernel_loss_p: float = 0.0          # per-wave mid-flight loss prob.
    slow_wave_every: int = 0            # every Nth wave is slow (0: off)
    slow_wave_skew_s: float = 0.0       # wall-clock skew of a slow wave
    malformed_p: float = 0.0            # loadgen: extra bad submissions
    corrupt_plan_cache: bool = False    # harness: garble cache pre-start
    log: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._compile_left: Dict[str, int] = {}
        self._waves = 0

    @classmethod
    def chaos(cls, seed: int = 0,
              classes: Sequence[str] = FAULT_CLASSES) -> "FaultPlan":
        """The all-classes chaos schedule the sweep/CI smoke uses;
        ``classes`` narrows it (e.g. a two-class smoke)."""
        unknown = set(classes) - set(FAULT_CLASSES)
        if unknown:
            raise ValueError(f"unknown fault classes {sorted(unknown)}")
        on = set(classes)
        return cls(
            seed=seed,
            compile_failures={"*": 2} if "compile_fail" in on else {},
            kernel_loss_p=0.25 if "kernel_loss" in on else 0.0,
            slow_wave_every=3 if "slow_wave" in on else 0,
            slow_wave_skew_s=0.05 if "slow_wave" in on else 0.0,
            malformed_p=0.15 if "malformed" in on else 0.0,
            corrupt_plan_cache="plan_cache_corrupt" in on,
        )

    def _record(self, kind: str, detail: str) -> None:
        self.log.append((kind, detail))

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for kind, _ in self.log:
            out[kind] = out.get(kind, 0) + 1
        return out

    # -- engine seams ------------------------------------------------------

    def maybe_fail_compile(self, bucket_key: str) -> None:
        """Raise ``InjectedFault('compile_fail')`` while the bucket's
        countdown is positive (engine warmup calls this pre-compile)."""
        if bucket_key not in self._compile_left:
            self._compile_left[bucket_key] = self.compile_failures.get(
                bucket_key, self.compile_failures.get("*", 0))
        if self._compile_left[bucket_key] > 0:
            self._compile_left[bucket_key] -= 1
            self._record("compile_fail", bucket_key)
            raise InjectedFault("compile_fail", bucket_key)

    def begin_wave(self, bucket_key: str, max_steps: int) -> WaveFaults:
        """Draw one wave's fault schedule (call once per wave)."""
        self._waves += 1
        fail_at = None
        if self.kernel_loss_p > 0 \
                and self._rng.random() < self.kernel_loss_p:
            fail_at = int(self._rng.integers(0, max(max_steps, 1)))
            self._record("kernel_loss", f"{bucket_key}@{fail_at}")
        skew = 0.0
        if self.slow_wave_every > 0 \
                and self._waves % self.slow_wave_every == 0:
            skew = self.slow_wave_skew_s
            self._record("slow_wave", bucket_key)
        return WaveFaults(fail_at_step=fail_at, skew_s=skew)

    # -- loadgen seams -----------------------------------------------------

    def draw_malformed(self) -> bool:
        """Should the load generator inject an extra malformed
        submission at this arrival?  (Drawn from the plan's RNG so the
        normal traffic stream is untouched.)"""
        return self.malformed_p > 0 \
            and self._rng.random() < self.malformed_p

    def malformed_request(self, vocab: int,
                          too_long: int = 1 << 16) -> Tuple[tuple, int]:
        """One malformed (prompt, new_tokens): empty prompt, zero
        decode budget, or a prompt no bucket can ever hold."""
        kind = int(self._rng.integers(0, 3))
        self._record("malformed", ("empty", "zero_budget",
                                   "unfittable")[kind])
        if kind == 0:
            return (), 4
        if kind == 1:
            return (1, 2, 3), 0
        return tuple(int(t) for t in
                     self._rng.integers(0, vocab, too_long)), 4


def corrupt_json_file(path: str, seed: int = 0) -> None:
    """Deterministically garble a JSON file in place: keep a truncated
    prefix and append junk bytes — the canonical half-written-file
    corruption a crashed writer leaves behind."""
    rng = np.random.default_rng(seed)
    data = b""
    if os.path.exists(path):
        with open(path, "rb") as f:
            data = f.read()
    cut = len(data) // 2
    junk = bytes(rng.integers(0, 256, 16, dtype=np.uint8))
    with open(path, "wb") as f:
        f.write(data[:cut] + b'{"truncated' + junk)
