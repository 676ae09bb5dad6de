"""Load generator for the serving engine: Poisson open-loop and
closed-loop drivers, the serving sweep, and the chaos /
fault-tolerance sweep — torch port of ``repro.serving.loadgen``.  The
payloads keep the reference's layout (``BENCH_5``/``BENCH_7``/
``BENCH_9``-shaped); ``backend`` is the torch device type.  The model
is built from the port's seeded ``init_params`` on ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions).

Open loop (``--mode poisson``): request arrivals are a seeded Poisson
process at ``--rates`` requests/s for ``--duration`` seconds; prompt
lengths and decode budgets vary per request (seeded), so the batcher
sees genuinely heterogeneous traffic.  Arrivals that hit backpressure
are retried with seeded exponential backoff up to ``--retries`` times
(``retries=0`` is the classic drop-on-backpressure open loop);
``DeadlineInfeasible`` is never retried — the engine's admission
control already proved the deadline hopeless.  Every offered request
ends in exactly one client-side terminal outcome:

  ``ok``        completed (tokens returned);
  ``shed``      admitted, then deadline-shed by the engine;
  ``rejected``  never admitted (backpressure retries exhausted,
                infeasible deadline, or unfittable);
  ``drained``   never admitted: the engine was draining/closed.  A
                drain is terminal for the client — retrying it like
                backpressure would spin the backoff loop against an
                engine that has already said it will not admit;
  ``failed``    admitted, then terminally failed (fallback died too).

An admitted rid missing from ``engine.outcomes`` after the drain is a
**lost** request — the invariant the chaos harness sweeps is
``lost_requests == 0`` under every fault class.

Chaos mode (``--chaos``) injects a seeded ``FaultPlan`` into the
engine and the driver (extra malformed submissions ride along with —
never replace — the normal stream, so traffic is bit-identical with
and without faults) and emits the chaos payload: one point without
faults, one with, each recording p99 / tokens-per-second / shed-rate /
lost-requests / quarantine-recovery counts.

Continuous-batching mode (``--continuous``) drives identical seeded
traffic through two engines — mid-wave joins disabled vs enabled —
and emits, per rate, wave occupancy (busy-slot-steps / slot-steps),
p99, join counts, and a per-request bit-exactness audit of every
completion (joiners included) against alone-runs of the same specs.

Speculative mode (``--speculative``) first trains a checkpoint briefly
(``spec.calibrated_params``, ``--train-steps`` Adam steps on the device:
acceptance is a property of the checkpoint), then drives identical
seeded traffic through two engines — speculation off vs on — and emits,
per rate, p99, tokens per target wave, the acceptance histogram and a
per-request bit-exactness audit of both curves against plain alone-runs.

Closed loop (``--mode closed``): ``--users`` concurrent clients, each
submitting its next request the moment the previous one completes —
the throughput-saturation view.

  PYTHONPATH=src python -m repro_torch.serving.loadgen \
      --arch tinyllama-1.1b --smoke --rates 30,90 --duration 1.0
  PYTHONPATH=src python -m repro_torch.serving.loadgen \
      --arch tinyllama-1.1b --smoke --chaos --device cpu
  PYTHONPATH=src python -m repro_torch.serving.loadgen \
      --arch tinyllama-1.1b --smoke --speculative --rates 60 --device cpu
"""
from __future__ import annotations

import argparse
import heapq
import os
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .engine import (Backpressure, Engine, EngineDraining,
                     PLAN_POLICIES)
from .faults import FAULT_CLASSES, FaultPlan, corrupt_json_file
from .metrics import write_snapshot
from .queue import BucketShape, DeadlineInfeasible


def poisson_arrivals(rate_per_s: float, duration_s: float,
                     rng: np.random.Generator) -> List[float]:
    t, out = 0.0, []
    while True:
        t += float(rng.exponential(1.0 / rate_per_s))
        if t >= duration_s:
            return out
        out.append(t)


def _request_specs(n: int, vocab: int, prompt_len: int, new_tokens: int,
                   rng: np.random.Generator):
    """Heterogeneous request stream: prompt lengths in
    [prompt_len/2, prompt_len], decode budgets in
    [new_tokens/2, new_tokens] (seeded, so runs are reproducible)."""
    specs = []
    for _ in range(n):
        pl = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        nt = int(rng.integers(max(1, new_tokens // 2), new_tokens + 1))
        specs.append((tuple(int(t) for t in rng.integers(0, vocab, pl)),
                      nt))
    return specs


def run_poisson(engine: Engine, *, rate: float, duration_s: float,
                prompt_len: int, new_tokens: int,
                rng: np.random.Generator,
                slo_s: Optional[float] = None,
                retries: int = 0, backoff_s: float = 0.01,
                faults: Optional[FaultPlan] = None,
                admitted_out: Optional[Dict[int, int]] = None,
                sleep=time.sleep) -> Dict[str, Any]:
    """Drive one engine with a Poisson arrival process; returns the
    metrics snapshot (plus the client-side outcome ledger) after the
    queue fully drains.

    Arrivals and specs are pre-drawn from ``rng`` before any
    fault-plan draw, so the offered traffic is bit-identical with and
    without ``faults``; malformed chaos submissions are *extra*
    requests on top of the stream, not replacements.  The latency
    clock of every submission — including retried ones — runs from the
    request's *scheduled arrival*, not from whenever a wave let this
    loop run or a retry finally got admitted: a busy engine cannot
    hide its own queueing delay (coordinated omission).
    """
    vocab = engine.cfg.vocab
    arrivals = poisson_arrivals(rate, duration_s, rng)
    specs = _request_specs(len(arrivals), vocab, prompt_len, new_tokens,
                           rng)
    t0 = engine.clock()
    # submission events: (due, tiebreak, request index, attempt)
    events = [(at, i, i, 0) for i, at in enumerate(arrivals)]
    heapq.heapify(events)
    seq = len(arrivals)
    outcomes: Dict[int, str] = {}       # client-side terminal outcome
    admitted: Dict[int, int] = {}       # request index -> engine rid
    unfittable = 0
    retried = 0
    malformed_sent = 0
    while events or engine.depth():
        now = engine.clock() - t0
        while events and events[0][0] <= now:
            _, _, idx, attempt = heapq.heappop(events)
            prompt, nt = specs[idx]
            if attempt == 0 and faults is not None \
                    and faults.draw_malformed():
                # chaos: an EXTRA malformed submission rides along
                bad_prompt, bad_nt = faults.malformed_request(vocab)
                malformed_sent += 1
                try:
                    engine.submit(bad_prompt, bad_nt)
                except (ValueError, Backpressure):
                    pass                # rejected cleanly — the point
            # latency and deadline run from the *scheduled arrival*
            arrived = t0 + arrivals[idx]
            try:
                admitted[idx] = engine.submit(
                    prompt, nt, submit_t=arrived,
                    deadline=(arrived + slo_s) if slo_s else None)
            except DeadlineInfeasible:  # admission control: no retry
                outcomes[idx] = "rejected"
            except EngineDraining:
                # a draining engine will NOT admit until the drain
                # ends — distinct terminal outcome, never retried
                # (EngineDraining subclasses Backpressure, so this
                # arm must precede the retry arm below)
                outcomes[idx] = "drained"
            except Backpressure:
                if attempt < retries:   # seeded exponential backoff
                    delay = backoff_s * (2 ** attempt) \
                        * (1.0 + float(rng.random()))
                    heapq.heappush(events,
                                   (now + delay, seq, idx, attempt + 1))
                    seq += 1
                    retried += 1
                else:
                    outcomes[idx] = "rejected"
            except ValueError:          # no bucket could ever fit it
                unfittable += 1
                outcomes[idx] = "rejected"
        if engine.step() or engine.busy():
            # progress was made, or a wave is mid-flight (resumable
            # waves return between iterations so due arrivals can join
            # freed slots) — loop straight back, never sleep
            continue
        if events:                      # idle until the next event
            wait = events[0][0] - (engine.clock() - t0)
            if wait > 0:
                sleep(min(wait, 5e-3))
        elif engine.depth():
            engine.step(force=True)     # tail drain: partial buckets
    if admitted_out is not None:        # request index -> engine rid
        admitted_out.update(admitted)   # (bit-exactness verification)
    # resolve admitted requests against the engine's outcome ledger;
    # an admitted rid with no terminal outcome was LOST (must be 0)
    lost = 0
    for idx, rid in admitted.items():
        o = engine.outcomes.get(rid)
        if o is None:
            lost += 1
            outcomes[idx] = "lost"
        else:
            outcomes[idx] = o["outcome"]
    counts = {"ok": 0, "shed": 0, "rejected": 0, "drained": 0,
              "failed": 0, "lost": 0}
    for o in outcomes.values():
        counts[o] += 1
    snap = engine.metrics.snapshot()
    snap["offered_requests"] = len(arrivals)
    snap["offered_rate_per_s"] = rate
    snap["unfittable_requests"] = unfittable
    snap["client_outcomes"] = counts
    snap["lost_requests"] = lost
    snap["retried_submissions"] = retried
    snap["malformed_submitted"] = malformed_sent
    snap["bucket_health"] = engine.bucket_health()
    return snap


def run_closed_loop(engine: Engine, *, users: int, rounds: int,
                    prompt_len: int, new_tokens: int,
                    rng: np.random.Generator) -> Dict[str, Any]:
    """Closed loop: every round, each user submits one request as soon
    as the previous round completed; the engine drains between rounds
    (a synchronous engine's equivalent of think-time-zero clients)."""
    vocab = engine.cfg.vocab
    total = 0
    unfittable = 0
    for _ in range(rounds):
        for prompt, nt in _request_specs(users, vocab, prompt_len,
                                         new_tokens, rng):
            total += 1
            try:
                engine.submit(prompt, nt)
            except Backpressure:
                pass
            except ValueError:
                unfittable += 1
        engine.drain()
    snap = engine.metrics.snapshot()
    snap["offered_requests"] = total
    snap["closed_loop_users"] = users
    snap["unfittable_requests"] = unfittable
    return snap


def _model(arch: str, smoke: bool, device):
    """(config, seeded float parameters on ``device``, the device)."""
    from ..configs.registry import get_arch
    from ..device import resolve_device
    from ..models import init_params

    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    return cfg, init_params(cfg, seed=0, device=dev), dev


# ---------------------------------------------------------------------------
# the BENCH_5 sweep
# ---------------------------------------------------------------------------

def bench_serving(arch: str, *, smoke: bool, rates: Sequence[float],
                  duration_s: float, computes: Sequence[str],
                  prompt_len: int, new_tokens: int, batch: int,
                  s_maxes: Sequence[int], weight_bits: int, act_bits: int,
                  plan_policy: Optional[str], plan_cache: Optional[str],
                  slo_ms: Optional[float], seed: int,
                  mode: str = "poisson", users: int = 8,
                  rounds: int = 2, retries: int = 0,
                  device="cuda") -> Dict[str, Any]:
    cfg, params, dev = _model(arch, smoke, device)
    buckets = tuple(BucketShape(batch, s) for s in s_maxes)

    curves: List[Dict[str, Any]] = []
    bucket_plans: Dict[str, Any] = {}
    resolved_policy = None
    for compute in computes:
        for ri, rate in enumerate(rates):
            engine = Engine(cfg, params, compute=compute,
                            weight_bits=weight_bits, act_bits=act_bits,
                            plan_policy=plan_policy,
                            plan_cache=plan_cache, buckets=buckets,
                            device=dev)
            for b in buckets:      # steady-state curves: compile cost
                engine.warmup(b)   # is not charged to early requests
            rng = np.random.default_rng(seed + ri)   # same stream per
            if mode == "closed":                     # compute mode
                snap = run_closed_loop(engine, users=users, rounds=rounds,
                                       prompt_len=prompt_len,
                                       new_tokens=new_tokens, rng=rng)
            else:
                snap = run_poisson(engine, rate=rate,
                                   duration_s=duration_s,
                                   prompt_len=prompt_len,
                                   new_tokens=new_tokens, rng=rng,
                                   slo_s=(slo_ms / 1e3) if slo_ms
                                   else None, retries=retries)
            curves.append({"compute": compute, "rate_per_s": rate,
                           **snap})
            if compute == "sdv":
                resolved_policy = engine.plan_policy
                for key, util in engine.plan_report().items():
                    bucket_plans.setdefault(key, util)

    return {
        "bench": "serving_engine",
        "arch": cfg.name,
        "smoke": smoke,
        "mode": mode,
        "backend": dev.type,
        "buckets": [{"batch": b.batch, "s_max": b.s_max} for b in buckets],
        "weight_bits": weight_bits,
        "act_bits": act_bits,
        "plan_policy": resolved_policy,
        "computes": list(computes),
        "rates_per_s": list(rates),
        "duration_s": duration_s,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "curves": curves,
        "bucket_plans": bucket_plans,
    }


# ---------------------------------------------------------------------------
# the BENCH_7 chaos sweep (fault tolerance)
# ---------------------------------------------------------------------------

def bench_fault_tolerance(arch: str, *, smoke: bool = True,
                          rate: float = 60.0, duration_s: float = 1.0,
                          prompt_len: int = 8, new_tokens: int = 8,
                          batch: int = 4, s_maxes: Sequence[int] = (24, 48),
                          weight_bits: int = 4, act_bits: int = 8,
                          slo_ms: float = 4000.0, seed: int = 0,
                          fault_classes: Sequence[str] = FAULT_CLASSES,
                          retries: int = 3, backoff_s: float = 0.01,
                          breaker_threshold: int = 2,
                          breaker_cooldown_s: float = 0.2,
                          device="cuda") -> Dict[str, Any]:
    """Identical seeded Poisson traffic with and without an injected
    ``FaultPlan.chaos`` schedule; each point records p99 latency,
    tokens/s, shed rate, lost requests (the zero-loss invariant) and
    quarantine/recovery counts.  The chaos engine's buckets are
    deliberately NOT prewarmed — the first wave per bucket is where
    ``compile_fail`` injections land, exercising the circuit breaker
    end to end (only the degraded fallback path is compiled up front,
    as a real deployment would); the
    ``plan_cache_corrupt`` class garbles a throwaway cache file and
    asserts the engine demoted ``plan_policy="cache"`` to ``"auto"``
    instead of dying."""
    cfg, params, dev = _model(arch, smoke, device)
    buckets = tuple(BucketShape(batch, s) for s in s_maxes)

    points: List[Dict[str, Any]] = []
    fault_log: Dict[str, int] = {}
    for with_faults in (False, True):
        faults = FaultPlan.chaos(seed, fault_classes) if with_faults \
            else None
        plan_policy: Optional[str] = None
        plan_cache: Optional[str] = None
        cache_demoted = False
        with tempfile.TemporaryDirectory() as td:
            if faults is not None and faults.corrupt_plan_cache:
                plan_cache = os.path.join(td, "plans.json")
                with open(plan_cache, "w") as f:
                    f.write('{"version": 1, "entries": {}}')
                corrupt_json_file(plan_cache, seed)
                plan_policy = "cache"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                engine = Engine(cfg, params, compute="sdv",
                                weight_bits=weight_bits,
                                act_bits=act_bits,
                                plan_policy=plan_policy,
                                plan_cache=plan_cache, buckets=buckets,
                                breaker_threshold=breaker_threshold,
                                breaker_cooldown_s=breaker_cooldown_s,
                                faults=faults, device=dev)
            if plan_policy == "cache":
                cache_demoted = engine.plan_policy == "auto" \
                    and any("plan cache unusable" in str(w.message)
                            for w in caught)
            if faults is None:
                for b in buckets:       # fault-free baseline: steady
                    engine.warmup(b)    # state, compile not charged
            else:
                # the chaos engine's buckets stay cold (compile_fail
                # lands in their first warmup) but its last line of
                # defense is compiled now — a fallback that JITs in
                # the middle of an outage sheds the whole backlog
                engine.prewarm_fallback()
            snap = run_poisson(
                engine, rate=rate, duration_s=duration_s,
                prompt_len=prompt_len, new_tokens=new_tokens,
                rng=np.random.default_rng(seed),    # same traffic
                slo_s=slo_ms / 1e3, retries=retries,
                backoff_s=backoff_s, faults=faults)
        if faults is not None:
            fault_log = faults.counts()
        points.append({
            **snap,
            # the metrics snapshot's own "faults" sub-dict moves to
            # "fault_counters"; "faults" here is the point's flag
            "fault_counters": snap["faults"],
            "faults": with_faults,
            "p99_ms": snap["latency"]["p99_ms"],
            "tokens_per_s": snap["tokens_per_s"],
            "shed_rate": snap["shed_rate"],
            "lost_requests": snap["lost_requests"],
            "quarantines": snap["faults"]["quarantines"],
            "recoveries": snap["faults"]["recoveries"],
            "plan_cache_demoted": cache_demoted,
        })

    return {
        "bench": "fault_tolerance",
        "arch": cfg.name,
        "smoke": smoke,
        "backend": dev.type,
        "buckets": [{"batch": b.batch, "s_max": b.s_max} for b in buckets],
        "rate_per_s": rate,
        "duration_s": duration_s,
        "slo_ms": slo_ms,
        "seed": seed,
        "fault_classes": list(fault_classes),
        "fault_injections": fault_log,
        "retries": retries,
        "points": points,
    }


# ---------------------------------------------------------------------------
# the BENCH_9 continuous-batching sweep (mid-wave joins)
# ---------------------------------------------------------------------------

def bench_continuous(arch: str, *, smoke: bool = True,
                     rates: Sequence[float] = (150.0, 240.0),
                     duration_s: float = 1.0, prompt_len: int = 8,
                     new_tokens: int = 8, batch: int = 4,
                     s_maxes: Sequence[int] = (24, 48),
                     weight_bits: int = 4, act_bits: int = 8,
                     prefill_chunk: int = 4, wave_quantum: int = 1,
                     seed: int = 0, verify: bool = True,
                     device="cuda") -> Dict[str, Any]:
    """Identical seeded Poisson traffic with mid-wave joins disabled
    vs enabled; each point records p99 latency and wave occupancy
    (busy-slot-steps / slot-steps).  With joins off, a slot freed by a
    short request idles until the whole wave retires; with joins on,
    ``step()`` pulls the oldest fitting queued request into the freed
    slot every iteration, so occupancy rises and queueing-dominated
    p99 falls at rates that keep the queue non-empty.

    When ``verify`` is set, every completed request's tokens — joiners
    included — are compared against an alone-run of the same (prompt,
    new_tokens) spec on a fresh engine: the continuous-batching path
    must be bit-exact, not merely close (``bit_exact_mismatches``
    must be 0).  Alone-runs are cached per spec."""
    cfg, params, dev = _model(arch, smoke, device)
    buckets = tuple(BucketShape(batch, s) for s in s_maxes)

    # one verify engine reused across all points; each distinct spec
    # costs one alone-run (submit + forced drain of a 1-deep queue)
    verify_engine: Optional[Engine] = None
    alone_cache: Dict[Any, Optional[tuple]] = {}

    def alone_tokens(prompt, nt):
        nonlocal verify_engine
        key = (prompt, nt)
        if key in alone_cache:
            return alone_cache[key]
        if verify_engine is None:
            verify_engine = Engine(
                cfg, params, compute="sdv", weight_bits=weight_bits,
                act_bits=act_bits, buckets=buckets,
                midwave_joins=False, prefill_chunk=prefill_chunk,
                device=dev)
            for b in buckets:
                verify_engine.warmup(b)
        rid = verify_engine.submit(prompt, nt)
        verify_engine.drain()
        toks = next((tuple(c.tokens) for c in verify_engine.completions
                     if c.rid == rid), None)
        alone_cache[key] = toks
        return toks

    points: List[Dict[str, Any]] = []
    for ri, rate in enumerate(rates):
        # regenerate the offered trace the driver will draw: arrivals
        # first, then specs, from the same seeded generator — this is
        # the idx -> (prompt, new_tokens) map the verifier needs
        trace_rng = np.random.default_rng(seed + ri)
        arrivals = poisson_arrivals(rate, duration_s, trace_rng)
        specs = _request_specs(len(arrivals), cfg.vocab, prompt_len,
                               new_tokens, trace_rng)
        for joins in (False, True):
            engine = Engine(cfg, params, compute="sdv",
                            weight_bits=weight_bits, act_bits=act_bits,
                            buckets=buckets, midwave_joins=joins,
                            prefill_chunk=prefill_chunk,
                            wave_quantum=wave_quantum, device=dev)
            for b in buckets:       # steady state: compile cost is
                engine.warmup(b)    # not charged to early requests
            admitted: Dict[int, int] = {}
            snap = run_poisson(engine, rate=rate, duration_s=duration_s,
                               prompt_len=prompt_len,
                               new_tokens=new_tokens,
                               rng=np.random.default_rng(seed + ri),
                               admitted_out=admitted)
            checked = midwave_checked = mismatches = 0
            if verify:
                by_rid = {c.rid: c for c in engine.completions}
                for idx, rid in sorted(admitted.items()):
                    o = engine.outcomes.get(rid)
                    if o is None or o["outcome"] != "ok":
                        continue
                    comp = by_rid.get(rid)
                    checked += 1
                    if comp is None:
                        mismatches += 1
                        continue
                    if comp.midwave_join:
                        midwave_checked += 1
                    ref = alone_tokens(*specs[idx])
                    if ref is None or tuple(comp.tokens) != ref:
                        mismatches += 1
            points.append({
                **snap,
                "midwave_joins": joins,
                "rate_per_s": rate,
                "p99_ms": snap["latency"]["p99_ms"],
                "occupancy": snap["waves"]["occupancy"],
                "joins": snap["waves"]["midwave_joins"],
                "tokens_per_s": snap["tokens_per_s"],
                "bit_exact_checked": checked,
                "bit_exact_midwave_checked": midwave_checked,
                "bit_exact_mismatches": mismatches,
            })

    return {
        "bench": "continuous_batching",
        "arch": cfg.name,
        "smoke": smoke,
        "backend": dev.type,
        "buckets": [{"batch": b.batch, "s_max": b.s_max} for b in buckets],
        "rates_per_s": list(rates),
        "duration_s": duration_s,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "prefill_chunk": prefill_chunk,
        "wave_quantum": wave_quantum,
        "seed": seed,
        "bit_exact_verified": verify,
        "points": points,
    }


# ---------------------------------------------------------------------------
# the BENCH_10 speculative-decoding sweep
# ---------------------------------------------------------------------------

def bench_speculative(arch: str, *, smoke: bool = True,
                      rates: Sequence[float] = (60.0, 120.0, 200.0),
                      duration_s: float = 1.0, prompt_len: int = 8,
                      new_tokens: int = 12, batch: int = 4,
                      s_maxes: Sequence[int] = (24, 48),
                      weight_bits: int = 4, act_bits: int = 8,
                      spec_k: int = 3, draft_bits: int = 4,
                      draft_act_bits: int = 4, prefill_chunk: int = 4,
                      train_steps: int = 350, seed: int = 0,
                      verify: bool = True, trials: int = 1,
                      device="cuda") -> Dict[str, Any]:
    """Identical seeded Poisson traffic through two engines —
    speculation off vs on — at every rate (BENCH_10-shaped).

    The checkpoint is *briefly trained* first
    (``spec.calibrated_params`` on ``device``): acceptance is a
    checkpoint property, and a random-init model's near-tied logits mean
    the low-bit draft almost never agrees with the target.  Each point
    records p99, effective tokens per target wave (every verify round
    and every plain decode launch counts as one target wave), the
    acceptance-length histogram, and — with ``verify`` — a per-request
    alone-run bit-exactness audit of every ok completion on BOTH curves
    against a fresh non-speculative engine (mismatches must be 0).  The
    payload also carries the per-layer target-vs-draft plan table.

    ``trials`` > 1 repeats every rate point as PAIRED trials (plain then
    spec back to back on the identical trace); the representative pair
    is the one with the median spec/plain p99 ratio, and the audits are
    pooled across trials."""
    from ..configs.registry import get_arch
    from ..device import resolve_device
    from .spec import calibrated_params

    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    params = calibrated_params(cfg, steps=train_steps, seed=seed,
                               device=dev)
    buckets = tuple(BucketShape(batch, s) for s in s_maxes)

    verify_engine: Optional[Engine] = None
    alone_cache: Dict[Any, Optional[tuple]] = {}

    def alone_tokens(prompt, nt):
        nonlocal verify_engine
        key = (prompt, nt)
        if key in alone_cache:
            return alone_cache[key]
        if verify_engine is None:
            # the reference is always NON-speculative: both curves
            # audit against plain decode
            verify_engine = Engine(
                cfg, params, compute="sdv", weight_bits=weight_bits,
                act_bits=act_bits, buckets=buckets,
                midwave_joins=False, prefill_chunk=prefill_chunk,
                device=dev)
            for b in buckets:
                verify_engine.warmup(b)
        rid = verify_engine.submit(prompt, nt)
        verify_engine.drain()
        toks = next((tuple(c.tokens) for c in verify_engine.completions
                     if c.rid == rid), None)
        alone_cache[key] = toks
        return toks

    points: List[Dict[str, Any]] = []
    plan_table: Dict[str, Any] = {}
    for ri, rate in enumerate(rates):
        trace_rng = np.random.default_rng(seed + ri)
        arrivals = poisson_arrivals(rate, duration_s, trace_rng)
        specs = _request_specs(len(arrivals), cfg.vocab, prompt_len,
                               new_tokens, trace_rng)
        pairs: List[Dict[bool, Dict[str, Any]]] = []
        audit = {False: [0, 0], True: [0, 0]}  # checked, mismatches
        for _ in range(max(trials, 1)):
            pair: Dict[bool, Dict[str, Any]] = {}
            for speculative in (False, True):
                engine = Engine(cfg, params, compute="sdv",
                                weight_bits=weight_bits,
                                act_bits=act_bits, buckets=buckets,
                                prefill_chunk=prefill_chunk,
                                speculative=speculative, spec_k=spec_k,
                                draft_bits=draft_bits,
                                draft_act_bits=draft_act_bits, device=dev)
                for b in buckets:    # steady state: kernel builds are
                    engine.warmup(b)  # not charged to early requests
                admitted: Dict[int, int] = {}
                snap = run_poisson(engine, rate=rate,
                                   duration_s=duration_s,
                                   prompt_len=prompt_len,
                                   new_tokens=new_tokens,
                                   rng=np.random.default_rng(seed + ri),
                                   admitted_out=admitted)
                if verify:
                    by_rid = {c.rid: c for c in engine.completions}
                    for idx, rid in sorted(admitted.items()):
                        o = engine.outcomes.get(rid)
                        if o is None or o["outcome"] != "ok":
                            continue
                        comp = by_rid.get(rid)
                        audit[speculative][0] += 1
                        if comp is None:
                            audit[speculative][1] += 1
                            continue
                        ref = alone_tokens(*specs[idx])
                        if ref is None or tuple(comp.tokens) != ref:
                            audit[speculative][1] += 1
                if speculative and not plan_table:
                    plan_table = engine.spec_report()
                pair[speculative] = snap
            pairs.append(pair)

        def _ratio(p: Dict[bool, Dict[str, Any]]) -> float:
            off = max(p[False]["latency"]["p99_ms"], 1e-9)
            return p[True]["latency"]["p99_ms"] / off
        order = sorted(pairs, key=_ratio)
        rep = order[(len(order) - 1) // 2]
        for speculative in (False, True):
            snap = rep[speculative]
            sp = snap["speculative"]
            points.append({
                **snap,
                # the metrics snapshot's "speculative" sub-dict stays
                # under that key; this level's flag names the curve
                "speculative": speculative,
                "spec_counters": sp,
                "rate_per_s": rate,
                "p99_ms": snap["latency"]["p99_ms"],
                "p99_ms_trials": [p[speculative]["latency"]["p99_ms"]
                                  for p in pairs],
                "tokens_per_s": snap["tokens_per_s"],
                "tokens_per_target_wave": sp["tokens_per_target_wave"],
                "mean_accepted": sp["mean_accepted"],
                "acceptance_hist": sp["acceptance_hist"],
                "spec_degraded": sp["degraded_buckets"],
                "bit_exact_checked": audit[speculative][0],
                "bit_exact_mismatches": audit[speculative][1],
            })

    return {
        "bench": "speculative_decoding",
        "arch": cfg.name,
        "smoke": smoke,
        "backend": dev.type,
        "buckets": [{"batch": b.batch, "s_max": b.s_max} for b in buckets],
        "rates_per_s": list(rates),
        "duration_s": duration_s,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "prefill_chunk": prefill_chunk,
        "spec_k": spec_k,
        "target_bits": {"w": weight_bits, "a": act_bits},
        "draft_bits": {"w": draft_bits, "a": draft_act_bits},
        "calibration_steps": train_steps,
        "trials": max(trials, 1),
        "seed": seed,
        "bit_exact_verified": verify,
        "plan_table": plan_table,
        "points": points,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (--no-smoke runs full size)")
    ap.add_argument("--rates", default="30,90",
                    help="comma-separated arrival rates (requests/s)")
    ap.add_argument("--duration", type=float, default=1.0,
                    help="seconds of offered load per rate point")
    ap.add_argument("--computes", default="sdv,memory")
    ap.add_argument("--mode", choices=("poisson", "closed"),
                    default="poisson")
    ap.add_argument("--users", type=int, default=8,
                    help="closed-loop concurrent clients")
    ap.add_argument("--rounds", type=int, default=2,
                    help="closed-loop rounds per client")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="bucket batch width (KV slots per wave)")
    ap.add_argument("--buckets", default="24,48",
                    help="comma-separated bucket s_max ladder")
    ap.add_argument("--weight-bits", type=int, default=4)
    ap.add_argument("--act-bits", type=int, default=8)
    ap.add_argument("--plan-policy", choices=PLAN_POLICIES, default=None,
                    help="default: cache when a plan-cache file exists, "
                         "else auto (the engine default)")
    ap.add_argument("--plan-cache", default=None)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request deadline (submit + slo)")
    ap.add_argument("--retries", type=int, default=0,
                    help="backpressure retries per request (seeded "
                         "exponential backoff)")
    ap.add_argument("--chaos", action="store_true",
                    help="fault-tolerance sweep: identical traffic with "
                         "and without injected faults (BENCH_7)")
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching sweep: identical traffic "
                         "with mid-wave joins off vs on (BENCH_9); use "
                         "--rates above the BENCH_5 sweep, e.g. 150,240")
    ap.add_argument("--prefill-chunk", type=int, default=4,
                    help="teacher-forced prompt tokens per prefill "
                         "iteration (continuous sweep)")
    ap.add_argument("--speculative", action="store_true",
                    help="speculative-decoding sweep: identical traffic "
                         "with speculation off vs on (BENCH_10); the "
                         "checkpoint is briefly trained first so the "
                         "draft has something to agree with")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="drafted tokens per verification wave")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="draft weight bits (self-speculation)")
    ap.add_argument("--draft-act-bits", type=int, default=4,
                    help="draft activation bits — the knob that buys "
                         "packing density (see serving.spec)")
    ap.add_argument("--train-steps", type=int, default=350,
                    help="calibration Adam steps before the "
                         "speculative sweep")
    ap.add_argument("--trials", type=int, default=1,
                    help="paired repeats per speculative-sweep rate: "
                         "each trial runs plain+spec back to back; "
                         "the median-p99-ratio pair represents the "
                         "point (audits are pooled)")
    ap.add_argument("--no-verify", dest="verify", action="store_false",
                    help="skip the per-request alone-run bit-exactness "
                         "check in the continuous and speculative "
                         "sweeps")
    ap.add_argument("--fault-classes", default=",".join(FAULT_CLASSES),
                    help="comma-separated chaos fault classes")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--json", default=None,
                    help="write the payload to this path (atomic)")
    args = ap.parse_args(argv)

    if args.speculative:
        payload = bench_speculative(
            args.arch, smoke=args.smoke,
            rates=[float(r) for r in args.rates.split(",") if r],
            duration_s=args.duration,
            prompt_len=args.prompt_len, new_tokens=args.new_tokens,
            batch=args.batch,
            s_maxes=[int(s) for s in args.buckets.split(",") if s],
            weight_bits=args.weight_bits, act_bits=args.act_bits,
            spec_k=args.spec_k, draft_bits=args.draft_bits,
            draft_act_bits=args.draft_act_bits,
            prefill_chunk=args.prefill_chunk,
            train_steps=args.train_steps, seed=args.seed,
            verify=args.verify, trials=args.trials, device=args.device)
        for p in payload["points"]:
            tag = "spec  " if p["speculative"] else "plain "
            print(f"{tag}@ {p['rate_per_s']:6.1f} req/s: "
                  f"{p['requests_completed']} done, "
                  f"tok/target-wave {p['tokens_per_target_wave']:.2f}, "
                  f"mean accepted {p['mean_accepted']:.2f}, "
                  f"p99 {p['p99_ms']:.1f} ms, "
                  f"{p['tokens_per_s']:.1f} tok/s, "
                  f"bit-exact {p['bit_exact_checked']} checked / "
                  f"{p['bit_exact_mismatches']} mismatches")
        for key, rep in payload["plan_table"].items():
            denser = sum(1 for l in rep["layers"] if l["draft_denser"])
            print(f"bucket {key}: spec_on={rep['spec_on']}, "
                  f"{denser}/{len(rep['layers'])} draft layers "
                  f"strictly denser")
    elif args.continuous:
        payload = bench_continuous(
            args.arch, smoke=args.smoke,
            rates=[float(r) for r in args.rates.split(",") if r],
            duration_s=args.duration,
            prompt_len=args.prompt_len, new_tokens=args.new_tokens,
            batch=args.batch,
            s_maxes=[int(s) for s in args.buckets.split(",") if s],
            weight_bits=args.weight_bits, act_bits=args.act_bits,
            prefill_chunk=args.prefill_chunk, seed=args.seed,
            verify=args.verify, device=args.device)
        for p in payload["points"]:
            tag = "joins " if p["midwave_joins"] else "solo  "
            print(f"{tag}@ {p['rate_per_s']:6.1f} req/s: "
                  f"{p['requests_completed']} done, "
                  f"{p['joins']} mid-wave joins, "
                  f"occupancy {p['occupancy']:.3f}, "
                  f"p99 {p['p99_ms']:.1f} ms, "
                  f"{p['tokens_per_s']:.1f} tok/s, "
                  f"bit-exact {p['bit_exact_checked']} checked "
                  f"({p['bit_exact_midwave_checked']} joiners) / "
                  f"{p['bit_exact_mismatches']} mismatches")
    elif args.chaos:
        payload = bench_fault_tolerance(
            args.arch, smoke=args.smoke,
            rate=[float(r) for r in args.rates.split(",") if r][0],
            duration_s=args.duration,
            prompt_len=args.prompt_len, new_tokens=args.new_tokens,
            batch=args.batch,
            s_maxes=[int(s) for s in args.buckets.split(",") if s],
            weight_bits=args.weight_bits, act_bits=args.act_bits,
            slo_ms=args.slo_ms if args.slo_ms else 4000.0,
            seed=args.seed,
            fault_classes=[c for c in args.fault_classes.split(",") if c],
            retries=args.retries or 3, device=args.device)
        for p in payload["points"]:
            tag = "chaos " if p["faults"] else "clean "
            print(f"{tag}@ {payload['rate_per_s']:6.1f} req/s: "
                  f"{p['requests_completed']} done, "
                  f"{p['client_outcomes']['shed']} shed, "
                  f"{p['client_outcomes']['rejected']} rejected, "
                  f"{p['lost_requests']} LOST, "
                  f"p99 {p['p99_ms']:.1f} ms, "
                  f"{p['tokens_per_s']:.1f} tok/s, "
                  f"{p['quarantines']} quarantines / "
                  f"{p['recoveries']} recoveries")
        print(f"fault injections: {payload['fault_injections']}")
    else:
        payload = bench_serving(
            args.arch, smoke=args.smoke,
            rates=[float(r) for r in args.rates.split(",") if r],
            duration_s=args.duration,
            computes=[c for c in args.computes.split(",") if c],
            prompt_len=args.prompt_len, new_tokens=args.new_tokens,
            batch=args.batch,
            s_maxes=[int(s) for s in args.buckets.split(",") if s],
            weight_bits=args.weight_bits, act_bits=args.act_bits,
            plan_policy=args.plan_policy, plan_cache=args.plan_cache,
            slo_ms=args.slo_ms, seed=args.seed, mode=args.mode,
            users=args.users, rounds=args.rounds, retries=args.retries,
            device=args.device)

        for c in payload["curves"]:
            print(f"{c['compute']:>6} @ {c['rate_per_s']:6.1f} req/s: "
                  f"{c['requests_completed']} done, "
                  f"{c['requests_rejected']} shed, "
                  f"p50 {c['latency']['p50_ms']:.1f} ms, "
                  f"p99 {c['latency']['p99_ms']:.1f} ms, "
                  f"{c['tokens_per_s']:.1f} tok/s")
        for key, util in payload["bucket_plans"].items():
            print(f"bucket {key}: {util['kernel_routed_layers']}/"
                  f"{util['packed_layers']} packed layers on kernel "
                  f"routes, density {util['density_achieved']:.2f} "
                  f"MACs/multiply")
    if args.json:
        write_snapshot(args.json, payload)
        print(f"wrote {args.json}")
    return payload


if __name__ == "__main__":
    main()
