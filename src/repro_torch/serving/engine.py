"""Online inference engine: planner-bucketed packed decode with
layered fault tolerance — torch port of ``repro.serving.engine``.

The engine owns the path from "a request arrived" to "planner-chosen
packed kernels execute at high occupancy":

  * a ``ContinuousBatcher`` (``queue.py``) coalesces heterogeneous
    traffic into the engine's bucket shapes;
  * per (arch, bucket) the engine resolves lane plans through the
    mixed-precision planner — ``serve_params(plan_policy=...,
    rows=bucket.batch)`` so every bucket is planned for the batch
    shape it actually runs — memoized per batch width, warms the
    decode step up once per bucket shape (``warmup``), and keeps the
    bucket's KV cache + decode session table alive across waves;
  * a ``SessionTable`` maps requests to KV-cache slots: joining
    requests take the lowest free slot, finished requests free their
    slot mid-wave, and — because the cache carries a *per-slot*
    position vector ``index[B]`` (``models.init_cache``) — a freed
    slot is reset (``models.reset_slot``) and handed to the next
    queued request **mid-wave**: token-level continuous batching
    (vLLM/Orca iteration-level scheduling, DESIGN.md §5).  Waves are
    resumable: ``step()`` advances the active wave by a bounded
    quantum of iterations and pulls fitting queued requests into
    freed slots every iteration, so arrivals between steps join the
    running wave instead of waiting for the next boundary;
  * prompt replay is split from decode: KV-cache families
    (dense/moe/vlm) replay prompts through a chunked *prefill step*
    (``models.prefill_slot``, ``prefill_chunk`` teacher-forced tokens
    per slot per iteration), and prefill piggybacks on decode — both
    run in the same iteration on disjoint slots, the decode advance
    mask freezing mid-prefill slots — so a joiner replays its prompt
    in ceil(P/C) iterations without ever stalling its decoding
    neighbours; recurrent-state families (ssm/hybrid) replay
    token-at-a-time through ``decode_step``.  Prefill and decode step
    times feed *separate* EMAs — admission control estimates from the
    decode EMA of the request's own bucket, never a prefill-skewed
    global max.

Failure is a *bucket-local* event, never process death (the kernel
dispatch's kernel-route → ref-route layering, lifted to the engine):

  * **circuit breaker** — each bucket carries a health state
    (``healthy → quarantined → probing → healthy``).
    ``breaker_threshold`` consecutive wave/warmup failures quarantine
    the bucket: its queued requests re-route to the nearest healthy
    bucket (``batcher.enqueue``) or, when only quarantined shapes
    fit, to the engine's degraded single-request fallback state
    (uniform default plans — no planner, no cache — the most robust
    configuration).  After ``breaker_cooldown_s`` the bucket turns
    ``probing``: it re-enters assignment and its next wave is the
    probe — success restores ``healthy``, failure re-quarantines.
    A wave that fails mid-flight keeps the completions it already
    produced and re-queues the unfinished requests (decode is
    deterministic, so a retried request yields bit-identical tokens).
  * **deadline shedding + admission control** — expired queued
    requests are shed with a ``deadline_exceeded`` outcome before
    burning a wave slot; ``submit`` rejects deadlines that cannot
    survive one estimated wave (``DeadlineInfeasible``).
  * **plan-cache degradation** — a corrupt/unreadable plan cache
    demotes ``plan_policy="cache"`` to ``"auto"`` with a warning
    instead of raising.
  * **terminal outcomes** — every admitted request ends in exactly
    one of ``ok | shed | failed`` (``Engine.outcomes``); rejected
    submissions never enter the ledger.  Zero lost requests is an
    invariant the chaos tests sweep (``tests/test_torch_serving.py``).
  * **drain / recovery** — ``drain()`` finishes queued work without
    admitting (``EngineDraining``); ``snapshot()``/``restore()``
    round-trip the queue + rid state through JSON so a restarted
    engine resumes exactly where the old one stopped.

Plan-policy default (ROADMAP calibration item): when a plan-cache
file is present the engine defaults to ``plan_policy="cache"`` —
falling back to ``"auto"`` when there is no cache to consult
(``default_plan_policy``) or the cache is corrupt.

Latency accounting synchronizes the engine's device inside the timed
loop: a completion's latency includes queue wait, all decode steps,
retries after injected/real faults, and device time.

What differs from the reference, and why:

  * the model calls are plain calls (the reference's three ``jax.jit``
    seams: decode, per-slot prefill, slot reset); the first calls in
    ``warmup`` build the kernel libraries, so no build lands in a timed
    iteration;
  * the port's ``decode_step``/``prefill_slot``/``reset_slot`` update
    the cache tensors in place, where the reference's caches never
    change.  So ``cache0`` (the bucket's pristine cache) is never
    handed to a model call: each bucket keeps one working cache, which
    every wave start (a retry after a failed wave included) overwrites
    from ``cache0``, and warmup runs on that working cache too;
  * each iteration copies ``logits[:, -1, :vocab]`` to the host once
    and takes the greedy argmax there, as the reference does;
  * speculative decoding (``speculative=True``, ``serving/spec.py``):
    the reference's jitted draft and verify programs are plain methods
    of ``SpecDecoder``, and the draft's fork of the target cache is a
    per-bucket working cache (``draft_work``) that every round
    overwrites from the target's, so the draft never writes the
    target's cache; ``_warm_spec`` runs on the working caches.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import (decode_step, init_cache, prefill_slot, reset_slot,
                      serve_params)
from .faults import FaultPlan, InjectedFault, WaveFaults
from .queue import (Backpressure, BucketShape, BucketUnavailable,
                    ContinuousBatcher, DeadlineInfeasible, Request,
                    bucket_for, default_buckets)
from .metrics import EngineMetrics, packed_utilization

PLAN_POLICIES = ("default", "auto", "cache")

#: per-bucket health states (the circuit breaker, DESIGN.md §5)
HEALTH_STATES = ("healthy", "quarantined", "probing")

#: the bucket-state key of the degraded single-request fallback shape
FALLBACK_KEY = "fallback"


class EngineDraining(Backpressure):
    """Raised by ``submit`` while the engine drains (or after a
    closing drain): in-flight work finishes, nothing new is admitted."""


def default_plan_policy(plan_cache: Optional[str] = None) -> str:
    """The engine's plan-policy default: ``"cache"`` when a plan-cache
    file exists (at ``plan_cache``, ``$REPRO_PLAN_CACHE`` or the
    default path), so autotuned timings steer serving; ``"auto"``
    otherwise — a cold start should not fail on a missing file."""
    from ..planner import default_cache_path
    path = plan_cache or default_cache_path()
    return "cache" if os.path.exists(path) else "auto"


@dataclasses.dataclass
class Session:
    """One request occupying a KV-cache slot.

    ``fed`` counts prompt tokens consumed so far — the slot is
    *prefilling* while ``fed < prompt_len - 1`` (those teacher-forced
    positions never need logits) and *decoding* after.  Because the
    cache position is per-slot, ``fed`` always equals this slot's
    ``cache["index"][slot]``, regardless of what its neighbours do.
    """
    request: Request
    start_t: float
    slot: int = -1
    fed: int = 0
    midwave: bool = False           # joined a running wave (not at start)
    tokens: List[int] = dataclasses.field(default_factory=list)
    first_token_t: Optional[float] = None   # the step that gave tokens[0]

    @property
    def prompt_len(self) -> int:
        return len(self.request.prompt)

    def done(self) -> bool:
        return len(self.tokens) >= self.request.new_tokens


class SessionTable:
    """Slot allocator for one bucket's KV cache.

    Slots are reused across waves: ``join`` takes the lowest free
    slot, ``leave`` frees it the moment a request finishes (mid-wave),
    and the cache arrays themselves persist per bucket — no
    re-allocation between waves.
    """

    def __init__(self, batch: int):
        self._slots: List[Optional[Session]] = [None] * batch

    def join(self, session: Session) -> int:
        for i, s in enumerate(self._slots):
            if s is None:
                session.slot = i
                self._slots[i] = session
                return i
        raise RuntimeError("no free KV slot")

    def leave(self, slot: int) -> Session:
        s = self._slots[slot]
        assert s is not None, slot
        self._slots[slot] = None
        return s

    def clear(self) -> List[Session]:
        """Evict every active session (a failed wave's reset path)."""
        out = [s for s in self._slots if s is not None]
        self._slots = [None] * len(self._slots)
        return out

    def active(self) -> List[Tuple[int, Session]]:
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)


@dataclasses.dataclass(frozen=True)
class Completion:
    rid: int
    tokens: Tuple[int, ...]
    prompt_len: int
    bucket_key: str
    submit_t: float
    start_t: float
    finish_t: float
    first_token_t: float            # after the sync that gave the first token
    deadline: Optional[float] = None
    midwave_join: bool = False      # session joined its wave mid-flight

    @property
    def latency_s(self) -> float:
        return self.finish_t - self.submit_t

    @property
    def met_deadline(self) -> bool:
        return self.deadline is None or self.finish_t <= self.deadline


@dataclasses.dataclass
class _WaveState:
    """Bookkeeping for one resumable wave (lives across ``step()``
    calls until the session table empties or the wave fails)."""
    faults: WaveFaults
    allow_joins: bool
    iters: int = 0                  # total iterations (fault schedule)
    inject: bool = False            # draws fault schedules as it runs
    sched_window: int = 1           # iterations per fault-schedule draw
    sched_base: int = 0             # iters at the current draw
    skew_s: float = 0.0             # slow-wave skew accumulated so far
    prefill_steps: int = 0
    decode_steps: int = 0
    prefill_wall_s: float = 0.0
    decode_wall_s: float = 0.0
    spec_rounds: int = 0            # speculative draft+verify rounds
    spec_tokens: int = 0            # tokens those rounds emitted
    draft_wall_s: float = 0.0
    verify_wall_s: float = 0.0
    busy_slot_steps: int = 0        # occupied slots summed over iters
    requests: int = 0               # admitted incl. mid-wave joiners


@dataclasses.dataclass
class _BucketState:
    bucket: BucketShape
    qparams: Any
    cache0: Any                     # pristine cache, never given to a model
    sessions: SessionTable
    work: Any = None                # the working cache's tensors
    warmed: bool = False
    decode_s: float = 0.0           # EMA of one decode step's wall clock
    prefill_s: float = 0.0          # EMA of one prefill step's wall clock
    health: str = "healthy"         # circuit breaker state
    fail_streak: int = 0            # consecutive wave/warmup failures
    quarantined_until: float = 0.0  # cooldown expiry (engine clock)
    cache: Any = None               # live cache of the active wave
    wave: Optional[_WaveState] = None
    # -- speculative decoding (engine speculative=True, DESIGN.md §5.2)
    spec_on: bool = False           # draft+verify warmed and healthy
    accept_ema: float = 0.0         # EMA of tokens emitted per round
    draft_work: Any = None          # the draft's fork of the cache


class Engine:
    """The execution core.  ``step()`` advances the *active* wave by
    ``wave_quantum`` iterations — pulling queued requests into freed
    KV slots every iteration (mid-wave joins) — or, when no wave is
    active, pulls a ready batch from the batcher and starts one.
    ``midwave_joins=False`` restores boundary-only admission.  ``params``
    is the float parameter tree on ``device`` (the card unless the
    caller asks for the CPU, where the kernels run their plain
    versions)."""

    def __init__(self, cfg, params, *, compute: str = "sdv",
                 weight_bits: int = 4, act_bits: int = 8,
                 conv_datapath: str = "bseg",
                 plan_policy: Optional[str] = None,
                 plan_cache: Optional[str] = None,
                 buckets: Optional[Sequence[BucketShape]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 queue_budget: int = 64,
                 flush_budget: Optional[int] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 faults: Optional[FaultPlan] = None,
                 midwave_joins: bool = True,
                 prefill_chunk: int = 8,
                 wave_quantum: int = 1,
                 speculative: bool = False,
                 spec_k: int = 3,
                 draft_bits: int = 4,
                 draft_act_bits: int = 4,
                 min_size: int = 1024, pad_token: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.compute = compute
        self.weight_bits = weight_bits
        self.act_bits = act_bits
        self.conv_datapath = conv_datapath
        self.min_size = min_size
        self.pad_token = pad_token
        self.clock = clock
        self.plan_cache = plan_cache
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.faults = faults
        self.plan_policy = self._resolve_plan_policy(compute, plan_policy,
                                                     plan_cache)
        self.buckets = tuple(buckets) if buckets else default_buckets()
        self.batcher = ContinuousBatcher(
            self.buckets, clock=clock, queue_budget=queue_budget,
            flush_budget=flush_budget)
        self.metrics = EngineMetrics(clock=clock)
        self.completions: List[Completion] = []
        #: rid -> {"outcome": "ok"|"shed"|"failed", "detail": str} —
        #: every admitted request reaches exactly ONE terminal outcome
        self.outcomes: Dict[int, Dict[str, str]] = {}
        self._fallback_pending: List[Request] = []
        self._admitting = True
        self._states: Dict[str, _BucketState] = {}
        self._qparams_by_rows: Dict[int, Any] = {}
        self.midwave_joins = midwave_joins
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        #: teacher-forced tokens per prefill iteration; recurrent-state
        #: families replay token-at-a-time through decode_step instead
        self.prefill_chunk = prefill_chunk \
            if cfg.family in ("dense", "moe", "vlm") else 1
        if wave_quantum < 1:
            raise ValueError(f"wave_quantum must be >= 1, got "
                             f"{wave_quantum}")
        self.wave_quantum = wave_quantum
        self._active: Optional[str] = None      # key of the active wave
        #: the advance mask is an input of every decode (pure-decode,
        #: mixed prefill+decode, warmup, fallback), so per-request
        #: results cannot depend on wave makeup
        self._use_adv = cfg.family in ("dense", "moe", "vlm")
        # speculative decoding: a W-low/A-low self-speculation draft of
        # the SAME checkpoint proposes spec_k tokens per round and the
        # target verifies them in one chunked wave — greedy acceptance
        # is exact, so completions stay bit-identical to plain decode
        self.speculative = bool(speculative)
        self.spec = None
        if self.speculative:
            from .spec import SpecConfig, SpecDecoder
            self.spec = SpecDecoder(
                cfg, params,
                SpecConfig(k=spec_k, draft_bits=draft_bits,
                           draft_act_bits=draft_act_bits),
                compute=compute, min_size=min_size,
                conv_datapath=conv_datapath,
                plan_policy=self.plan_policy, plan_cache=plan_cache)

    # -- the model calls (the reference's three jit seams) -----------------

    def _dec(self, qparams, cache, toks, adv):
        return decode_step(self.cfg, qparams, cache, toks,
                           advance=adv if self._use_adv else None)

    def _pre(self, qparams, cache, slot, toks, n_valid):
        # prefill is per-slot: one [1, C] call for every slot, wave
        # start and mid-wave join alike, so a prompt's replay cost and
        # numerics never depend on wave composition
        return prefill_slot(self.cfg, qparams, cache, slot, toks, n_valid)

    def _reset(self, cache, slot):
        return reset_slot(cache, slot)

    def _sync(self) -> None:
        """Wait for the device (inside every timed region)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    @staticmethod
    def _resolve_plan_policy(compute: str, plan_policy: Optional[str],
                             plan_cache: Optional[str]) -> str:
        if compute != "sdv":
            # memory packing has no lane plans to choose
            return "default"
        if plan_policy is not None and plan_policy not in PLAN_POLICIES:
            raise ValueError(f"unknown plan policy {plan_policy!r}")
        policy = plan_policy or default_plan_policy(plan_cache)
        if policy == "cache":
            # degrade, don't die: a corrupt/unreadable cache file must
            # not take the engine down — re-plan analytically instead
            from ..planner import PlanCache, PlanCacheCorrupt
            try:
                PlanCache.load(plan_cache, strict=True)
            except PlanCacheCorrupt as e:
                warnings.warn(
                    f"plan cache unusable ({e}); falling back to "
                    f"plan_policy='auto'", stacklevel=3)
                policy = "auto"
        return policy

    # -- plan resolution / warmup -----------------------------------------

    def _qparams(self, rows: int) -> Any:
        """Packed parameters planned for a ``rows``-row decode batch
        (memoized — buckets sharing a batch width share the tree)."""
        if rows not in self._qparams_by_rows:
            self._qparams_by_rows[rows] = serve_params(
                self.params, bits=self.weight_bits, min_size=self.min_size,
                compute=self.compute, act_bits=self.act_bits,
                conv_bseg=(self.compute == "sdv"
                           and self.conv_datapath == "bseg"),
                plan_policy=self.plan_policy, plan_cache=self.plan_cache,
                rows=rows)
        return self._qparams_by_rows[rows]

    def _make_state(self, bucket: BucketShape, qparams: Any
                    ) -> _BucketState:
        cache0 = init_cache(self.cfg, bucket.batch, bucket.s_max,
                            device=self.device)
        return _BucketState(
            bucket=bucket, qparams=qparams, cache0=cache0,
            work={k: v.clone() for k, v in cache0.items()},
            sessions=SessionTable(bucket.batch))

    def _fresh_cache(self, st: _BucketState) -> Dict[str, torch.Tensor]:
        """The bucket's working cache, overwritten from the pristine
        ``cache0`` (the reference's ``st.cache = st.cache0``: the model
        calls update caches in place, so ``cache0`` itself is never
        passed to one)."""
        for k, v in st.work.items():
            v.copy_(st.cache0[k])
        return dict(st.work)

    def _state(self, bucket: BucketShape) -> _BucketState:
        st = self._states.get(bucket.key)
        if st is None:
            st = self._make_state(bucket, self._qparams(bucket.batch))
            self._states[bucket.key] = st
        elif st.qparams is None:
            # a stub left by a failed plan resolution (see
            # ``_on_wave_failure``): retry the build — the cooldown
            # probe repairs transient resolution failures
            repaired = self._make_state(bucket,
                                        self._qparams(bucket.batch))
            repaired.health = st.health
            repaired.fail_streak = st.fail_streak
            repaired.quarantined_until = st.quarantined_until
            st = repaired
            self._states[bucket.key] = st
        return st

    def _fallback_state(self) -> _BucketState:
        """The degraded single-request execution shape: batch 1 at the
        largest bucket capacity, packed with the *uniform default*
        plans — no planner search, no plan cache, the most robust
        configuration (and still bit-exact: lane plans change packing
        layout, never arithmetic)."""
        st = self._states.get(FALLBACK_KEY)
        if st is None:
            shape = BucketShape(1, max(b.s_max for b in self.buckets))
            try:
                qp = serve_params(
                    self.params, bits=self.weight_bits,
                    min_size=self.min_size, compute=self.compute,
                    act_bits=self.act_bits,
                    conv_bseg=(self.compute == "sdv"
                               and self.conv_datapath == "bseg"),
                    plan_policy="default", rows=1)
            except Exception:           # no default plan for these bits:
                qp = serve_params(      # memory packing always exists
                    self.params, bits=self.weight_bits,
                    min_size=self.min_size, compute="memory")
            st = self._make_state(shape, qp)
            self._states[FALLBACK_KEY] = st
        return st

    def _warm_decode(self, st: _BucketState) -> None:
        """One decode step of pad tokens on the bucket's working cache
        (the first builds the kernel libraries the path launches)."""
        b = st.bucket.batch
        toks = self._tensor(np.full((b, 1), self.pad_token, np.int32))
        ones = self._tensor(np.ones((b,), np.int32))
        self._dec(st.qparams, dict(st.work), toks, ones)
        self._sync()

    def warmup(self, bucket: BucketShape, *,
               inject: bool = True) -> _BucketState:
        """Build the bucket's kernels and run its decode step once, then
        time one more step and record its packed-multiply utilization;
        idempotent.  May raise (injected compile faults, real build or
        launch errors) — ``_run_wave`` turns that into a breaker event
        instead of process death."""
        st = self._state(bucket)
        if st.warmed:
            return st
        if inject and self.faults is not None:
            self.faults.maybe_fail_compile(bucket.key)
        self._warm_decode(st)                                 # build
        self._compile_aux(st)
        t0 = self.clock()
        self._warm_decode(st)                                 # measure
        st.decode_s = max(self.clock() - t0, 1e-9)
        st.warmed = True
        util = packed_utilization(st.qparams, st.bucket.batch)
        self.metrics.set_bucket_utilization(
            bucket.key, {k: v for k, v in util.items() if k != "layers"})
        return st

    def _compile_aux(self, st: _BucketState, *, spec: bool = True
                     ) -> None:
        """Run the per-slot prefill and the slot reset once during
        warmup, on the working cache (``cache0`` stays pristine): a
        mid-wave join must never pay a kernel build in the middle of
        live traffic.  With ``speculative=True`` the draft and verify
        programs run here too (``spec`` is False only for the fallback
        state — the degraded batch-1 path never speculates)."""
        if self.prefill_chunk > 1 or self.speculative:
            # spec mode replays EVERY teacher-forced prompt token
            # through the prefill path, so the [1, C] call is needed
            # even at chunk 1
            ptoks = self._tensor(np.full((1, self.prefill_chunk),
                                         self.pad_token, np.int32))
            self._pre(st.qparams, dict(st.work), 0, ptoks,
                      self._tensor(np.ones((1,), np.int32)))
        self._reset(dict(st.work), 0)
        self._sync()
        if spec and self.speculative:
            st.spec_on = self._warm_spec(st)

    def _warm_spec(self, st: _BucketState) -> bool:
        """Resolve the draft's plans and run the draft round and the
        verify wave once for this bucket shape, on the working caches.
        ANY failure — draft plan resolution, a kernel build, a launch —
        degrades the bucket to plain decode on the spot (returns False)
        instead of quarantining it or re-routing to the batch-1
        fallback: the target path is intact and correctness never
        depended on the draft."""
        b = st.bucket.batch
        try:
            dqp = self.spec.draft_qparams(b)
            if st.draft_work is None:
                st.draft_work = {k: torch.empty_like(v)
                                 for k, v in st.cache0.items()}
            pend = self._tensor(np.full((b,), self.pad_token, np.int32))
            ones = self._tensor(np.ones((b,), np.int32))
            props = self.spec.draft(dqp, dict(st.work), pend, ones,
                                    st.draft_work)
            self._sync()
            k1 = self.spec.config.k + 1
            self.spec.verify(st.qparams, dict(st.work), pend, props, ones,
                             self._tensor(np.full((b,), k1, np.int32)))
            self._sync()
        except Exception as e:
            warnings.warn(
                f"speculative decode disabled for bucket "
                f"{st.bucket.key}: {e!r}; degrading to plain decode",
                stacklevel=2)
            self.metrics.record_spec_degraded(st.bucket.key)
            return False
        return True

    def prewarm_fallback(self) -> None:
        """Build and run the degraded fallback path ahead of traffic.
        The fallback is the last line of defense during a bucket
        outage — paying its warmup in the middle of one would stall the
        queue past every deadline, so startup is the time for it.
        Faults are never injected here."""
        st = self._fallback_state()
        if not st.warmed:
            self._warm_state(st)

    def plan_report(self) -> Dict[str, Any]:
        """Per-bucket plan resolution: utilization + per-layer routes
        (use_kernel=True — the datapath routes the plans land on)."""
        return {key: packed_utilization(st.qparams, st.bucket.batch)
                for key, st in sorted(self._states.items())
                if key != FALLBACK_KEY and st.qparams is not None}

    def spec_report(self) -> Dict[str, Any]:
        """Per warmed bucket: speculation health + the per-layer
        target-vs-draft plan table (the acceptance gate is every draft
        GEMM strictly denser on the same datapath)."""
        if not self.speculative:
            return {}
        return {key: {
                    "spec_on": st.spec_on,
                    "accept_ema": st.accept_ema,
                    "layers": self.spec.plan_comparison(
                        st.qparams, st.bucket.batch),
                }
                for key, st in sorted(self._states.items())
                if key != FALLBACK_KEY and st.warmed}

    def bucket_health(self) -> Dict[str, str]:
        """Circuit-breaker state per warmed/known bucket."""
        return {key: st.health for key, st in sorted(self._states.items())
                if key != FALLBACK_KEY}

    def _est_wave_s(self, request: Optional[Request] = None) -> float:
        """One wave's estimated wall clock, from the *decode* EMA —
        prefill iterations are tracked separately so replay-heavy
        waves cannot skew admission for decode-heavy traffic.

        With ``request`` the estimate resolves the request's own
        bucket first (``bucket_for``) and uses that bucket's EMA.
        Without a request (flush heuristics), the conservative max
        over warmed buckets is kept."""
        warmed = [st for key, st in self._states.items()
                  if st.warmed and key != FALLBACK_KEY]
        if not warmed:
            return 0.0
        if request is not None:
            try:
                bucket = bucket_for(request, self.buckets,
                                    unavailable=self.batcher.quarantined())
            except (BucketUnavailable, ValueError):
                bucket = None
            if bucket is not None:
                st = self._states.get(bucket.key)
                if st is not None and st.warmed:
                    return self._bucket_est_s(st)
        return max(self._bucket_est_s(st) for st in warmed)

    def _bucket_est_s(self, st: _BucketState) -> float:
        """One bucket's estimated wave wall clock.  When the bucket
        speculates, its decode EMA prices a *round* (draft + verify)
        that emits ``accept_ema`` tokens, not one."""
        est = st.decode_s * (st.bucket.s_max - 1)
        if self.speculative and st.spec_on and st.accept_ema > 0.0:
            est /= max(st.accept_ema, 1.0)
        return est

    # -- request admission -------------------------------------------------

    def submit(self, prompt: Sequence[int], new_tokens: int,
               deadline: Optional[float] = None,
               submit_t: Optional[float] = None) -> int:
        """Enqueue a request; returns its rid.  Raises
        ``EngineDraining`` after/while a closing drain,
        ``ValueError`` on malformed or never-fittable requests,
        ``DeadlineInfeasible`` when the deadline cannot survive one
        estimated wave, ``Backpressure`` at the hard queue budget (all
        recorded).  ``submit_t`` back-dates the latency clock to the
        request's true arrival time (load generators submitting after
        a wave held the loop)."""
        if not self._admitting:
            raise EngineDraining("engine is draining: not admitting")
        # admission must see *current* health: a cooldown that expired
        # while a long wave held the loop reinstates its bucket now,
        # not at the next step() — else a submission burst right after
        # the wave would all re-route past a bucket that is ready to
        # probe (and the probe would never happen)
        self._tick_breakers()
        try:
            req = Request(prompt=tuple(prompt) if prompt is not None
                          else (), new_tokens=new_tokens,
                          deadline=deadline, submit_t=submit_t)
        except (TypeError, ValueError) as e:
            self.metrics.record_malformed()
            raise ValueError(f"malformed request: {e}") from e
        try:
            self.batcher.submit(req, est_wave_s=self._est_wave_s(req))
        except BucketUnavailable:
            # fits only a quarantined bucket: degraded fallback path
            if self.depth() >= self.batcher.queue_budget:
                self.metrics.record_rejection()
                raise Backpressure(
                    f"queue at budget ({self.batcher.queue_budget})")
            self.batcher.stamp(req)
            self._fallback_pending.append(req)
            self.metrics.record_reroute()
        except DeadlineInfeasible:
            self.metrics.record_rejection(infeasible=True)
            raise
        except Backpressure:
            self.metrics.record_rejection()
            raise
        return req.rid

    def depth(self) -> int:
        """Unfinished engine-held requests: queued, fallback-pending,
        and sessions in flight on a resumable wave."""
        return (self.batcher.depth() + len(self._fallback_pending)
                + self._inflight())

    def _inflight(self) -> int:
        return sum(len(st.sessions.active())
                   for st in self._states.values() if st.wave is not None)

    def busy(self) -> bool:
        """True while a wave is mid-flight — the next ``step()`` will
        advance it (load generators should loop, not sleep)."""
        return self._active is not None

    # -- terminal outcomes -------------------------------------------------

    def _set_outcome(self, rid: int, outcome: str, detail: str = ""
                     ) -> None:
        assert rid not in self.outcomes, \
            (rid, outcome, self.outcomes[rid])       # exactly once
        self.outcomes[rid] = {"outcome": outcome, "detail": detail}

    def _shed(self, requests: List[Request]) -> None:
        for r in requests:
            self._set_outcome(r.rid, "shed", "deadline_exceeded")
            self.metrics.record_shed()

    def _shed_expired(self) -> None:
        self._shed(self.batcher.shed_expired())
        now = self.clock()
        keep: List[Request] = []
        expired: List[Request] = []
        for r in self._fallback_pending:
            tr = r.time_remaining(now)
            (expired if tr is not None and tr <= 0 else keep).append(r)
        self._fallback_pending = keep
        self._shed(expired)

    # -- circuit breaker ---------------------------------------------------

    def _tick_breakers(self) -> None:
        """Cooldown expiry: quarantined buckets turn ``probing`` and
        re-enter assignment — their next wave is the probe."""
        now = self.clock()
        for st in self._states.values():
            if st.health == "quarantined" and now >= st.quarantined_until:
                st.health = "probing"
                self.batcher.reinstate(st.bucket)

    def _reroute(self, request: Request) -> None:
        """Re-admit an already-admitted request after its bucket
        failed: nearest healthy bucket, else the fallback path.  The
        request is never dropped."""
        self.metrics.record_reroute()
        try:
            self.batcher.enqueue(request)
        except (BucketUnavailable, ValueError):
            self._fallback_pending.append(request)

    def _on_wave_failure(self, bucket: BucketShape, error: Exception,
                         unfinished: List[Request]) -> None:
        st = self._states.get(bucket.key)
        if st is None:
            # plan resolution itself failed: track breaker state on a
            # stub; ``_state`` retries the build on the cooldown probe
            st = _BucketState(bucket=bucket, qparams=None, cache0=None,
                              sessions=SessionTable(bucket.batch))
            self._states[bucket.key] = st
        kind = getattr(error, "kind", type(error).__name__)
        st.fail_streak += 1
        self.metrics.record_wave_failure(bucket.key, kind)
        failed_probe = st.health == "probing"
        if failed_probe or st.fail_streak >= self.breaker_threshold:
            st.health = "quarantined"
            st.quarantined_until = self.clock() + self.breaker_cooldown_s
            self.metrics.record_quarantine(bucket.key)
            drained = self.batcher.quarantine(bucket)
            for r in list(unfinished) + drained:
                self._reroute(r)
        else:
            # below threshold: retry in place (oldest-first by rid)
            for r in unfinished:
                self.batcher.enqueue(r)

    def _on_wave_success(self, bucket: BucketShape) -> None:
        st = self._states[bucket.key]
        st.fail_streak = 0
        if st.health == "probing":
            st.health = "healthy"
            self.metrics.record_recovery(bucket.key)

    # -- execution ---------------------------------------------------------

    def step(self, force: bool = False) -> List[Completion]:
        """Advance the engine: shed expired requests, then either
        continue the active wave by ``wave_quantum`` iterations
        (pulling queued requests into freed slots — mid-wave joins) or
        start a new wave from a ready batch (``force=True`` flushes a
        partial bucket — the drain path); when no bucket flushes,
        serve one degraded-fallback request if any is pending.
        Returns the completions this call produced."""
        self.metrics.sample_depth(self.depth())
        self._tick_breakers()
        self._shed_expired()
        if self._active is not None:
            st = self._states[self._active]
            return self._advance_and_settle(st, self.wave_quantum)
        got = self.batcher.ready(est_wave_s=self._est_wave_s(),
                                 force=force)
        if got is not None:
            return self._run_wave(*got)
        if self._fallback_pending:
            return self._run_fallback(self._fallback_pending.pop(0))
        return []

    def drain(self, close: bool = False) -> List[Completion]:
        """Finish every queued request without admitting new ones
        (``submit`` raises ``EngineDraining`` meanwhile); ``close=True``
        keeps admission shut afterwards — the shutdown/snapshot path."""
        was_admitting = self._admitting
        self._admitting = False
        try:
            out: List[Completion] = []
            while self.depth():
                out.extend(self.step(force=True))
            return out
        finally:
            self._admitting = was_admitting and not close

    # -- snapshot / restore (engine restart with zero lost requests) ------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able queue + session-table snapshot.  Waves are
        resumable, so between ``step()`` calls the engine may hold
        queued requests *and* sessions mid-flight on an active wave —
        the snapshot serializes both (in-flight sessions as their
        requests, partial tokens discarded: decode is deterministic,
        so the restored engine regenerates them bit-exactly), plus the
        rid watermark so a restarted engine never reuses an old rid."""
        inflight = [s.request for st in self._states.values()
                    if st.wave is not None
                    for _, s in st.sessions.active()]
        queued = (self.batcher.snapshot_requests()
                  + list(self._fallback_pending) + inflight)
        queued.sort(key=lambda r: r.rid)
        return {
            "version": 1,
            "next_rid": self.batcher._next_rid,
            "requests": [r.to_dict() for r in queued],
            "outcomes": {str(rid): dict(o)
                         for rid, o in sorted(self.outcomes.items())},
        }

    def restore(self, snap: Dict[str, Any]) -> int:
        """Re-admit a snapshot's queued requests (rid, submit_t and
        deadline preserved — latency accounting spans the restart).
        Returns the number of restored requests."""
        if snap.get("version") != 1:
            raise ValueError(f"unknown snapshot version "
                             f"{snap.get('version')!r}")
        self.batcher._next_rid = max(self.batcher._next_rid,
                                     int(snap["next_rid"]))
        n = 0
        for d in snap["requests"]:
            req = Request.from_dict(d)
            try:
                self.batcher.enqueue(req)
            except (BucketUnavailable, ValueError):
                self._fallback_pending.append(req)
            n += 1
        return n

    # -- wave execution ----------------------------------------------------

    def _expected_iters(self, requests: Sequence[Request]) -> int:
        """Iterations the initial batch needs: ceil((P-1)/C) chunked
        prefill steps plus new_tokens decode steps, maxed over the
        batch (the fault schedule's window)."""
        c = self.prefill_chunk
        return max(-(-(len(r.prompt) - 1) // c) + r.new_tokens
                   for r in requests)

    def _start_wave(self, st: _BucketState, requests: List[Request], *,
                    inject: bool, allow_joins: bool) -> None:
        self.metrics.record_start()
        start_t = self.clock()
        for r in requests:
            st.sessions.join(Session(request=r, start_t=start_t))
        st.cache = self._fresh_cache(st)        # pristine contents
        window = max(self._expected_iters(requests), 1)
        injecting = inject and self.faults is not None
        wf = self.faults.begin_wave(st.bucket.key, window) \
            if injecting else WaveFaults()
        st.wave = _WaveState(faults=wf, allow_joins=allow_joins,
                             inject=injecting, sched_window=window,
                             skew_s=wf.skew_s, requests=len(requests))

    def _pull_joiners(self, st: _BucketState) -> None:
        """Fill freed slots from the bucket's queue *mid-wave*: the
        slot's cache column is reset (``reset_slot``) so the joining
        session starts from position 0 while its neighbours keep
        decoding — the per-slot ``index[B]`` contract is what makes
        this sound.  Expired requests found here are shed, not run."""
        free = st.sessions.free_slots()
        if not st.wave.allow_joins or free == 0:
            return
        pulled = self.batcher.take(st.bucket, free)
        if not pulled:
            return
        now = self.clock()
        for r in pulled:
            tr = r.time_remaining(now)
            if tr is not None and tr <= 0:
                self._shed([r])
                continue
            slot = st.sessions.join(Session(request=r, start_t=now,
                                            midwave=True))
            st.cache = self._reset(st.cache, slot)
            st.wave.requests += 1
            self.metrics.record_join()

    def _wave_iteration(self, st: _BucketState) -> List[Completion]:
        """One iteration of the active wave: slots with teacher-forced
        prompt left take a chunked prefill step while the remaining
        active slots take a decode step — in the SAME iteration, on
        disjoint slots (the decode advance mask freezes mid-prefill
        slots).  Joiners therefore never stall their decoding
        neighbours.  May raise — the caller turns that into a breaker
        event."""
        w, bucket, table = st.wave, st.bucket, st.sessions
        self._pull_joiners(st)
        if w.inject and w.iters - w.sched_base >= w.sched_window:
            # a continuous wave can outlive any batch: redraw the fault
            # schedule every expected-wave window so injection
            # frequency tracks work done, not wave boundaries
            w.sched_base = w.iters
            w.faults = self.faults.begin_wave(bucket.key, w.sched_window)
            w.skew_s += w.faults.skew_s
        if w.faults.fail_at_step is not None \
                and w.iters - w.sched_base == w.faults.fail_at_step:
            raise InjectedFault(
                "kernel_loss", f"{bucket.key} step {w.iters}")
        b, vocab = bucket.batch, self.cfg.vocab
        active = table.active()
        c = self.prefill_chunk
        # spec mode forces the chunked-prefill path for teacher-forced
        # positions even at chunk 1: a speculative round must never run
        # on a slot that still has prompt left, so decoding slots always
        # have fed >= prompt_len - 1
        use_spec = self.speculative and st.spec_on
        prefilling = [(slot, s) for slot, s in active
                      if (c > 1 or use_spec)
                      and s.fed < s.prompt_len - 1]
        pref_slots = {slot for slot, _ in prefilling}
        decoding = [(slot, s) for slot, s in active
                    if slot not in pref_slots]
        w.iters += 1
        if prefilling:
            t0 = self.clock()
            cache = st.cache
            for slot, s in prefilling:
                n = min(c, s.prompt_len - 1 - s.fed)
                toks = np.full((1, c), self.pad_token, np.int32)
                toks[0, :n] = s.request.prompt[s.fed:s.fed + n]
                cache = self._pre(st.qparams, cache, slot,
                                  self._tensor(toks),
                                  self._tensor(np.array([n], np.int32)))
                s.fed += n
            # sync INSIDE the timed loop: the prefill EMA must include
            # device time
            self._sync()
            st.cache = cache
            w.prefill_steps += len(prefilling)
            w.prefill_wall_s += max(self.clock() - t0, 1e-9)
            w.busy_slot_steps += len(prefilling)
        if not decoding:
            return []
        if use_spec:
            try:
                return self._spec_iteration(st, decoding)
            except InjectedFault:
                raise                       # chaos events keep the
            except Exception as e:          # normal breaker path
                # draft/verify runtime failure: degrade THIS bucket to
                # plain decode in place (never the batch-1 fallback —
                # the target path is intact) and serve the iteration
                # below.  st.cache was not reassigned and the draft
                # writes only its fork, so the pending tokens are still
                # unconsumed (a failed verify may have written K/V past
                # the index, which is never read before it is rewritten)
                self._degrade_spec(st, e)
        t0 = self.clock()
        toks = np.full((b, 1), self.pad_token, np.int32)
        for slot, s in decoding:
            # the next token this slot consumes: its own prompt while
            # teacher-forcing (fed is this slot's cache position), its
            # last generated token afterwards
            toks[slot, 0] = s.request.prompt[s.fed] \
                if s.fed < s.prompt_len else s.tokens[-1]
        adv = np.ones((b,), np.int32)
        for slot in pref_slots:     # mid-prefill slots: no KV write,
            adv[slot] = 0           # no index move, logits discarded
        logits, cache = self._dec(st.qparams, st.cache, self._tensor(toks),
                                  self._tensor(adv))
        # sync INSIDE the timed loop: per-step wall clock and
        # completion latencies must include device time
        self._sync()
        st.cache = cache
        w.decode_steps += 1
        w.decode_wall_s += max(self.clock() - t0, 1e-9)
        w.busy_slot_steps += len(decoding)
        # one device-to-host copy of the batch's last-position logits
        last = logits[:, -1, :vocab].cpu().numpy()
        finish_t = self.clock()
        completions: List[Completion] = []
        emitted = 0
        for slot, s in decoding:
            if s.fed < s.prompt_len:
                s.fed += 1
                if s.fed < s.prompt_len:        # teacher-forced: output
                    continue                    # discarded
            tok = int(last[slot].argmax())
            s.tokens.append(tok)
            if s.first_token_t is None:
                s.first_token_t = finish_t
            emitted += 1
            if s.done():                        # leave mid-wave: free slot
                table.leave(slot)
                comp = Completion(
                    rid=s.request.rid, tokens=tuple(s.tokens),
                    prompt_len=s.prompt_len, bucket_key=bucket.key,
                    submit_t=s.request.submit_t,
                    start_t=s.start_t, finish_t=finish_t,
                    first_token_t=s.first_token_t,
                    deadline=s.request.deadline, midwave_join=s.midwave)
                completions.append(comp)
                self._set_outcome(comp.rid, "ok", bucket.key)
                self.metrics.record_completion(
                    submit_t=comp.submit_t, start_t=comp.start_t,
                    finish_t=comp.finish_t, n_tokens=len(comp.tokens),
                    first_token_t=comp.first_token_t)
        self.metrics.record_decode_launch(emitted)
        return completions

    def _degrade_spec(self, st: _BucketState, error: Exception) -> None:
        """Turn off speculation for one bucket after a draft-side
        failure.  DESIGN.md §5.2: the degradation target is plain
        decode on the SAME bucket — never quarantine, never the
        batch-1 fallback — because target-path correctness was never
        in the draft's hands."""
        warnings.warn(
            f"speculative decode disabled for bucket {st.bucket.key}: "
            f"{error!r}; degrading to plain decode", stacklevel=3)
        self.metrics.record_spec_degraded(st.bucket.key)
        st.spec_on = False

    def _spec_iteration(self, st: _BucketState,
                        decoding: List[Tuple[int, Session]]
                        ) -> List[Completion]:
        """One speculative round for the wave's decoding slots: k draft
        steps on the packed low-bit draft over the bucket's fork of the
        target's cache, then one chunked verification wave on the
        target scoring all k + 1 positions, with longest-prefix greedy
        acceptance and the rejected tail's rollback on the device.

        The emitted tokens are always the *target's* argmax choices, so
        output is bit-identical to plain decode — the draft only sets
        the tokens-per-round rate.  Slots mid-prefill ride along frozen
        (draft advance 0, verify n_valid 0: no K/V write, no index
        move).  The proposals stay on the device; the host reads back
        only (greedy [B, k+1], accepted [B]).  May raise; the caller
        degrades the bucket to plain decode."""
        w, bucket, table = st.wave, st.bucket, st.sessions
        b = bucket.batch
        dqp = self.spec.draft_qparams(b)
        pend = np.full((b,), self.pad_token, np.int32)
        adv = np.zeros((b,), np.int32)
        rem = np.zeros((b,), np.int32)
        for slot, s in decoding:
            # the one unconsumed token per decoding slot: the final
            # prompt token right after prefill, else the last accepted
            pend[slot] = s.request.prompt[s.fed] \
                if s.fed < s.prompt_len else s.tokens[-1]
            adv[slot] = 1
            rem[slot] = s.request.new_tokens - len(s.tokens)
        pend_t, adv_t = self._tensor(pend), self._tensor(adv)
        t0 = self.clock()
        props = self.spec.draft(dqp, st.cache, pend_t, adv_t, st.draft_work)
        self._sync()                            # draft wall = device too
        t1 = self.clock()
        # acceptance on device: t = min(matched prefix + 1, remaining)
        # per slot — m accepted proposals PLUS the target's correction
        # at the first mismatch, capped by what the request still wants
        greedy, acc, cache = self.spec.verify(st.qparams, st.cache, pend_t,
                                              props, adv_t,
                                              self._tensor(rem))
        greedy = greedy.cpu().numpy()                         # [B, k+1]
        acc = acc.cpu().numpy()                               # [B]
        t2 = self.clock()
        st.cache = cache                        # already rolled back
        draft_s = max(t1 - t0, 1e-9)
        verify_s = max(t2 - t1, 1e-9)
        w.spec_rounds += 1
        w.draft_wall_s += draft_s
        w.verify_wall_s += verify_s
        w.busy_slot_steps += len(decoding)
        finish_t = self.clock()
        completions: List[Completion] = []
        accepted: List[int] = []
        for slot, s in decoding:
            t = int(acc[slot])
            if s.fed < s.prompt_len:
                s.fed += 1                      # consumed: last prompt tok
            s.tokens.extend(int(g) for g in greedy[slot, :t])
            if s.first_token_t is None and s.tokens:
                s.first_token_t = finish_t
            accepted.append(t)
            w.spec_tokens += t
            if s.done():
                table.leave(slot)
                comp = Completion(
                    rid=s.request.rid, tokens=tuple(s.tokens),
                    prompt_len=s.prompt_len, bucket_key=bucket.key,
                    submit_t=s.request.submit_t,
                    start_t=s.start_t, finish_t=finish_t,
                    first_token_t=s.first_token_t,
                    deadline=s.request.deadline, midwave_join=s.midwave)
                completions.append(comp)
                self._set_outcome(comp.rid, "ok", bucket.key)
                self.metrics.record_completion(
                    submit_t=comp.submit_t, start_t=comp.start_t,
                    finish_t=comp.finish_t, n_tokens=len(comp.tokens),
                    first_token_t=comp.first_token_t)
        self.metrics.record_spec_round(bucket.key, accepted=accepted,
                                       draft_s=draft_s,
                                       verify_s=verify_s)
        return completions

    def _end_wave(self, st: _BucketState) -> None:
        """Successful wave end: fold this wave's walls into the
        *separate* prefill/decode EMAs and record occupancy."""
        w = st.wave
        # slow-wave fault: the decode wall reads skewed/slow, inflating
        # the step EMA -> est_wave_s -> shedding + admission pressure
        if w.decode_steps:
            per = (w.decode_wall_s + w.skew_s) / w.decode_steps
            st.decode_s = 0.5 * st.decode_s + 0.5 * per
        elif w.spec_rounds:
            # a purely speculative wave: the decode EMA prices one
            # ROUND (draft + verify) — accept_ema below converts that
            # back to per-token for admission (``_bucket_est_s``)
            per = (w.draft_wall_s + w.verify_wall_s + w.skew_s) \
                / w.spec_rounds
            st.decode_s = 0.5 * st.decode_s + 0.5 * per
        if w.prefill_steps:
            per = w.prefill_wall_s / w.prefill_steps
            st.prefill_s = per if st.prefill_s == 0.0 \
                else 0.5 * st.prefill_s + 0.5 * per
        if w.spec_rounds:
            per_tok = w.spec_tokens / w.spec_rounds
            st.accept_ema = per_tok if st.accept_ema == 0.0 \
                else 0.5 * st.accept_ema + 0.5 * per_tok
        self.metrics.record_wave(
            st.bucket.key, steps=w.iters,
            wall_s=(w.prefill_wall_s + w.decode_wall_s + w.draft_wall_s
                    + w.verify_wall_s + w.skew_s),
            requests=w.requests, busy_slot_steps=w.busy_slot_steps,
            slot_steps=w.iters * st.bucket.batch,
            decode_steps=w.decode_steps, decode_wall_s=w.decode_wall_s,
            prefill_calls=w.prefill_steps, prefill_wall_s=w.prefill_wall_s)
        st.wave = None
        st.cache = None

    def _advance_wave(self, st: _BucketState,
                      max_iters: Optional[int]
                      ) -> Tuple[List[Completion], List[Request],
                                 Optional[Exception], bool]:
        """Run up to ``max_iters`` iterations (``None``: to completion)
        of the wave on ``st``.  Returns (completions, unfinished
        requests, error, done).  On error the session table is reset
        and the unfinished requests (tokens discarded — decode is
        deterministic, a retry reproduces them) are handed back;
        completions that finished before the fault are kept."""
        completions: List[Completion] = []
        n = 0
        try:
            while st.sessions.active():
                completions.extend(self._wave_iteration(st))
                n += 1
                if max_iters is not None and n >= max_iters \
                        and st.sessions.active():
                    return completions, [], None, False
        except Exception as e:                  # bucket-local, not fatal
            unfinished = [s.request for s in st.sessions.clear()]
            st.wave = None
            st.cache = None
            return completions, unfinished, e, True
        self._end_wave(st)
        return completions, [], None, True

    def _advance_and_settle(self, st: _BucketState,
                            max_iters: Optional[int]
                            ) -> List[Completion]:
        """Advance the active wave and settle breaker bookkeeping when
        it ends (success or failure)."""
        completions, unfinished, err, done = self._advance_wave(
            st, max_iters)
        if done:
            self._active = None
            if err is not None:
                self._on_wave_failure(st.bucket, err, unfinished)
            else:
                self._on_wave_success(st.bucket)
        self.completions.extend(completions)
        return completions

    def _run_wave(self, bucket: BucketShape,
                  requests: List[Request]) -> List[Completion]:
        try:
            st = self.warmup(bucket)
        except Exception as e:                  # compile failure: breaker
            self._on_wave_failure(bucket, e, requests)
            return []
        self._start_wave(st, requests, inject=True,
                         allow_joins=self.midwave_joins)
        self._active = bucket.key
        return self._advance_and_settle(st, self.wave_quantum)

    def _run_fallback(self, request: Request) -> List[Completion]:
        """Serve one request on the degraded single-request state.
        This is the last line of defense: faults are not injected
        here, joins never happen (the fallback shape is not a batcher
        bucket), the wave runs synchronously to completion, and a
        failure is the request's terminal ``failed`` outcome — never
        an engine crash."""
        try:
            st = self._fallback_state()
            if not st.warmed:
                self._warm_state(st)
            self._start_wave(st, [request], inject=False,
                             allow_joins=False)
            completions, unfinished, err, _ = self._advance_wave(st, None)
        except Exception as e:                  # even setup may fail
            completions, unfinished, err = [], [request], e
        if err is not None:
            for r in unfinished:
                self._set_outcome(r.rid, "failed", str(err))
                self.metrics.record_failed()
        else:
            self.metrics.record_fallback_wave()
        self.completions.extend(completions)
        return completions

    def _warm_state(self, st: _BucketState) -> None:
        self._warm_decode(st)
        self._compile_aux(st, spec=False)
        st.warmed = True
