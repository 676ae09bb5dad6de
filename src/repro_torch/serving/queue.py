"""Request queue + continuous batcher (the serving front end) — the
torch port's own copy of ``repro.serving.queue`` (standard library
only, the same decisions under the same injected clock).

Requests arrive one at a time (``Request``: prompt tokens, a decode
budget, an optional absolute deadline) and are coalesced into a small
set of *bucket shapes* — the (batch, s_max) pairs the engine has
warmed up, compiled, and plan-resolved.  The packing technique only
pays off when the wide datapath is kept full, so the batcher's whole
job is shape discipline: every wave the engine runs has one of a
handful of static shapes, each of which the planner has already
optimized (`engine.py` resolves plans per bucket).

Bucket assignment is deterministic: the smallest ``s_max`` that holds
``len(prompt) + new_tokens``, padded to the bucket (pad slots feed a
fixed pad token and are discarded).  Quarantined buckets (the engine's
circuit breaker, DESIGN.md §5) are excluded from assignment — requests
re-route to the nearest healthy bucket, and ``BucketUnavailable`` is
raised when *only* a quarantined bucket could hold the request (the
engine then serves it on its degraded fallback path).  Flush policy,
in priority order:

  * **full bucket** — a bucket has ``batch`` pending requests;
  * **deadline** — the oldest pending request in a bucket could miss
    its deadline if the flush waited any longer (``est_wave_s`` is the
    caller's estimate of one wave's wall clock);
  * **budget** — total queued requests exceed the *soft* budget
    (``flush_budget``): the deepest bucket flushes partially rather
    than letting latency build while waiting to fill.

Deadline semantics are single-sourced in ``time_remaining``: the flush
heuristic, the admission check, and the shedder all compare the same
``deadline - now`` number (they used to each derive their own — the
semantics-drift fix).  A request is *viable* at admission iff its time
remaining covers one estimated wave (``submit(est_wave_s=...)``
raises ``DeadlineInfeasible`` otherwise — admission control); a queued
request whose time remaining hits zero is *expired* and
``shed_expired`` removes it before it burns a wave slot (the engine
records a ``deadline_exceeded`` outcome).

Past the *hard* budget (``queue_budget``), ``submit`` raises
``Backpressure`` — the caller sheds load instead of queueing unbounded
work (the engine surfaces this to its clients; the load generator
retries with seeded exponential backoff).

The clock is injectable (``clock=`` returns seconds, monotonic), so
every flush/shed rule is unit-testable with a fake clock — no sleeps
in the test suite.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import (Callable, Collection, Dict, List, Optional, Sequence,
                    Tuple)


class Backpressure(RuntimeError):
    """Raised by ``submit`` when the queue is at its hard budget."""


class DeadlineInfeasible(Backpressure):
    """Raised by ``submit`` when the request's deadline cannot be met
    even if a wave started right now (admission control) — a subclass
    of ``Backpressure`` so legacy callers still shed it, but retrying
    is pointless and clients should not."""


class BucketUnavailable(RuntimeError):
    """Raised when a request fits only bucket shapes that are
    currently quarantined — the engine serves it degraded instead."""


def time_remaining(deadline: Optional[float], now: float
                   ) -> Optional[float]:
    """THE deadline computation: seconds until ``deadline`` (negative
    when already expired), ``None`` for best-effort requests.  Every
    consumer — flush heuristic, admission check, shedder, loadgen —
    derives from this one function so they cannot drift."""
    return None if deadline is None else deadline - now


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """One compiled decode shape: ``batch`` KV slots of ``s_max``
    positions (prompt + generated tokens both count)."""
    batch: int
    s_max: int

    @property
    def key(self) -> str:
        return f"b{self.batch}.s{self.s_max}"


def default_buckets(batch: int = 8,
                    s_maxes: Sequence[int] = (32, 64, 128)
                    ) -> Tuple[BucketShape, ...]:
    """The default bucket ladder: one batch width, power-of-two
    sequence capacities (compile cost is per shape, so the ladder is
    deliberately short)."""
    return tuple(BucketShape(batch, s) for s in sorted(s_maxes))


@dataclasses.dataclass
class Request:
    """One inference request.

    ``deadline`` is an *absolute* clock value (same clock as the
    batcher's); ``None`` means best-effort.  ``rid`` is assigned by
    the batcher; ``submit_t`` too, unless the caller pre-stamps it
    (a load generator stamps the *scheduled arrival* time, so that a
    wave in flight at arrival time cannot hide queueing delay from
    the latency accounting — coordinated omission).
    """
    prompt: Tuple[int, ...]
    new_tokens: int
    deadline: Optional[float] = None
    rid: int = -1
    submit_t: Optional[float] = None

    def __post_init__(self):
        try:
            self.prompt = tuple(int(t) for t in self.prompt)
        except (TypeError, ValueError) as e:
            raise ValueError(f"malformed prompt: {e}") from e
        if not self.prompt:
            raise ValueError("empty prompt")
        if not isinstance(self.new_tokens, int) or self.new_tokens < 1:
            raise ValueError(f"new_tokens must be >= 1, got "
                             f"{self.new_tokens!r}")

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.new_tokens

    def time_remaining(self, now: float) -> Optional[float]:
        return time_remaining(self.deadline, now)

    def to_dict(self) -> dict:
        """JSON-able form (the engine snapshot/restore format)."""
        return {"prompt": list(self.prompt),
                "new_tokens": self.new_tokens,
                "deadline": self.deadline, "rid": self.rid,
                "submit_t": self.submit_t}

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(prompt=tuple(d["prompt"]),
                   new_tokens=d["new_tokens"],
                   deadline=d.get("deadline"), rid=d.get("rid", -1),
                   submit_t=d.get("submit_t"))


def bucket_for(request: Request, buckets: Sequence[BucketShape], *,
               unavailable: Collection[BucketShape] = ()
               ) -> BucketShape:
    """Deterministic bucket assignment: the smallest ``s_max`` that
    holds the request end to end, skipping ``unavailable``
    (quarantined) shapes — the nearest-healthy-bucket re-route.
    Raises ``BucketUnavailable`` when only unavailable shapes fit (the
    engine's degraded path takes over) and ``ValueError`` when no
    shape could *ever* run it (the caller rejects outright)."""
    fits_unavailable = None
    for b in sorted(buckets, key=lambda b: b.s_max):
        if request.total_tokens <= b.s_max:
            if b in unavailable:
                fits_unavailable = fits_unavailable or b
                continue
            return b
    if fits_unavailable is not None:
        raise BucketUnavailable(
            f"request fits only quarantined bucket "
            f"{fits_unavailable.key}")
    raise ValueError(
        f"request needs {request.total_tokens} positions; largest "
        f"bucket holds {max(b.s_max for b in buckets)}")


class ContinuousBatcher:
    """Admits requests and hands the engine bucket-shaped batches."""

    def __init__(self, buckets: Sequence[BucketShape], *,
                 clock: Callable[[], float] = time.monotonic,
                 queue_budget: int = 64,
                 flush_budget: Optional[int] = None):
        if not buckets:
            raise ValueError("need at least one bucket shape")
        self.buckets = tuple(sorted(buckets, key=lambda b: b.s_max))
        self.clock = clock
        self.queue_budget = queue_budget
        #: soft budget: queue depth at which a partial flush is forced
        self.flush_budget = queue_budget // 2 \
            if flush_budget is None else flush_budget
        self._pending: Dict[BucketShape, List[Request]] = {
            b: [] for b in self.buckets}
        self._quarantined: set = set()
        self._next_rid = 0

    def depth(self) -> int:
        return sum(len(q) for q in self._pending.values())

    def pending(self, bucket: BucketShape) -> int:
        return len(self._pending[bucket])

    def stamp(self, request: Request) -> Request:
        """Assign rid/submit_t (idempotent: pre-stamped values kept)."""
        if request.rid < 0:
            request.rid = self._next_rid
            self._next_rid += 1
        if request.submit_t is None:
            request.submit_t = self.clock()
        return request

    def submit(self, request: Request, *,
               est_wave_s: float = 0.0) -> Request:
        """Admit one request: assign a bucket + rid and enqueue.

        Every check runs *before* any state mutates, so a rejected
        submit leaves the batcher exactly as it was (no phantom
        half-enqueued request, rid unassigned).  Raises, in order:
        ``ValueError`` when no bucket could ever fit it,
        ``BucketUnavailable`` when only a quarantined bucket fits,
        ``DeadlineInfeasible`` when the deadline cannot survive one
        estimated wave, ``Backpressure`` at the hard budget."""
        bucket = bucket_for(request, self.buckets,
                            unavailable=self._quarantined)
        tr = request.time_remaining(self.clock())
        if tr is not None and tr < est_wave_s:
            raise DeadlineInfeasible(
                f"deadline leaves {tr * 1e3:.1f} ms but one wave is "
                f"estimated at {est_wave_s * 1e3:.1f} ms")
        if self.depth() >= self.queue_budget:
            raise Backpressure(
                f"queue at budget ({self.queue_budget} requests)")
        self.stamp(request)
        self._pending[bucket].append(request)
        return request

    def enqueue(self, request: Request) -> BucketShape:
        """Re-admit an already-admitted request (engine re-route after
        a bucket failure, or snapshot restore): no budget or deadline
        checks — the request was already accepted and must not be
        lost — rid preserved, queue position by rid (oldest first)."""
        bucket = bucket_for(request, self.buckets,
                            unavailable=self._quarantined)
        self.stamp(request)
        q = self._pending[bucket]
        bisect.insort(q, request, key=lambda r: r.rid)
        return bucket

    # -- circuit-breaker hooks (the engine drives these) -------------------

    def quarantine(self, bucket: BucketShape) -> List[Request]:
        """Exclude ``bucket`` from assignment and hand back anything
        queued for it (the engine re-routes those)."""
        self._quarantined.add(bucket)
        drained = self._pending[bucket]
        self._pending[bucket] = []
        return drained

    def reinstate(self, bucket: BucketShape) -> None:
        self._quarantined.discard(bucket)

    def quarantined(self) -> Tuple[BucketShape, ...]:
        return tuple(b for b in self.buckets if b in self._quarantined)

    # -- deadline shedding -------------------------------------------------

    def shed_expired(self) -> List[Request]:
        """Remove and return queued requests whose deadline already
        passed — running them would burn a wave slot on a guaranteed
        miss.  The engine records each as ``deadline_exceeded``."""
        now = self.clock()
        out: List[Request] = []
        for b, q in self._pending.items():
            keep: List[Request] = []
            for r in q:
                tr = r.time_remaining(now)
                (out if tr is not None and tr <= 0 else keep).append(r)
            self._pending[b] = keep
        return out

    # -- flush rules -------------------------------------------------------

    def _deadline_due(self, q: List[Request], est_wave_s: float) -> bool:
        now = self.clock()
        return any(tr is not None and tr <= est_wave_s
                   for tr in (r.time_remaining(now) for r in q))

    def ready(self, *, est_wave_s: float = 0.0,
              force: bool = False
              ) -> Optional[Tuple[BucketShape, List[Request]]]:
        """The next batch to run, or ``None`` when no flush rule fires.

        Requests pop oldest-first within their bucket.  ``force=True``
        drains the fullest non-empty bucket regardless of the rules
        (the engine's drain path).  Quarantined buckets never flush
        (their queues were drained at quarantine time).
        """
        live = [b for b in self.buckets if b not in self._quarantined]
        # full buckets first, smallest shape first (cheapest wave)
        for b in live:
            if len(self._pending[b]) >= b.batch:
                return b, self._pop(b)
        for b in live:
            if self._pending[b] and self._deadline_due(self._pending[b],
                                                       est_wave_s):
                return b, self._pop(b)
        over_budget = self.depth() > self.flush_budget
        if force or over_budget:
            # deepest bucket, smaller shape on ties; the key string
            # breaks exact ties (BucketShape itself is unordered)
            depths = [(len(self._pending[b]), -b.s_max, -b.batch, b.key,
                       b) for b in live if self._pending[b]]
            if depths:
                b = max(depths)[-1]
                return b, self._pop(b)
        return None

    def _pop(self, bucket: BucketShape) -> List[Request]:
        q = self._pending[bucket]
        take, self._pending[bucket] = q[:bucket.batch], q[bucket.batch:]
        return take

    def take(self, bucket: BucketShape, n: int) -> List[Request]:
        """Pop up to ``n`` queued requests for ``bucket``, oldest
        first — the engine's mid-wave join pull: freed KV slots of a
        running wave refill from the same bucket's queue without
        waiting for a flush rule.  Quarantined buckets never hand out
        work (their queues were drained at quarantine time)."""
        if n <= 0 or bucket in self._quarantined:
            return []
        q = self._pending.get(bucket)
        if not q:
            return []
        take, self._pending[bucket] = q[:n], q[n:]
        return take

    # -- snapshot (engine drain/recovery) ----------------------------------

    def snapshot_requests(self) -> List[Request]:
        """Every queued request, oldest (lowest rid) first."""
        out = [r for q in self._pending.values() for r in q]
        out.sort(key=lambda r: r.rid)
        return out
