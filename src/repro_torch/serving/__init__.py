"""Online serving engine (DESIGN.md §5) — torch port of
``repro.serving``.

The subsystem that connects "requests arrive" to "planner-chosen
packed kernels execute at high occupancy":

  * ``queue``   — ``Request`` admission + the continuous batcher that
    coalesces traffic into planner-bucketed batch shapes (pad-to-
    bucket; budget- and deadline-aware flush; hard-budget
    backpressure; single-sourced deadline semantics via
    ``time_remaining``; injectable clock);
  * ``engine``  — per-(arch, bucket) warmup + plan resolution
    through ``repro_torch.planner`` (``plan_policy`` defaults to ``cache``
    when a plan-cache file exists, else ``auto``; a corrupt cache
    demotes to ``auto`` instead of raising), the decode session table
    with KV-cache slot reuse, wave execution, and the fault-tolerance
    layer: per-bucket circuit breaker, deadline shedding + admission
    control, degraded fallback path, terminal-outcome ledger, and
    drain / snapshot / restore;
  * ``faults``  — the seeded deterministic fault-injection seam
    (``FaultPlan``) that forces every failure mode reproducibly;
  * ``metrics`` — p50/p99 latency, tokens/s, queue depth, fault
    counters, and packed-multiply utilization (achieved
    MACs/wide-multiply via the existing density accounting), exported
    as a JSON snapshot (written atomically);
  * ``loadgen`` — Poisson / closed-loop drivers with backpressure
    retry + the client-side outcome ledger, the serving sweep, the
    chaos sweep and the continuous-batching sweep (``python -m
    repro_torch.serving.loadgen [--chaos|--continuous]``).

Not ported yet: speculative decoding (the reference's ``spec``;
``Engine(speculative=True)`` and ``loadgen --speculative`` raise
``NotImplementedError``).  ``launch/serve.py --engine on`` is the thin
CLI over this package.
"""
from .queue import (Backpressure, BucketShape, BucketUnavailable,
                    ContinuousBatcher, DeadlineInfeasible, Request,
                    bucket_for, default_buckets, time_remaining)
from .engine import (Completion, Engine, EngineDraining, Session,
                     SessionTable, default_plan_policy)
from .faults import (FAULT_CLASSES, FaultPlan, InjectedFault, WaveFaults,
                     corrupt_json_file)
from .metrics import (EngineMetrics, latency_summary, packed_layer_stats,
                      packed_utilization, write_snapshot)

__all__ = [
    "Backpressure", "BucketShape", "BucketUnavailable",
    "ContinuousBatcher", "DeadlineInfeasible", "Request",
    "bucket_for", "default_buckets", "time_remaining",
    "Completion", "Engine", "EngineDraining", "Session", "SessionTable",
    "default_plan_policy",
    "FAULT_CLASSES", "FaultPlan", "InjectedFault", "WaveFaults",
    "corrupt_json_file",
    "EngineMetrics", "latency_summary", "packed_layer_stats",
    "packed_utilization", "write_snapshot",
]
