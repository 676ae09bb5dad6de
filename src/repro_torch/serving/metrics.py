"""Serving metrics: latency percentiles, throughput, queue depth,
fault-tolerance counters, and packed-multiply utilization, exported as
one JSON-able snapshot — torch port of ``repro.serving.metrics``
(written atomically — ``write_snapshot`` uses the tmp+rename dance from
``repro_torch.ioutil``, so a ctrl-C mid-benchmark can never leave a
torn snapshot).

Latency is measured per request from ``submit`` to the step its last
token came off the device (the engine synchronizes the device inside
the timed loop, so the numbers cannot be understated by asynchronous
launches).

Packed-multiply utilization is the paper's operational-density
currency applied to a serving bucket: achieved MACs per wide multiply
for one decode step of the bucket's batch, computed from the packed
parameter containers with the existing accounting
(``sdv_num_multiplies`` / ``bseg_num_multiplies``) and the *actual*
dispatch route each layer's plan lands on (a ref-routed layer counts
density 1 — it never reaches the packed datapath; memory-packed
layers likewise, their packing is HBM-only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

from ..ioutil import atomic_write_json


def write_snapshot(path: str, payload: Any) -> None:
    """Persist a JSON snapshot atomically (tmp file + ``os.replace``):
    readers see the old payload or the new one, never a torn write."""
    atomic_write_json(path, payload, indent=1, sort_keys=True)


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of pre-sorted values:
    the smallest value with at least q% of the sample at or below it,
    ``ceil(q/100 * n)`` in one-based ranks — identical to
    ``numpy.percentile(..., method="inverted_cdf")``.  (This used to
    round half-even on an *interpolation* index, under-reporting p99
    whenever ``0.99 * (n-1)`` rounded down — e.g. every n in
    101..150.)"""
    if not sorted_vals:
        return 0.0
    n = len(sorted_vals)
    rank = max(1, min(n, math.ceil(q / 100.0 * n)))
    return sorted_vals[rank - 1]


def latency_summary(latencies_s: List[float]) -> Dict[str, float]:
    vals = sorted(latencies_s)
    n = len(vals)
    return {
        "count": n,
        "p50_ms": percentile(vals, 50) * 1e3,
        "p99_ms": percentile(vals, 99) * 1e3,
        "max_ms": (vals[-1] * 1e3) if vals else 0.0,
        "mean_ms": (sum(vals) / n * 1e3) if n else 0.0,
    }


# ---------------------------------------------------------------------------
# packed-multiply utilization (density accounting over a param tree)
# ---------------------------------------------------------------------------

def packed_layer_stats(qparams: Any, rows: int,
                       use_kernel: bool = True) -> List[Dict[str, Any]]:
    """Per packed layer: (route, reason, MACs, wide multiplies) for one
    decode step of ``rows`` batch rows.

    Routes are resolved with ``use_kernel=True`` by default — the
    *datapath* route the plan lands on (the kernel on the card; on a
    CPU tensor the same route runs the kernel's plain version).
    """
    from ..core.bseg import bseg_num_multiplies
    from ..kernels import bseg_common, ops
    from ..kernels.sdv_matmul import sdv_num_multiplies
    from ..models.quantized import BSEGConv, PackedLinear, SDVLinear
    from ..planner import describe_plan

    stats: List[Dict[str, Any]] = []

    def add(name, kind, datapath, plan_desc, route, reason, macs, wide):
        stats.append({"layer": name, "kind": kind, "datapath": datapath,
                      "plan": plan_desc, "route": route, "reason": reason,
                      "macs": int(macs), "wide_multiplies": int(wide)})

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}" if path else k)
            return
        if isinstance(tree, SDVLinear):
            # [d_in, G] (+ a leading (2,) limb-plane axis on wide
            # plans, + a leading L layer axis when scan-stacked)
            d_in = tree.words.shape[-2]
            base = 2 + (bseg_common.sdv_word_spec(tree.plan).limbs == 2)
            stack = tree.words.shape[0] if tree.words.ndim == base + 1 \
                else 1
            macs = rows * d_in * tree.d_out * stack
            route, reason = ops.select_packed_route(
                rows, plan=tree.plan, use_kernel=use_kernel, explain=True)
            wide = macs if route == "ref" else \
                sdv_num_multiplies(rows, tree.d_out, d_in,
                                   tree.plan) * stack
            add(path, "sdv_matmul", tree.plan.spec.name,
                describe_plan(tree.plan), route, reason, macs, wide)
        elif isinstance(tree, BSEGConv):
            channels = tree.tap_sum.shape[-1]
            stack = tree.tap_sum.shape[0] if tree.tap_sum.ndim == 2 else 1
            macs = rows * channels * tree.taps
            route, reason = ops.select_conv1d_route(
                tree.plan, use_kernel=use_kernel, explain=True)
            wide = macs if route == "ref" else \
                rows * channels * bseg_num_multiplies(
                    tree.taps, tree.taps, tree.plan)   # one output step
            add(path, "bseg_conv1d", tree.plan.spec.name,
                describe_plan(tree.plan), route, reason,
                macs * stack, wide * stack)
        elif isinstance(tree, PackedLinear):
            d_in = tree.words.shape[-2]
            stack = 1                    # stacked blocks / expert banks
            for s in tree.words.shape[:-2]:
                stack *= s
            macs = rows * d_in * tree.d_out * stack
            add(path, "quant_matmul", "memory", f"w{tree.bits} lane words",
                "quant_matmul", "memory packing only: density 1",
                macs, macs)

    walk(qparams, "")
    return stats


def packed_utilization(qparams: Any, rows: int,
                       use_kernel: bool = True) -> Dict[str, Any]:
    """Aggregate achieved MACs/wide-multiply for one decode step."""
    stats = packed_layer_stats(qparams, rows, use_kernel)
    macs = sum(s["macs"] for s in stats)
    wide = sum(s["wide_multiplies"] for s in stats)
    kernel_routed = [s for s in stats if s["route"] != "ref"
                     and s["kind"] != "quant_matmul"]
    return {
        "rows": rows,
        "packed_layers": len(stats),
        "kernel_routed_layers": len(kernel_routed),
        "macs_per_step": macs,
        "wide_multiplies_per_step": wide,
        "density_achieved": macs / max(wide, 1),
        "layers": stats,
    }


# ---------------------------------------------------------------------------
# the engine-side registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EngineMetrics:
    """Accumulates engine observations; ``snapshot()`` is the JSON
    export (everything in it is a plain int/float/str/list/dict)."""
    clock: Callable[[], float]
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    ttft_s: List[float] = dataclasses.field(default_factory=list)
    depth_samples: List[int] = dataclasses.field(default_factory=list)
    rejected: int = 0
    rejected_infeasible: int = 0    # admission control: hopeless deadline
    malformed: int = 0              # rejected at request validation
    shed: int = 0                   # deadline_exceeded before a wave slot
    failed: int = 0                 # terminal failure (fallback died too)
    rerouted: int = 0               # re-admitted after a bucket failure
    wave_failures: int = 0
    failure_kinds: Dict[str, int] = dataclasses.field(default_factory=dict)
    quarantines: int = 0
    recoveries: int = 0
    fallback_waves: int = 0
    midwave_joins: int = 0          # sessions that joined a running wave
    tokens_out: int = 0
    # -- target-wave accounting (speculative decoding, DESIGN.md §5.2):
    # a "target wave" is one launch of the target model — either a
    # plain decode step or one spec verify wave.  tokens emitted per
    # target wave is the speedup currency of the speculative sweep.
    decode_launches: int = 0        # plain decode programs dispatched
    decode_tokens: int = 0          # tokens those launches emitted
    spec_iters: int = 0             # draft+verify rounds completed
    spec_tokens: int = 0            # tokens those rounds emitted
    spec_draft_wall_s: float = 0.0
    spec_verify_wall_s: float = 0.0
    spec_accept_hist: Dict[int, int] = dataclasses.field(
        default_factory=dict)      # emitted-per-slot-round -> count
    spec_degraded: int = 0          # buckets that fell back to plain
    waves: int = 0
    wave_steps: int = 0
    wave_wall_s: float = 0.0
    busy_slot_steps: int = 0        # occupied KV slots summed over steps
    slot_steps: int = 0             # batch-width slots summed over steps
    per_bucket: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    started_t: Optional[float] = None
    finished_t: Optional[float] = None

    def record_start(self) -> None:
        if self.started_t is None:
            self.started_t = self.clock()

    def record_completion(self, *, submit_t: float, start_t: float,
                          finish_t: float, n_tokens: int,
                          first_token_t: Optional[float] = None) -> None:
        """One finished request; ``first_token_t`` (the port's, absent
        from the reference) adds its time to first token."""
        self.record_start()
        self.latencies_s.append(finish_t - submit_t)
        self.queue_wait_s.append(start_t - submit_t)
        if first_token_t is not None:
            self.ttft_s.append(first_token_t - submit_t)
        self.tokens_out += n_tokens
        self.finished_t = finish_t

    def record_wave(self, bucket_key: str, *, steps: int, wall_s: float,
                    requests: int, busy_slot_steps: int = 0,
                    slot_steps: int = 0, decode_steps: int = 0,
                    decode_wall_s: float = 0.0, prefill_calls: int = 0,
                    prefill_wall_s: float = 0.0) -> None:
        """One finished wave.  Beyond the reference's fields, the
        bucket keeps the wave's decode iterations and per-slot prefill
        calls with their synchronized walls (the port's per-iteration
        timings: decode ms = decode_wall_s / decode_steps)."""
        self.waves += 1
        self.wave_steps += steps
        self.wave_wall_s += wall_s
        self.busy_slot_steps += busy_slot_steps
        self.slot_steps += slot_steps
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["waves"] += 1
        b["steps"] += steps
        b["wall_s"] += wall_s
        b["requests"] += requests
        b["busy_slot_steps"] = b.get("busy_slot_steps", 0) + busy_slot_steps
        b["slot_steps"] = b.get("slot_steps", 0) + slot_steps
        for key, v in (("decode_steps", decode_steps),
                       ("decode_wall_s", decode_wall_s),
                       ("prefill_calls", prefill_calls),
                       ("prefill_wall_s", prefill_wall_s)):
            b[key] = b.get(key, 0) + v

    def record_join(self) -> None:
        self.midwave_joins += 1

    def record_decode_launch(self, tokens_emitted: int) -> None:
        """One plain (non-speculative) decode-step launch and the
        tokens it appended across the batch (teacher-forced slots
        emit nothing)."""
        self.decode_launches += 1
        self.decode_tokens += tokens_emitted

    def record_spec_round(self, bucket_key: str, *,
                          accepted: List[int], draft_s: float,
                          verify_s: float) -> None:
        """One speculative round: per speculating slot, the number of
        tokens it emitted (1 = bonus only, k+1 = everything accepted),
        plus the round's draft and verify wall clocks."""
        self.spec_iters += 1
        self.spec_draft_wall_s += draft_s
        self.spec_verify_wall_s += verify_s
        for n in accepted:
            self.spec_tokens += n
            self.spec_accept_hist[n] = self.spec_accept_hist.get(n, 0) + 1
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["spec_iters"] = b.get("spec_iters", 0) + 1
        b["spec_tokens"] = b.get("spec_tokens", 0) + sum(accepted)

    def record_spec_degraded(self, bucket_key: str) -> None:
        """A bucket's speculative path failed (draft resolution, build
        or runtime): it degraded to plain decode on the SAME bucket —
        never to the batch-1 fallback."""
        self.spec_degraded += 1
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["spec_degraded"] = b.get("spec_degraded", 0) + 1

    def record_rejection(self, infeasible: bool = False) -> None:
        self.rejected += 1
        if infeasible:
            self.rejected_infeasible += 1

    def record_malformed(self) -> None:
        self.malformed += 1

    def record_shed(self) -> None:
        self.shed += 1

    def record_failed(self) -> None:
        self.failed += 1

    def record_reroute(self) -> None:
        self.rerouted += 1

    def record_wave_failure(self, bucket_key: str, kind: str) -> None:
        self.wave_failures += 1
        self.failure_kinds[kind] = self.failure_kinds.get(kind, 0) + 1
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["failures"] = b.get("failures", 0) + 1

    def record_quarantine(self, bucket_key: str) -> None:
        self.quarantines += 1
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["quarantines"] = b.get("quarantines", 0) + 1

    def record_recovery(self, bucket_key: str) -> None:
        self.recoveries += 1
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["recoveries"] = b.get("recoveries", 0) + 1

    def record_fallback_wave(self) -> None:
        self.fallback_waves += 1

    def sample_depth(self, depth: int) -> None:
        self.depth_samples.append(depth)

    def set_bucket_utilization(self, bucket_key: str,
                               util: Dict[str, Any]) -> None:
        b = self.per_bucket.setdefault(
            bucket_key, {"waves": 0, "steps": 0, "wall_s": 0.0,
                         "requests": 0})
        b["utilization"] = util

    def _spec_snapshot(self) -> Dict[str, Any]:
        """Effective tokens-per-target-wave counts EVERY target launch
        — verify waves and plain decode steps alike — so a spec engine
        that keeps degrading cannot report a flattering ratio."""
        target_waves = self.spec_iters + self.decode_launches
        generated = self.spec_tokens + self.decode_tokens
        return {
            "rounds": self.spec_iters,
            "spec_tokens": self.spec_tokens,
            "acceptance_hist": {str(k): v for k, v in
                                sorted(self.spec_accept_hist.items())},
            "mean_accepted": (self.spec_tokens
                              / max(sum(self.spec_accept_hist.values()),
                                    1)),
            "draft_wall_s": self.spec_draft_wall_s,
            "verify_wall_s": self.spec_verify_wall_s,
            "degraded_buckets": self.spec_degraded,
            "plain_decode_launches": self.decode_launches,
            "tokens_per_target_wave": (generated / target_waves
                                       if target_waves else 0.0),
        }

    def snapshot(self) -> Dict[str, Any]:
        span = 0.0
        if self.started_t is not None and self.finished_t is not None:
            span = max(self.finished_t - self.started_t, 1e-9)
        depth = self.depth_samples
        terminal = len(self.latencies_s) + self.shed + self.failed
        return {
            "requests_completed": len(self.latencies_s),
            "requests_rejected": self.rejected,
            "rejected_infeasible": self.rejected_infeasible,
            "requests_malformed": self.malformed,
            "requests_shed": self.shed,
            "requests_failed": self.failed,
            "shed_rate": self.shed / terminal if terminal else 0.0,
            "faults": {
                "wave_failures": self.wave_failures,
                "kinds": dict(sorted(self.failure_kinds.items())),
                "quarantines": self.quarantines,
                "recoveries": self.recoveries,
                "rerouted": self.rerouted,
                "fallback_waves": self.fallback_waves,
            },
            "tokens_out": self.tokens_out,
            "tokens_per_s": self.tokens_out / span if span else 0.0,
            "speculative": self._spec_snapshot(),
            "latency": latency_summary(self.latencies_s),
            "queue_wait": latency_summary(self.queue_wait_s),
            "ttft": latency_summary(self.ttft_s),
            "queue_depth": {
                "mean": (sum(depth) / len(depth)) if depth else 0.0,
                "max": max(depth) if depth else 0,
            },
            "waves": {"count": self.waves, "steps": self.wave_steps,
                      "wall_s": self.wave_wall_s,
                      "midwave_joins": self.midwave_joins,
                      "busy_slot_steps": self.busy_slot_steps,
                      "slot_steps": self.slot_steps,
                      # wave occupancy: the fraction of compiled batch
                      # slots that held a live session, summed over
                      # every wave iteration — the packed datapath is
                      # only as busy as this number
                      "occupancy": (self.busy_slot_steps / self.slot_steps
                                    if self.slot_steps else 0.0)},
            "buckets": self.per_bucket,
        }
