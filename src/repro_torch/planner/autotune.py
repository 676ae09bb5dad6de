"""On-device autotune: time the analytic top-k through the real kernels
— torch port of ``repro.planner.autotune``.

The analytic model (``cost.py``) ranks candidates by effective wide
multiplies; wall clock additionally depends on block shapes, shared
memory and launch counts, so the planner can optionally *measure* the
shortlist through the port's live ``kernels/ops`` dispatch on synthetic
data of the layer's exact shape and dtype domain (operands drawn with
numpy from a fixed seed, then moved to the torch device; each timed
call ends in a device synchronize).

Two guards keep the measurement honest:

  * ref-routed shortlist candidates are skipped when a kernel-routed
    candidate with an identical-or-better analytic score is already on
    the shortlist — a plain ref win would steer serving onto a route
    with no packing at all;
  * every cache entry records the dispatch *route* the plan resolved
    to when it was measured; entries whose recorded route no longer
    matches ``select_*_route`` (e.g. a ref gap since closed by a new
    kernel) are invalidated instead of replayed.

Timings are persisted in a JSON plan cache keyed by
``(layer shape+bits, datapath+plan, backend)`` — the backend is the
torch device type, ``"cuda"`` or ``"cpu"`` — so re-planning the same
network is free; the chosen plan is additionally stored under a
``choice|...`` key that ``serve_params(plan_policy="cache")`` and the
CLI consult without re-timing.  The cache path defaults to
``$REPRO_PLAN_CACHE`` or ``.repro_plan_cache.json`` in the working
directory.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

import torch

from ..core.datapath import SDVPlan
from ..ioutil import atomic_write_json

from .cost import PlanChoice, choose_plan, route_for, score_plan
from .enumerate import LayerSpec, Plan, plan_from_dict, plan_to_dict

CACHE_VERSION = 1
_ENV_VAR = "REPRO_PLAN_CACHE"


class PlanCacheCorrupt(RuntimeError):
    """A plan-cache file exists but cannot be used (torn write, junk
    bytes, wrong schema/version).  ``PlanCache.load(strict=True)``
    raises this; the default (lenient) load starts fresh instead, and
    the serving engine demotes ``plan_policy="cache"`` to ``"auto"``
    with a warning (DESIGN.md §5 failure modes)."""


def default_cache_path() -> str:
    return os.environ.get(_ENV_VAR, ".repro_plan_cache.json")


def _backend() -> str:
    """The process's default backend, as ``jax.default_backend()`` is in
    the reference: ``"cuda"`` with a card, else ``"cpu"``.  Analytic
    choices are keyed by it; ``autotune_layer`` keys its timings and
    choice by the type of the device it measured on."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def timing_key(layer: LayerSpec, plan: Plan, backend: str) -> str:
    pd = plan_to_dict(plan)
    sig = ".".join(f"{k}{v}" for k, v in sorted(pd.items()) if k != "spec")
    return f"{layer.key()}|{pd['spec']}|{sig}|{backend}"


def choice_key(layer: LayerSpec, backend: str) -> str:
    return f"choice|{layer.key()}|{backend}"


@dataclasses.dataclass
class PlanCache:
    """JSON-file plan cache.  ``entries`` maps a key to either
    ``{"us": float, "plan": {...}}`` (a measured candidate) or
    ``{"plan": {...}, "score": float, "source": str}`` (a choice)."""
    path: str
    entries: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @classmethod
    def load(cls, path: Optional[str] = None,
             strict: bool = False) -> "PlanCache":
        """Load the cache file.  A corrupt/unreadable/wrong-schema
        file starts fresh by default; ``strict=True`` raises
        ``PlanCacheCorrupt`` instead (the engine's probe — it falls
        back to ``plan_policy="auto"`` rather than serving against a
        cache it cannot trust)."""
        path = path or default_cache_path()
        entries: Dict[str, dict] = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    payload = json.load(f)
                if not isinstance(payload, dict):
                    raise ValueError("payload is not a JSON object")
                if payload.get("version") != CACHE_VERSION:
                    raise ValueError(
                        f"cache version {payload.get('version')!r} != "
                        f"{CACHE_VERSION}")
                raw = payload.get("entries", {})
                if not isinstance(raw, dict):
                    raise ValueError("entries is not a JSON object")
                entries = dict(raw)
            except (OSError, ValueError) as e:
                if strict:
                    raise PlanCacheCorrupt(f"{path}: {e}") from e
                entries = {}       # corrupt cache: start fresh
        return cls(path=path, entries=entries)

    def save(self) -> None:
        # atomic tmp+rename: a ctrl-C mid-persist (the loadgen/autotune
        # exit path) must never leave a torn cache for the next run
        atomic_write_json(
            self.path, {"version": CACHE_VERSION, "entries": self.entries},
            indent=1, sort_keys=True)

    def get_choice(self, layer: LayerSpec,
                   backend: Optional[str] = None,
                   use_kernel: bool = True) -> Optional[PlanChoice]:
        key = choice_key(layer, backend or _backend())
        entry = self.entries.get(key)
        if entry is None:
            return None
        try:
            plan = plan_from_dict(entry["plan"])
        except (KeyError, TypeError, ValueError):
            # malformed entry (hand-edited / partially-written cache):
            # drop it and re-plan rather than crash the consumer
            self.entries.pop(key, None)
            return None
        cost = score_plan(layer, plan, use_kernel)
        # Route-staleness validation only makes sense against THIS
        # process's routing — an entry keyed for another backend cannot
        # be re-derived here, so it is returned as recorded.
        if (backend or _backend()) == _backend() \
                and entry.get("route") != cost.route:
            # stale: the dispatch would no longer land this plan on the
            # route it was cached against (e.g. a ref gap since closed
            # by a new kernel, or a kernel route since gated away) —
            # invalidate instead of replaying the old decision.
            self.entries.pop(key, None)
            return None
        return PlanChoice(layer=layer, plan=plan, cost=cost,
                          measured_us=entry.get("us"))

    def put_choice(self, choice: PlanChoice, source: str,
                   backend: Optional[str] = None) -> None:
        self.entries[choice_key(choice.layer, backend or _backend())] = {
            "plan": plan_to_dict(choice.plan),
            "score": choice.cost.score,
            "route": choice.cost.route,
            "source": source,
            **({"us": choice.measured_us}
             if choice.measured_us is not None else {}),
        }


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn, device: torch.device, repeats: int = 2) -> float:
    fn()                                     # build / warm
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
        _sync(device)
    return (time.perf_counter() - t0) / repeats * 1e6


def _layer_runner(layer: LayerSpec, plan: Plan, use_kernel: bool,
                  dev: torch.device):
    """Build a nullary callable running the layer through the live
    dispatch with synthetic data in the plan's exact dtype domain (numpy
    draws from seed 0, moved to ``dev``).  The port's
    dispatch always routes as the reference does with
    ``use_kernel=True``; ``use_kernel=False`` times the matmul and
    conv2d ``ref`` modes instead (the short conv has no such mode)."""
    from ..kernels import ops

    rng = np.random.default_rng(0)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def rand_signed(bits, shape):
        lim = 1 << (bits - 1)
        return rng.integers(-lim, lim, size=shape)

    if layer.kind == "matmul":
        rows, k, m = layer.rows, layer.k, layer.m
        w_int = rand_signed(plan.w_a, (m, k)) if plan.signed_a \
            else rng.integers(0, 1 << plan.w_a, size=(m, k))
        words = ops.prepare_sdv_weights(t(w_int), plan)
        lo, hi = ((-(1 << plan.w_b - 1), 1 << plan.w_b - 1)
                  if plan.signed_b else (0, 1 << plan.w_b))
        x = t(rng.integers(lo, hi, size=(rows, k)))
        mode = "auto" if use_kernel else "ref"
        return lambda: ops.packed_matmul(x, words, plan=plan, m=m,
                                         mode=mode)

    if layer.kind == "conv2d" and isinstance(plan, SDVPlan):
        # time the FULL im2col dispatch (patch materialization
        # included — cost.py prices that traffic, so the measurement
        # must pay it too); the base BSEG plan only passes the route
        # gates, compute runs on the sdv_plan override
        from ..core.datapath import INT32, plan_bseg
        x = t(rng.integers(0, 1 << layer.a_bits,
                           size=(layer.rows, layer.h, layer.w, layer.c_in)))
        w = t(rand_signed(plan.w_a, (layer.c_out, layer.c_in, layer.kh,
                                     layer.kw)), torch.int8)
        base = plan_bseg(INT32, 2, 2)
        # even taps cannot im2col ('same' pad): the dispatch would run
        # the ref conv, so that is what gets timed
        mode = "im2col" if layer.kh % 2 and layer.kw % 2 \
            and use_kernel else "ref"
        return lambda: ops.packed_conv2d(
            x, w, plan=base, mode=mode,
            sdv_plan=plan if mode == "im2col" else None, zero_point=0)

    if layer.kind == "conv2d":
        x = t(rng.integers(0, 1 << plan.w_i,
                           size=(layer.rows, layer.h, layer.w, layer.c_in)))
        w = t(rand_signed(plan.w_k, (layer.c_out, layer.c_in, layer.kh,
                                     layer.kw)), torch.int8)
        mode = "auto" if use_kernel else "ref"
        return lambda: ops.packed_conv2d(x, w, plan=plan, zero_point=0,
                                         mode=mode)

    # conv1d: the causal depthwise short conv
    taps = t(rand_signed(plan.w_k, (layer.c_in, layer.kw)))
    kappa, tap_sum = ops.prepare_bseg_taps(taps, plan)
    zp = 1 << (plan.w_i - 1)
    x = t(rng.integers(-zp, (1 << plan.w_i) - zp,
                       size=(layer.rows, layer.w, layer.c_in)), torch.int8)
    return lambda: ops.bseg_conv1d(x, kappa, tap_sum, plan=plan,
                                   n_taps=layer.kw, zero_point=zp)


def timing_shortlist(layer: LayerSpec, analytic: PlanChoice) -> List[Plan]:
    """The plans worth timing for a layer: the analytic top-k, minus
    ref-routed candidates that a kernel-routed candidate with an
    identical-or-better analytic score makes pointless to measure.
    Routes come from the CostBreakdowns already baked into ``analytic``
    (scored with the caller's ``use_kernel``).

    A host wall clock can rank the plain ref above a kernel route (the
    kernels' plain CPU versions emulate the datapath step by step) —
    but serving a ref "winner" means serving *no* packing at all, so a
    ref candidate only stays on the shortlist when every kernel-routed
    candidate is analytically more expensive.
    """
    cands = [(analytic.plan, analytic.cost)] + list(analytic.alternatives)
    kernel_best = min((c.score for _, c in cands if c.route != "ref"),
                      default=None)
    out: List[Plan] = []
    for plan, cost in cands:
        if cost.route == "ref" and kernel_best is not None \
                and kernel_best <= cost.score:
            continue
        out.append(plan)
    return out


def autotune_layer(layer: LayerSpec, *, cache: Optional[PlanCache] = None,
                   top_k: int = 3, repeats: int = 2,
                   use_kernel: bool = True,
                   device="cuda") -> PlanChoice:
    """Time the analytic top-k through the real kernels on ``device``
    (the card unless the caller asks for ``"cpu"``, where the kernels
    run their plain versions); return the fastest as the choice
    (cache-backed under the device type as backend, cached timings are
    reused; timing entries whose recorded dispatch route went stale are
    re-measured)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    analytic = choose_plan(layer, use_kernel=use_kernel, top_k=top_k)
    shortlist = timing_shortlist(layer, analytic)
    backend = dev.type
    timed = []
    for plan in shortlist:
        route, _ = route_for(layer, plan, use_kernel)
        key = timing_key(layer, plan, backend)
        entry = cache.entries.get(key) if cache is not None else None
        if entry is not None and entry.get("route") != route:
            # stale: routing changed since this timing was recorded —
            # the measured number belongs to a different kernel.
            cache.entries.pop(key, None)
            entry = None
        if entry is not None:
            us = entry["us"]
        else:
            us = _time_us(_layer_runner(layer, plan, use_kernel, dev), dev,
                          repeats)
            if cache is not None:
                cache.entries[key] = {"us": us,
                                      "plan": plan_to_dict(plan),
                                      "route": route}
        timed.append((us, plan))
    timed.sort(key=lambda t: t[0])
    best_us, best = timed[0]
    choice = PlanChoice(layer=layer, plan=best,
                        cost=score_plan(layer, best, use_kernel),
                        alternatives=analytic.alternatives,
                        measured_us=best_us)
    if cache is not None:
        cache.put_choice(choice, source="autotune", backend=backend)
    return choice
