"""Analytic cost model: score a candidate plan on a layer — torch port
of ``repro.planner.cost``, the same arithmetic and tie breaks over the
port's route tables (``kernels/ops``, whose reason strings are the
reference's word for word).

The score is an *effective wide-multiply count* — the paper's currency
(Tab. II FPS is multiplies/frame over multiplies/cycle).  Three terms:

  1. packed-multiply volume on the route the plan would actually land
     on (``select_packed_route`` / ``select_conv_route`` with
     ``explain=True``): ``sdv_num_multiplies`` for the SDV GEMM/GEMV,
     ``bseg_conv2d_num_multiplies`` / ``bseg_num_multiplies`` for the
     conv kernels.  Both kernel families are word-generic
     (``bseg_common.WordSpec``): one int32 limb for 32-bit words, fp32
     for FP32M convs, two carry-propagating int32 limbs for the wide
     DSP48E2/DSP58 words — so wide-word matmul *and* conv plans
     compile everywhere and are priced as *kernel* routes in the
     paper's wide-multiply currency (one word, ``n`` / ``n_k * n_i``
     MACs), never as ref fallbacks.  A remaining ref fallback (fp32m
     SDV — rounding breaks spill tracking, int8-staging overflow, even
     taps, a hand-built plan overrunning its own storage word, no
     kernel backend: the reason "no Pallas backend") is charged the
     *naive* MAC count times ``REF_ROUTE_FACTOR`` — the plan never
     reaches the packed datapath, so its density is 1;
  2. spill-correction overhead on SDV routes: every wide multiply
     carries ``n`` mod-4 observe/compare/accumulate fix-ups (the
     fractured-LUT tracker, ``finnlite.resource`` charges the same
     per-lane term in LUTs);
  3. guard-bit slicing overhead on BSEG routes: ``(n_k - 1)`` hi/lo
     splits of ``(lane - w_l)`` bits per multiply (Fig. 7) — a larger
     lane with a larger resident low part slices less, which is why
     enumeration sweeps guard bits at all — plus im2col patch-traffic
     for convs lowered to a GEMM (the ``kh*kw``-fold activation
     duplication that spatial reuse would have avoided).

The constants are dimensionless op weights relative to one wide
multiply, calibrated only to order the routes sanely (kernel routes
beat ref; bseg_conv2d beats im2col at 3x3; im2col wins at 1x1); they
are not a wall-clock model — ``autotune`` exists for that.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from ..core.bseg import bseg_num_multiplies
from ..core.datapath import BSEGPlan, INT32, SDVPlan, plan_bseg, plan_sdv
from ..kernels import ops
from ..kernels.bseg_conv2d import bseg_conv2d_num_multiplies
from ..kernels.sdv_matmul import sdv_num_multiplies

from .enumerate import LayerSpec, Plan, enumerate_plans

#: a MAC that stays on the scalar/jnp ref path costs this many
#: effective wide multiplies (density 1, plus the dispatch preference
#: for keeping work on the packed datapath)
REF_ROUTE_FACTOR = 1.5
#: per-lane mod-4 spill-tracking fix-up, per wide multiply (SDV)
SPILL_TRACK_COST = 0.03
#: per-bit guard slicing cost, per wide multiply (BSEG, Fig. 7)
SLICE_COST = 0.015
#: per-element cost of materializing im2col patches (pure traffic)
IM2COL_TRAFFIC_COST = 0.05


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    route: str
    reason: str
    wide_multiplies: int        # packed multiplies the plan spends
    overhead: float             # spill / slicing / traffic ops
    score: float                # effective wide multiplies (lower wins)
    macs: int

    @property
    def density(self) -> float:
        return self.macs / max(self.wide_multiplies, 1)


@dataclasses.dataclass(frozen=True)
class PlanChoice:
    layer: LayerSpec
    plan: Plan
    cost: CostBreakdown
    #: (plan, cost) runner-ups, best first — the autotune shortlist
    alternatives: Tuple = ()
    #: microseconds measured by autotune (None = analytic choice)
    measured_us: Optional[float] = None


def _conv_gemm_geometry(layer: LayerSpec) -> Tuple[int, int, int]:
    """(rows, k, m) of the im2col GEMM for a conv2d layer."""
    return (layer.rows * layer.h * layer.w,
            layer.kh * layer.kw * layer.c_in, layer.c_out)


def route_for(layer: LayerSpec, plan: Plan,
              use_kernel: bool = True) -> Tuple[str, str]:
    """(route, reason) the dispatch layer would pick for this plan."""
    if layer.kind == "matmul":
        if not isinstance(plan, SDVPlan):
            raise TypeError(f"matmul layers take SDV plans, got {plan!r}")
        return ops.select_packed_route(layer.rows, plan=plan,
                                       use_kernel=use_kernel,
                                       explain=True)
    if layer.kind == "conv1d":
        if not isinstance(plan, BSEGPlan):
            raise TypeError(f"conv1d layers take BSEG plans, got {plan!r}")
        return ops.select_conv1d_route(plan, use_kernel=use_kernel,
                                       explain=True)
    # conv2d
    x_shape = (layer.rows, layer.h, layer.w, layer.c_in)
    w_shape = (layer.c_out, layer.c_in, layer.kh, layer.kw)
    if isinstance(plan, BSEGPlan):
        return ops.select_conv_route(x_shape, w_shape, plan=plan,
                                     use_kernel=use_kernel, explain=True)
    # SDV candidate: the conv lowers to an im2col GEMM
    if layer.kh % 2 == 0 or layer.kw % 2 == 0:
        return "ref", (f"even kernel {layer.kh}x{layer.kw}: no stride-1 "
                       "'same' pad for the im2col unfold")
    rows, _, _ = _conv_gemm_geometry(layer)
    route, reason = ops.select_packed_route(rows, plan=plan,
                                            use_kernel=use_kernel,
                                            explain=True)
    if route == "ref":
        return "ref", reason
    return "im2col", f"conv as GEMM on the SDV datapath ({route}: {reason})"


def score_plan(layer: LayerSpec, plan: Plan,
               use_kernel: bool = True) -> CostBreakdown:
    """Score one candidate (lower is better) — see module docstring."""
    route, reason = route_for(layer, plan, use_kernel)
    macs = layer.macs

    if route == "ref":
        return CostBreakdown(route=route, reason=reason,
                             wide_multiplies=macs, overhead=0.0,
                             score=macs * REF_ROUTE_FACTOR, macs=macs)

    if route in ("sdv_matmul", "sdv_matvec"):
        wide = sdv_num_multiplies(layer.rows, layer.m, layer.k, plan)
        overhead = SPILL_TRACK_COST * plan.n * wide
        return CostBreakdown(route=route, reason=reason,
                             wide_multiplies=wide, overhead=overhead,
                             score=wide + overhead, macs=macs)

    if route == "im2col":
        rows, k, m = _conv_gemm_geometry(layer)
        # a BSEG plan landing on im2col runs on the SDV plan the
        # dispatch derives from its widths (ops._im2col_sdv_plan)
        sdv = plan if isinstance(plan, SDVPlan) \
            else ops._im2col_sdv_plan(plan)
        wide = sdv_num_multiplies(rows, m, k, sdv)
        overhead = (SPILL_TRACK_COST * sdv.n * wide
                    + IM2COL_TRAFFIC_COST * rows * k)
        return CostBreakdown(route=route, reason=reason,
                             wide_multiplies=wide, overhead=overhead,
                             score=wide + overhead, macs=macs)

    # BSEG conv kernels: Fig. 7 slicing overhead per wide multiply
    slice_bits = (plan.n_k - 1) * (plan.lane - plan.w_l)
    if route == "bseg_conv2d":
        wide = bseg_conv2d_num_multiplies(layer.h, layer.w, layer.c_in,
                                          layer.c_out, layer.kh, layer.kw,
                                          plan) * layer.rows
    elif route == "bseg_conv1d":
        if layer.kind == "conv1d":
            per_call = bseg_num_multiplies(
                layer.kw, layer.w + layer.kw - 1, plan)
            wide = layer.rows * layer.c_in * per_call
        else:                    # depthwise conv2d shape
            per_row = bseg_num_multiplies(
                layer.kw, layer.w + 2 * (layer.kw // 2), plan)
            wide = layer.rows * layer.h * layer.c_in * per_row
    else:
        raise AssertionError(f"unhandled route {route!r}")
    overhead = SLICE_COST * slice_bits * wide
    return CostBreakdown(route=route, reason=reason,
                         wide_multiplies=wide, overhead=overhead,
                         score=wide + overhead, macs=macs)


def _rank_key(plan: Plan, cost: CostBreakdown):
    density = plan.n if isinstance(plan, SDVPlan) else plan.density
    return (cost.score, -density, plan.lane, _plan_sort_tag(plan))


def _plan_sort_tag(plan: Plan) -> str:
    from .enumerate import plan_to_dict
    return str(sorted(plan_to_dict(plan).items()))


def choose_plan(layer: LayerSpec, candidates: Optional[Sequence[Plan]] = None,
                *, use_kernel: bool = True, top_k: int = 3) -> PlanChoice:
    """Enumerate (unless given), score, and rank; the best candidate
    becomes the choice, the next ``top_k - 1`` ride along as the
    autotune shortlist.  Deterministic: ties break toward higher
    density, then smaller lane, then the plan signature."""
    if candidates is None:
        candidates = enumerate_plans(layer)
    if not candidates:
        raise ValueError(
            f"no feasible packing for layer {layer.name!r} "
            f"(w{layer.w_bits}/a{layer.a_bits}) on any datapath")
    scored = sorted(((p, score_plan(layer, p, use_kernel))
                     for p in candidates),
                    key=lambda pc: _rank_key(*pc))
    best, best_cost = scored[0]
    return PlanChoice(layer=layer, plan=best, cost=best_cost,
                      alternatives=tuple(scored[1:top_k]))


def default_plan_for(layer: LayerSpec) -> Optional[Plan]:
    """The plan the *default* (non-planner) policy would use for this
    layer — ``models/quantized.default_sdv_plan``/``default_bseg_plan``
    semantics without importing models (kept import-cycle-free).
    Returns ``None`` when the INT32 default cannot pack the bit config
    at all (the planner may still find a wider-datapath plan)."""
    try:
        if layer.kind == "matmul":
            return plan_sdv(INT32, layer.w_bits, layer.a_bits,
                            signed_a=True, signed_b=True,
                            park_sign_bits=True)
        return plan_bseg(INT32, min(layer.w_bits, 4), min(layer.a_bits, 4))
    except ValueError:
        return None
