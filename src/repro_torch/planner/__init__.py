"""Mixed-precision packing planner (DESIGN.md §Planner) — torch port
of ``repro.planner``.

The paper packs (un-)signed inputs of *arbitrary* bitwidths onto a wide
datapath; this subsystem is the bridge between that Sec. III math
(``core/datapath.py``) and the kernel dispatch (``kernels/ops.py``): it
dimensions every feasible packing for a layer across all four
``DatapathSpec``s (``enumerate``), scores them with an analytic cost
model that knows which kernel route each plan would actually land on
(``cost``), optionally times the top candidates through the real
kernels with a persisted JSON cache (``autotune``), and exposes arch
adapters plus a plan table (``network``, ``python -m repro_torch.planner``).

Per-layer bitwidth configs (e.g. an 8-bit first layer over a 4-bit
body) therefore route each layer to its best (datapath, packing factor)
automatically — ``serve_params(plan_policy="auto")`` and
``ultranet_forward(plans=...)`` consume the output.

The analytic ranking (``enumerate``, ``cost``) is the reference's, tie
breaks included, over the port's own route tables (``kernels/ops``), so
it picks the reference's plan for every layer; autotune times the
shortlist through the port's kernels on the torch device; the plan-cache
file keeps the reference's JSON layout, so either package reads the
other's file (timings and choices stay keyed by backend: ``"cuda"`` /
``"cpu"`` here, the JAX backend's name there).
"""
from .enumerate import (LayerSpec, conv1d_spec, conv2d_spec,
                        enumerate_bseg_plans, enumerate_plans,
                        enumerate_sdv_plans, matmul_spec, plan_from_dict,
                        plan_to_dict)
from .cost import (CostBreakdown, PlanChoice, choose_plan, default_plan_for,
                   route_for, score_plan)
from .autotune import (PlanCache, PlanCacheCorrupt, autotune_layer,
                       default_cache_path, timing_key, timing_shortlist)
from .network import (PLAN_POLICIES, arch_layer_specs, describe_plan,
                      format_plan_table, plan_arch, plan_differs_from_default,
                      plan_layers, plan_ultranet, ultranet_layer_specs)

__all__ = [
    "LayerSpec", "conv1d_spec", "conv2d_spec", "matmul_spec",
    "enumerate_plans", "enumerate_sdv_plans", "enumerate_bseg_plans",
    "plan_to_dict", "plan_from_dict",
    "CostBreakdown", "PlanChoice", "score_plan", "route_for",
    "choose_plan", "default_plan_for",
    "PlanCache", "PlanCacheCorrupt", "autotune_layer",
    "default_cache_path",
    "timing_key", "timing_shortlist",
    "PLAN_POLICIES", "plan_layers", "plan_ultranet", "plan_arch",
    "ultranet_layer_specs", "arch_layer_specs", "format_plan_table",
    "describe_plan", "plan_differs_from_default",
]
