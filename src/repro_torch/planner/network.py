"""Network-level planning: layer-spec extraction and the plan table —
torch port of ``repro.planner.network``.

Adapters turn a model description into ``LayerSpec`` lists — UltraNet
from its static stage table (with an optional mixed-precision first
layer), any registry arch the port's ``init_params`` builds (dense, ssm,
hybrid) from the *shape tree* of its parameters (``init_params`` on the
``meta`` device, which draws nothing and allocates nothing, so a
full-width config plans without materializing a single weight).
``plan_layers`` runs the chosen policy over them, memoizing identical
shapes, and ``format_plan_table`` prints the per-layer result the
``python -m repro_torch.planner`` CLI shows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from ..core.datapath import BSEGPlan, SDVPlan

from .autotune import PlanCache, autotune_layer
from .cost import PlanChoice, choose_plan, default_plan_for, score_plan
from .enumerate import LayerSpec, conv1d_spec, conv2d_spec, matmul_spec

PLAN_POLICIES = ("default", "auto", "cache")


def plan_layers(layers: Sequence[LayerSpec], *, policy: str = "auto",
                cache: Optional[PlanCache] = None, use_kernel: bool = True,
                autotune: bool = False, top_k: int = 3,
                repeats: int = 2, device="cuda") -> List[PlanChoice]:
    """Run the planning policy over a layer list.

    ``default`` scores the repo's uniform default plan per layer (the
    comparison baseline), ``auto`` searches analytically (optionally
    autotuned), ``cache`` reuses persisted choices and fills misses
    with the auto path (storing them back).  ``device`` is where
    ``autotune`` measures (nothing runs on it otherwise).
    """
    if policy not in PLAN_POLICIES:
        raise ValueError(f"unknown plan policy {policy!r}; "
                         f"expected one of {PLAN_POLICIES}")
    if policy == "cache" and cache is None:
        cache = PlanCache.load()
    memo = {}
    out = []
    for layer in layers:
        mk = (layer.key(), policy)
        if mk in memo:
            out.append(dataclasses.replace(memo[mk], layer=layer))
            continue
        if policy == "default":
            plan = default_plan_for(layer)
            if plan is None:
                raise ValueError(
                    f"layer {layer.name!r} (w{layer.w_bits}/"
                    f"a{layer.a_bits}) has no INT32 default plan — use "
                    f"policy='auto' to search the other datapaths")
            choice = PlanChoice(layer=layer, plan=plan,
                                cost=score_plan(layer, plan, use_kernel))
        else:
            choice = cache.get_choice(layer, use_kernel=use_kernel) \
                if policy == "cache" else None
            if choice is None:
                if autotune:
                    choice = autotune_layer(layer, cache=cache,
                                            top_k=top_k, repeats=repeats,
                                            use_kernel=use_kernel,
                                            device=device)
                else:
                    choice = choose_plan(layer, use_kernel=use_kernel,
                                         top_k=top_k)
                if policy == "cache" and choice.measured_us is None:
                    cache.put_choice(choice, source="analytic")
        memo[mk] = choice
        out.append(choice)
    if policy == "cache":
        cache.save()
    return out


# ---------------------------------------------------------------------------
# UltraNet
# ---------------------------------------------------------------------------

def ultranet_layer_specs(size: int = 416, *, w_bits: Optional[int] = None,
                         a_bits: Optional[int] = None,
                         first_layer_a_bits: Optional[int] = 8,
                         batch: int = 1) -> List[LayerSpec]:
    """The 8 conv stages + 1x1 head as conv2d LayerSpecs.

    ``first_layer_a_bits`` widens the input layer's activation domain
    (camera frames are 8-bit; the body stays at the requantized
    ``a_bits``) — the mixed-precision configuration of DESIGN.md
    §Planner.  ``None`` keeps the layer uniform.
    """
    from ..models import ultranet as U
    w_bits = U.W_BITS if w_bits is None else w_bits
    a_bits = U.A_BITS if a_bits is None else a_bits
    specs = []
    for i, s in enumerate(U.ultranet_layer_shapes(size, size)):
        ab = a_bits
        if i == 0 and first_layer_a_bits is not None:
            ab = first_layer_a_bits
        name = "head" if i == len(U.ULTRANET_LAYERS) else f"L{i}"
        specs.append(conv2d_spec(name, s["h"], s["w"], s["cin"], s["cout"],
                                 s["k"], s["k"], w_bits=w_bits, a_bits=ab,
                                 rows=batch, a_signed=False))
    return specs


def plan_ultranet(size: int = 416, *, policy: str = "auto",
                  w_bits: Optional[int] = None, a_bits: Optional[int] = None,
                  first_layer_a_bits: Optional[int] = 8, batch: int = 1,
                  cache: Optional[PlanCache] = None, use_kernel: bool = True,
                  autotune: bool = False, device="cuda") -> List[PlanChoice]:
    return plan_layers(
        ultranet_layer_specs(size, w_bits=w_bits, a_bits=a_bits,
                             first_layer_a_bits=first_layer_a_bits,
                             batch=batch),
        policy=policy, cache=cache, use_kernel=use_kernel,
        autotune=autotune, device=device)


# ---------------------------------------------------------------------------
# registry archs (shape-tree walk — no weight materialization)
# ---------------------------------------------------------------------------

def arch_layer_specs(arch: str, *, bits: int = 4, act_bits: int = 8,
                     rows: int = 8, min_size: int = 1 << 16,
                     smoke: bool = False) -> List[LayerSpec]:
    """LayerSpecs for every kernel ``serve_params`` would pack in an
    assigned arch, from the parameter *shape* tree (``init_params`` on
    the ``meta`` device: shapes only, nothing drawn or allocated)."""
    from ..configs.registry import get_arch
    from ..models.quantized import (_QUANT_LEAF_NAMES, _SKIP_CONTAINERS,
                                    _stacked_leading_axis)
    from ..models.transformer import init_params

    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    shapes = init_params(cfg, device="meta")

    conv_bits = min(bits, 4)
    specs: List[LayerSpec] = []

    def walk(tree, path):
        if not isinstance(tree, dict):
            return
        # key order as the reference's shape tree has it (a JAX pytree
        # comes back from eval_shape with its dict keys sorted)
        for k, v in sorted(tree.items()):
            name = f"{path}/{k}" if path else k
            if k == "conv" and isinstance(v, dict) and "w" in v \
                    and getattr(v["w"], "ndim", 0) in (2, 3):
                channels, taps = v["w"].shape[-2], v["w"].shape[-1]
                specs.append(conv1d_spec(name, channels, taps,
                                         w_bits=conv_bits, a_bits=4,
                                         rows=rows))
            elif k in _SKIP_CONTAINERS:
                continue
            elif isinstance(v, dict):
                walk(v, name)
            elif k in _QUANT_LEAF_NAMES and (
                    getattr(v, "ndim", 0) == 2
                    or (getattr(v, "ndim", 0) == 3
                        and _stacked_leading_axis(name))) \
                    and math.prod(v.shape) >= min_size:
                # a scanned layer stack is a stack of identical 2-D
                # GEMMs — one spec covers every slice (serve_params
                # packs it per layer with the shared plan)
                d_in, d_out = v.shape[-2], v.shape[-1]
                specs.append(matmul_spec(name, rows, d_in, d_out,
                                         w_bits=bits, a_bits=act_bits))
    walk(shapes, "")
    if isinstance(shapes, dict) and "lm_head" in shapes \
            and getattr(shapes["lm_head"], "ndim", 0) == 2:
        d_in, d_out = shapes["lm_head"].shape
        specs.append(matmul_spec("lm_head", rows, d_in, d_out,
                                 w_bits=bits, a_bits=act_bits))
    return specs


def plan_arch(arch: str, *, policy: str = "auto", bits: int = 4,
              act_bits: int = 8, rows: int = 8, min_size: int = 1 << 16,
              smoke: bool = False, cache: Optional[PlanCache] = None,
              use_kernel: bool = True, autotune: bool = False,
              device="cuda") -> List[PlanChoice]:
    return plan_layers(
        arch_layer_specs(arch, bits=bits, act_bits=act_bits, rows=rows,
                         min_size=min_size, smoke=smoke),
        policy=policy, cache=cache, use_kernel=use_kernel,
        autotune=autotune, device=device)


# ---------------------------------------------------------------------------
# the plan table
# ---------------------------------------------------------------------------

def describe_plan(plan) -> str:
    if isinstance(plan, SDVPlan):
        b = f"{'s' if plan.signed_a else 'u'}{plan.w_a}x" \
            f"{'s' if plan.signed_b else 'u'}{plan.w_b}"
        return f"sdv n={plan.n} L={plan.lane} {b}"
    if isinstance(plan, BSEGPlan):
        return (f"bseg {plan.n_k}x{plan.n_i} L={plan.lane} "
                f"wl={plan.w_l} s{plan.w_k}xu{plan.w_i}")
    return repr(plan)


def _packing_factor(plan):
    return plan.n if isinstance(plan, SDVPlan) else (plan.n_k, plan.n_i)


def plan_differs_from_default(choice: PlanChoice) -> bool:
    """True when the chosen (datapath, packing factor) — or the packing
    family itself — differs from the uniform default plan.  A bit
    config with no INT32 default at all always differs."""
    default = default_plan_for(choice.layer)
    if default is None:
        return True
    return (type(choice.plan), choice.plan.spec.name,
            _packing_factor(choice.plan)) != \
           (type(default), default.spec.name, _packing_factor(default))


def _geometry(layer: LayerSpec) -> str:
    if layer.kind == "matmul":
        return f"[{layer.rows}x{layer.k}] @ [{layer.k}x{layer.m}]"
    if layer.kind == "conv2d":
        return (f"{layer.c_in}->{layer.c_out} "
                f"{layer.kh}x{layer.kw} @{layer.h}x{layer.w}")
    return f"c{layer.c_in} t{layer.kw} s{layer.w}"


def format_plan_table(choices: Sequence[PlanChoice],
                      title: str = "") -> str:
    """Render the per-layer plan table (the CLI output).  A ``*`` in
    the last column marks layers whose chosen (datapath, packing
    factor) differs from the uniform default plan."""
    header = ("layer", "kind", "geometry", "bits", "datapath", "plan",
              "dens", "route", "score", "≠def")
    rows = [header]
    total_wide = total_macs = 0
    for c in choices:
        ly = c.layer
        total_wide += c.cost.wide_multiplies
        total_macs += c.cost.macs
        rows.append((
            ly.name, ly.kind, _geometry(ly),
            f"w{ly.w_bits}a{ly.a_bits}", c.plan.spec.name,
            describe_plan(c.plan), f"{c.cost.density:.2f}",
            c.cost.route,
            (f"{c.measured_us:.0f}us" if c.measured_us is not None
             else f"{c.cost.score:.3g}"),
            "*" if plan_differs_from_default(c) else ""))
    widths = [max(len(str(r[i])) for r in rows) for i in range(len(header))]
    lines = []
    if title:
        lines.append(title)
    for i, r in enumerate(rows):
        lines.append("  ".join(str(v).ljust(w) for v, w in zip(r, widths))
                     .rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    dens = total_macs / max(total_wide, 1)
    lines.append(f"total: {total_macs} MACs on {total_wide} wide "
                 f"multiplies ({dens:.2f} MACs/multiply)")
    return "\n".join(lines)
