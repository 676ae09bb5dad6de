"""Planner-coupled per-layer bitwidth search (DeepBurning-MixQ's
co-design loop in planner form, PAPERS.md) — torch port of
``repro.train.qat.bitsearch``, on the port's planner and ``PlanCache``.

For every packable layer of a parameter tree, sweep (w_bits, a_bits)
candidates and price each with BOTH sides of the co-design:

  * hardware: the route-aware analytic cost model
    (``planner.choose_plan``) — normalized to cost per MAC, so a plan
    that packs n values per wide multiply scores ~1/n and a ref
    fallback scores the ref penalty;
  * accuracy: a sensitivity proxy — the relative quantization MSE of
    the layer's weights under the shared rule (``quant/quantizer.py``)
    at that bitwidth.  Layers whose weight distribution survives 4-bit
    quantization cheaply go narrow; sensitive layers stay wide.

The search emits two artifacts:

  * a precision config ``{leaf_path: (w_bits, a_bits)}`` consumed by
    ``qat_params`` (per-layer STE bitwidths);
  * a WARM PLAN-CACHE file: the chosen ``PlanChoice`` for every
    candidate bitwidth x decode-row count is persisted through
    ``planner.PlanCache.put_choice``, so a serving engine started with
    ``plan_policy="cache"`` resolves every bucket from the file without
    re-planning (cache keys are layer *geometry* + bits — name-free —
    so one warm entry covers every layer sharing the shape).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from . import ste


@dataclasses.dataclass(frozen=True)
class BitwidthChoice:
    """One layer's searched precision + the plan that prices it."""
    path: str
    kind: str                  # "matmul" | "conv1d"
    w_bits: int
    a_bits: int
    datapath: str
    plan: str                  # printable plan signature
    route: str
    cost_per_mac: float        # planner score / MACs (lower packs denser)
    sensitivity: float         # relative weight-quantization MSE
    objective: float           # cost_per_mac + lam * sensitivity


def sensitivity_proxy(kernel: torch.Tensor, w_bits: int) -> float:
    """Relative per-output-channel quantization MSE of the shared rule
    (``E[(w - deq(q(w)))^2] / E[w^2]``) — the accuracy half of the
    objective.  Pure statistics of the float weights; no data needed."""
    k2 = kernel.reshape(-1, kernel.shape[-1]).to(torch.float32)
    q, scale = ste.quantize_weights(k2, w_bits)
    deq = q.to(torch.float32) * scale[None, :]
    num = float(torch.mean(torch.square(k2 - deq)))
    den = float(torch.mean(torch.square(k2))) or 1.0
    return num / den


def iter_packable_leaves(params: Any, min_size: int = 1 << 16
                         ) -> Iterable[Tuple[str, str, Any]]:
    """Yield (path, kind, value) for every leaf ``serve_params`` /
    ``qat_params`` would pack — the same walk rules, value tree in."""
    from ...models.quantized import (_QUANT_LEAF_NAMES, _SKIP_CONTAINERS,
                                     _stacked_leading_axis)

    def walk(tree, name):
        if not isinstance(tree, dict):
            return
        for k, v in tree.items():
            path = f"{name}/{k}" if name else k
            if k == "conv" and isinstance(v, dict) and "w" in v \
                    and getattr(v["w"], "ndim", 0) in (2, 3):
                yield path, "conv1d", v["w"]
            elif k in _SKIP_CONTAINERS:
                continue
            elif isinstance(v, dict):
                yield from walk(v, path)
            elif k in _QUANT_LEAF_NAMES and isinstance(v, torch.Tensor) \
                    and (v.ndim == 2
                         or (v.ndim == 3 and _stacked_leading_axis(path))) \
                    and v.numel() >= min_size:
                yield path, "matmul", v

    yield from walk(params, "")
    # the LM head packs unconditionally (serve_params' top-level rule)
    if isinstance(params, dict) and "lm_head" in params \
            and getattr(params["lm_head"], "ndim", 0) == 2:
        yield "lm_head", "matmul", params["lm_head"]


def search_bitwidths(params: Any, *,
                     candidates: Sequence[Tuple[int, int]] = ((4, 4),
                                                             (4, 8),
                                                             (8, 8)),
                     rows_list: Sequence[int] = (8,),
                     lam: float = 4.0,
                     min_size: int = 1 << 16,
                     cache_path: Optional[str] = None
                     ) -> Tuple[Dict[str, Tuple[int, int]],
                                List[BitwidthChoice]]:
    """Joint bitwidth + plan search over a float parameter tree.

    Returns ``(precision, report)`` and — when ``cache_path`` is given
    — persists a warm plan cache covering every candidate bitwidth and
    every decode-row count in ``rows_list`` (the engine's bucket batch
    sizes), so ``plan_policy="cache"`` serving never re-plans.
    """
    from ... import planner

    cache = planner.PlanCache.load(cache_path) if cache_path else None
    rows0 = rows_list[0]
    precision: Dict[str, Tuple[int, int]] = {}
    report: List[BitwidthChoice] = []

    def choose(layer):
        choice = planner.choose_plan(layer)
        if cache is not None:
            cache.put_choice(choice, source="bitsearch")
        return choice

    for path, kind, v in iter_packable_leaves(params, min_size):
        scored: List[BitwidthChoice] = []
        for wb, ab in candidates:
            if kind == "conv1d":
                # the serving convention: conv taps clamp to <= 4 bits,
                # 4-bit unsigned activations (Eqs. 9/10 domain)
                layer = planner.conv1d_spec(path, v.shape[-2], v.shape[-1],
                                            w_bits=min(wb, 4), a_bits=4,
                                            rows=rows0)
                sens = sensitivity_proxy(v.reshape(-1, v.shape[-1]).T,
                                         min(wb, 4))
            else:
                layer = planner.matmul_spec(path, rows0, v.shape[-2],
                                            v.shape[-1], w_bits=wb,
                                            a_bits=ab)
                sens = sensitivity_proxy(v, wb)
            choice = choose(layer)
            cpm = choice.cost.score / max(layer.macs, 1)
            scored.append(BitwidthChoice(
                path=path, kind=kind, w_bits=wb, a_bits=ab,
                datapath=choice.plan.spec.name,
                plan=planner.describe_plan(choice.plan),
                route=choice.cost.route, cost_per_mac=cpm,
                sensitivity=sens, objective=cpm + lam * sens))
            # warm every other row count the engine may bucket at
            for rows in rows_list[1:]:
                if kind == "conv1d":
                    choose(planner.conv1d_spec(
                        path, v.shape[-2], v.shape[-1], w_bits=min(wb, 4),
                        a_bits=4, rows=rows))
                else:
                    choose(planner.matmul_spec(
                        path, rows, v.shape[-2], v.shape[-1], w_bits=wb,
                        a_bits=ab))
        best = min(scored, key=lambda c: c.objective)
        precision[path] = (best.w_bits, best.a_bits)
        report.append(best)

    if cache is not None:
        cache.save()
    return precision, report


def write_search_report(report: Sequence[BitwidthChoice], path: str,
                        extra: Optional[Dict[str, Any]] = None) -> dict:
    """Persist the search result as JSON (atomic — loadgen/CI exit
    path); returns the payload."""
    from ...ioutil import atomic_write_json
    payload = {
        "bench": "bitsearch",
        "layers": [dataclasses.asdict(c) for c in report],
        "precision": {c.path: [c.w_bits, c.a_bits] for c in report},
        **(extra or {}),
    }
    atomic_write_json(path, payload, indent=1, sort_keys=True)
    return payload
