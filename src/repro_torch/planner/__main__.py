"""``python -m repro_torch.planner`` — print the chosen plan table for an
arch (torch port of ``python -m repro.planner``).

  PYTHONPATH=src python -m repro_torch.planner --arch ultranet
  PYTHONPATH=src python -m repro_torch.planner --arch mamba2-130m --smoke
  PYTHONPATH=src python -m repro_torch.planner --arch tinyllama-1.1b \\
      --policy cache --autotune --cache plans.json

Without ``--autotune`` nothing runs on a device: the analytic choice is
the same on every machine.  ``--autotune`` times the shortlist through
the port's kernels on ``--device`` (default ``cuda``; ``cpu`` times the
kernels' plain versions).

``--arch ultranet`` plans the paper's evaluation CNN (per-layer
mixed precision: ``--first-layer-act-bits`` widens the input layer);
any other name resolves through ``configs/registry`` and plans the
serving projections from the parameter shape tree (dense, ssm and
hybrid families; the meta device, no weights).  ``--smoke`` uses
the reduced config / a small frame (``--no-smoke`` to force full
size, threaded exactly like ``launch/serve.py``).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from ..ioutil import atomic_write_json


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.planner",
        description="mixed-precision packing planner (DESIGN.md §Planner)")
    ap.add_argument("--arch", default="ultranet")
    ap.add_argument("--policy", choices=("default", "auto", "cache"),
                    default="auto")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="reduced config / small frame (CI smoke)")
    ap.add_argument("--size", type=int, default=416,
                    help="UltraNet input frame size")
    ap.add_argument("--weight-bits", type=int, default=None)
    ap.add_argument("--act-bits", type=int, default=None)
    ap.add_argument("--first-layer-act-bits", type=int, default=8,
                    help="UltraNet mixed precision: input-layer "
                         "activation width (0 keeps it uniform)")
    ap.add_argument("--rows", type=int, default=8,
                    help="decode micro-batch rows for matmul layers")
    ap.add_argument("--min-size", type=int, default=1 << 16,
                    help="smallest kernel (elements) worth packing")
    ap.add_argument("--autotune", action="store_true",
                    help="time the analytic top-k through the real "
                         "kernels on --device")
    ap.add_argument("--device", default="cuda",
                    help="where --autotune measures (default cuda; cpu "
                         "runs the kernels' plain versions)")
    ap.add_argument("--cache", default=None,
                    help="plan-cache JSON path (default "
                         "$REPRO_PLAN_CACHE or .repro_plan_cache.json)")
    ap.add_argument("--json", default=None,
                    help="also write the table as JSON")
    args = ap.parse_args(argv)

    from repro_torch import planner

    cache = None
    if args.policy == "cache" or args.autotune:
        cache = planner.PlanCache.load(args.cache)

    if args.arch == "ultranet":
        size = 64 if args.smoke else args.size
        fla = args.first_layer_act_bits or None
        choices = planner.plan_ultranet(
            size, policy=args.policy, w_bits=args.weight_bits,
            a_bits=args.act_bits, first_layer_a_bits=fla,
            cache=cache, autotune=args.autotune, device=args.device)
        title = (f"UltraNet {size}x{size} plan table "
                 f"(policy={args.policy}, first layer "
                 f"a{fla or 'uniform'})")
    else:
        choices = planner.plan_arch(
            args.arch, policy=args.policy,
            bits=args.weight_bits or 4, act_bits=args.act_bits or 8,
            rows=args.rows, min_size=args.min_size, smoke=args.smoke,
            cache=cache, autotune=args.autotune, device=args.device)
        title = (f"{args.arch}{' (reduced)' if args.smoke else ''} "
                 f"plan table (policy={args.policy}, rows={args.rows})")

    if cache is not None:
        cache.save()

    print(planner.format_plan_table(choices, title=title))
    n_diff = sum(planner.plan_differs_from_default(c) for c in choices)
    print(f"{n_diff}/{len(choices)} layers chose a (datapath, packing "
          f"factor) different from the uniform default plan")

    if args.json:
        payload = {
            "arch": args.arch, "policy": args.policy,
            "layers": [{
                "name": c.layer.name, "key": c.layer.key(),
                "plan": planner.plan_to_dict(c.plan),
                "route": c.cost.route, "reason": c.cost.reason,
                "wide_multiplies": c.cost.wide_multiplies,
                "density": c.cost.density, "score": c.cost.score,
                "measured_us": c.measured_us,
                "differs_from_default":
                    planner.plan_differs_from_default(c),
            } for c in choices],
        }
        atomic_write_json(args.json, payload, indent=1)
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
