"""The port's benchmark: one run of one cell.

  python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

run from the root of a checkout.  The cell, its configuration, traffic,
limits and metrics are found by name (``harness.Bench``).  It needs
CUDA cards, as many as the cell asks for; the program builds its kernels
into the checkout (``build/``), and the caches this process points at
lie there too.  The last line on standard output is the result as one
JSON object; the numbers compared with the reference are the last lines
on standard error.  With ``--trace 1`` the window runs under
``torch.profiler`` and the cell's per-layer metrics are reported instead
of its end-to-end ones.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches():
    """Kernel caches at fixed paths inside the checkout."""
    build = ROOT / "build" / "portbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from portbench import harness
    bench = harness.Bench(ROOT)
    chips = bench.cell(args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, seed=args.seed,
                           seconds=args.seconds, trace=bool(args.trace),
                           device="cuda", t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} (JAX or the JAX "
              "package); no result", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
