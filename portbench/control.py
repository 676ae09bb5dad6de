"""The readings that set a cell's limits: its numbers compared with the
reference on several seeds in one process (the kernels are built once),
for the program as the configuration states it and for the control, the
program's own next lower precision (``--act-bits``: W4A4 where the
configuration states W4A8).

  python3 portbench/control.py --workload <name> --seconds <s> \\
      --act-bits 8 4 --seeds <n> <n> ...

One JSON line a run on standard output: the seed, the activation bits,
the checks and the end-to-end metrics.  Needs a CUDA card.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _caches  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--act-bits", type=int, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    _caches()
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: control readings need a CUDA card", file=sys.stderr)
        return 2
    bench = harness.Bench(ROOT)
    for bits in args.act_bits:
        for seed in args.seeds:
            t0 = time.perf_counter()
            out = harness.run_cell(bench, args.workload, seed=seed,
                                   seconds=args.seconds, trace=False,
                                   device="cuda", t_start=t0, act_bits=bits)
            print(json.dumps({"seed": seed, "act_bits": bits,
                              "checks": out["checks"],
                              "metrics": out["metrics"],
                              "peak": out["device"]["memory_peak_bytes"]}),
                  flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
