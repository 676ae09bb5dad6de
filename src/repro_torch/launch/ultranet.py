"""UltraNet-INT4 inference through the BSEG packed datapath — the
paper's own evaluation workload (Tabs. II-IV), on the torch port.

Runs one seeded frame through ``ultranet_forward(mode="bseg")``
(kernel B3 for the 3x3 stages, B2 for the 1x1 head on the card) and the
exact integer oracle, and prints whether they agree bit for bit, the
route of each conv, the 416x416 multiply counts and the Tab. IV lines
of the resource model.

  PYTHONPATH=src python -m repro_torch.launch.ultranet --size 416
  PYTHONPATH=src python -m repro_torch.launch.ultranet --size 64 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

#: one frame, weights from seed 0 and the frame from seed 1, as in the
#: reference's ``examples/ultranet_bseg.py``
BATCH = 1
WEIGHT_SEED = 0
FRAME_SEED = 1


def main(argv=None, default_size: int = 416):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=default_size,
                    help="input resolution (paper: 416)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.finnlite import ultranet_tables
    from repro_torch.models import ultranet as U

    device = resolve_device(args.device)
    params = U.init_ultranet(WEIGHT_SEED, device=device)
    rng = np.random.default_rng(FRAME_SEED)
    img = torch.tensor(rng.integers(0, 16, (BATCH, args.size, args.size, 3)),
                       dtype=torch.int32, device=device)

    def timed(mode):
        t0 = time.perf_counter()
        y = U.ultranet_forward(params, img, mode=mode, device=device)
        if y.is_cuda:
            torch.cuda.synchronize(device)
        return y, time.perf_counter() - t0

    y_ref, t_ref = timed("ref")
    y_bseg, t_cold = timed("bseg")
    _, t_warm = timed("bseg")
    exact = bool(torch.equal(y_ref, y_bseg))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU")
    print(f"UltraNet {args.size}x{args.size} on {name}: head "
          f"{tuple(y_ref.shape)}, BSEG bit-exact vs integer conv oracle: "
          f"{exact}")
    routes = U.ultranet_conv_routes(args.size, args.size)
    print("conv dispatch:",
          " ".join(f"L{i}:{r}" for i, r in enumerate(routes)))
    print(f"(wall: ref {t_ref:.3f}s, packed {t_cold:.3f}s cold / "
          f"{t_warm:.3f}s warm)")

    m = U.ultranet_multiplies(416, 416, mode="bseg")
    n = U.ultranet_multiplies(416, 416, mode="naive")
    print(f"\n416x416 frame: {m['total_macs'] / 1e6:.0f}M MACs")
    print(f"  naive multiplies : {n['total_mults'] / 1e6:.0f}M")
    print(f"  BSEG  multiplies : {m['total_mults'] / 1e6:.0f}M "
          f"({m['density_achieved']:.2f} MACs/multiply on the int32 "
          "datapath; 6/multiply on DSP48E2)")

    t = ultranet_tables()
    t4m, t4p = t["tab4"]["model"], t["tab4"]["paper"]
    print("\nTab IV reproduction (model vs paper):")
    print(f"  FINN baseline: {t4m['finn_lut']} LUT / {t4m['finn_dsp']} DSP "
          f"(paper {t4p['finn']['lut']} / {t4p['finn']['dsp']})")
    print(f"  BSEG         : {t4m['bseg_lut']} LUT / {t4m['bseg_dsp']} DSP "
          f"(paper {t4p['bseg']['lut']} / {t4p['bseg']['dsp']})")
    print(f"  LUT reduction: {1 - t4m['bseg_lut'] / t4m['finn_lut']:.0%} "
          f"(paper: 63%)")
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main())
