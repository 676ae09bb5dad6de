"""Quickstart: the paper's packing arithmetic in 60 lines, on the torch
port.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

On a CUDA card the packed products run on the port's hand-written
kernels (the SDV GEMV, B1; the BSEG conv1d, B4); with ``--device cpu``
they run the kernels' plain torch versions.  The wide DSP48E2 48-bit
words are carried as two int32 limbs, as on the card.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (DSP48E2, INT32, bseg_density, plan_bseg,
                              plan_sdv, sdv_density)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import conv1d_causal_ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    i32 = dict(dtype=torch.int32, device=dev)
    rng = np.random.default_rng(0)

    # --- 1. operational density (paper Fig. 5) --------------------------
    print("SDV  density, DSP48E2, INT8:", sdv_density(DSP48E2, 8, 8),
          "(paper: 2)")
    print("SDV  density, DSP48E2, INT4:", sdv_density(DSP48E2, 4, 4))
    print("BSEG density, DSP48E2, INT4:", bseg_density(DSP48E2, 4, 4))
    print("SDV  density, int32 word, W4A4:", sdv_density(INT32, 4, 4))

    # --- 2. SDV on the DSP48E2 word: 4+ channels per multiply (III-C) ---
    plan = plan_sdv(DSP48E2, 4, 4, park_sign_bits=True)
    W = rng.integers(-8, 8, size=(8, 64))        # int4 weights, 8 outputs
    x = rng.integers(-8, 8, size=(2, 64))        # int4 activations, 2 rows
    words = ops.prepare_sdv_weights(torch.tensor(W, **i32), plan)
    y = ops.packed_matmul(torch.tensor(x, **i32), words, plan=plan, m=8)
    assert (y.cpu().numpy() == x @ W.T).all()
    print(f"\nSDV matmul on DSP48E2: {plan.n} MACs/wide multiply "
          f"(lane={plan.lane} bits), word = 2x int32 limbs, bit-exact = True")

    # --- 3. BSEG: convolution inside the multiplier (Sec. III-D) --------
    planb = plan_bseg(DSP48E2, 4, 4)
    taps = rng.integers(-8, 8, size=(6, 5))      # 6 channels, 5 taps
    sig = rng.integers(0, 16, size=(1, 100, 6))  # unsigned w_i-bit samples
    kappa, tap_sum = ops.prepare_bseg_taps(torch.tensor(taps, **i32), planb)
    yc = ops.bseg_conv1d(torch.tensor(sig, dtype=torch.int8, device=dev),
                         kappa, tap_sum, plan=planb, n_taps=5)
    want = conv1d_causal_ref(torch.tensor(sig), torch.tensor(taps))
    assert torch.equal(yc.cpu(), want.to(yc.dtype))
    print(f"BSEG conv on DSP48E2: n_k={planb.n_k} x n_i={planb.n_i} = "
          f"{planb.density} MACs/multiply, guard bias 2^{planb.lane - 1}, "
          "bit-exact = True")

    # --- 4. the SDV GEMV kernel (B1 on the card) ------------------------
    kplan = plan_sdv(INT32, 4, 8, park_sign_bits=True)
    Wd = rng.integers(-8, 8, size=(128, 256))
    xq = rng.integers(-128, 128, size=(2, 256))
    words = ops.prepare_sdv_weights(torch.tensor(Wd, **i32), kplan)
    yk = ops.sdv_matvec(torch.tensor(xq, dtype=torch.int8, device=dev),
                        words, plan=kplan, m=128)
    assert (yk.cpu().numpy() == xq @ Wd.T).all()
    where = (f"CUDA kernel on {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else "plain torch version on the CPU")
    print(f"sdv_matvec ({where}): {kplan.n} MACs/int32-multiply, "
          "pre-adder + mod-4 spill tracker, bit-exact = True")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
