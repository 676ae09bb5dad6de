#!/usr/bin/env python3
"""Where kernel B4 (``src/repro_torch/kernels/csrc/bseg1d.cu``) spends
its time, on one CUDA card.

Builds the shipped source and copies of it with one part changed or
taken out (text patches of the source, for timing only: the outputs of
all but ``shipped`` and ``stream-stores`` are wrong), and times each on
the INT32 W4A4 plan at the short conv's decode shape (batch 8, 4
samples) and at 2048 samples, with the channels of mamba2-130m (1792)
and recurrentgemma-2b (2560), beside an empty launch; then the shipped
kernel at 2048 samples under other launch shapes (threads per block x
outputs per strip).  Timing as in ``breakdown_common``, in
microseconds.

  PYTHONPATH=src python scripts/conv1d_breakdown.py

Variants:
  shipped        the source as it is
  stream-stores  the outputs stored with st.global.cs (evict first)
  no-store       without the output stores
  loads-only     only the loads of kappa and x_pad (no stores)
  empty          the kernel returns at once: the floor
"""
from __future__ import annotations

import sys

from breakdown_common import Timer, build_variants, print_card

_STORE = "    *d = make_int4("
_STORE_CALL = ("        store_row(ob + static_cast<int64_t>(s + t) * p.c, "
               "acc, p, nc,\n                  j0 > 0);\n")
_MAC = "            acc[ch] += tap[jj][ch] *\n" \
    "                       __byte_perm(win[t + jj], 0u, 0x4440 + ch);\n"
_BODY = "  if (c0 >= p.c) return;\n"
# keep the loads live without stores: fold them into a value that is
# never true, so the compiler cannot drop them
_KEEP = "        if (acc[0] == 0xFFFFFFFFu && acc[1] == 0x7u) ob[0] = 1;\n"
PATCHES = {
    "shipped": [],
    "stream-stores": [(_STORE, "    __stcs(d, make_int4("),
                      ("static_cast<int>(o[2]), static_cast<int>(o[3]));",
                       "static_cast<int>(o[2]), static_cast<int>(o[3])));")],
    "no-store": [(_STORE_CALL, _KEEP)],
    "loads-only": [(_STORE_CALL, _KEEP),
                   (_MAC, "            acc[ch] += win[t + jj] >> ch;\n")],
    "empty": [(_BODY, "  if (c0 >= 0) return;\n")],
}
SHAPES = ((4, 1792), (4, 2560), (2048, 1792), (2048, 2560))


def main() -> int:
    import torch
    from repro_torch.core.datapath import INT32, plan_bseg
    from repro_torch.kernels import bseg_conv1d, ops
    if not torch.cuda.is_available():
        print("conv1d_breakdown: no CUDA device", file=sys.stderr)
        return 1
    libs, _ = build_variants("bseg1d", PATCHES)
    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print_card()
    plan = plan_bseg(INT32, 4, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def operands(s, c):
        taps = torch.randint(-8, 8, (c, 4), generator=gen, device=dev,
                             dtype=torch.int32)
        xq = torch.randint(-8, 8, (8, s, c), generator=gen, device=dev,
                           dtype=torch.int32)
        kappa, _ = ops.prepare_bseg_taps(taps, plan)
        x_pad = ops.bseg_conv1d_x_pad(xq, plan, n_groups=kappa.shape[-2],
                                      n_taps=4, zero_point=8)
        return x_pad, kappa

    def run(lib, x_pad, kappa, s, shape):
        return bseg_conv1d.launch(x_pad, kappa, plan, s_out=s, shape=shape,
                                  lib=lib)

    print("variants (us): shape | bound | " + " | ".join(PATCHES))
    for s, c in SHAPES:
        x_pad, kappa = operands(s, c)
        want = bseg_conv1d.bseg_conv1d(x_pad, kappa, plan=plan, s_out=s)
        shape = bseg_conv1d.launch_shape(8, c, s, sms=sms)
        for name in ("shipped", "stream-stores"):
            if not torch.equal(run(libs[name], x_pad, kappa, s, shape),
                               want):
                raise SystemExit(f"{name} S={s} C={c}: differs from the "
                                 "wrapper")
        times = [timer.us(lambda lib=lib: run(lib, x_pad, kappa, s, shape))
                 for lib in libs.values()]
        nbytes = x_pad.numel() + kappa.numel() * 4 + want.numel() * 4
        print(f"8x{s}x{c} ({shape[0]} threads, strip {shape[1]}) | "
              f"{nbytes / 3.35e12 * 1e6:.2f} | "
              + " | ".join(f"{t:.1f}" for t in times), flush=True)
    launches = [(t, st) for t in (64, 128, 256) for st in (16, 32, 64, 128)]
    print("launch shapes at 2048 samples (us): C | " + " | ".join(
        f"{t}x{st}" for t, st in launches))
    for s, c in SHAPES[2:]:
        x_pad, kappa = operands(s, c)
        times = [timer.us(lambda shape=shape: run(libs["shipped"], x_pad,
                                                  kappa, s, shape))
                 for shape in launches]
        print(f"{c} | " + " | ".join(f"{t:.1f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
