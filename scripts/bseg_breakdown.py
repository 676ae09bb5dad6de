#!/usr/bin/env python3
"""Where kernel B3 (``src/repro_torch/kernels/csrc/bseg.cu``) spends its
time, on one CUDA card.

Builds the shipped source and copies of it with one phase taken out
(text patches of the source, for timing only: their outputs are wrong),
and times each at every 3x3 stage of UltraNet-INT4 at 416x416, batch 8,
on the INT32 W4A4 plan, beside an empty launch.  Timing as in
``breakdown_common``, in microseconds.

  PYTHONPATH=src python scripts/bseg_breakdown.py

Variants:
  shipped     the source as it is
  no-decode   without the tap decode into the B tile
  no-mma      without the tensor-core products
  no-store    without the output stage and stores
  wide-decode the narrow (32-bit) words decoded in 64-bit arithmetic
  loads-only  only the strip staging (no decode, products or output)
  empty       the kernel returns at once: the floor
"""
from __future__ import annotations

import sys

from breakdown_common import Timer, build_variants, print_card

_DECODE_FIRST = ("  if (c.n_chunks == 1) decode_taps<N>(c, kappa, btile, co0, "
                 "0);\n")
_MMA = ("      for (int j = 0; j < c.slices; ++j) {\n"
        "        int acc[MT][NT][4];")
_STORE = ("      if (ch == c.n_chunks - 1)\n"
          "        store_tile<NT, MT>(c, out, stage, total, live, t, co0);\n")
_NARROW = "  c.narrow = !c.wide && n_k * lane <= 32 && lane < 32;\n"
_BODY = "  const int co0 = blockIdx.x * N;\n"
PATCHES = {
    "shipped": [],
    "no-decode": [(_DECODE_FIRST, "")],
    "no-mma": [(_MMA, _MMA.replace("j < c.slices", "j < 0"))],
    "no-store": [(_STORE, "")],
    "wide-decode": [(_NARROW, "  c.narrow = false;\n")],
    "loads-only": [(_DECODE_FIRST, ""),
                   (_MMA, _MMA.replace("j < c.slices", "j < 0")),
                   (_STORE, "")],
    "empty": [(_BODY, _BODY + "  if (c.c_out > 0) return;\n")],
}


def main() -> int:
    import torch
    from repro_torch.core.datapath import INT32, plan_bseg
    from repro_torch.kernels import bseg_conv2d, ops
    from repro_torch.models.ultranet import ultranet_layer_shapes
    if not torch.cuda.is_available():
        print("bseg_breakdown: no CUDA device", file=sys.stderr)
        return 1
    libs, _ = build_variants("bseg", PATCHES)
    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    print_card()
    plan = plan_bseg(INT32, 4, 4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print("layer | " + " | ".join(PATCHES))
    for li, s in enumerate(ultranet_layer_shapes(416, 416)):
        if s["k"] != 3:
            continue
        h, w, cin, cout = s["h"], s["w"], s["cin"], s["cout"]
        x = torch.randint(0, 16, (8, h, w, cin), generator=gen, device=dev,
                          dtype=torch.int32)
        taps = torch.randint(-8, 8, (cout, cin, 3, 3), generator=gen,
                             device=dev, dtype=torch.int32)
        x_pad, kappa, _ = ops.bseg_conv2d_operands(x, taps, plan)
        geo = bseg_conv2d.launch_shape(
            8, h, w, cin, cout, 3, kappa.shape[-4] * plan.n_k,
            bseg_conv2d.tap_slices(plan), sms=sms)
        want = bseg_conv2d.bseg_conv2d(x_pad, kappa, plan=plan, h_out=h,
                                       w_out=w)

        def call(lib):
            return bseg_conv2d.launch(x_pad, kappa, plan, h_out=h, w_out=w,
                                      lib=lib)
        for name in ("shipped", "wide-decode"):
            if not torch.equal(call(libs[name]), want):
                raise SystemExit(f"{name} L{li}: differs from the wrapper")
        times = [timer.us(lambda lib=lib: call(lib)) for lib in libs.values()]
        print(f"L{li} {h}x{w} {cin}->{cout} ({geo.n_tile} ch x "
              f"{geo.tr}x{geo.tc} px, mt {geo.mt}, {geo.tiles[2]} tiles, "
              f"grid {geo.grid}) | " + " | ".join(f"{t:.1f}" for t in times),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
