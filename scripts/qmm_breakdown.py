#!/usr/bin/env python3
"""Where kernel B5 (``src/repro_torch/kernels/csrc/quant_matmul.cu``)
spends its time, and what its accumulator restarts buy, on one CUDA card.

Builds the shipped source and copies of it with one phase taken out or
the accumulator's restart interval changed (text patches of the source;
the phase copies' outputs are wrong), and times each at tinyllama-1.1b's
memory-packed projection shapes and LM head (W4, bf16 x) at 8 and 128
rows, beside an empty launch; then the shipped kernel under other K
splits (blocks aimed at per SM); then, at W4 and W8 with bf16 and
float32 x, the time and rounding reading (max |y - exact| over
``quant_matmul.rounding_scale``; the limit is ``ROUNDING_LIMIT``) with
the accumulator restarted every stage of 64 k (shipped), every 4 stages
and never.  Timing as in ``breakdown_common``, in microseconds.

  PYTHONPATH=src python scripts/qmm_breakdown.py

Variants:
  shipped       the source as it is
  no-decode     without the word decode into the A tile
  no-mma        without the tensor-core products
  partials-only each split writes its partial and stops (no last-block
                sum, scale or store of y)
  loads-only    only the staging ring (no decode, products or output)
  empty         the kernel returns at once: the floor
  acc-4         the accumulator restarted every 4 stages
  acc-never     the accumulator never restarted (one tensor-core chain
                per K split)
"""
from __future__ import annotations

import sys

from breakdown_common import Timer, build_variants, print_card

_DECODE = "    decode_stage(sm, t % kStages);\n"
_MMA = "    for (int ks = 0; ks < kBK / 16; ++ks) {\n"
# stop after the ticket, leaving it zero for the next launch
_LAST = "    if (!last_block) return;\n"
_STOP = "    if (last_block && threadIdx.x == 0) p.tickets[tile] = 0;\n" \
    "    return;\n"
_STAGE_OUT = "        sm.out[row * kOutPitch + col] = total[mt][nt][e] + " \
    "acc[mt][nt][e];\n"
_BODY = "  const int g0 = blockIdx.x * F::kWords, r0 = blockIdx.y * R;\n"
_RESTART = "constexpr int kAccStages = 1;\n"
PHASES = {
    "shipped": [],
    "no-decode": [(_DECODE, "")],
    "no-mma": [(_MMA, _MMA.replace("ks < kBK / 16", "ks < 0"))],
    "partials-only": [(_LAST, _STOP)],
    "loads-only": [(_DECODE, ""),
                   (_MMA, _MMA.replace("ks < kBK / 16", "ks < 0")),
                   (_STAGE_OUT, ""), (_LAST, _STOP)],
    "empty": [(_BODY, _BODY + "  if (p.m > 0) return;\n")],
}
RESTARTS = {
    "acc-4": [(_RESTART, _RESTART.replace("1", "4"))],
    "acc-never": [(_RESTART, _RESTART.replace("1", "1 << 30"))],
}
#: tinyllama-1.1b's (K, N): q/o, k/v, gate/up, down, LM head
SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
          (2048, 32000))


def main() -> int:
    import torch
    from repro_torch.kernels import packbits, quant_matmul as qmm
    if not torch.cuda.is_available():
        print("qmm_breakdown: no CUDA device", file=sys.stderr)
        return 1
    libs, _ = build_variants("quant_matmul", {**PHASES, **RESTARTS})
    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print_card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def case(rows, k, n, w, dtype):
        half = 1 << (w - 1)
        x = torch.randn((rows, k), generator=gen, device=dev).to(dtype)
        vals = torch.randint(-half, half, (k, n), generator=gen, device=dev,
                             dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device=dev) * 0.05 + 0.001
        return x, vals, packbits.pack_words(vals, w=w), scale

    def timed(lib, x, words, scale, w, geo=None):
        return timer.us(lambda: qmm.launch(x, words, scale, w=w, geo=geo,
                                           lib=lib))

    cases = [(rows, k, n) + case(rows, k, n, 4, torch.bfloat16)
             for rows in (8, 128) for k, n in SHAPES]
    print("phases (us): shape | grid | " + " | ".join(PHASES))
    for rows, k, n, x, _, words, scale in cases:
        want = qmm.quant_matmul(x, words, scale, w=4)
        if not torch.equal(qmm.launch(x, words, scale, w=4,
                                      lib=libs["shipped"]), want):
            raise SystemExit(f"shipped {rows}x{k}x{n}: differs from the "
                             "wrapper")
        times = [timed(libs[v], x, words, scale, 4) for v in PHASES]
        print(f"{rows}x{k}x{n} | "
              f"{qmm.launch_geometry(rows, n, k, 4, sms).grid} | "
              + " | ".join(f"{t:.1f}" for t in times), flush=True)

    per_sm = (1, 2, 4)
    print("K split (us): shape | blocks per SM " + " | ".join(
        str(b) for b in per_sm) + " | no split")
    for rows, k, n, x, _, words, scale in cases:
        times = []
        for b in per_sm:
            qmm.BLOCKS_PER_SM, saved = b, qmm.BLOCKS_PER_SM
            geo = qmm.launch_geometry(rows, n, k, 4, sms)
            qmm.BLOCKS_PER_SM = saved
            times.append(timed(libs["shipped"], x, words, scale, 4, geo))
        geo = qmm.launch_geometry(rows, n, k, 4, sms)
        one = geo._replace(kchunk=-(-k // qmm.TILE_K) * qmm.TILE_K,
                           grid=geo.grid[:2] + (1,), workspace=0, tickets=0)
        times.append(timed(libs["shipped"], x, words, scale, 4, one))
        print(f"{rows}x{k}x{n} | " + " | ".join(f"{t:.1f}" for t in times),
              flush=True)

    restarts = ("shipped",) + tuple(RESTARTS)
    print(f"accumulator restarts (us, reading; limit "
          f"{qmm.ROUNDING_LIMIT}): case | " + " | ".join(restarts))
    worst = dict.fromkeys(restarts, 0.0)
    for w in (4, 8):
        for dtype in (torch.bfloat16, torch.float32):
            for rows in (8, 128):
                for k, n in SHAPES:
                    x, vals, words, scale = case(rows, k, n, w, dtype)
                    exact = (x.double() @ vals.double()) * scale.double()
                    rs = qmm.rounding_scale(x, vals, scale).clamp_min(1e-300)
                    cells = []
                    for v in restarts:
                        y = qmm.launch(x, words, scale, w=w, lib=libs[v])
                        reading = float(((y.double() - exact).abs()
                                         / rs).max())
                        worst[v] = max(worst[v], reading)
                        us = timed(libs[v], x, words, scale, w)
                        cells.append(f"{us:.1f}, {reading:.3f}")
                    print(f"W{w} {str(dtype)[6:]} {rows}x{k}x{n} | "
                          + " | ".join(cells), flush=True)
    print("largest reading: " + ", ".join(f"{v} {r:.3f}"
                                          for v, r in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
