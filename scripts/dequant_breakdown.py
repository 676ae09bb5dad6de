#!/usr/bin/env python3
"""Where the fused B7 (``src/repro_torch/kernels/csrc/packbits.cu::
unpack_dequant_kernel``, unpack and dequantize in one pass) spends its
time, on one CUDA card.

Builds the shipped source and copies of it with one part changed or
taken out (text patches of the source, for timing only: the outputs of
``loads-only`` and ``empty`` are wrong), and times each at
tinyllama-1.1b's memory-packed shapes (W4 words, bf16 out), per call and
per decode step (154 projections + the LM head), beside the byte bound;
then the shipped kernel under other grids (one wave of 1 and 2 blocks
an SM, and two and four waves); then the shipped kernel and the route
it replaced (int8 unpack, then scale, trim and cast as torch ops) with
the L2 flushed by writing the flush buffer (``zero_``, as chip_smoke
does: 50 MB of dirty lines, written back while the timed call runs) and
by reading it (a clean L2); then one decode step's 155 calls back
to back on distinct weights, as the decode loop launches them (the L2
flushed before the first only), beside the replaced route: their device
time, and the host's time to enqueue them (behind a ~10 ms device
spin).  Timing as in ``breakdown_common``, in microseconds.

  PYTHONPATH=src python scripts/dequant_breakdown.py

Variants:
  shipped        the source as it is (registers for kMinBlocks = 2
                 blocks an SM, a grid of one wave of them; kDepth = 4
                 rows of words in flight a warp)
  min-blocks-3   registers and grid for 3 blocks an SM
  depth-1        one row of words in flight a warp
  depth-8        eight rows of words in flight a warp
  stream-stores  the outputs stored with st.global.cs (evict first)
  smem-scales    the span's scales read once per block into shared
                 memory (one barrier), then each lane's into registers
  loads-only     words loaded and transposed, scales loaded, nothing
                 decoded or stored
  empty          the kernel returns at once: the floor
"""
from __future__ import annotations

import statistics
import sys
import time

from breakdown_common import Timer, build_variants, print_card

_MIN_BLOCKS = "constexpr int kMinBlocks = 2;"
_DEPTH = "constexpr int kDepth = 4;"
_STORE = "        *reinterpret_cast<U*>(orow + col + p * kElems) = u;"
_CALL = ("          dequant_store<W, OutT, kVec>(pick(t, (k - qi) & 3), s[k], "
         "orow,\n                                       wcol[k] * kPer, "
         "d_out);")
# keep the loads live without decoding or storing: a value never true
_KEEP = ("          if (pick(t, (k - qi) & 3) == 0x7fffffffu && "
         "s[k][0] == 3.f)\n            orow[0] = to_out<OutT>(0.f);")
_BODY = "  if (first >= slab_end) return;"
_SCALES = """\
  if (first >= slab_end) return;                 // the whole warp
  // after the transpose, store k writes word span + 16 quad + 4 k + qi;
  // its scales are read once and stay in registers for every row the
  // warp walks (16-byte runs where a word's scales are whole ones)
  int wcol[4];
  float s[4][kPer];
  const float* srow = scale + static_cast<int64_t>(g) * nw * kPer;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wcol[k] = span + 16 * quad + 4 * k + qi;
    const float* sw = srow + wcol[k] * kPer;
    if constexpr (kPer % 4 == 0) {
#pragma unroll
      for (int f = 0; f < kPer; f += 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (wcol[k] < nw) v = *reinterpret_cast<const float4*>(sw + f);
        s[k][f] = v.x; s[k][f + 1] = v.y;
        s[k][f + 2] = v.z; s[k][f + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int f = 0; f < kPer; ++f) s[k][f] = wcol[k] < nw ? sw[f] : 0.f;
    }
  }
"""
_SMEM_SCALES = """\
  __shared__ __align__(16) float span_scale[kSpanWords * kPer];
  const float* srow = scale + static_cast<int64_t>(g) * nw * kPer;
  for (int i = threadIdx.x; i < kSpanWords * kPer; i += kWarps * 32)
    span_scale[i] = span * kPer + i < nw * kPer ? srow[span * kPer + i]
                                                : 0.f;
  __syncthreads();
  if (first >= slab_end) return;
  int wcol[4];
  float s[4][kPer];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wcol[k] = span + 16 * quad + 4 * k + qi;
#pragma unroll
    for (int f = 0; f < kPer; ++f)
      s[k][f] = span_scale[(16 * quad + 4 * k + qi) * kPer + f];
  }
"""
PATCHES = {
    "shipped": [],
    "min-blocks-3": [(_MIN_BLOCKS, "constexpr int kMinBlocks = 3;")],
    "depth-1": [(_DEPTH, "constexpr int kDepth = 1;")],
    "depth-8": [(_DEPTH, "constexpr int kDepth = 8;")],
    "stream-stores": [(_STORE, "        __stcs(reinterpret_cast<U*>(orow + "
                               "col + p * kElems), u);")],
    "smem-scales": [(_SCALES, _SMEM_SCALES)],
    "loads-only": [(_CALL, _KEEP)],
    "empty": [(_BODY, "  if (first >= 0) return;")],
}
#: the blocks an SM each variant's grid is sized for
GRID_BLOCKS = {"min-blocks-3": 3}
#: (K, N) of tinyllama's memory-packed matrices, calls per decode step
SHAPES = {(2048, 2048): 44, (2048, 256): 44, (2048, 5632): 44,
          (5632, 2048): 22, (2048, 32000): 1}
W = 4
#: device spin before the 155-call sequence (~10 ms): the host enqueues
#: every call before the first runs
SEQ_SPIN = 20_000_000


def main() -> int:
    import torch
    from repro_torch.kernels import packbits
    if not torch.cuda.is_available():
        print("dequant_breakdown: no CUDA device", file=sys.stderr)
        return 1
    libs, _ = build_variants("packbits", PATCHES)
    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print_card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    per = 32 // W

    def operands(k, n):
        words = torch.randint(-2**31, 2**31, (k, n // per), generator=gen,
                              device=dev, dtype=torch.int32)
        scale = torch.rand((1, n), generator=gen, device=dev) * 0.05 + 0.001
        return words, scale

    def run(lib, words, scale, n, blocks):
        rows = packbits.launch_shape(words.shape[0], words.shape[1],
                                     words.shape[0], sms=sms,
                                     blocks_per_sm=blocks)[2]
        return packbits.launch_dequant(
            words, scale, w=W, d_out=n, rows_per_scale=words.shape[0],
            dtype=torch.bfloat16, rows=rows, lib=lib)

    names = list(PATCHES)
    print("variants (us a call; per decode step in the last row): shape | "
          "bound | " + " | ".join(names))
    step = dict.fromkeys(names, 0.0)
    bound_step = 0.0
    for (k, n), calls in SHAPES.items():
        words, scale = operands(k, n)
        want = packbits.unpack_dequant(words, scale, w=W, d_out=n,
                                       rows_per_scale=k)
        times = []
        for name in names:
            blocks = GRID_BLOCKS.get(name, packbits.DEQUANT_BLOCKS_PER_SM)
            fn = (lambda lib=libs[name], blocks=blocks:
                  run(lib, words, scale, n, blocks))
            if name not in ("loads-only", "empty") and not torch.equal(
                    fn().view(torch.int16), want.view(torch.int16)):
                raise SystemExit(f"{name} {k}x{n}: differs from the wrapper")
            times.append(timer.us(fn))
            step[name] += calls * times[-1]
        bound = (words.numel() * 4 + scale.numel() * 4 + want.numel() * 2) \
            / 3.35e12 * 1e6
        bound_step += calls * bound
        print(f"{k}x{n} x{calls} | {bound:.2f} | "
              + " | ".join(f"{t:.1f}" for t in times), flush=True)
    print(f"decode step | {bound_step:.1f} | "
          + " | ".join(f"{step[name]:.1f}" for name in names))

    grids = (1, 2, 4, 8)
    print("shipped under other grids (us a call): shape | " + " | ".join(
        f"{b} blocks/SM" for b in grids))
    for (k, n), _ in SHAPES.items():
        words, scale = operands(k, n)
        times = [timer.us(lambda b=b: run(libs["shipped"], words, scale, n,
                                          b)) for b in grids]
        print(f"{k}x{n} | " + " | ".join(f"{t:.1f}" for t in times),
              flush=True)

    def replaced_one(words, scale, n):
        q = packbits.unpack_words(words, w=W)
        return (q.to(torch.float32) * scale)[:, :n].to(torch.bfloat16)

    def clean_us(fn, reps=10):
        fn()
        fn()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)
            timer.flush.sum()                    # reads: leaves L2 clean
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times) * 1e3

    print("flush by writing (dirty L2) | by reading (clean L2), us a call: "
          "shape | shipped | replaced route")
    sums = [0.0] * 4
    for (k, n), calls in SHAPES.items():
        words, scale = operands(k, n)
        fns = (lambda: packbits.unpack_dequant(words, scale, w=W, d_out=n,
                                               rows_per_scale=k),
               lambda: replaced_one(words, scale, n))
        times = [f(fn) for fn in fns for f in (timer.us, clean_us)]
        sums = [a + calls * t for a, t in zip(sums, times)]
        print(f"{k}x{n} | {times[0]:.1f} | {times[1]:.1f} | {times[2]:.1f} "
              f"| {times[3]:.1f}", flush=True)
    print("decode step | " + " | ".join(f"{t:.1f}" for t in sums))

    # one decode step's calls back to back, each on its own weights
    calls = [operands(k, n) + (n,) for (k, n), c in SHAPES.items()
             for _ in range(c)]

    def fused():
        for words, scale, n in calls:
            packbits.unpack_dequant(words, scale, w=W, d_out=n,
                                    rows_per_scale=words.shape[0])

    def replaced():
        for words, scale, n in calls:
            replaced_one(words, scale, n)

    for label, fn in (("fused B7", fused), ("replaced route", replaced)):
        fn()
        ms, host = [], []
        for _ in range(5):
            torch.cuda._sleep(SEQ_SPIN)
            timer.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        print(f"one decode step's {len(calls)} calls back to back, "
              f"{label}: device {statistics.median(ms) * 1e3:.1f} us, host "
              f"enqueue {statistics.median(host) * 1e6:.1f} us (medians of "
              f"5)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
