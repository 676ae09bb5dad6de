#!/usr/bin/env python3
"""Where kernels B1/B2 (``src/repro_torch/kernels/csrc/sdv.cu``) spend
their time, on one CUDA card.

Builds the shipped source and copies of it with one phase taken out
(text patches of the source, for timing only: their outputs are wrong),
and times each at tinyllama-1.1b's projection shapes on the INT32 W4A8
plan (B1 at 8 rows, B2 at 128) and at a llava-next-mistral-7b prefill
chunk's largest call (B2 at 4096 rows, K 4096 -> M 14336), beside a
plain streaming read of the same word bytes and an empty launch.  Timing as in
``breakdown_common``, in microseconds.

  PYTHONPATH=src python scripts/sdv_breakdown.py

Then the same for B2's wgmma kernel (``csrc/sdv_wgmma.cu``) at a llava
prefill chunk's 4096 rows, every projection shape of a layer, with its
own variants (``WGMMA_PATCHES``): without the decode, without the
products, without the stores, and the TMA ring alone.

Variants:
  shipped      the source as it is
  no-zeroing   without the cudaMemsetAsync that split-K needs
  no-decode    without the word -> int8 lane decode
  no-mma       without the tensor-core products
  loads-only   only the cp.async ring (no zeroing, decode, narrowing,
               products or output)
  empty        the launch returns at once (no zeroing): the floor
"""
from __future__ import annotations

import sys

from breakdown_common import OUT, Timer, build_variants, print_card

SHAPES = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))
#: (kernel, rows, shapes): the tinyllama shapes at decode and prefill
#: rows, and llava's wi / wg at the 4096 rows of a prefill chunk
CASES = (("B1", 8, SHAPES), ("B2", 128, SHAPES),
         ("B2", 4096, ((4096, 14336),)))

_MEMSET = "  if (p.accumulate) {   // split-K blocks add into a zeroed output"
_DECODE = "    decode_stage(p, sm, t % kStages, ia);\n"
_CONVERT = "    convert_stage(p, sm, t % kStages, ib);\n"
_MMA = "#pragma unroll\n    for (int ks = 0; ks < kBK / 32; ++ks) {"
_EPILOGUE = "        if (p.accumulate)\n          atomicAdd("
_BODY = "  const Smem<kGemm, kTwoLimb> sm(smem);\n"
_NO_MMA = "#pragma unroll\n    for (int ks = 0; ks < 0; ++ks) {"
PATCHES = {
    "shipped": [],
    "no-zeroing": [(_MEMSET, "  if (false) {")],
    "no-decode": [(_DECODE, "")],
    "no-mma": [(_MMA, _NO_MMA)],
    "loads-only": [(_MEMSET, "  if (false) {"), (_DECODE, ""),
                   (_CONVERT, ""),
                   (_MMA, _NO_MMA),
                   (_EPILOGUE, "        if (acc[mt][nt][e] != 7) continue;\n"
                               "        if (p.accumulate)\n"
                               "          atomicAdd(")],
    "empty": [(_MEMSET, "  if (false) {"),
              (_BODY, _BODY + "  if (p.rows > 0) return;\n")],
}
_W_DECODE0 = "    dec.run(p, sm.w(it % p.stages), sm.a(c, 0), c, tl);\n"
_W_DECODE1 = "        dec.run(p, sm.w(s1), sm.a(c, (t + 1) & 1), c, tl);\n"
_W_MMA = ("      Wgmma<kAU8, kBU8>::run(d, da, db);\n"
          "      Wgmma<kAU8, kBU8>::run(d, da + 2, db + 2);")
_W_STORE = "    store(p, d, r0, g0, c, tl);\n"
_W_NO_STORE = "    if (d[0] == 0x7fffffff) store(p, d, r0, g0, c, tl);\n"
WGMMA_PATCHES = {
    "shipped": [],
    "no-decode": [(_W_DECODE0, ""), (_W_DECODE1, "")],
    "no-mma": [(_W_MMA, "")],
    "no-store": [(_W_STORE, _W_NO_STORE)],
    "loads-only": [(_W_DECODE0, ""), (_W_DECODE1, ""), (_W_MMA, ""),
                   (_W_STORE, _W_NO_STORE)],
}
#: llava-next-mistral-7b's projection shapes (K, M): q/o, k/v, gate/up,
#: down
LLAVA_SHAPES = ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))
STREAM = r"""
#include <cstdint>
#include <cuda_runtime.h>
__global__ void stream_kernel(const int4* __restrict__ in, int64_t n4,
                              int* out) {
  int acc = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int4 v = __ldg(in + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x12345678) out[0] = acc;
}
extern "C" int stream(const void* in, long long bytes, void* out, void* s) {
  stream_kernel<<<132 * 8, 256, 0, (cudaStream_t)s>>>(
      (const int4*)in, bytes / 16, (int*)out);
  return cudaGetLastError();
}
"""


def main() -> int:
    import ctypes

    import torch
    from repro_torch.kernels import ops, sdv_matmul
    from repro_torch.models.quantized import default_sdv_plan
    if not torch.cuda.is_available():
        print("sdv_breakdown: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "stream.cu").write_text(STREAM)
    kernels, (stream_so,) = build_variants("sdv", PATCHES,
                                           [OUT / "stream.cu"])
    stream_lib = ctypes.CDLL(str(stream_so))
    stream_lib.stream.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                  ctypes.c_void_p, ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    timer = Timer(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    print_card()
    plan = default_sdv_plan(4, 8)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    print("kernel K x M rows | " + " | ".join(PATCHES) + " | stream")
    for kname, rows, shapes in CASES:
        for k, m in shapes:
            w = torch.randint(-8, 8, (m, k), generator=gen, device=dev)
            words = ops.prepare_sdv_weights(w, plan)
            g = words.shape[-1]
            x = torch.randint(-127, 128, (rows, k), generator=gen,
                              device=dev, dtype=torch.int32)
            xin = x.T.contiguous() if kname == "B1" else x
            geo = sdv_matmul.launch_geometry(
                rows, k, g, plan.n, gemv=kname == "B1", sms=sms,
                pairs=len(sdv_matmul.slice_pairs(plan)))
            fn = "sdv_gemv" if kname == "B1" else "sdv_gemm"

            def call(lib):
                return sdv_matmul.launch(fn, xin, words, plan, rows, k, g,
                                         lib=lib)
            out = call(kernels["shipped"])
            exact = (x.double() @ w.double().T).long()
            if not torch.equal(out.reshape(rows, -1)[:, :m].long(), exact):
                raise SystemExit(f"{fn} K={k} M={m}: not exact")
            times = [timer.us(lambda lib=lib: call(lib))
                     for lib in kernels.values()]
            times.append(timer.us(lambda: stream_lib.stream(
                words.data_ptr(), words.numel() * 4, sink.data_ptr(),
                stream)))
            print(f"{kname} {k} x {m} {rows} (grid {geo.grid}) | "
                  + " | ".join(f"{t:.1f}" for t in times), flush=True)
    wgmma, _ = build_variants("sdv_wgmma", WGMMA_PATCHES)
    rows = 4096
    print("wgmma K x M rows | " + " | ".join(WGMMA_PATCHES) + " | stream")
    for k, m in LLAVA_SHAPES:
        w = torch.randint(-8, 8, (m, k), generator=gen, device=dev)
        words = ops.prepare_sdv_weights(w, plan)
        g = words.shape[-1]
        x = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                          dtype=torch.int32)
        x8 = sdv_matmul.wgmma_operand(x, plan)
        geo = sdv_matmul.wgmma_geometry(rows, k, g, plan.n, sms=sms)

        def call(lib):
            return sdv_matmul.launch_wgmma(x8, words, plan, rows, k, g,
                                           lib=lib)
        out = call(wgmma["shipped"])
        exact = (x.double() @ w.double().T).long()
        if not torch.equal(out.reshape(rows, -1)[:, :m].long(), exact):
            raise SystemExit(f"sdv_gemm_wgmma K={k} M={m}: not exact")
        times = [timer.us(lambda lib=lib: call(lib))
                 for lib in wgmma.values()]
        times.append(timer.us(lambda: stream_lib.stream(
            words.data_ptr(), words.numel() * 4, sink.data_ptr(), stream)))
        print(f"wgmma {k} x {m} {rows} ({geo.grid} blocks, "
              f"{geo.row_tiles * geo.col_tiles} tiles, {geo.stages} stages) "
              "| " + " | ".join(f"{t:.1f}" for t in times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
