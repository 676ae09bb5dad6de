#!/usr/bin/env python3
"""Where kernel B3 (``src/repro_torch/kernels/csrc/bseg.cu``) spends its
time, on one CUDA card.

Builds the shipped source and copies of it with one phase taken out
(text patches of the source, for timing only: their outputs are wrong),
and times each at every 3x3 stage of UltraNet-INT4 at 416x416, batch 8,
on the INT32 W4A4 plan, beside an empty launch.  Times are CUDA events
around one call after a ~1 ms device spin with the L2 flushed (the
median of 10), as ``chip_smoke.py`` times its kernels, in microseconds.

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

import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "breakdown"

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


def patched(name: str) -> Path:
    src = (ROOT / "src/repro_torch/kernels/csrc/bseg.cu").read_text()
    for old, new in PATCHES[name]:
        if old not in src:
            raise SystemExit(f"{name}: patch target not found: {old!r}")
        src = src.replace(old, new)
    path = OUT / f"bseg-{name}.cu"
    path.write_text(src)
    return path


def compile_so(src: Path):
    from repro_torch.kernels import build
    out = src.with_suffix(".so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    argtypes, restype = build._SIGNATURES["bseg"]["bseg_conv2d"]
    lib.bseg_conv2d.argtypes = argtypes
    lib.bseg_conv2d.restype = restype
    return lib


def main() -> int:
    import torch
    from repro_torch.core.datapath import INT32, plan_bseg
    from repro_torch.kernels import bseg_conv2d, ops
    from repro_torch.models.ultranet import ultranet_layer_shapes
    if not torch.cuda.is_available():
        print("bseg_breakdown: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    sources = [patched(name) for name in PATCHES]
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        libs = dict(zip(PATCHES, pool.map(compile_so, sources)))
    dev = torch.device("cuda", 0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def event_us(fn, reps=10):
        fn()
        fn()
        times = []
        for _ in range(reps):
            torch.cuda._sleep(2_000_000)
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times) * 1e3

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
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
        n_groups = kappa.shape[-4]
        b, h_pad, w_pad, _ = x_pad.shape
        geo = bseg_conv2d.launch_shape(b, h, w, cin, cout, 3,
                                       n_groups * plan.n_k, 1, sms=sms)
        out = torch.empty((b, h, w, cout), dtype=torch.int32, device=dev)
        want = bseg_conv2d.bseg_conv2d(x_pad, kappa, plan=plan, h_out=h,
                                       w_out=w)
        times = []
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.bseg_conv2d(
                    x_pad.data_ptr(), kappa.data_ptr(), out.data_ptr(), b,
                    h_pad, w_pad, cin, 3, n_groups, cout, h, w, plan.n_k,
                    plan.lane, 1, 0, geo.n_tile, geo.mt, geo.tr, geo.tc,
                    geo.cc, geo.grid[1], geo.smem, stream)
                if err:
                    raise SystemExit(f"{name}: CUDA error {err}")
            times.append(event_us(call))
            if name in ("shipped", "wide-decode") and \
                    not torch.equal(out, want):
                raise SystemExit(f"{name} L{li}: differs from the wrapper")
        print(f"L{li} {h}x{w} {cin}->{cout} ({geo.n_tile} ch x "
              f"{geo.tr}x{geo.tc} px, mt {geo.mt}, {geo.tiles[2]} tiles, "
              f"grid {geo.grid}) | " + " | ".join(f"{t:.1f}" for t in times),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
