#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths on one CUDA card and stops with a nonzero
exit at the first failure:

  1. build — compiles kernels B1 (SDV GEMV) and B2 (SDV GEMM) from
     ``src/repro_torch/kernels/csrc/sdv.cu``, B3 (BSEG conv2d) from
     ``csrc/bseg.cu``, B4 (BSEG depthwise conv1d) from
     ``csrc/bseg1d.cu``, B6/B7 (lane pack/unpack) from
     ``csrc/packbits.cu`` and B5 (quantized matmul) from
     ``csrc/quant_matmul.cu`` with nvcc for sm_90a, one nvcc per source,
     all started together; prints ptxas's registers and spills of each
     B1/B2/B3 instantiation, B1/B2's dynamic shared memory (B3's, which
     follows the layer, is printed with each conv case);
  2. kernels — each kernel against its plain torch version bit for bit,
     and against the exact integer product (float64 on the card, exact
     while |sum| < 2^53), at the main path's (K, M) shapes, for the
     INT32 W4A8 plan and the wide DSP48E2 W4A8 (n=3, [2, K, G] limb
     planes) plan; times each kernel, its plain version and
     ``torch._int_mm`` (the library yardstick, never used by the port).
     Then B1 (8 rows) and B2 (128 rows) at K = 2048, M = 256 on
     operands wider than 8 bits (byte slices): the planner's W4A9 /
     W8A9 and W4A16 on each exact-wrap word and the widest w_a = w_b
     plan of each, against the plain version and the exact product mod
     2^32 (int64 on the CPU);
  3. serve — full-width tinyllama-1.1b from a seeded torch init, packed
     by ``serve_params(compute="sdv", min_size=1024)``: a 16-token
     prefill of 8 prompts (128 GEMM rows -> B2), 16 greedy decode steps
     at batch 8 (-> B1), then ``single_batch_loop`` as the serve CLI runs
     it; the launch counters are reset before and read after each run.
     Reduced tinyllama-1.1b, mamba2-130m and recurrentgemma-2b on the
     card are held against the same models on the CPU (plain kernel
     versions), the recurrent ones over 24 decode steps, which wrap the
     reduced attention window;
  4. conv kernels — B3 at every UltraNet-INT4 conv shape at 416x416,
     batch 8, on the int32, fp32m, dsp48e2 and dsp58 W4A4 plans, and at
     the first and a 26x26 shape on taps wider than 8 bits (W12A4 on
     dsp58 and the widest w_k of each word), against its plain version
     bit for bit and the float64 conv oracle, a second launch bit for
     bit against the first; B2 on
     the im2col plan of the 1x1 head; times each kernel, its plain
     version and ``torch.nn.functional.conv2d`` on float32 operands with
     TF32 off (the library yardstick, never used by the port; its
     difference from the exact conv is printed);
  5. ultranet — full-width UltraNet-INT4 ``ultranet_forward(mode=
     "bseg")`` at 416x416, batch 8, with the default INT32 plan (8 B3
     launches + 1 B2 launch) and with the DSP48E2 BSEG 3x2 plan on all
     9 convs (9 B3 launches), each bit-exact against ``mode="ref"``;
     the counters are reset before and read after each run.  The INT32
     forward's device busy share (torch.profiler, device events only)
     and the wall time of its operand prep are printed.  A 32x32 frame
     on the card is held against the same frame on the CPU;
  6. conv1d kernels — B4 (decoded taps, no carry chain) on the int32,
     fp32m, dsp48e2 and dsp58 W4A4 plans at the decode shape (batch 8,
     4 samples: 1 new + 3 of history) and at 2048 samples, with the
     channels of mamba2-130m
     (1792) and recurrentgemma-2b (2560), and on a 'same'-padded
     depthwise ``packed_conv2d``: against its plain version and the
     exact conv, timed beside its bound and
     ``torch.nn.functional.conv1d(groups=C)`` on float32 operands with
     TF32 off (the library yardstick, never used by the port);
  7. recurrent serve — full-width mamba2-130m, then full-width
     recurrentgemma-2b, from a seeded torch init packed by
     ``serve_params(compute="sdv", min_size=1024)``: 16-token prompts
     replayed one token per step and 16 greedy tokens at batch 8 through
     ``single_batch_loop``, with the per-step launch counts read from the
     packed tree (B4 24 / 18, B1 120 / 200, no B2, B3 or plain call); ms
     per step, tok/s, peak memory and the device busy share of a step.
     B1 is held against its plain version and the exact product at each
     projection shape of the packed tree.  The packed short conv
     (``bseg_conv_apply``) on the card is held against the same call on
     the CPU at the full-width decode shape;
  8. memory kernels — B6 (lane pack) and B7 (unpack) from
     ``csrc/packbits.cu`` at every tinyllama projection shape, the LM
     head and a ragged shape, W2/W4/W8, and B6 at the stacked shapes
     serve_params gives it, each against its plain version bit for bit;
     the fused B7 (unpack and dequantize, the serving path's) at every
     tinyllama shape at W4 and, with edge scales (a subnormal column,
     bf16 rounding ties, overflow), at W2..W8 on ragged shapes (d_out a
     multiple of neither 32 / w nor 8, and one that trims inside a word)
     and a stacked one, bf16 and float32 out, against its plain version
     bit for bit, and timed per decode step beside its bound and the
     route it replaced (int8 B7 + scale, trim and cast in torch);
     B5 (``csrc/quant_matmul.cu``) at those shapes x 8 and 128 rows x
     W4/W8 x bf16/f32 activations, against its plain version and the
     float64 product within the float32 summation bound
     (``quant_matmul.error_bound``, which grows with K) and within
     ``ROUNDING_LIMIT`` typical float32 roundings
     (``quant_matmul.rounding_scale``), a check that TF32-rounded and
     bf16-rounded x, run beside it on the float32 cases, must fail; two
     launches bit-identical; each timed beside its bound (B5's
     operations at the bf16 tensor rate for bf16 x, a third of it for
     float32 x, split into three bf16 parts), B5 also beside
     ``torch.mm`` on float32 operands
     (TF32 off; no single PyTorch call packs bit fields, so B6/B7 have
     no library time);
  9. memory serve — full-width tinyllama-1.1b packed by
     ``serve_params(compute="memory", min_size=1024)`` (one B6 launch per
     container; words == the plain pack, int8 B7 of them == the plain
     unpack, and each container's materialized bf16 weights (fused B7)
     == the route it replaced), a 16-token prefill of 8 prompts (154
     fused B7), 16 decode steps
     and ``single_batch_loop`` (155 B7 per step: 22 x 7 projections + the
     LM head; no other kernel or plain call), with ms/step, tok/s, peak
     memory and the device busy share; then every container's words
     through ``packed_matmul(plan=None)`` (B5) at 8 and 8 x 16 rows;
     reduced tinyllama, mamba2-130m and recurrentgemma-2b in memory mode
     on the card against the CPU;
 10. engine — full-width tinyllama-1.1b through the continuous-batching
     engine (``repro_torch.serving.Engine``), buckets of batch 8 at
     s_max 32 and 64, 8-token chunked prefill per slot, mid-wave joins:
     an SDV W4A8 burst of 32 seeded requests (prompts and budgets of
     8-24 tokens) on the plans the planner picks (``plan_policy``
     resolves to "auto"; every layer's plan == the analytic
     ``choose_plan``), every outcome "ok", at least one mid-wave join,
     154 B1 per decode iteration and per prefill-slot call and nothing
     else, and 4 requests (the first, a joiner, the longest, the last)
     run alone again through the same engine, bit for bit; a fault run
     of 8 that loses one wave mid-flight (``FaultPlan`` kernel_loss) and
     gives the clean tokens; a memory-mode run of 8 (8 B6 at set-up, 155
     B7 per decode iteration and 154 per prefill-slot call).  Each run
     prints requests/s, tok/s, p50/p99 latency and queue wait, decode and
     prefill ms per iteration, peak memory, and the SDV and memory runs
     the device busy share of one decode iteration.

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``; the card's name and power limit come
before them.

  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense int8 tensor
#: ops/s, dense bf16 tensor FLOP/s, float32 CUDA-core FLOP/s.  Kernel B5's
#: bound takes its activations' type: a bf16 value times a field of at
#: most 8 bits is exact in float32, so bf16 tensor cores with float32
#: accumulation compute its function on bf16 x; float32 x splits exactly
#: into three bf16 parts, three tensor-core products each (TF32 would
#: round x), which is faster than float32 FMAs at the CUDA-core rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
#: the main path's projection shapes (K, M) and how often one tinyllama
#: layer runs each: q/o 2048->2048, k/v 2048->256, gate/up 2048->5632,
#: down 5632->2048
LAYER_SHAPES = {(2048, 2048): 2, (2048, 256): 2, (2048, 5632): 2,
                (5632, 2048): 1}
B1_ROWS, B2_ROWS = (1, 8), (9, 128)
DECODE_ROWS, PREFILL_ROWS = 8, 128
BATCH, PROMPT, NEW = 8, 16, 16
#: UltraNet-INT4 at the frame of the repo's Tab. II accounting
ULTRA_SIZE, ULTRA_BATCH = 416, 8
CONV_SPECS = ("int32", "fp32m", "dsp48e2", "dsp58")
#: the short conv: channels of mamba2-130m (d_inner + 2 d_state) and of
#: recurrentgemma-2b (d_rnn), 4 taps; a decode call sees 1 new sample and
#: 3 of history, a long call 2048
CONV1D_CHANNELS, CONV1D_TAPS = (1792, 2560), 4
CONV1D_SAMPLES = {"decode": 4, "long": 2048}
#: the recurrent archs and their per-step launches (batch 8: B1, never B2)
RECURRENT_STEP = {"mamba2-130m": {"B1": 120, "B4": 24},
                  "recurrentgemma-2b": {"B1": 200, "B4": 18}}
#: reduced models, card vs CPU: every packed GEMM and conv is exact on
#: both, but the bf16 elementwise ops and the bf16 LM-head product round
#: differently on the card; a one-ulp bf16 change upstream of an
#: activation quantizer moves an activation by one step and compounds
#: over the layers (tinyllama: 0.051 observed while the quantizer scales
#: were divided by Python numbers, 0.00024 since; H100, 700 W)
LOGIT_ATOL = 0.1
REFERENCE_ARCHS = ("tinyllama-1.1b", "mamba2-130m", "recurrentgemma-2b")
#: decode steps of the reduced recurrent models: past their window of 16
REFERENCE_STEPS = 24
#: the memory-packed kernels: tinyllama's LM head (d_model x vocab) beside
#: LAYER_SHAPES, the lane widths B6/B7 are checked at (the path packs W4),
#: the widths B5 is checked at, and one ragged (rows, words) shape
LM_HEAD_SHAPE = (2048, 32000)
PACK_WIDTHS = (2, 4, 8)
QMM_WIDTHS = (4, 8)
RAGGED_PACK = (37, 301)
MEMORY_BITS = 4
#: the engine phase: full-width tinyllama-1.1b, buckets of batch BATCH
#: at these s_max, chunked prefill of 8 tokens, a burst of 32 requests
#: whose prompt lengths and decode budgets are drawn in ENGINE_LENGTHS;
#: the fault and memory runs take the first 8 of them
ENGINE_BUCKETS = (32, 64)
ENGINE_CHUNK = 8
ENGINE_REQUESTS = 32
ENGINE_LENGTHS = (8, 24)
ENGINE_FAULT_REQUESTS = 8
ENGINE_MEMORY_REQUESTS = 8


#: SDV plans wider than int8 (fault C1), byte-sliced in B1/B2: (word,
#: w_a, w_b) — the planner's w_b = a_bits + 1 and W4A16 on every
#: exact-wrap word, and the widest w_a = w_b plan of each word
WIDE_SDV_PLANS = [(s, wa, wb) for s in ("int32", "dsp48e2", "dsp58")
                  for wa, wb in ((4, 9), (8, 9), (4, 16))] + [
    ("int32", 15, 15), ("dsp48e2", 23, 23), ("dsp58", 26, 26)]
WIDE_SDV_SHAPE = (2048, 256)
#: B3 plans with taps wider than 8 bits: (word, w_k, w_i) — W12A4 on
#: DSP58 and the widest w_k plan_bseg admits on each word (at w_i = 1)
WIDE_B3_PLANS = [("dsp58", 12, 4), ("int32", 29, 1), ("fp32m", 21, 1),
                 ("dsp48e2", 26, 1), ("dsp58", 26, 1)]

#: the kernel functions of csrc/*.cu, as the profiler names them
PORT_KERNELS = ("sdv_gemv_kernel", "sdv_gemm_kernel", "bseg_conv2d_kernel",
                "bseg_conv1d_kernel", "quant_matmul_kernel",
                "pack_words_kernel", "unpack_words_kernel",
                "unpack_dequant_kernel")
#: the launch counters that counts() reads: B7 is the fused
#: unpack-and-dequantize the serving path runs, B7_int8 the int8 unpack
#: (the TPU kernel's counterpart, on no path)
KERNEL_NAMES = ("B1", "B2", "B3", "B4", "B5", "B6", "B7", "B7_int8")
#: clock cycles the card spins before each timed call (~1 ms)
SPIN_CYCLES = 2_000_000


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def event_ms(fn, reps, flush=None):
    """Median device time of ``fn`` over ``reps`` calls (CUDA events
    around each call; ``flush`` runs before each, outside the events),
    after two untimed calls.  The card first spins ``SPIN_CYCLES``, long
    enough for the host to queue the flush, the events and the call
    behind it: the events then time the device's work and not the
    wrapper's host time, which exceeds a small kernel's.  The median
    keeps out a call whose host stalled longer than the spin (the card
    then idles between the events)."""
    import statistics

    import torch
    fn()
    fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES)
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes, ops, ops_per_s=INT8_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    names = ("sdv", "bseg", "bseg1d", "packbits", "quant_matmul")
    with ThreadPoolExecutor(len(names)) as pool:     # one nvcc per source
        list(pool.map(build.build, names))
    for name in names:
        build.library(name)
        log = build.library_path(name).with_suffix(".log").read_text()
        regs = [line.split("ptxas info    :")[-1].strip()
                for line in log.splitlines() if "Used" in line]
        print(f"[build] {name}.cu -> {build.library_path(name).name} (nvcc "
              f"{build.build_seconds[name]:.1f} s); {len(regs)} kernels, "
              f"e.g. {regs[:2]}")
        if name in ("sdv", "bseg", "bseg1d", "quant_matmul"):
            for line in ptxas_report(log):
                print(f"[build]   {line}")
        if name == "sdv":
            lib = build.library(name)
            print("[build]   dynamic shared memory per block: " + ", ".join(
                f"{k} {w} words {lib.sdv_smem_bytes(gemm, limb)} B"
                for k, gemm in (("B1", 0), ("B2", 1))
                for w, limb in (("INT32", 0), ("two-limb", 1))))
    print(f"[build] all sources in {time.perf_counter() - t0:.1f} s")


def ptxas_report(log):
    """One line per kernel of an ``-Xptxas -v`` log: its name with its
    template arguments (sdv.cu: <two-limb words, .u8 lanes, .u8
    activations>, the ``_sliced`` kernels <two-limb words>; bseg.cu:
    <n-tiles of 8 output channels>; bseg1d.cu: <word form, taps a
    pass>; quant_matmul.cu: <w, x rows, float32 x>),
    registers, spills and static shared memory (the tiles are dynamic
    shared memory, sized by the launchers)."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+((?:sdv_gem[mv]|bseg_conv[12]d|quant_matmul)"
                          r"_kernel\w*?)I(\w*)E", m.group(1))
            flags = [] if k is None else \
                re.findall(r"L[bi](\d+)E", k.group(2))
            name = m.group(1) if k is None else \
                f"{k.group(1)}<{','.join(flags)}>"
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and name is not None:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spill}")
            name, spill = None, ""
    return out


def phase_kernels(dev, flush):
    """Every kernel vs its plain version and the exact product; timings.
    Returns per-kernel sums over one layer's projections (INT32 plan)."""
    import torch
    from repro_torch.core.datapath import DSP48E2, plan_sdv
    from repro_torch.models.quantized import default_sdv_plan

    plans = {"int32 W4A8 n=2": default_sdv_plan(4, 8),
             "dsp48e2 W4A8 n=3": plan_sdv(DSP48E2, 4, 8, signed_a=True,
                                          signed_b=True, park_sign_bits=True)}
    check(plans["dsp48e2 W4A8 n=3"].n == 3, plans["dsp48e2 W4A8 n=3"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    layer = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                        bytes=0, ops=0)
             for name in ("B1", "B2")}
    max_err = {"B1": 0, "B2": 0}
    t_phase = time.perf_counter()
    for pname, plan in plans.items():
        for (k, m), mult in LAYER_SHAPES.items():
            for kname, rows_list in (("B1", B1_ROWS), ("B2", B2_ROWS)):
                for rows in rows_list:
                    r = sdv_case(kname, plan, pname, k, m, rows, gen, flush)
                    max_err[kname] = max(max_err[kname], r["max_abs_err"])
                    main_rows = DECODE_ROWS if kname == "B1" else PREFILL_ROWS
                    if pname.startswith("int32") and rows == main_rows:
                        acc = layer[kname]
                        for key in ("ms", "plain_ms", "bytes", "ops"):
                            acc[key] += mult * r[key]
                        if r["library_ms"] is None \
                                or acc["library_ms"] is None:
                            acc["library_ms"] = None
                        else:
                            acc["library_ms"] += mult * r["library_ms"]
    for kname, err in wide_sdv_cases(gen, flush).items():
        max_err[kname] = max(max_err[kname], err)
    for kname, acc in layer.items():
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"])
        acc["max_abs_err"] = max_err[kname]
    print(f"[kernels] all shapes exact, {time.perf_counter() - t_phase:.1f} s")
    return layer


def wide_sdv_cases(gen, flush):
    """B1 and B2 on the plans wider than int8 (``WIDE_SDV_PLANS``, fault
    C1): random operands of the full widths, each kernel against its
    plain version and the exact product mod 2^32 (int64 on the CPU,
    where a product that wraps keeps its low 32 bits).  Returns the
    largest difference from the plain version by kernel."""
    import torch
    from repro_torch.core.datapath import DATAPATHS, plan_sdv
    from repro_torch.core.limbs import lo32
    from repro_torch.kernels import ops, sdv_matmul, sdv_matvec

    k, m = WIDE_SDV_SHAPE
    max_err = {"B1": 0, "B2": 0}
    for spec, wa, wb in WIDE_SDV_PLANS:
        plan = plan_sdv(DATAPATHS[spec], wa, wb, signed_a=True,
                        signed_b=True, park_sign_bits=True)
        w = torch.randint(-(1 << wa - 1), 1 << wa - 1, (m, k), generator=gen,
                          device=gen.device)
        words = ops.prepare_sdv_weights(w, plan)
        for kname, rows in (("B1", DECODE_ROWS), ("B2", PREFILL_ROWS)):
            x = torch.randint(-(1 << wb - 1), 1 << wb - 1, (rows, k),
                              generator=gen, device=gen.device,
                              dtype=torch.int32)
            if kname == "B1":
                xt = x.T.contiguous()

                def run():
                    return sdv_matvec.sdv_matvec(xt, words, plan=plan)
            else:
                def run():
                    return sdv_matmul.sdv_matmul(x, words, plan=plan)
            got = run()
            want = sdv_matmul.sdv_matmul_plain(x, words, plan)
            exact = lo32(x.cpu().long() @ w.cpu().long().T)
            err = int((got.long() - want.long()).abs().max())
            max_err[kname] = max(max_err[kname], err)
            where = (f"{spec} W{wa}A{wb} (n={plan.n}, "
                     f"{len(sdv_matmul.slice_pairs(plan))} slice pairs) "
                     f"K={k} M={m} rows={rows}")
            check(err == 0, f"{kname} != plain at {where} (max err {err})")
            check(torch.equal(got.reshape(rows, -1)[:, :m].cpu(), exact),
                  f"{kname} != exact product at {where}")
            ms = event_ms(run, reps=5, flush=flush)
            print(f"[kernels] {kname} {where}: {ms:.4f} ms, exact")
    return max_err


def sdv_case(kname, plan, pname, k, m, rows, gen, flush):
    """One B1 or B2 case: random W4 weights [M, K] in ``plan``'s words and
    ``rows`` random int8 activation rows.  Checks the kernel against its
    plain version and the exact product; returns its times, bytes,
    operations and library time."""
    import torch
    from repro_torch.kernels import ops, ref, sdv_matmul, sdv_matvec

    w = torch.randint(-8, 8, (m, k), generator=gen, device=gen.device)
    words = ops.prepare_sdv_weights(w, plan)
    x = torch.randint(-127, 128, (rows, k), generator=gen, device=gen.device,
                      dtype=torch.int32)
    if kname == "B1":
        xt = x.T.contiguous()

        def run():
            return sdv_matvec.sdv_matvec(xt, words, plan=plan)
    else:
        def run():
            return sdv_matmul.sdv_matmul(x, words, plan=plan)
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sdv_matmul.sdv_matmul_plain(x, words, plan)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    exact = ref.sdv_matmul_ref(x, w)                  # float64, exact
    err = int((got.long() - want.long()).abs().max())
    where = f"{pname} K={k} M={m} rows={rows}"
    check(err == 0, f"{kname} != plain at {where} (max err {err})")
    check(torch.equal(got.reshape(rows, -1)[:, :m], exact),
          f"{kname} != exact product at {where}")
    ms = event_ms(run, reps=10, flush=flush)
    nbytes = x.numel() * 4 + words.numel() * 4 + got.numel() * 4
    ops_n = 2 * rows * m * k
    b_ms, b_by = bound_ms(nbytes, ops_n)
    lib_ms = int_mm_ms(x, w, flush)
    print(f"[kernels] {kname} {where}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
          f"{b_by}, {b_ms / ms:.1%} of bound), plain {plain_ms:.1f} ms, "
          f"_int_mm {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, exact")
    return dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops_n,
                library_ms=lib_ms, max_abs_err=err)


def int_mm_ms(x, w, flush):
    """``torch._int_mm`` on the unpacked int8 operands (rows padded to 32,
    its smallest accepted row count above 16; output columns zero-padded
    to a multiple of 8, which it needs: the same function), or None if
    refused."""
    import torch
    rows = max(32, x.shape[0])
    a = torch.zeros((rows, x.shape[1]), dtype=torch.int8, device=x.device)
    a[:x.shape[0]] = x.to(torch.int8)
    m = -(-w.shape[0] // 8) * 8
    wp = torch.zeros((m, w.shape[1]), dtype=torch.int8, device=w.device)
    wp[:w.shape[0]] = w.to(torch.int8)
    b = wp.T                                  # [K, M], column-major
    try:
        torch._int_mm(a, b)
    except RuntimeError as e:
        print(f"[kernels] _int_mm refused {tuple(a.shape)}x{tuple(b.shape)}: "
              f"{str(e).splitlines()[0]}")
        return None
    return event_ms(lambda: torch._int_mm(a, b), reps=10, flush=flush)


def phase_conv_kernels(dev, flush):
    """B3 at every UltraNet conv shape on the four W4A4 plans, and B2 on
    the head's im2col plan: each against its plain version and the
    float64 oracle, timed beside its bound and the library conv.
    Returns B3's sums over one forward's 8 3x3 stages (INT32 plan), its
    per-layer times, and the B2 head time."""
    import torch
    from repro_torch.core.datapath import DATAPATHS, plan_bseg
    from repro_torch.kernels import bseg_conv2d, ops, ref, sdv_matmul
    from repro_torch.models.ultranet import ultranet_layer_shapes

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    b = ULTRA_BATCH
    acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0,
               mults=0)
    per_layer, max_err = [], 0
    t_phase = time.perf_counter()
    for spec in CONV_SPECS:
        plan = plan_bseg(DATAPATHS[spec], 4, 4)
        tot = dict(ms=0.0, mults=0)
        for li, s in enumerate(ultranet_layer_shapes(ULTRA_SIZE, ULTRA_SIZE)):
            h, w, cin, cout, k = s["h"], s["w"], s["cin"], s["cout"], s["k"]
            x = torch.randint(0, 16, (b, h, w, cin), generator=gen,
                              device=dev, dtype=torch.int32)
            taps = torch.randint(-8, 8, (cout, cin, k, k), generator=gen,
                                 device=dev, dtype=torch.int32)
            x_pad, kappa, _ = ops.bseg_conv2d_operands(x, taps, plan)

            def run():
                return bseg_conv2d.bseg_conv2d(x_pad, kappa, plan=plan,
                                               h_out=h, w_out=w)
            got = run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = bseg_conv2d.bseg_conv2d_plain(x_pad, kappa, plan,
                                                 h_out=h, w_out=w)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            exact = ref.conv2d_int_ref(x, taps)              # float64
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            where = f"{spec} L{li} {h}x{w} {cin}->{cout} k{k}"
            check(err == 0, f"B3 != plain at {where} (max err {err})")
            check(torch.equal(got, exact), f"B3 != exact conv at {where}")
            check(torch.equal(run(), got),
                  f"B3 differs between two launches at {where}")
            ms = event_ms(run, reps=5, flush=flush)
            nbytes = x_pad.numel() + kappa.numel() * 4 + got.numel() * 4
            macs = b * h * w * cout * cin * k * k
            b_ms, b_by = bound_ms(nbytes, 2 * macs)
            mults = b * bseg_conv2d.bseg_conv2d_num_multiplies(
                h, w, cin, cout, k, k, plan)
            lib_ms, lib_err = conv2d_library_ms(x, taps, exact, flush)
            print(f"[conv] B3 {where}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
                  f"{b_by}, {b_ms / ms:.1%} of bound; {mults / 1e6:.1f}M "
                  f"wide multiplies, {mults / ms / 1e6:.2f} G/s), plain "
                  f"{plain_ms:.1f} ms, F.conv2d fp32 {lib_ms:.4f} ms "
                  f"(max |err| {lib_err:g}), exact; "
                  f"{b3_geometry(x_pad, kappa, plan, h, w)}")
            tot["ms"] += ms
            tot["mults"] += mults
            if spec == "int32" and k == 3:
                per_layer.append(ms)
                acc["ms"] += ms
                acc["plain_ms"] += plain_ms
                acc["library_ms"] += lib_ms
                acc["bytes"] += nbytes
                acc["ops"] += 2 * macs
                acc["mults"] += mults
        print(f"[conv] B3 {spec} plan (n_k={plan.n_k}, n_i={plan.n_i}, "
              f"L={plan.lane}): all 9 convs {tot['ms']:.3f} ms, "
              f"{tot['mults'] / 1e9:.3f}G wide multiplies")
    max_err = max(max_err, wide_b3_cases(gen, flush))
    acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"])
    acc["max_abs_err"] = max_err

    # B2 on the 1x1 head's im2col plan (signed w_a=4 x w_b=5, n=3)
    plan = ops._im2col_sdv_plan(plan_bseg(DATAPATHS["int32"], 4, 4))
    s = ultranet_layer_shapes(ULTRA_SIZE, ULTRA_SIZE)[-1]
    rows = b * s["h"] * s["w"]
    x = torch.randint(0, 16, (rows, s["cin"]), generator=gen, device=dev,
                      dtype=torch.int32)
    w = torch.randint(-8, 8, (s["cout"], s["cin"]), generator=gen,
                      device=dev)
    words = ops.prepare_sdv_weights(w, plan)
    got = sdv_matmul.sdv_matmul(x, words, plan=plan)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sdv_matmul.sdv_matmul_plain(x, words, plan)
    torch.cuda.synchronize()
    head_plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"B2 != plain on the head's im2col plan ({err})")
    check(torch.equal(got.reshape(rows, -1)[:, :s["cout"]],
                      ref.sdv_matmul_ref(x, w)),
          "B2 != exact product on the head's im2col plan")
    head_ms = event_ms(lambda: sdv_matmul.sdv_matmul(x, words, plan=plan),
                       reps=10, flush=flush)
    lib_ms = int_mm_ms(x, w, flush)
    b_ms, b_by = bound_ms(x.numel() * 4 + words.numel() * 4
                          + got.numel() * 4, 2 * rows * s["cin"] * s["cout"])
    print(f"[conv] B2 head im2col plan (w_a={plan.w_a}, w_b={plan.w_b}, "
          f"n={plan.n}) {rows}x{s['cin']} @ {s['cin']}x{s['cout']}: "
          f"{head_ms:.4f} ms (bound {b_ms:.5f} ms by {b_by}, "
          f"{b_ms / head_ms:.1%} of bound), plain {head_plain_ms:.1f} ms, "
          f"_int_mm {lib_ms if lib_ms is None else f'{lib_ms:.4f}'} ms, "
          "exact")
    print(f"[conv] all shapes exact, {time.perf_counter() - t_phase:.1f} s")
    return acc, per_layer, head_ms


def b3_geometry(x_pad, kappa, plan, h, w):
    """B3's launch at this shape: tiles, grid and shared memory."""
    from repro_torch.device import sm_count
    from repro_torch.kernels import bseg_conv2d
    b, _, _, c_in = x_pad.shape
    n_groups, kh, _, c_out = kappa.shape[-4:]
    geo = bseg_conv2d.launch_shape(b, h, w, c_in, c_out, kh,
                                   n_groups * plan.n_k,
                                   bseg_conv2d.tap_slices(plan),
                                   sms=sm_count(x_pad.device.index))
    return (f"{geo.n_tile} ch x {geo.tr}x{geo.tc} px tiles (mt {geo.mt}), "
            f"{geo.tiles[2]} tiles, grid {geo.grid}, {geo.smem} B smem")


def wide_b3_cases(gen, flush):
    """B3 on taps wider than 8 bits (``WIDE_B3_PLANS``, byte-sliced) at
    UltraNet's first and a 26x26 shape, batch 8: against its plain
    version and the float64 oracle (exact: every sum is below 2^53).
    Returns the largest difference from the plain version."""
    import torch
    from repro_torch.core.datapath import DATAPATHS, plan_bseg
    from repro_torch.kernels import bseg_conv2d, ops, ref
    from repro_torch.models.ultranet import ultranet_layer_shapes

    shapes = ultranet_layer_shapes(ULTRA_SIZE, ULTRA_SIZE)
    max_err = 0
    for spec, wk, wi in WIDE_B3_PLANS:
        plan = plan_bseg(DATAPATHS[spec], wk, wi)
        for li in (0, 4):
            s = shapes[li]
            h, w, cin, cout, k = s["h"], s["w"], s["cin"], s["cout"], s["k"]
            x = torch.randint(0, 1 << wi, (ULTRA_BATCH, h, w, cin),
                              generator=gen, device=gen.device,
                              dtype=torch.int32)
            taps = torch.randint(-(1 << wk - 1), 1 << wk - 1,
                                 (cout, cin, k, k), generator=gen,
                                 device=gen.device, dtype=torch.int32)
            x_pad, kappa, _ = ops.bseg_conv2d_operands(x, taps, plan)

            def run():
                return bseg_conv2d.bseg_conv2d(x_pad, kappa, plan=plan,
                                               h_out=h, w_out=w)
            got = run()
            want = bseg_conv2d.bseg_conv2d_plain(x_pad, kappa, plan,
                                                 h_out=h, w_out=w)
            err = int((got.long() - want.long()).abs().max())
            max_err = max(max_err, err)
            where = (f"{spec} W{wk}A{wi} ({bseg_conv2d.tap_slices(plan)} "
                     f"tap slices) L{li} {h}x{w} {cin}->{cout} k{k}")
            check(err == 0, f"B3 != plain at {where} (max err {err})")
            check(torch.equal(got, ref.conv2d_int_ref(x, taps)),
                  f"B3 != exact conv at {where}")
            ms = event_ms(run, reps=5, flush=flush)
            print(f"[conv] B3 {where}: {ms:.4f} ms, exact; "
                  f"{b3_geometry(x_pad, kappa, plan, h, w)}")
    return max_err


def conv2d_library_ms(x, taps, exact, flush):
    """``torch.nn.functional.conv2d`` on float32 NHWC-strided operands
    (TF32 off): (time, max |difference| from the exact conv).  Direct
    and GEMM algorithms are exact here (every partial sum stays below
    2^24); cuDNN's Winograd-type algorithms, which it may pick for 3x3
    filters, round."""
    import torch
    xf = x.permute(0, 3, 1, 2).to(torch.float32)     # channels-last strides
    wf = taps.to(torch.float32).contiguous(memory_format=torch.channels_last)
    pad = taps.shape[-1] // 2

    def run():
        return torch.nn.functional.conv2d(xf, wf, padding=pad)
    err = float((run().permute(0, 2, 3, 1) - exact).abs().max())
    return event_ms(run, reps=5, flush=flush), err


def _counters():
    """(kernel launch counters by name, plain-version call counters): the
    functions whose ``launches`` / ``calls`` attributes count."""
    from repro_torch.kernels import (bseg_conv1d, bseg_conv2d, packbits,
                                     quant_matmul, sdv_matmul, sdv_matvec)
    return ({"B1": sdv_matvec.sdv_matvec, "B2": sdv_matmul.sdv_matmul,
             "B3": bseg_conv2d.bseg_conv2d, "B4": bseg_conv1d.bseg_conv1d,
             "B5": quant_matmul.quant_matmul, "B6": packbits.pack_words,
             "B7": packbits.unpack_dequant,
             "B7_int8": packbits.unpack_words},
            (sdv_matmul.sdv_matmul_plain, bseg_conv2d.bseg_conv2d_plain,
             bseg_conv1d.bseg_conv1d_plain, quant_matmul.quant_matmul_plain,
             packbits.pack_words_plain, packbits.unpack_words_plain,
             packbits.unpack_dequant_plain))


def counts():
    kernels, plains = _counters()
    out = {name: fn.launches for name, fn in kernels.items()}
    out["plain"] = sum(fn.calls for fn in plains)
    return out


def reset_counts():
    kernels, plains = _counters()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plains:
        fn.calls = 0


def expect(**launches):
    """The counts() of a run that launched only ``launches`` (by kernel
    name) and called no plain version."""
    out = dict.fromkeys(KERNEL_NAMES, 0)
    out.update(launches)
    out["plain"] = 0
    return out


def phase_serve(dev):
    """Full-width tinyllama-1.1b prefill + greedy decode on the kernels.
    Returns the launch counts of that main-path run."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import single_batch_loop
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, serve_params)

    cfg = get_arch("tinyllama-1.1b")
    per_step = 7 * cfg.n_layers
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    qparams = serve_params(params, bits=4, min_size=1024, compute="sdv")
    del params
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}; seeded init + SDV packing in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                           dtype=torch.int32, device=dev)
    n_prompt = torch.full((BATCH,), PROMPT - 1, dtype=torch.int32,
                          device=dev)
    # warm-up (first-call costs of cuBLAS, allocator, kernels): one
    # prefill and one decode step on a throwaway cache
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    decode_step(cfg, qparams, cache, prompts[:, -1:])
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    # prefill: the first PROMPT-1 tokens (all PROMPT columns go through
    # the GEMMs: 8 x 16 = 128 rows); the last prompt token opens decode
    reset_counts()
    t0 = time.perf_counter()
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    c_prefill = counts()
    check(c_prefill == expect(B2=per_step),
          f"prefill launches {c_prefill}, want B2={per_step}")
    reset_counts()
    tok = prompts[:, -1:]
    gen = []
    t0 = time.perf_counter()
    for _ in range(NEW):
        logits, cache = decode_step(cfg, qparams, cache, tok)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1).to(torch.int32)
        gen.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    c_decode = counts()
    check(c_decode == expect(B1=NEW * per_step),
          f"decode launches {c_decode}, want B1={NEW * per_step}")
    check(tuple(logits.shape) == (BATCH, 1, cfg.vocab_padded)
          and logits.dtype == torch.float32, tuple(logits.shape))
    check(bool(torch.isfinite(logits).all()), "non-finite logits")
    check(cache["index"].tolist() == [PROMPT - 1 + NEW] * BATCH,
          cache["index"].tolist())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    sample = torch.cat(gen, 1)[0].tolist()
    print(f"[serve] prefill {BATCH}x{PROMPT}: {t_prefill * 1e3:.1f} ms "
          f"({BATCH * PROMPT / t_prefill:.1f} tok/s), launches {c_prefill}")
    print(f"[serve] decode {NEW} steps at batch {BATCH}: "
          f"{t_decode / NEW * 1e3:.1f} ms/step, {BATCH * NEW / t_decode:.1f} "
          f"tok/s, launches {c_decode}, peak memory {peak:.2f} GiB, "
          f"sample {sample[:8]}")

    # a copy of the cache, so the main path's cache is left as it was
    state = {"cache": {k: v.clone() for k, v in cache.items()}}

    def step():
        _, state["cache"] = decode_step(cfg, qparams, state["cache"], tok)
    profile(f"decode step at batch {BATCH}", step, steps=2,
            wall_ms=t_decode / NEW * 1e3)

    # the serve CLI's loop (--engine off): teacher-forced prompt + greedy
    reset_counts()
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    toks, dt = single_batch_loop(cfg, qparams, cache, prompts, NEW)
    c_loop = counts()
    steps = PROMPT + NEW - 1
    check(c_loop == expect(B1=steps * per_step),
          f"single_batch_loop launches {c_loop}")
    check(toks.shape == (BATCH, NEW), toks.shape)
    print(f"[serve] single_batch_loop: {BATCH * steps / dt:.1f} tok/s "
          f"({steps} steps), launches {c_loop}")
    return {"B1": c_decode["B1"], "B2": c_prefill["B2"]}


def profile(label, fn, steps, wall_ms):
    """Device busy time per call of ``fn`` (torch.profiler) against
    ``wall_ms``, the unprofiled wall time per call, and the kernels that
    take it.  Only device events count (kernels, copies, memsets): an
    aten op's own device time is that of the kernels it launched, which
    appear as device events too."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    busy_ms = sum(dev_us.values()) / 1e3 / steps
    if busy_ms == 0.0:
        print(f"[profile] {label}: the profiler saw no device time; "
              "device busy share not measured")
        return
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
    # each event goes to the longest port kernel name in it
    # (pack_words_kernel is a substring of unpack_words_kernel)
    ours = dict.fromkeys(PORT_KERNELS, 0.0)
    for k, v in dev_us.items():
        hits = [name for name in PORT_KERNELS if name in k]
        if hits:
            ours[max(hits, key=len)] += v / 1e3 / steps
    print(f"[profile] {label}: unprofiled wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) over "
          f"{len(dev_us)} distinct device events; the port's kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v)
          + f", the rest {busy_ms - sum(ours.values()):.3f} ms; top device "
          "time per call: "
          + "; ".join(f"{k[:60]} {v / 1e3 / steps:.3f} ms" for k, v in top))


def phase_reference(dev, compute="sdv"):
    """The reduced models on the card vs on the CPU (plain kernel
    versions), packed by ``serve_params(compute=compute)``: same seeded
    weights, same teacher-forced tokens.
    tinyllama prefills 5 tokens and decodes 3; the recurrent models
    replay ``REFERENCE_STEPS`` tokens one per decode step, past the
    reduced attention window, so recurrentgemma's KV ring wraps."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, serve_params)

    cpu = torch.device("cpu")
    for arch in REFERENCE_ARCHS:
        cfg = get_arch(arch).reduced()
        params = init_params(cfg, seed=1, device=cpu)
        rng = np.random.default_rng(1)
        if cfg.family == "dense":
            prompt = rng.integers(0, cfg.vocab, (3, 5))
            tokens = rng.integers(0, cfg.vocab, (3, 3, 1))
            s_max = 12
        else:
            prompt = None
            tokens = rng.integers(0, cfg.vocab, (REFERENCE_STEPS, 3, 1))
            s_max = REFERENCE_STEPS
            check(cfg.window is None or cfg.window < REFERENCE_STEPS,
                  f"{cfg.name}: {REFERENCE_STEPS} steps do not wrap the "
                  f"window {cfg.window}")
        outs, caches = {}, {}
        for d in (cpu, dev):
            q = serve_params(_to(params, d), bits=4, min_size=1024,
                             compute=compute)
            cache = init_cache(cfg, 3, s_max, device=d)
            if prompt is not None:
                cache = prefill_step(
                    cfg, q, cache,
                    torch.tensor(prompt, dtype=torch.int32, device=d),
                    torch.tensor([5, 3, 0], dtype=torch.int32, device=d))
            logits = []
            for t in tokens:
                out, cache = decode_step(cfg, q, cache, torch.tensor(
                    t, dtype=torch.int32, device=d))
                logits.append(out.cpu())
            outs[d.type] = torch.stack(logits)
            caches[d.type] = {k: v.cpu() for k, v in cache.items()}
        card, host = outs["cuda"], outs["cpu"]
        err = float((card - host).abs().max())
        check(err <= LOGIT_ATOL, f"reduced {cfg.name} card vs CPU logits "
                                 f"differ by {err} > {LOGIT_ATOL}")
        top2 = host[..., :cfg.vocab].topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > 2 * LOGIT_ATOL
        same = (card[..., :cfg.vocab].argmax(-1)
                == host[..., :cfg.vocab].argmax(-1))
        check(bool(same[sure].all()),
              f"reduced {cfg.name}: greedy tokens differ where the CPU's "
              "top-2 margin exceeds twice the tolerance")
        state_err = {k: float((caches["cuda"][k].float()
                               - v.float()).abs().max())
                     for k, v in caches["cpu"].items()
                     if v.is_floating_point()}
        print(f"[reference] reduced {cfg.name} ({compute}), {len(tokens)} "
              "decode steps: "
              f"card vs CPU max |dlogit| {err:.4g} (tolerance {LOGIT_ATOL}: "
              f"bf16 rounding and sum order differ between the card and the "
              f"CPU; max |logit| {float(host.abs().max()):.4g}; "
              f"{int(sure.sum())} of {sure.numel()} greedy tokens checked); "
              "cache max |d|: "
              + ", ".join(f"{k} {v:.4g}" for k, v in state_err.items()))


def phase_ultranet(dev, per_layer, card):
    """Full-width UltraNet-INT4 at 416x416, batch 8, on the default INT32
    plan and on the DSP48E2 plan, each bit-exact against the float64
    oracle; then a 32x32 frame on the card against the CPU.  Returns the
    launch counts of the two main-path runs."""
    import numpy as np
    import torch
    from repro_torch.core.datapath import DSP48E2, plan_bseg
    from repro_torch.models import init_ultranet, ultranet_forward

    b, size = ULTRA_BATCH, ULTRA_SIZE
    params = init_ultranet(0, device=dev)
    img = torch.tensor(np.random.default_rng(1).integers(
        0, 16, (b, size, size, 3)), dtype=torch.int32, device=dev)
    y_ref = ultranet_forward(params, img, mode="ref", device=dev)
    check(tuple(y_ref.shape) == (b, size // 16, size // 16, 36)
          and y_ref.dtype == torch.int32, tuple(y_ref.shape))
    runs = {"int32": (None, expect(B2=1, B3=8)),
            "dsp48e2": ([plan_bseg(DSP48E2, 4, 4)] * 9, expect(B3=9))}
    launches = {}
    for name, (plans, want) in runs.items():
        def forward():
            return ultranet_forward(params, img, mode="bseg", plans=plans,
                                    device=dev)
        forward()                                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        y = forward()
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        launches[name] = counts()
        check(launches[name] == want,
              f"ultranet {name} launches {launches[name]}, want {want}")
        check(torch.equal(y, y_ref),
              f"ultranet {name} plan differs from the float64 oracle")
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            forward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[ultranet] {name} plan, {size}x{size} x{b}: bit-exact vs "
              f"the float64 oracle; {ms:.3f} ms per forward "
              f"({b / ms * 1e3:.1f} frames/s; first timed forward "
              f"{t_first * 1e3:.1f} ms), peak memory {peak:.2f} GiB, "
              f"launches {launches[name]} ({card})")
        if name == "int32":
            profile(f"ultranet int32 forward, {size}x{size} x{b}", forward,
                    steps=2, wall_ms=ms)
            prep = time_operand_prep(params, dev)
            print(f"[ultranet] int32 operand prep per forward, synchronised "
                  f"wall ({card}): {sum(prep.values()):.3f} ms of the "
                  f"{ms:.3f} ms forward ("
                  + ", ".join(f"{k} {v:.3f} ms" for k, v in prep.items())
                  + ")")
    print(f"[ultranet] B3 per layer on the int32 plan, kernels phase, L2 "
          f"flushed ({card}): "
          + ", ".join(f"L{i} {t:.3f} ms" for i, t in enumerate(per_layer)))

    # a small frame on the card against the same frame on the CPU
    cpu = torch.device("cpu")
    small = np.random.default_rng(2).integers(0, 16, (2, 32, 32, 3))
    outs = []
    for d in (cpu, dev):
        p = init_ultranet(0, device=d)
        outs.append(ultranet_forward(p, torch.tensor(small), mode="bseg",
                                     device=d).cpu())
    check(torch.equal(outs[0], outs[1]), "ultranet 32x32: card != CPU")
    print("[ultranet] 32x32 x2: card (kernels) == CPU (plain versions)")
    return launches


def time_operand_prep(params, dev, reps=3):
    """Synchronised wall time (best of ``reps``) that one INT32-plan
    forward spends preparing its kernels' operands, at the main path's
    shapes: ``prepare_bseg_conv2d`` (kappa from the weights, redone on
    every call), the rest of ``bseg_conv2d_operands`` (building
    ``x_pad``), and the head's ``prepare_sdv_weights`` and
    ``_im2col_patches``.  Returns ms per forward by step."""
    import torch
    from repro_torch.core.datapath import INT32, plan_bseg
    from repro_torch.kernels import ops
    from repro_torch.models.ultranet import ultranet_layer_shapes

    def wall(fn):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    plan = plan_bseg(INT32, 4, 4)
    sdv_plan = ops._im2col_sdv_plan(plan)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    out = dict(kappa=0.0, x_pad=0.0, sdv_words=0.0, im2col=0.0)
    shapes = ultranet_layer_shapes(ULTRA_SIZE, ULTRA_SIZE)
    for s, w in zip(shapes, params.convs + [params.head]):
        x = torch.randint(0, 16, (ULTRA_BATCH, s["h"], s["w"], s["cin"]),
                          generator=gen, device=dev, dtype=torch.int32)
        if s["k"] == 3:
            t_kappa = wall(lambda: ops.prepare_bseg_conv2d(w, plan))
            out["kappa"] += t_kappa
            out["x_pad"] += wall(
                lambda: ops.bseg_conv2d_operands(x, w, plan)) - t_kappa
        else:
            w2 = w.to(torch.int32).reshape(s["cout"], s["cin"])
            out["sdv_words"] += wall(
                lambda: ops.prepare_sdv_weights(w2, sdv_plan))
            out["im2col"] += wall(lambda: ops._im2col_patches(x, 1, 1))
    return out


def phase_conv1d_kernels(dev, flush):
    """B4 on the four W4A4 plans at the short conv's decode and long
    shapes, and on a 'same'-padded depthwise packed_conv2d: each against
    its plain version and the exact conv, timed beside its bound and the
    library conv.  Returns B4's numbers at mamba2-130m's decode shape
    (int32 plan) and the largest error seen."""
    import torch
    from repro_torch.core.datapath import DATAPATHS, plan_bseg
    from repro_torch.kernels import ops, ref

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    t_phase = time.perf_counter()
    main, max_err = None, 0
    for spec in CONV_SPECS:
        plan = plan_bseg(DATAPATHS[spec], 4, 4)
        for c in CONV1D_CHANNELS:
            taps = torch.randint(-8, 8, (c, CONV1D_TAPS), generator=gen,
                                 device=dev, dtype=torch.int32)
            for label, s in CONV1D_SAMPLES.items():
                xq = torch.randint(-8, 8, (BATCH, s, c), generator=gen,
                                   device=dev, dtype=torch.int32)
                r = conv1d_case(xq, taps, plan, "causal", flush,
                                f"{spec} {label} B={BATCH} S={s} C={c}")
                max_err = max(max_err, r["max_abs_err"])
                if spec == "int32" and label == "decode" \
                        and c == CONV1D_CHANNELS[0]:
                    main = r
        # the depthwise route of packed_conv2d: 'same' pad along W
        x = torch.randint(-8, 8, (BATCH, 16, 64, 256), generator=gen,
                          device=dev, dtype=torch.int32)
        w = torch.randint(-8, 8, (256, 1, 1, 3), generator=gen, device=dev,
                          dtype=torch.int32)
        y = ops.packed_conv2d(x, w, plan=plan, zero_point=8)
        check(torch.equal(y, ref.conv2d_int_ref(x, w)),
              f"depthwise packed_conv2d != exact conv on {spec}")
        r = conv1d_case(x.reshape(-1, 64, 256), w[:, 0, 0, :], plan, "same",
                        flush, f"{spec} depthwise conv2d 'same' 8x16x64x256 "
                               "k1x3")
        max_err = max(max_err, r["max_abs_err"])
    print(f"[conv1d] all cases exact, {time.perf_counter() - t_phase:.1f} s")
    return dict(main, max_abs_err=max_err)


def conv1d_case(xq, taps, plan, padding, flush, where):
    """One B4 case: x_q [B, S, C] signed W4 activations (zero point 8),
    taps [C, n].  Checks the kernel against its plain version and the
    exact conv; returns its times, bound and library time."""
    import torch
    from repro_torch.kernels import bseg_conv1d, ops, ref

    n = taps.shape[1]
    s = xq.shape[1]
    zp = 8
    kappa, tap_sum = ops.prepare_bseg_taps(taps, plan)
    x_pad = ops.bseg_conv1d_x_pad(xq, plan, n_groups=kappa.shape[-2],
                                  n_taps=n, zero_point=zp, padding=padding)

    def run():
        return bseg_conv1d.bseg_conv1d(x_pad, kappa, plan=plan, s_out=s)
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = bseg_conv1d.bseg_conv1d_plain(x_pad, kappa, plan, s_out=s)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    left = n - 1 if padding == "causal" else (n - 1) // 2
    exact = ref.conv1d_ref(xq, taps, left)
    err = int((got.long() - want.long()).abs().max())
    check(err == 0, f"B4 != plain at {where} (max err {err})")
    y = got - zp * tap_sum[None, None, :]
    err_exact = int((y.long() - exact.long()).abs().max())
    check(err_exact == 0, f"B4 != exact conv at {where} ({err_exact})")
    ms = event_ms(run, reps=10, flush=flush)
    nbytes = x_pad.numel() + kappa.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 2 * xq.numel() * n)
    lib_ms, lib_err = conv1d_library_ms(xq, taps, left, exact, flush)
    print(f"[conv1d] B4 {where} (n_k={plan.n_k}, n_i={plan.n_i}, "
          f"L={plan.lane}, G={kappa.shape[-2]}): {ms:.4f} ms (bound "
          f"{b_ms:.5f} ms by {b_by}, {b_ms / ms:.1%} of bound), plain "
          f"{plain_ms:.1f} ms, F.conv1d fp32 {lib_ms:.4f} ms (max |err| "
          f"{lib_err:g}), exact")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=max(err, err_exact))


def conv1d_library_ms(xq, taps, left, exact, flush):
    """``torch.nn.functional.conv1d(groups=C)`` on float32 operands (TF32
    off), the input padded as the conv needs: (time, max |difference|
    from the exact conv)."""
    import torch
    n = taps.shape[1]
    xf = torch.nn.functional.pad(xq.permute(0, 2, 1).to(torch.float32),
                                 (left, n - 1 - left))       # [B, C, S+n-1]
    wf = taps.to(torch.float32)[:, None, :]                  # [C, 1, n]

    def run():
        return torch.nn.functional.conv1d(xf, wf, groups=taps.shape[0])
    err = float((run().permute(0, 2, 1) - exact).abs().max())
    return event_ms(run, reps=10, flush=flush), err


def phase_recurrent(dev, card, flush):
    """Full-width mamba2-130m and recurrentgemma-2b decoding through
    single_batch_loop at batch 8, with per-step launch counts read from
    the packed tree, and B1 held against its plain version and the exact
    product at each projection shape of the tree.  Returns each arch's
    B1 and B4 launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import single_batch_loop
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    serve_params)
    from repro_torch.models.quantized import count_packed

    launches = {}
    for arch, want_step in RECURRENT_STEP.items():
        cfg = get_arch(arch)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev)
        qparams = serve_params(params, bits=4, min_size=1024, compute="sdv")
        del params
        torch.cuda.synchronize()
        # every packed projection runs as B1 (8 rows) and every packed
        # conv as B4, once per layer and step; a packed LM head would be
        # materialized instead (tied embeddings here: none)
        packed = count_packed(qparams)
        per_step = {"B1": packed["sdv"], "B4": packed["bseg"]}
        check("lm_head" not in qparams and per_step == want_step,
              f"{arch}: the packed tree gives {per_step} launches per step, "
              f"want {want_step}")
        print(f"[recurrent] {cfg.name}: {cfg.n_layers} layers, d_model "
              f"{cfg.d_model}, vocab {cfg.vocab}; seeded init + SDV/BSEG "
              f"packing in {time.perf_counter() - t0:.1f} s; per step "
              f"{per_step}")
        # B1 at every projection shape the step gives it, on the tree's plan
        plan, shapes = sdv_shapes(qparams)
        check(sum(shapes.values()) == per_step["B1"], shapes)
        gen = torch.Generator(device=dev)
        gen.manual_seed(6)
        b1_ms = 0.0
        for (k, m), n in sorted(shapes.items()):
            r = sdv_case("B1", plan, f"{arch} ({n} per step)", k, m,
                         DECODE_ROWS, gen, flush)
            b1_ms += n * r["ms"]
        print(f"[recurrent] {cfg.name}: B1 exact at all {len(shapes)} "
              f"projection shapes; {b1_ms:.3f} ms per step from these "
              f"kernel times ({card})")
        rng = np.random.default_rng(0)
        prompts = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                               dtype=torch.int32, device=dev)
        # warm-up: two decode steps on a throwaway cache
        cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        for i in range(2):
            _, cache = decode_step(cfg, qparams, cache, prompts[:, i:i + 1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)

        reset_counts()
        cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        toks, dt = single_batch_loop(cfg, qparams, cache, prompts, NEW)
        c_loop = counts()
        steps = PROMPT + NEW - 1
        want = expect(B1=steps * per_step["B1"],
                      B4=steps * per_step["B4"])
        check(c_loop == want, f"{arch} single_batch_loop launches {c_loop}, "
                              f"want {want}")
        check(toks.shape == (BATCH, NEW) and (toks >= 0).all()
              and (toks < cfg.vocab).all(), f"{arch} tokens {toks.shape}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        step_ms = dt / steps * 1e3
        print(f"[recurrent] {cfg.name} single_batch_loop, batch {BATCH}, "
              f"{PROMPT}-token prompts + {NEW} new: {step_ms:.3f} ms/step, "
              f"{BATCH * steps / dt:.1f} tok/s ({steps} steps), peak memory "
              f"{peak:.2f} GiB, launches {c_loop}, sample "
              f"{toks[0][:8].tolist()} ({card})")
        launches[arch] = {"B1": c_loop["B1"], "B4": c_loop["B4"]}

        state = {"cache": init_cache(cfg, BATCH, PROMPT + NEW, device=dev)}

        def step():
            state["logits"], state["cache"] = decode_step(
                cfg, qparams, state["cache"], prompts[:, :1])
        profile(f"{cfg.name} decode step at batch {BATCH}", step, steps=2,
                wall_ms=step_ms)
        logits = state["logits"]
        check(tuple(logits.shape) == (BATCH, 1, cfg.vocab_padded)
              and logits.dtype == torch.float32
              and bool(torch.isfinite(logits).all()),
              f"{arch} logits {tuple(logits.shape)}")
        conv_card_vs_cpu(qparams, cfg, dev)
        del qparams, cache, state
        torch.cuda.empty_cache()
    return launches


def sdv_shapes(tree):
    """The SDV plan of a serve tree and its per-step B1 launches by
    projection shape: (plan, {(K, M): launches})."""
    from repro_torch.models.quantized import SDVLinear
    plans, shapes = set(), {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, SDVLinear):
            plans.add(node.plan)
            key = (node.words.shape[-2], node.d_out)
            shapes[key] = shapes.get(key, 0) + (
                node.words.shape[0] if node.stacked else 1)

    walk(tree)
    check(len(plans) == 1, f"one SDV plan per tree, got {plans}")
    return plans.pop(), shapes


def conv_card_vs_cpu(qparams, cfg, dev):
    """The first packed short conv of the tree at the decode shape (a new
    sample and 3 of history, batch 8): on the card (B4) and on the CPU
    (its plain version) the same inputs give the same outputs and state,
    bit for bit — the quantizer, the exact integer conv and the float32
    dequantization are the same operations on both."""
    import dataclasses
    import torch
    from repro_torch.models import BSEGConv, bseg_conv_apply

    def first(node):
        if isinstance(node, BSEGConv):
            return node
        if isinstance(node, dict):
            for v in node.values():
                hit = first(v)
                if hit is not None:
                    return hit
        return None

    qc = first(qparams).layer(0)
    c = qc.kappa.shape[-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x = torch.randn((BATCH, 1, c), generator=gen, device=dev).to(cfg.dtype)
    st = torch.randn((BATCH, 3, c), generator=gen, device=dev).to(cfg.dtype)
    y, new = bseg_conv_apply(qc, x, state=st)
    cpu = dataclasses.replace(qc, **{f: getattr(qc, f).cpu() for f in
                                     ("kappa", "tap_sum", "scale", "bias")})
    y_cpu, new_cpu = bseg_conv_apply(cpu, x.cpu(), state=st.cpu())
    check(torch.equal(y.cpu(), y_cpu) and torch.equal(new.cpu(), new_cpu),
          f"{cfg.name}: packed short conv on the card != on the CPU")
    print(f"[recurrent] {cfg.name}: packed short conv at [{BATCH}, 1+3, {c}]"
          " on the card (B4) == on the CPU (plain version), bit for bit")


def memory_shapes():
    """The (K, N) shapes of the memory-packed path with their multiplicity
    in one tinyllama layer (0 for the LM head, once per step)."""
    return {**LAYER_SHAPES, LM_HEAD_SHAPE: 0}


def packbits_case(m, n, w, gen, flush, where):
    """B6 on random w-bit values [m, n] and B7 on the words, each against
    its plain version bit for bit (and the round trip); returns both
    kernels' times, plain times and bounds."""
    import torch
    from repro_torch.kernels import packbits

    half = 1 << (w - 1)
    vals = torch.randint(-half, half, (m, n), generator=gen,
                         device=gen.device, dtype=torch.int8)
    words = packbits.pack_words(vals, w=w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = packbits.pack_words_plain(vals, w=w)
    torch.cuda.synchronize()
    plain6 = (time.perf_counter() - t0) * 1e3
    check(torch.equal(words, want), f"B6 != plain at {where}")
    back = packbits.unpack_words(words, w=w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_u = packbits.unpack_words_plain(words, w=w)
    torch.cuda.synchronize()
    plain7 = (time.perf_counter() - t0) * 1e3
    check(torch.equal(back, want_u), f"B7 != plain at {where}")
    check(torch.equal(back, vals), f"B7(B6(x)) != x at {where}")
    nbytes = vals.numel() + words.numel() * 4          # both directions
    b_ms, b_by = bound_ms(nbytes, 0)
    ms6 = event_ms(lambda: packbits.pack_words(vals, w=w), 10, flush)
    ms7 = event_ms(lambda: packbits.unpack_words(words, w=w), 10, flush)
    print(f"[memory] W{w} {where} [{m}, {n}] <-> [{m}, {words.shape[1]}] "
          f"words: B6 {ms6:.4f} ms, B7 {ms7:.4f} ms (bound {b_ms:.4f} ms by "
          f"{b_by}: {b_ms / ms6:.1%} / {b_ms / ms7:.1%}), plain {plain6:.2f} / "
          f"{plain7:.2f} ms, exact")
    return {"B6": dict(ms=ms6, plain_ms=plain6, bound_ms=b_ms),
            "B7": dict(ms=ms7, plain_ms=plain7, bound_ms=b_ms)}


#: fused B7's ragged cases: (rows, rows_per_scale, d_out) — two groups of
#: 37 rows with a d_out that is a multiple of neither 32 / w nor 8 (4-byte
#: word loads, scalar stores), and one group of 64 rows with d_out 2040
#: (16-byte word loads at most widths; at W2 and W3 the last word is
#: trimmed inside it)
DEQUANT_RAGGED = ((74, 37, 1001), (64, 64, 2040))


def before_route(words, scale, *, w, d_out, rows_per_scale, dtype):
    """What memory-mode serving ran before the fused B7: the int8 unpack
    (B7's int8 kernel), then float32 times each group's scale row, the
    trim and the cast, as torch ops."""
    import torch
    from repro_torch.kernels import packbits
    q = packbits.unpack_words(words, w=w)
    deq = q.to(torch.float32).reshape(-1, rows_per_scale, q.shape[1]) \
        * scale[:, None, :]
    return deq.reshape(q.shape)[:, :d_out].to(dtype)


def same_bits(a, b):
    import torch
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


def dequant_case(m, nw, w, d_out, rows_per_scale, dtype, gen, flush, where,
                 edges=False, timed=True):
    """Fused B7 on random words [m, nw] (every field value) and scales
    [m / rows_per_scale, nw * 32 / w]: against its plain version and the
    route it replaced, bit for bit; with ``edges`` the first columns'
    scales are a subnormal, two bf16 rounding ties (1 + 2^-8, 1 + 3 2^-8:
    q = +-1, +-2, +-4 land halfway) and an overflow.  Returns its time,
    plain time, bound and the replaced route's time (``timed``)."""
    import torch
    from repro_torch.kernels import packbits
    per = 32 // w
    words = torch.randint(-2**31, 2**31, (m, nw), generator=gen,
                          device=gen.device, dtype=torch.int32)
    scale = torch.rand((m // rows_per_scale, nw * per), generator=gen,
                       device=gen.device) * 0.05 + 0.001
    if edges:
        for col, v in enumerate((9e-41, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                                 3e38)):
            scale[:, col] = v
    kw = dict(w=w, d_out=d_out, rows_per_scale=rows_per_scale, dtype=dtype)

    def run():
        return packbits.unpack_dequant(words, scale, **kw)
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = packbits.unpack_dequant_plain(words, scale, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(same_bits(got, want), f"fused B7 != plain at {where} W{w} {dtype}")
    check(same_bits(got, before_route(words, scale, **kw)),
          f"fused B7 != the int8 unpack + torch dequant at {where} W{w}")
    vec = packbits.vector_store(w, dtype, d_out)
    spans, slabs, rows = packbits.launch_shape(
        m, nw, rows_per_scale,
        sms=torch.cuda.get_device_properties(0).multi_processor_count)
    nbytes = words.numel() * 4 + scale.numel() * 4 \
        + got.numel() * got.element_size()
    b_ms, _ = bound_ms(nbytes, 0)
    out = dict(ms=0.0, plain_ms=plain_ms, bound_ms=b_ms, before_ms=0.0)
    line = (f"[memory] fused B7 W{w} {where} {str(dtype)[6:]} [{m}, {nw}] "
            f"words -> [{m}, {d_out}] ({m // rows_per_scale} scale groups; "
            f"{'16' if nw % 4 == 0 else '4'}-byte word loads, "
            f"{packbits.store_unit(w, dtype) if vec else got.element_size()}"
            f"-byte stores; grid {spans} x {slabs}, {rows} rows a slab): "
            f"== plain == the replaced route, bit for bit")
    if timed:
        out["ms"] = event_ms(run, 10, flush)
        out["before_ms"] = event_ms(
            lambda: before_route(words, scale, **kw), 10, flush)
        line += (f"; {out['ms']:.4f} ms (bound {b_ms:.4f} ms by bytes, "
                 f"{b_ms / out['ms']:.1%}), replaced route "
                 f"{out['before_ms']:.4f} ms, plain {plain_ms:.2f} ms")
    print(line)
    return out


def quant_matmul_case(rows, k, n, w, dtype, gen, flush, where):
    """B5 on random activations [rows, k] and W-bit lane words [k, n]:
    against its plain version (within twice ``error_bound``) and the
    float64 product (within ``error_bound``: the float32 summation
    bound, which grows with K); returns its times, bound and library
    time (``torch.mm`` on float32 x and the dequantized float32 weights,
    TF32 off)."""
    import torch
    from repro_torch.device import sm_count
    from repro_torch.kernels import packbits, quant_matmul

    half = 1 << (w - 1)
    x = torch.randn((rows, k), generator=gen, device=gen.device).to(dtype)
    w_int = torch.randint(-half, half, (k, n), generator=gen,
                          device=gen.device, dtype=torch.int8)
    scale = torch.rand(n, generator=gen, device=gen.device) * 0.05 + 0.001
    words = packbits.pack_words_plain(w_int, w=w)

    def run():
        return quant_matmul.quant_matmul(x, words, scale, w=w)
    got = run()
    again = run()
    torch.cuda.synchronize()
    check(torch.equal(got, again),
          f"B5 not deterministic at {where}: two launches differ by "
          f"{float((got - again).abs().max()):.3g}")
    t0 = time.perf_counter()
    want = quant_matmul.quant_matmul_plain(x, words, scale, w=w)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    exact = (x.double() @ w_int.double()) * scale.double()
    bound = quant_matmul.error_bound(x, w_int, scale)
    err = float((got.double() - want.double()).abs().max())
    err_exact = (got.double() - exact).abs()
    check(bool(((got.double() - want.double()).abs() <= 2 * bound).all()),
          f"B5 != plain at {where} (max err {err:.3g})")
    check(bool((err_exact <= bound).all()),
          f"B5 off the float64 product at {where} by more than the "
          f"float32 summation bound ({float(err_exact.max()):.3g})")
    reading, plain_reading = (qmm_reading(y, exact, x, w_int, scale)
                              for y in (got, want))
    check(reading <= quant_matmul.ROUNDING_LIMIT
          and plain_reading <= quant_matmul.ROUNDING_LIMIT,
          f"B5 (or its plain version) off the float64 product at {where} "
          f"by {reading:.3g} ({plain_reading:.3g}) float32 rounding scales")
    controls = {}
    if dtype == torch.float32:
        # lower precisions the reading check must refuse: x rounded to
        # TF32's 10 mantissa bits (exact product after), and B5 on
        # bf16-rounded x; torch.mm with TF32 allowed is read beside them
        # (cuBLAS chooses whether to use TF32, so it is not checked)
        x_tf32 = (((x.view(torch.int32) + 0xFFF
                    + ((x.view(torch.int32) >> 13) & 1)) & ~0x1FFF)
                  .view(torch.float32))
        controls = {
            "tf32-rounded x": qmm_reading(
                (x_tf32.double() @ w_int.double()) * scale.double(), exact,
                x, w_int, scale),
            "bf16 x": qmm_reading(
                quant_matmul.quant_matmul(x.bfloat16(), words, scale, w=w),
                exact, x, w_int, scale)}
        check(min(controls.values()) > quant_matmul.ROUNDING_LIMIT,
              f"the rounding check at {where} does not refuse "
              f"lower-precision products: {controls}")
        torch.backends.cuda.matmul.allow_tf32 = True
        controls["torch.mm tf32 (read, not checked)"] = qmm_reading(
            torch.mm(x, w_int.float()) * scale, exact, x, w_int, scale)
        torch.backends.cuda.matmul.allow_tf32 = False
    ms = event_ms(run, 10, flush)
    nbytes = x.numel() * x.element_size() + words.numel() * 4 \
        + scale.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 2 * rows * k * n, qmm_ops_per_s(dtype))
    xf = x.float()
    wf = w_int.float() * scale
    lib_ms = event_ms(lambda: torch.mm(xf, wf), 10, flush)
    grid = quant_matmul.launch_geometry(rows, n, k, w,
                                        sm_count(x.device.index)).grid
    print(f"[memory] B5 W{w} {where} {str(dtype)[6:]} x [{rows}, {k}] @ "
          f"[{k}, {n}]: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
          f"{b_ms / ms:.1%} of bound), plain {plain_ms:.2f} ms, torch.mm "
          f"fp32 {lib_ms:.4f} ms; max |B5 - plain| {err:.3g}, max |B5 - "
          f"exact| {float(err_exact.max()):.3g} (bound at that entry "
          f"{float(bound.flatten()[err_exact.argmax()]):.3g}); reading "
          f"{reading:.3f} (plain {plain_reading:.3f}) rounding scales; "
          f"{grid} blocks, bit-identical twice"
          + "".join(f", {c} control {v:.1f}" for c, v in controls.items()))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=err, bytes=nbytes,
                ops=2 * rows * k * n, reading=max(reading, plain_reading),
                controls=controls)


def qmm_reading(y, exact, x, w_int, scale):
    """max |y - exact| in units of ``quant_matmul.rounding_scale``."""
    from repro_torch.kernels import quant_matmul
    rs = quant_matmul.rounding_scale(x, w_int, scale)
    return float(((y.double() - exact).abs() / rs.clamp_min(1e-300)).max())


def qmm_ops_per_s(dtype):
    """The peak rate B5's bound takes for activations of ``dtype``: the
    bf16 tensor rate, a third of it for float32 x (three exact bf16
    parts; the float32 CUDA-core rate is lower still)."""
    import torch
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else \
        max(BF16_OPS_PER_S / 3, F32_OPS_PER_S)


def phase_memory_kernels(dev, flush):
    """B6/B7 at every tinyllama projection shape, the LM head and a ragged
    shape (W2, W4, W8), and B6 at the stacked shapes serve_params gives it;
    B5 at those shapes x 8 and 128 rows x W4/W8 x bf16/f32 activations.
    Returns each kernel's sums on the main path (W4): B6 over one
    serve_params, B7 over one decode step (22 layers + the LM head), B5
    over one layer's 7 projections at 8 rows (bf16 x) and at 128 rows."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import quant_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    n_layers = get_arch("tinyllama-1.1b").n_layers
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    t_phase = time.perf_counter()
    out = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                      max_abs_err=0)
           for name in ("B6", "B7_int8")}
    for w in PACK_WIDTHS:
        per = 32 // w
        for (k, n), mult in memory_shapes().items():
            r = packbits_case(k, n, w, gen, flush, f"K={k} N={n}")
            if w == MEMORY_BITS:           # one step: 22 layers + the head
                times = mult * n_layers if mult else 1
                for key in ("ms", "plain_ms", "bound_ms"):
                    out["B7_int8"][key] += times * r["B7"][key]
        rows, nw = RAGGED_PACK
        packbits_case(rows, nw * per, w, gen, flush, "ragged")
    # B6 as serve_params calls it: one [L * K, N] call per stacked leaf
    for (k, n), mult in memory_shapes().items():
        m = k * n_layers if mult else k
        r = packbits_case(m, n, MEMORY_BITS, gen, flush,
                          f"stacked K={k} N={n}" if mult else "LM head")
        for key in ("ms", "plain_ms", "bound_ms"):
            out["B6"][key] += max(mult, 1) * r["B6"][key]
    # the fused B7 as materialize calls it: one [K, N / 8] W4 call per
    # projection and the LM head, one scale row; per decode step
    fused = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, before_ms=0.0,
                 library_ms=None, max_abs_err=0, bound_by="bytes")
    for dtype in (torch.bfloat16, torch.float32):
        for (k, n), mult in memory_shapes().items():
            r = dequant_case(k, n // (32 // MEMORY_BITS), MEMORY_BITS, n, k,
                             dtype, gen, flush,
                             "LM head" if not mult else f"x{mult} per layer")
            if dtype == torch.bfloat16:
                times = mult * n_layers if mult else 1
                for key in ("ms", "plain_ms", "bound_ms", "before_ms"):
                    fused[key] += times * r[key]
        for w in range(2, 9):
            per = 32 // w
            for rows, rps, d_out in DEQUANT_RAGGED:
                dequant_case(rows, -(-d_out // per), w, d_out, rps, dtype,
                             gen, flush, "ragged", edges=True, timed=False)
        # a stacked container: 22 layers of q/o, one scale row a layer
        dequant_case(n_layers * 2048, 2048 // 8, MEMORY_BITS, 2048, 2048,
                     dtype, gen, flush, "stacked", edges=True, timed=False)
    out["B7"] = fused
    for name in ("B6", "B7_int8"):
        out[name]["bound_by"] = "bytes"
    b5 = {rows: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
          for rows in (DECODE_ROWS, PREFILL_ROWS)}
    max_err, readings, controls = 0.0, [], {}
    for w in QMM_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for (k, n), mult in memory_shapes().items():
                for rows in (DECODE_ROWS, PREFILL_ROWS):
                    r = quant_matmul_case(rows, k, n, w, dtype, gen, flush,
                                          "LM head" if not mult else
                                          f"x{mult} per layer")
                    max_err = max(max_err, r["max_abs_err"])
                    readings.append(r["reading"])
                    for c, v in r["controls"].items():
                        controls[c] = min(controls.get(c, v), v)
                    if w == MEMORY_BITS and dtype == torch.bfloat16 and mult:
                        acc = b5[rows]
                        for key in ("ms", "plain_ms", "library_ms", "bytes",
                                    "ops"):
                            acc[key] += mult * r[key]
    for rows, acc in b5.items():
        acc["bound_ms"], acc["bound_by"] = bound_ms(
            acc["bytes"], acc["ops"], qmm_ops_per_s(torch.bfloat16))
        print(f"[memory] B5 per tinyllama layer (7 W4 projections, bf16 x, "
              f"{rows} rows): {acc['ms']:.4f} ms (bound {acc['bound_ms']:.4f}"
              f" ms by {acc['bound_by']}), plain {acc['plain_ms']:.2f} ms, "
              f"torch.mm fp32 {acc['library_ms']:.4f} ms")
    out["B5"] = dict(b5[DECODE_ROWS], max_abs_err=max_err,
                     prefill_ms=b5[PREFILL_ROWS]["ms"],
                     prefill_bound_ms=b5[PREFILL_ROWS]["bound_ms"],
                     prefill_library_ms=b5[PREFILL_ROWS]["library_ms"])
    print(f"[memory] B6 per serve_params (7 stacked W4 leaves + the LM "
          f"head): {out['B6']['ms']:.3f} ms (bound {out['B6']['bound_ms']:.3f}"
          f" ms), plain {out['B6']['plain_ms']:.1f} ms; int8 B7 per decode "
          f"step's shapes (154 W4 projections + the LM head): "
          f"{out['B7_int8']['ms']:.3f} ms (bound "
          f"{out['B7_int8']['bound_ms']:.3f} ms), plain "
          f"{out['B7_int8']['plain_ms']:.1f} ms; no single PyTorch call "
          f"packs or unpacks bit fields, so B6/B7 have no library time")
    print(f"[memory] fused B7 per decode step (154 W4 projections + the LM "
          f"head, bf16 out, 155 flushed calls): {fused['ms']:.3f} ms (bound "
          f"{fused['bound_ms']:.3f} ms by bytes, "
          f"{fused['bound_ms'] / fused['ms']:.1%}); the route it replaced "
          f"(int8 B7 + scale, trim and cast in torch) "
          f"{fused['before_ms']:.3f} ms; plain {fused['plain_ms']:.1f} ms")
    print(f"[memory] B5 rounding readings (|y - exact| over "
          f"quant_matmul.rounding_scale, limit "
          f"{quant_matmul.ROUNDING_LIMIT}): largest {max(readings):.3f} over "
          f"{len(readings)} cases (accumulator restarted every "
          f"{quant_matmul.ACC_STAGES} x {quant_matmul.TILE_K} k); the "
          f"smallest of the float32 cases' controls: "
          + ", ".join(f"{c} {v:.1f}" for c, v in controls.items()))
    print(f"[memory] all cases within their checks, "
          f"{time.perf_counter() - t_phase:.1f} s")
    return out


def packed_leaves(tree, path=()):
    """[(path, PackedLinear)] of a serve tree, in tree order."""
    from repro_torch.models import PackedLinear
    if isinstance(tree, PackedLinear):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [hit for k, v in tree.items()
                for hit in packed_leaves(v, path + (k,))]
    return []


def phase_memory_serve(dev, card):
    """Full-width tinyllama-1.1b in memory mode: serve_params(compute=
    "memory") packs every projection and the LM head with B6 (checked
    against the plain pack of the same quantized fields, and B7 of the
    words against the plain unpack); a 16-token prefill of 8 prompts,
    16 greedy decode steps and the serve CLI's single_batch_loop, each
    with exactly one B7 launch per projection and the LM head and no
    other kernel or plain call; then the tree's words through
    ``packed_matmul(plan=None)`` (B5) at 8 and 8 x 16 rows, each output
    within the float32 summation bound of the float64 product.  Returns
    the launch counts of those runs."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import ops, packbits, quant_matmul
    from repro_torch.launch.serve import single_batch_loop
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, serve_params)
    from repro_torch.models.quantized import (count_packed, materialize,
                                              quantize_linear)

    cfg = get_arch("tinyllama-1.1b")
    per_step = 7 * cfg.n_layers + 1
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qparams = serve_params(params, bits=MEMORY_BITS, min_size=1024,
                           compute="memory")
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    c_pack = counts()
    leaves = packed_leaves(qparams)
    check(c_pack == expect(B6=len(leaves)) and len(leaves) == 8,
          f"serve_params launches {c_pack} for {len(leaves)} leaves")
    check(count_packed(qparams) == {"memory": per_step, "sdv": 0, "bseg": 0},
          count_packed(qparams))
    for path, pl in leaves:
        kernel = params
        for key in path:
            kernel = kernel[key]
        q, scale = quantize_linear(kernel, MEMORY_BITS)
        q = q.reshape(-1, q.shape[-1]).to(torch.int8)
        words = pl.words.reshape(-1, pl.words.shape[-1])
        check(torch.equal(words, packbits.pack_words_plain(q, w=pl.bits))
              and torch.equal(pl.scale, scale),
              f"{'/'.join(path)}: B6 words != the plain pack")
        back = packbits.unpack_words(words, w=pl.bits)
        check(torch.equal(back, packbits.unpack_words_plain(words, w=pl.bits))
              and torch.equal(back, q),
              f"{'/'.join(path)}: int8 B7 != the plain unpack")
        dense = materialize(pl, cfg.dtype)
        check(same_bits(dense.reshape(-1, pl.d_out), before_route(
            words, pl.scale.reshape(-1, pl.scale.shape[-1]), w=pl.bits,
            d_out=pl.d_out, rows_per_scale=pl.words.shape[-2],
            dtype=cfg.dtype)),
            f"{'/'.join(path)}: materialized weights (fused B7) != the "
            "int8 unpack + torch dequant")
        del dense
    del params
    print(f"[memory serve] {cfg.name}: serve_params(compute=\"memory\") in "
          f"{t_pack * 1e3:.1f} ms, launches {c_pack}; {len(leaves)} "
          "containers: B6 words == the plain pack, int8 B7 of them == the "
          "plain unpack, materialized bf16 weights (fused B7) == the int8 "
          "unpack + torch dequant, bit for bit")

    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                           dtype=torch.int32, device=dev)
    n_prompt = torch.full((BATCH,), PROMPT - 1, dtype=torch.int32,
                          device=dev)
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    decode_step(cfg, qparams, cache, prompts[:, -1:])      # warm-up
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    c_prefill = counts()
    check(c_prefill == expect(B7=7 * cfg.n_layers),
          f"memory prefill launches {c_prefill}")
    reset_counts()
    tok = prompts[:, -1:]
    t0 = time.perf_counter()
    for _ in range(NEW):
        logits, cache = decode_step(cfg, qparams, cache, tok)
        tok = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    c_decode = counts()
    check(c_decode == expect(B7=NEW * per_step),
          f"memory decode launches {c_decode}, want B7={NEW * per_step}")
    check(tuple(logits.shape) == (BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "memory decode logits")
    check(cache["index"].tolist() == [PROMPT - 1 + NEW] * BATCH,
          cache["index"].tolist())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = t_decode / NEW * 1e3
    print(f"[memory serve] prefill {BATCH}x{PROMPT}: {t_prefill * 1e3:.1f} ms "
          f"({BATCH * PROMPT / t_prefill:.1f} tok/s), launches {c_prefill}")
    print(f"[memory serve] decode {NEW} steps at batch {BATCH}: "
          f"{step_ms:.1f} ms/step, {BATCH * NEW / t_decode:.1f} tok/s, "
          f"launches {c_decode}, peak memory {peak:.2f} GiB ({card})")
    state = {"cache": {k: v.clone() for k, v in cache.items()}}

    def step():
        _, state["cache"] = decode_step(cfg, qparams, state["cache"], tok)
    profile(f"memory decode step at batch {BATCH}", step, steps=2,
            wall_ms=step_ms)
    del state

    reset_counts()
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    toks, dt = single_batch_loop(cfg, qparams, cache, prompts, NEW)
    c_loop = counts()
    steps = PROMPT + NEW - 1
    check(c_loop == expect(B7=steps * per_step),
          f"memory single_batch_loop launches {c_loop}")
    check(toks.shape == (BATCH, NEW) and (toks >= 0).all()
          and (toks < cfg.vocab).all(), toks.shape)
    print(f"[memory serve] single_batch_loop: {dt / steps * 1e3:.1f} ms/step, "
          f"{BATCH * steps / dt:.1f} tok/s ({steps} steps), launches "
          f"{c_loop}, sample {toks[0][:8].tolist()} ({card})")
    del cache

    # B5 on the tree's own words through the dispatch's memory-packed route
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    calls = []
    reset_counts()
    t0 = time.perf_counter()
    for lead in ((BATCH, 1), (BATCH, PROMPT)):
        for _, pl in leaves:
            for lp in ([pl.layer(i) for i in range(pl.words.shape[0])]
                       if pl.stacked else [pl]):
                x = torch.randn(lead + (lp.words.shape[-2],), generator=gen,
                                device=dev).to(cfg.dtype)
                y = ops.packed_matmul(x, lp.words, scale=lp.scale[0],
                                      w_bits=lp.bits, m=lp.d_out)
                calls.append((x, lp, y))
    torch.cuda.synchronize()
    t_b5 = time.perf_counter() - t0
    c_b5 = counts()
    check(c_b5 == expect(B5=2 * per_step),
          f"packed_matmul(plan=None) launches {c_b5}")
    worst = worst_reading = 0.0
    for x, lp, y in calls:
        x2 = x.reshape(-1, x.shape[-1])
        w_int = packbits.unpack_words_plain(lp.words, w=lp.bits)
        w_int = w_int[:, :lp.d_out]
        s = lp.scale[0, :lp.d_out]
        exact = (x2.double() @ w_int.double()) * s.double()
        bound = quant_matmul.error_bound(x2, w_int, s)
        err = (y.reshape(exact.shape).double() - exact).abs()
        reading = qmm_reading(y.reshape(exact.shape), exact, x2, w_int, s)
        check(tuple(y.shape) == x.shape[:-1] + (lp.d_out,)
              and bool((err <= bound).all())
              and reading <= quant_matmul.ROUNDING_LIMIT,
              f"B5 off the float64 product on the tree's words "
              f"{tuple(lp.words.shape)} (reading {reading:.3g})")
        worst = max(worst, float((err / bound.clamp_min(1e-30)).max()))
        worst_reading = max(worst_reading, reading)
    print(f"[memory serve] packed_matmul(plan=None) on every projection and "
          f"the LM head of the tree at [{BATCH}, 1] and [{BATCH}, {PROMPT}] "
          f"rows: {t_b5 * 1e3:.1f} ms, launches {c_b5}; every output within "
          f"the float32 summation bound of the float64 product (worst "
          f"{worst:.3f} of it) and within {quant_matmul.ROUNDING_LIMIT} "
          f"rounding scales (worst {worst_reading:.3f})")
    return {"B5": c_b5["B5"], "B6": c_pack["B6"],
            "B7 prefill": c_prefill["B7"], "B7 decode": c_decode["B7"]}


def engine_specs(vocab, n, seed=0):
    """``n`` seeded (prompt, new_tokens) requests: prompt lengths and
    decode budgets each drawn in ``ENGINE_LENGTHS``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = ENGINE_LENGTHS
    out = []
    for _ in range(n):
        pl = int(rng.integers(lo, hi + 1))
        nt = int(rng.integers(lo, hi + 1))
        out.append((tuple(int(t) for t in rng.integers(0, vocab, pl)), nt))
    return out


def engine_run(engine, specs):
    """Submit every spec before the first step (a burst), drain, and
    return (rids, {rid: Completion}, wall seconds)."""
    t0 = time.perf_counter()
    rids = [engine.submit(p, nt) for p, nt in specs]
    comps = {c.rid: c for c in engine.drain()}
    return rids, comps, time.perf_counter() - t0


def engine_report(label, engine, wall, card):
    """Print one engine run's end-to-end and per-iteration numbers;
    returns (decode iterations, prefill-slot calls, decode ms per
    iteration)."""
    import torch
    snap = engine.metrics.snapshot()
    buckets = snap["buckets"].values()
    dec = sum(b.get("decode_steps", 0) for b in buckets)
    pre = sum(b.get("prefill_calls", 0) for b in buckets)
    dec_ms = sum(b.get("decode_wall_s", 0.0) for b in buckets) / max(dec, 1)
    pre_ms = sum(b.get("prefill_wall_s", 0.0) for b in buckets) / max(pre, 1)
    done = snap["requests_completed"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[engine] {label}: {done} requests in {wall:.3f} s "
          f"({done / wall:.2f} requests/s, {snap['tokens_out'] / wall:.1f} "
          f"tok/s; engine span {snap['tokens_per_s']:.1f} tok/s), "
          f"latency p50 {snap['latency']['p50_ms']:.1f} / p99 "
          f"{snap['latency']['p99_ms']:.1f} ms, queue wait p50 "
          f"{snap['queue_wait']['p50_ms']:.1f} / p99 "
          f"{snap['queue_wait']['p99_ms']:.1f} ms; {snap['waves']['count']} "
          f"waves, {dec} decode iterations at {dec_ms * 1e3:.2f} ms, {pre} "
          f"prefill-slot calls at {pre_ms * 1e3:.2f} ms, "
          f"{snap['waves']['midwave_joins']} mid-wave joins, occupancy "
          f"{snap['waves']['occupancy']:.3f}; peak memory {peak:.2f} GiB "
          f"({card})")
    return dec, pre, dec_ms


def phase_engine(dev, card):
    """Full-width tinyllama-1.1b through the continuous-batching engine
    (``repro_torch.serving.Engine``): an SDV W4A8 run on the planner's
    plans (``plan_policy`` resolved to "auto": the plan cache does not
    exist), a fault run that loses one wave mid-flight, and a memory-mode
    run.  Returns the launch counts of those runs."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import SDVLinear, init_params
    from repro_torch.planner import arch_layer_specs, choose_plan
    from repro_torch.serving import BucketShape, Engine, FaultPlan

    cfg = get_arch("tinyllama-1.1b")
    per_call = 7 * cfg.n_layers
    params = init_params(cfg, seed=0, device=dev)
    buckets = tuple(BucketShape(BATCH, s) for s in ENGINE_BUCKETS)
    specs = engine_specs(cfg.vocab, ENGINE_REQUESTS)

    def make(compute, faults=None):
        with tempfile.TemporaryDirectory() as td:
            engine = Engine(cfg, params, compute=compute, weight_bits=4,
                            act_bits=8, plan_cache=f"{td}/absent.json",
                            buckets=buckets, prefill_chunk=ENGINE_CHUNK,
                            faults=faults, device=dev)
        for b in buckets:            # kernel builds and first calls
            engine.warmup(b, inject=False)
        torch.cuda.synchronize()
        return engine

    # --- SDV run: a burst of 32 requests on the planner's plans ---------
    t0 = time.perf_counter()
    engine = make("sdv")
    check(engine.plan_policy == "auto", engine.plan_policy)
    print(f"[engine] {cfg.name}: SDV W4A8, plan policy "
          f"{engine.plan_policy}, buckets {[b.key for b in buckets]}, "
          f"prefill chunk {ENGINE_CHUNK}; engine, packing and warmup in "
          f"{time.perf_counter() - t0:.1f} s")
    qparams = engine._qparams(BATCH)
    want = {spec.name: choose_plan(spec).plan for spec in arch_layer_specs(
        cfg.name, bits=4, act_bits=8, rows=BATCH, min_size=1024)}
    got = {}

    def walk(tree, path):
        for k, v in tree.items():
            name = f"{path}/{k}" if path else k
            if isinstance(v, dict):
                walk(v, name)
            elif isinstance(v, SDVLinear):
                got[name] = v.plan
    walk(qparams, "")
    check(got == want and len(got) == 8,
          f"engine plans {got} != the analytic planner's {want}")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    rids, comps, wall = engine_run(engine, specs)
    c_sdv = counts()
    check(all(engine.outcomes[r]["outcome"] == "ok" for r in rids)
          and sorted(comps) == sorted(rids),
          f"SDV run outcomes {[engine.outcomes.get(r) for r in rids]}")
    for (prompt, nt), rid in zip(specs, rids):
        out = comps[rid].tokens
        check(len(out) == nt and all(0 <= t < cfg.vocab for t in out),
              f"rid {rid}: tokens {out}")
    dec, pre, dec_ms = engine_report(
        f"SDV burst of {len(specs)}", engine, wall, card)
    check(engine.metrics.midwave_joins >= 1, "no mid-wave join")
    check(engine.metrics.decode_launches == dec,
          f"{engine.metrics.decode_launches} decode launches != {dec}")
    check(c_sdv == expect(B1=per_call * (dec + pre)),
          f"SDV engine launches {c_sdv}, want B1={per_call} x ({dec} "
          f"decode iterations + {pre} prefill-slot calls)")
    joiner = next(c.rid for c in sorted(comps.values(), key=lambda c: c.rid)
                  if c.midwave_join)
    spec_of = dict(zip(rids, specs))
    longest = max(rids, key=lambda r: len(spec_of[r][0]) + spec_of[r][1])
    alone_rids = list(dict.fromkeys([rids[0], joiner, longest, rids[-1]]))
    for rid in alone_rids:
        again = engine.submit(*spec_of[rid])
        alone = {c.rid: c for c in engine.drain()}[again]
        check(alone.tokens == comps[rid].tokens,
              f"rid {rid} alone {alone.tokens} != in the burst "
              f"{comps[rid].tokens}")
    words = sorted({f"{p.spec.name} n={p.n}" for p in got.values()})
    print(f"[engine] alone runs of rids {alone_rids} (first, a mid-wave "
          f"joiner, the longest, the last) == their burst tokens, bit for "
          f"bit; plans == the analytic planner's for all {len(got)} layers "
          f"({words}); launches {c_sdv}")
    st = engine._states[buckets[-1].key]
    toks = torch.zeros((BATCH, 1), dtype=torch.int32, device=dev)
    ones = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    profile(f"engine decode iteration at batch {BATCH}",
            lambda: engine._dec(st.qparams, dict(st.work), toks, ones),
            steps=2, wall_ms=dec_ms * 1e3)
    del engine, st

    # --- fault run: one wave lost mid-flight, then retried ---------------
    faults = FaultPlan(seed=0, kernel_loss_p=1.0)
    engine = make("sdv", faults)
    sub = specs[:ENGINE_FAULT_REQUESTS]
    t0 = time.perf_counter()
    f_rids = [engine.submit(p, nt) for p, nt in sub]
    f_comps = {}
    while engine.depth():
        for c in engine.step(force=True):
            f_comps[c.rid] = c
        if faults.counts().get("kernel_loss"):
            faults.kernel_loss_p = 0.0       # lose exactly one wave
    wall = time.perf_counter() - t0
    check(engine.metrics.failure_kinds == {"kernel_loss": 1},
          f"fault run failures {engine.metrics.failure_kinds}")
    check(all(engine.outcomes[r]["outcome"] == "ok" for r in f_rids),
          f"fault run outcomes {[engine.outcomes.get(r) for r in f_rids]}")
    for i, rid in enumerate(f_rids):
        check(f_comps[rid].tokens == comps[rids[i]].tokens,
              f"fault run rid {rid}: {f_comps[rid].tokens} != the clean "
              f"run's {comps[rids[i]].tokens}")
    engine_report(f"fault run of {len(sub)}, {faults.log}", engine, wall,
                  card)
    print(f"[engine] fault run: every outcome ok, tokens == the clean "
          f"run's for all {len(sub)} requests")
    del engine

    # --- memory run ------------------------------------------------------
    reset_counts()
    engine = make("memory")
    c_setup = counts()
    check(c_setup["B6"] == 8, f"memory engine set-up launches {c_setup}")
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    sub = specs[:ENGINE_MEMORY_REQUESTS]
    m_rids, m_comps, wall = engine_run(engine, sub)
    c_mem = counts()
    check(all(engine.outcomes[r]["outcome"] == "ok" for r in m_rids),
          f"memory run outcomes {[engine.outcomes.get(r) for r in m_rids]}")
    for (prompt, nt), rid in zip(sub, m_rids):
        out = m_comps[rid].tokens
        check(len(out) == nt and all(0 <= t < cfg.vocab for t in out),
              f"memory rid {rid}: tokens {out}")
    m_dec, m_pre, m_dec_ms = engine_report(
        f"memory burst of {len(sub)}", engine, wall, card)
    check(c_mem == expect(B7=(per_call + 1) * m_dec + per_call * m_pre),
          f"memory engine launches {c_mem}, want B7 = {per_call + 1} x "
          f"{m_dec} decode iterations + {per_call} x {m_pre} prefill calls")
    st = engine._states[buckets[-1].key]
    profile(f"memory engine decode iteration at batch {BATCH}",
            lambda: engine._dec(st.qparams, dict(st.work), toks, ones),
            steps=2, wall_ms=m_dec_ms * 1e3)
    print(f"[engine] memory run: launches {c_mem} ({per_call + 1} B7 per "
          f"decode iteration, {per_call} per prefill-slot call)")
    del engine, st, params
    return {"B1": c_sdv["B1"], "B6": c_setup["B6"], "B7": c_mem["B7"]}


def _to(v, d):
    if isinstance(v, dict):
        return {k: _to(x, d) for k, x in v.items()}
    return v.to(d)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "unknown"
    print(f"[card] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    try:
        phase_build()
        flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        flush = flush_buf.zero_                # evicts the 50 MB L2
        layer = phase_kernels(dev, flush)
        launches = phase_serve(dev)
        phase_reference(dev)
        conv, per_layer, head_ms = phase_conv_kernels(dev, flush)
        ultra = phase_ultranet(dev, per_layer, card)
        conv1d = phase_conv1d_kernels(dev, flush)
        recurrent = phase_recurrent(dev, card, flush)
        memory = phase_memory_kernels(dev, flush)
        mem_launches = phase_memory_serve(dev, card)
        phase_reference(dev, "memory")
        eng = phase_engine(dev, card)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    sources = {"B1": ("sdv_matvec", "src/repro/kernels/sdv_matvec.py:46"),
               "B2": ("sdv_matmul", "src/repro/kernels/sdv_matmul.py:178")}
    by_path = {"B1": {"tinyllama decode": launches["B1"],
                      "mamba2 decode": recurrent["mamba2-130m"]["B1"],
                      "recurrentgemma decode":
                          recurrent["recurrentgemma-2b"]["B1"],
                      "tinyllama engine": eng["B1"]},
               "B2": {"tinyllama prefill": launches["B2"],
                      "ultranet int32": ultra["int32"]["B2"]}}
    kernels = []
    for kname in ("B1", "B2"):
        acc = layer[kname]
        kernels.append({
            "name": f"{kname} {sources[kname][0]}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sdv.cu",
            "replaces": sources[kname][1],
            "launches": sum(by_path[kname].values()),
            "launches_by_path": by_path[kname],
            "max_abs_err": acc["max_abs_err"],
            "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
            "library_ms": acc["library_ms"],
            "per": (f"one tinyllama layer's 7 projections at "
                    f"{DECODE_ROWS if kname == 'B1' else PREFILL_ROWS} rows, "
                    "int32 W4A8 plan"),
        })
    kernels[1]["ultranet_head_ms"] = head_ms
    b3_paths = {f"ultranet {name}": c["B3"] for name, c in ultra.items()}
    kernels.append({
        "name": "B3 bseg_conv2d",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bseg.cu",
        "replaces": "src/repro/kernels/bseg_conv2d.py:110",
        "launches": sum(b3_paths.values()),
        "launches_by_path": b3_paths,
        "max_abs_err": conv["max_abs_err"],
        "ms": conv["ms"], "plain_ms": conv["plain_ms"],
        "bound_ms": conv["bound_ms"], "bound_by": conv["bound_by"],
        "library_ms": conv["library_ms"],
        "per": (f"one UltraNet-INT4 forward's 8 3x3 stages at "
                f"{ULTRA_SIZE}x{ULTRA_SIZE}, batch {ULTRA_BATCH}, int32 "
                "W4A4 plan"),
    })
    b4_paths = {"mamba2 decode": recurrent["mamba2-130m"]["B4"],
                "recurrentgemma decode": recurrent["recurrentgemma-2b"]["B4"]}
    kernels.append({
        "name": "B4 bseg_conv1d",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bseg1d.cu",
        "replaces": "src/repro/kernels/bseg_conv1d.py:85",
        "launches": sum(b4_paths.values()),
        "launches_by_path": b4_paths,
        "max_abs_err": conv1d["max_abs_err"],
        "ms": conv1d["ms"], "plain_ms": conv1d["plain_ms"],
        "bound_ms": conv1d["bound_ms"], "bound_by": conv1d["bound_by"],
        "library_ms": conv1d["library_ms"],
        "per": (f"one call at mamba2-130m's decode shape (batch {BATCH}, "
                f"4 samples, {CONV1D_CHANNELS[0]} channels, "
                f"{CONV1D_TAPS} taps), int32 W4A4 plan; "
                f"{RECURRENT_STEP['mamba2-130m']['B4']} calls per step"),
    })
    mem_kernels = {
        "B5": ("quant_matmul", "quant_matmul.cu",
               "src/repro/kernels/quant_matmul.py:54",
               {"tinyllama packed_matmul(plan=None)": mem_launches["B5"]},
               (f"one tinyllama layer's 7 W4 projections at {DECODE_ROWS} "
                "rows, bf16 x (prefill_ms: at 128 rows); library: torch.mm "
                "on float32 x and the dequantized float32 weights, TF32 "
                "off")),
        "B6": ("pack_words", "packbits.cu",
               "src/repro/kernels/packbits.py:60",
               {"tinyllama serve_params": mem_launches["B6"],
                "tinyllama memory engine serve_params": eng["B6"]},
               ("one tinyllama serve_params(compute=\"memory\"): 7 stacked "
                "W4 leaves of 22 layers + the LM head; no single PyTorch "
                "call packs bit fields: no library time")),
        "B7": ("unpack_dequant", "packbits.cu",
               "src/repro/kernels/packbits.py:41",
               {"tinyllama memory prefill": mem_launches["B7 prefill"],
                "tinyllama memory decode": mem_launches["B7 decode"],
                "tinyllama memory engine": eng["B7"]},
               ("one tinyllama memory decode step: 154 W4 projections + the "
                "LM head, unpacked and dequantized to bf16 in one pass "
                "(unpack_dequant_kernel); before_ms: the route it replaced "
                "(int8 B7 + scale, trim and cast in torch); int8_*: the "
                "int8 unpack_words_kernel at the same shapes; no single "
                "PyTorch call unpacks bit fields: no library time")),
    }
    for kname, (fn, src, replaces, paths, per) in mem_kernels.items():
        acc = memory[kname]
        entry = {
            "name": f"{kname} {fn}",
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": sum(paths.values()),
            "launches_by_path": paths,
            "max_abs_err": acc["max_abs_err"],
            "ms": acc["ms"], "plain_ms": acc["plain_ms"],
            "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
            "library_ms": acc["library_ms"],
            "per": per,
        }
        if kname == "B5":
            entry.update(prefill_ms=acc["prefill_ms"],
                         prefill_bound_ms=acc["prefill_bound_ms"],
                         prefill_library_ms=acc["prefill_library_ms"])
        if kname == "B7":
            entry.update(before_ms=acc["before_ms"],
                         int8_ms=memory["B7_int8"]["ms"],
                         int8_plain_ms=memory["B7_int8"]["plain_ms"],
                         int8_bound_ms=memory["B7_int8"]["bound_ms"])
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
