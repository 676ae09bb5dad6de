#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Drives the port's main paths on one CUDA card and stops with a nonzero
exit at the first failure:

  1. build — compiles kernels B1 (SDV GEMV) and B2 (SDV GEMM) from
     ``src/repro_torch/kernels/csrc/sdv.cu``, B2 at many rows (TMA and
     wgmma) from ``csrc/sdv_wgmma.cu``, B3 (BSEG conv2d) from
     ``csrc/bseg.cu``, B4 (BSEG depthwise conv1d) from
     ``csrc/bseg1d.cu``, B6/B7 (lane pack/unpack) from
     ``csrc/packbits.cu`` and B5 (quantized matmul) from
     ``csrc/quant_matmul.cu`` with nvcc for sm_90a, one nvcc per source,
     all started together; prints ptxas's registers and spills of each
     B1/B2/B3 instantiation, B1/B2's dynamic shared memory (B3's, which
     follows the layer, is printed with each conv case; B2's wgmma
     kernel's at n = 1, 2, 3);
  2. kernels — each kernel against its plain torch version bit for bit,
     and against the exact integer product (float64 on the card, exact
     while |sum| < 2^53), at the main path's (K, M) shapes, for the
     INT32 W4A8 plan and the wide DSP48E2 W4A8 (n=3, [2, K, G] limb
     planes) plan; times each kernel, its plain version and
     ``torch._int_mm`` (the library yardstick, never used by the port).
     Then the speculative path's shapes and plans: B2 at the verify
     wave's 32 rows (8 slots x 4 columns) on the target's dsp48e2 n=3
     plan and B1 at 8 rows on the W4A4 draft's dsp48e2 n=4 plan, at the
     same (K, M) shapes, each timed beside its bound and ``_int_mm``.
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
     the device busy share of one decode iteration;
 11. spec — speculative decoding of full-width tinyllama-1.1b
     (``Engine(speculative=True)``, k = 3, the W4A4 self-speculation
     draft): a burst of 8 of the engine phase's requests through a plain
     and a speculative engine on its buckets and chunk, the same token
     stream per request, and the speculative run's launches 3 x 154 B1
     (draft, 8 rows) + 154 B2 (verify, 32 rows) a round plus 154 B1 a
     prefill-slot call and nothing else; every draft layer dsp48e2 W4A4
     n=4, strictly denser than the target's n=3; at b8.s32 and b8.s64
     one ``verify_step`` over 4 columns ``torch.equal`` to 4 sequential
     ``decode_step``s (logits and every cache leaf); the device busy share
     of one round; then ``calibrated_params`` at full width (the steps
     and rate of ``SPEC_CALIBRATION``; the loss finite and falling) and
     the same pair on that checkpoint (acceptance reported); then
     reduced tinyllama calibrated on the card (120 steps), whose
     speculative run must accept 2 or more tokens in some round.  Each
     pair prints rounds, mean accepted, the acceptance histogram, the
     draft and verify walls a round and tokens per target wave;
 12. train — packed QAT (``repro_torch.train.qat``): B2 at 512 rows (a
     microbatch of 4 x 128 tokens) on the dsp48e2 W4A8 n=3 plan at every
     tinyllama projection shape and the LM head's, against its plain
     version and the exact product, timed beside its bound and
     ``_int_mm``; ``ste_dense`` on that plan == ``ste_dense(plan=None)``
     bitwise at those shapes, its backward's float32 products within a
     float32 bound of float64 (TF32 would fail it); ``ste_conv2d`` on
     the W4A4 BSEG plan (B3) == ``plan=None`` at UltraNet's 64 -> 64 3x3
     stage; then ``run_qat`` on full-width tinyllama-1.1b with the
     launcher's ``--qat`` defaults (W4A8, plan_policy "auto", batch 8 x
     128 in 2 microbatches) for 3 steps (no checkpoint: phase 15 restores
     mamba2-130m's and phase 16 the launcher's full-width one): finite
     losses, every wrapped leaf on the planner's
     plan, 898 B2 a step (2 microbatches of 155 in the forward and 294 in
     the backward's recompute under the registry's remat, ``qat_launches``)
     and 155 an eval batch and nothing else, step walls, peak memory and
     one profiled step split into B2, ``prepare_sdv_weights`` (the
     program's span) and the rest (``qat_run``, which phase 15 runs
     too); one more
     step from the last state with ``remat=False``, bit for bit the
     remat step's loss and parameters; the step-3 parameters exported by ``export_for_serving``
     evaluate within 0.1 of the QAT eval (154 B2) and decode through
     ``single_batch_loop`` (154 B1 a step);
 13. moe — the MoE family at full-width phi3.5-moe-42b-a6.6b (32 layers,
     16 experts top-2, d_ff 6400; 84 GB in bf16, so it is drawn and
     packed one layer at a time by ``launch.serve.packed_params_layerwise``
     after the earlier phases' memory is freed): B7 at both expert-bank
     shapes (W4 words [16 x 4096, 800] and [16 x 6400, 512], 16 scale
     groups) against its plain version and the replaced route bit for
     bit, launched twice, timed beside its bound; B1 (8 rows) and B2 (128
     rows) at the attention shapes (K, M in 4096 and 1024) on the INT32
     W4A8 plan against the plain version and the exact product, beside
     their bound and ``_int_mm``; reduced phi3.5-moe and llama4-maverick
     (``moe_every`` 2, a shared expert) in SDV and memory modes on the
     card against the CPU, prefill + 8 decode steps: logits within
     ``LOGIT_ATOL``, the routing and the int8 caches bit for bit; then
     full width in SDV mode (``count_packed``: 96 memory containers,
     the banks, and 129 SDV; 96 B6 to build; a 16-token prefill of 8
     prompts 128 B2 + 96 B7, each of 16 greedy decode steps at batch 8
     128 B1 + 96 B7, ``single_batch_loop`` as the CLI runs it, nothing
     else and no plain call) and in memory mode (225 memory containers
     and 225 B6; 224 B7 a prefill, 225 a decode step), each with
     ms/step, tok/s, peak memory and one decode step's device busy share
     split into B7, B1, the expert GEMMs (``aten::bmm`` on a bank) and
     the rest;
 14. families — the encdec and vlm families (after the earlier phases'
     memory is freed): B1 (8 rows) and B2 (128 rows) at every projection
     shape of a full-width seamless-m4t-large-v2 decoder layer (d 1024, 16
     heads of 64, d_ff 8192) and llava-next-mistral-7b layer (d 4096, K up
     to 14336) on the INT32 W4A8 plan against the plain version and the
     exact product; B2's row sweep (``B2_SWEEP_ROWS``, 32 to 4096) on a
     llava layer on both of its kernels (mma.sync and wgmma), each equal
     to the exact product, beside the bound, ``_int_mm`` and the plain
     version (the sweep behind ``sdv_matmul.WGMMA_MIN_ROWS``), and
     recurrentgemma-2b's projections at 4096 rows; B6 at every leaf shape that memory-mode
     ``serve_params`` packs of both models (up to llava's [458752, 4096]
     stack, 1.88e9 values), the fused B7 at every decode projection shape
     and both LM heads, against their plain versions (and B7 the replaced
     route), twice; the built memory trees' leaf shapes checked to be
     exactly those;
     reduced seamless (forward on {src, tokens}, 8 decode steps) and
     reduced llava (forward with patches, prefill + 8 decode steps) in SDV
     and memory modes on the card against the CPU: logits within
     ``LOGIT_ATOL``, seamless's bf16 K/V within one bf16 rounding of their
     scale and its cross caches all zero, llava's int8 K/V within one step
     (the entries that differ counted); then each full-width model from a
     seeded init in SDV and memory mode (``serve_params``, min_size 1024,
     the bf16 tree freed): llava's 16-token prefill of 8 prompts (224 B2 /
     224 B7) and, in SDV mode, one prefill chunk of 8 x 512 (224 B2, all on
     the wgmma kernel: ``sdv_matmul.wgmma_launches``), seamless's 15 prompt tokens replayed by ``decode_step``, 16
     greedy steps at batch 8 (seamless 108 B1 / 109 B7 a step, llava 224
     B1 / 225 B7), ``single_batch_loop`` as the CLI runs it, nothing else
     and no plain call; ms/step, tok/s, peak memory, one decode step's busy
     share split into B1 or B7, the LM head (the program's span: the SDV
     head's plain-torch decode, also timed by CUDA events, and its
     product), the other bf16 GEMMs (``aten::mm``) and the rest; then
     one ``forward(mode="last_logits")`` at
     batch 2 (seamless 512 frames + 512 tokens: 216 B2 / 217 B7; llava
     1152 patches + 64 tokens: 224 B2 / 225 B7);
 15. ssm — the ssm and hybrid families' full-sequence path (after the
     earlier phases' memory is freed): reduced mamba2-130m and
     recurrentgemma-2b ``forward`` at 2 x 64 tokens in float, SDV and
     memory mode on the card against the CPU (logits within
     ``LOGIT_ATOL``, ``loss_fn`` within ``SSM_LOSS_ATOL``), the chunked
     SSD scan and the RG-LRU core at full width within ``SSM_SCAN_RTOL``
     of the CPU and the associative scan bit for bit; full-size
     mamba2-130m and full-width, full-depth recurrentgemma-2b, one
     ``forward(mode="last_logits")`` each at batch 2 x 2048 tokens in SDV
     (120 B2 + 24 B4 / 200 B2 + 18 B4) and memory mode (120 / 200 B7),
     nothing else and no plain call, with ms, peak memory and a profiled
     split (B2, B4, B7, the SSD scan, the RG-LRU scan, the rest); packed
     QAT of full-size mamba2-130m (``run_qat`` with the launcher's
     ``--qat`` defaults, a checkpoint at step 2, step 3 from memory and
     from the restored checkpoint with the same loss, 480 B2 a step (its
     blocks recomputed) and 120 an eval batch, the export decoded on B1 +
     B4) and of
     recurrentgemma-2b at full width cut to the depth whose reckoned peak
     is under ``QAT_PEAK_LIMIT_GIB`` (2 steps, 432 B2 a step at 14
     layers);
     then the int64 oracles on the card bit for bit against the kernels:
     ``core.sdv.sdv_matvec`` against B1 and B2, ``core.bseg.bseg_conv1d``
     against B4, UltraNet ``mode="bseg_jnp"`` against ``mode="bseg"``;
 16. dist — distribution (after the earlier phases' memory is freed), on
     a one-rank ``nccl`` process group and a (1, 1) ("data", "model")
     ``DeviceMesh`` (no fallback: without ``nccl`` the phase fails):
     (a) ``train.grad_compress.compressed_allreduce`` over a float32
     gradient tree of full-width tinyllama-1.1b's shapes (1.1e9 values),
     packed == unpacked bit for bit in g_hat and the error, the card ==
     the CPU (a one-rank ``gloo`` group) bit for bit on a slice of
     ``DIST_SLICE`` values, the ms of the packed and the unpacked reduce
     and their wire bytes; (b) ``launch/train.py --mesh 1,1 --steps
     DIST_STEPS`` at the launcher's defaults (global batch 8 x 128, 2
     microbatches) at full width, and the same steps without a mesh
     from the same seed (``loop.init_run``): losses finite and within
     ``DIST_LOSS_ATOL``, step walls and peak memory, the mesh run's
     checkpoint restored into the plain layout bit for bit, the plain
     step's peak above what was held before it; (c) the dry run's
     ``build_cell`` for tinyllama-1.1b ``train_4k`` and ``decode_32k`` on
     the 16 x 16 production mesh (a fake process group of 256 ranks): leaf
     counts, and from ``measure_cell`` (reckoned by ``HostDryRun``'s
     worker process, started with the script, beside the card's phases)
     per-device argument bytes and flops, and for both cells a rank's
     peak, temporaries, outputs, collectives and bytes.
 17. kv — the bf16 KV cache (``serve_kv_bits = 16``: K and V in bf16,
     no scales) of the dense, moe and vlm families (after the earlier
     phases' memory is freed): (a) reduced tinyllama-1.1b, phi3.5-moe
     and llava-next-mistral-7b in SDV and memory modes on the card
     against the CPU, a 5-token prefill and 8 decode steps: logits within
     ``LOGIT_ATOL``, the bf16 K/V within one bf16 rounding of their scale
     (the entries that differ counted); (b) full-width tinyllama-1.1b
     (``serve_params``, min_size 1024) on the bf16 and on the int8 cache
     in the same call, SDV and memory: a prefill of 8 x 16 tokens and 16
     greedy steps (154 B2 a prefill and 154 B1 a step / 154 and 155 B7,
     nothing else and no plain call), ms/step, tok/s, peak memory, the
     cache's bytes, one decode step's busy share split into B1 or B7, the
     KV write and attention (the program's spans) and the rest; on the bf16
     cache ``single_batch_loop`` as the CLI runs it, and speculative
     decoding (k = 3, the W4A4 draft, round by round as the engine runs
     it), whose tokens must equal plain decode's; (c)
     ``examples_torch/quickstart.py`` and ``ultranet_bseg.py`` (64x64),
     each in a subprocess of its own on the card: exit 0 and their
     "bit-exact ... True" lines.
 18. remat — rematerialization of the full-sequence forward (after the
     earlier phases' memory is freed): (a) full-width tinyllama-1.1b float
     training through ``make_train_step``, 2 steps at 4 x 1024 tokens in
     4 microbatches from one state with ``remat=False``, per-block remat
     and the registry's ``remat_group`` 11: every loss and layer 0's
     updated parameters bit for bit alike, step walls and peaks; (b) 2
     steps at 4 x 4096 in 4 microbatches of one sequence on the
     registry's remat: finite losses, step 1's within 1e-6 of a
     ``no_grad`` ``loss_fn`` over the same microbatches, step walls and
     the peak above what was held before; (c) the dry run's one-rank
     (1, 1) ``measure_cell`` of (b)'s step (the worker's): with remat its
     peak within 15% of (b)'s, without remat against the card's 80 GB,
     and the reckoned peak of phase 16's plain step against its measured
     one; (d) the QAT phases' B2 a step (checked there) and walls.
 19. sharded — the sharded decode (after the earlier phases' memory is
     freed), on a one-rank ``nccl`` group and a (1, 1) ("data", "model")
     mesh, full-width tinyllama-1.1b from its W4 memory-packed tree
     placed by ``launch/mesh.place_decode``: (a) a prefill of 8 x 15
     tokens and 16 greedy steps at batch 8, plainly and on the mesh, on
     the int8 and the bf16 cache: tokens, every step's logits and every
     cache leaf bit for bit alike, 154 B7 a prefill and 155 a step on
     both paths; (b) one SDV and one memory decode step under
     ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing op
     left, by source line, none in the cache writes; (c) ``decode_32k``
     on the mesh (batch 128, ``s_max`` 32768, int8 cache): 127 rows at
     32767 write it in every layer, one at 32768 under ``advance`` 0
     writes nothing, finite logits, 155 B7, two step walls, the peak
     against the worker's one-rank reckoning within 5%; (d) the
     worker's ``decode_32k`` and recurrentgemma-2b ``long_500k`` on the
     16 x 16 mesh: a rank's memory and collectives, none on a layer's
     cache shard.

The last two lines of standard output are the ``kernels`` JSON line and
``{"ok": true, "device": {...}}``; the card's name and power limit come
before them.

  python3 chip_smoke.py
"""
from __future__ import annotations

import gc
import json
import math
import re
import signal
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
#: the spec phase: k drafted tokens a round, so the verify wave's GEMMs
#: take BATCH x (k + 1) = 32 rows (B2); bursts of 8 of the engine
#: phase's requests through a plain and a speculative engine on the
#: engine phase's buckets and chunk; the full-width calibration run's
#: Adam steps and rate (40 steps since its forward recomputes under the
#: registry's remat, 0.5 s a step on the H100, so the script stays well
#: inside its time limit; at lr 1e-3 the loss rose) and the reduced
#: one's (the
#: reference's test: 120 steps at 1e-2); a run's loss "falls" when the
#: mean of its last LOSS_WINDOW steps is below that of its first (one
#: step's loss on a fresh random batch is noisy)
SPEC_K = 3
VERIFY_ROWS = BATCH * (SPEC_K + 1)
SPEC_REQUESTS = 8
SPEC_CALIBRATION = {"steps": 40, "lr": 1e-4}
SPEC_REDUCED_CALIBRATION = {"steps": 120, "lr": 1e-2}
LOSS_WINDOW = 10
#: the train phase: packed QAT of full-width tinyllama-1.1b as the
#: launcher runs it by default (``python -m repro_torch.launch.train
#: --qat``: W4A8, plan_policy "auto", a global batch of 8 x 128 tokens
#: in 2 microbatches, so every STE forward GEMM takes 4 x 128 = 512 rows
#: (B2) and the eval batch 8 x 128 = 1024), QAT_STEPS steps (the ssm
#: phase's mamba2-130m with a checkpoint at QAT_CKPT_STEP that a second
#: run resumes from); the exported model decodes QAT_DECODE = (prompt, new) tokens at batch 8
QAT_STEPS, QAT_BATCH, QAT_SEQ, QAT_MICRO = 3, 8, 128, 2
QAT_ROWS = QAT_BATCH // QAT_MICRO * QAT_SEQ
QAT_CKPT_STEP = 2
QAT_DECODE = (4, 4)
#: the served (SDV-packed) eval against the QAT eval, the reference's
#: contract (``tests/test_qat.py::test_qat_export_serves``)
EXPORT_ATOL = 0.1
#: the moe phase: full-width phi3.5-moe-42b-a6.6b (84 GB in bf16, so
#: drawn and packed one layer at a time), and the reduced MoE models held
#: on the card against the CPU over a prefill and MOE_REFERENCE_STEPS
#: decode steps (phi3.5-moe; llama4-maverick for moe_every = 2 and the
#: shared expert)
MOE_ARCH = "phi3.5-moe"
MOE_REFERENCE_ARCHS = ("phi3.5-moe", "llama4-maverick")
MOE_REFERENCE_STEPS = 8
#: reduced MoE caches, card vs CPU: the K/V scales (the amax of a bf16
#: K or V row / 127) within one bf16 rounding; the families phase holds
#: seamless's bf16 K/V to one bf16 rounding of their scale with it
CACHE_SCALE_RTOL = 2.0 ** -7
#: the families phase: full-width seamless-m4t-large-v2 (encdec) and
#: llava-next-mistral-7b (vlm), batch BATCH, PROMPT-token prompts and NEW
#: greedy tokens in SDV and memory mode, and one full-width
#: forward(mode="last_logits") each at (batch, source frames or patches,
#: target tokens); the reduced models held on the card against the CPU
#: over FAMILY_REFERENCE_STEPS decode steps
FAMILY_ARCHS = ("seamless-m4t-large-v2", "llava-next-mistral-7b")
FAMILY_FORWARD = {"seamless-m4t-large-v2": (2, 512, 512),
                  "llava-next-mistral-7b": (2, 1152, 64)}
#: a llava prefill chunk as the benchmark's prefill cell runs it: 8
#: prompts x 512 columns (B2 at 4096 rows, on its wgmma kernel)
CHUNK_BATCH, CHUNK_COLS = 8, 512
#: B2's row sweep on a llava layer (both kernels: the crossover
#: ``sdv_matmul.WGMMA_MIN_ROWS`` is read from it) and the many-row shapes
#: of other main paths: recurrentgemma-2b's SDV forward at 2 x 2048
B2_SWEEP_ROWS = (32, 64, 128, 256, 512, 1024, 2048, 4096)
B2_MANY_ROWS = 4096
FAMILY_REFERENCE_STEPS = 8
#: the program's span of the LM head: the SDV head's plain-torch weight
#: decode (a memory-packed head's B7) and its product
HEAD_SPAN = "repro_torch.head"
#: the ssm phase: full-size mamba2-130m and full-width recurrentgemma-2b,
#: one forward each at SSM_FORWARD = (batch, tokens) in SDV and memory
#: mode (mamba2: 8 SSD chunks of 256; recurrentgemma: its whole window of
#: 2048); the reduced models card vs CPU within LOGIT_ATOL and their loss
#: within SSM_LOSS_ATOL (the tests' LOSS_ATOL), the scans alone within
#: SSM_SCAN_RTOL of the CPU, relative to the largest output (float32
#: einsums and GEMMs sum in another order, exp and sigmoid round
#: otherwise: 1.2e-5 observed on the SSD's final state after 4 chunks of
#: 256, H100, 700 W); the SSD run with TF32 on (a 10-bit mantissa) must
#: miss it; the
#: program's spans of the SSD scan, the RG-LRU's associative scan and
#: the STE weight packing
SSM_ARCHS = ("mamba2-130m", "recurrentgemma-2b")
SSM_FORWARD = (2, 2048)
SSM_LOSS_ATOL = 5e-3
SSM_SCAN_RTOL = 1e-4
SSM_SPANS = ("repro_torch.ssm.scan", "repro_torch.rglru.scan",
             "repro_torch.qat.pack")
#: recurrentgemma-2b's QAT depth: the largest 3g + 2 layers whose peak,
#: reckoned at the bytes a parameter the train phase measured (a 37.99
#: GiB peak over tinyllama-1.1b's 1.100e9 parameters, H100, 700 W), is
#: under QAT_PEAK_LIMIT_GIB of the card's 80 GB
QAT_BYTES_PER_PARAM = 37.99 * 2**30 / 1.100048384e9
QAT_PEAK_LIMIT_GIB = 70
#: the oracles on the card: the SDV matvec at (M, K), the BSEG conv1d at
#: (channels, samples, taps)
ORACLE_SDV_SHAPE = (64, 96)
ORACLE_CONV_SHAPE = (37, 64, 4)


#: the dist phase: the card-vs-CPU slice of the compressed all-reduce,
#: the launcher's steps with and without a mesh, their losses' tolerance
#: (the CPU tests' MESH_TOL: a mesh reduces the same bf16 products in
#: another order), the dry run's cells and their argument/sharding leaf
#: counts at full width (train: 12 parameters, their 24 moments, the
#: step, the tokens; decode: 8 packed kernels of 2 leaves and 4 others,
#: 5 cache leaves, the tokens — at the reference test's reduced width 4
#: kernels stay under serve_params' min_size, 22 leaves)
DIST_SLICE = 1 << 20
DIST_STEPS = 3
DIST_LOSS_ATOL = 2e-3
DIST_CELLS = {"train_4k": 38, "decode_32k": 26}
#: phase 18: rematerialization of full-width REMAT_ARCH float training:
#: (a) REMAT_EXACT_STEPS steps at REMAT_EXACT = (global batch, seq,
#: microbatches) under each of REMAT_SETTINGS, bit for bit alike; (b) the
#: long step REMAT_LONG, REMAT_LONG_STEPS steps on the registry's remat,
#: its first loss within REMAT_LOSS_RTOL of a no_grad ``loss_fn`` over the
#: same microbatches; (c) the dry run's one-rank peak within
#: REMAT_PEAK_RTOL of (b)'s measured one (the tolerances fixed before the
#: first reading); the card's memory for the remat-off reckoning
REMAT_ARCH = "tinyllama-1.1b"
REMAT_EXACT, REMAT_EXACT_STEPS = (4, 1024, 4), 2
REMAT_SETTINGS = {"off": dict(remat=False, remat_group=0),
                  "block": dict(remat=True, remat_group=0),
                  "registry": {}}
REMAT_LONG, REMAT_LONG_STEPS = (4, 4096, 4), 2
REMAT_LOSS_RTOL = 1e-6
REMAT_PEAK_RTOL = 0.15
CARD_BYTES = 80e9
#: the dry run's cells are reckoned on the host by a worker process
#: started with the script (``HostDryRun``); the phases that read them
#: wait at most this long
DRYRUN_WAIT_S = 900
#: phase 19: the sharded decode of full-width SHARDED_ARCH on a one-rank
#: (1, 1) mesh; LONG_DECODE = (batch, s_max) of the reference's decode_32k
#: cell, its reckoned peak within LONG_PEAK_RTOL of the card's (fixed
#: before the first reading); the hybrid cell the worker also reckons
SHARDED_ARCH = "tinyllama-1.1b"
LONG_DECODE = (128, 32768)
LONG_PEAK_RTOL = 0.05
LONG_ARCH = "recurrentgemma-2b"
#: phase 17: the reduced models held card against CPU on the bf16 KV
#: cache (``serve_kv_bits = KV_BITS``), their decode steps, and the
#: program's spans of the decode step's KV write and attention
KV_ARCHS = ("tinyllama-1.1b", "phi3.5-moe", "llava-next-mistral-7b")
KV_BITS = 16
KV_REFERENCE_STEPS = 8
KV_SPANS = ("repro_torch.attn.kv", "repro_torch.attn.core")


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
    names = ("sdv", "sdv_wgmma", "bseg", "bseg1d", "packbits",
             "quant_matmul")
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
        if name in ("sdv", "sdv_wgmma", "bseg", "bseg1d", "quant_matmul"):
            for line in ptxas_report(log):
                print(f"[build]   {line}")
        if name == "sdv":
            lib = build.library(name)
            print("[build]   dynamic shared memory per block: " + ", ".join(
                f"{k} {w} words {lib.sdv_smem_bytes(gemm, limb)} B"
                for k, gemm in (("B1", 0), ("B2", 1))
                for w, limb in (("INT32", 0), ("two-limb", 1))))
        if name == "sdv_wgmma":
            from repro_torch.kernels import sdv_matmul
            geo = {n: sdv_matmul.wgmma_geometry(4096, 4096, 7168, n, sms=132)
                   for n in (1, 2, 3)}
            lib = build.library(name)
            print("[build]   dynamic shared memory per block (B2 at many "
                  "rows): " + ", ".join(
                      f"n={n} {g.stages} stages "
                      f"{lib.sdv_wgmma_smem_bytes(g.bgw, g.stages)} B"
                      for n, g in geo.items()))
    print(f"[build] all sources in {time.perf_counter() - t0:.1f} s")


def ptxas_report(log):
    """One line per kernel of an ``-Xptxas -v`` log: its name with its
    template arguments (sdv.cu: <two-limb words, .u8 lanes, .u8
    activations>, the ``_sliced`` kernels <two-limb words>;
    sdv_wgmma.cu: <.u8 lanes, .u8 activations, n unrolled (0: any)>; bseg.cu:
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
    # the speculative path's new shapes and plans: B2 on the target's
    # word at the verify wave's 32 rows, B1 on the W4A4 draft's plan
    draft_plan = plan_sdv(DSP48E2, 4, 4, signed_a=True, signed_b=True,
                          park_sign_bits=True)
    check(draft_plan.n == 4, draft_plan)
    spec = {"B2": ("verify", plans["dsp48e2 W4A8 n=3"], "dsp48e2 W4A8 n=3",
                   VERIFY_ROWS),
            "B1": ("draft", draft_plan, "dsp48e2 W4A4 n=4", DECODE_ROWS)}
    for kname, (path, plan, pname, rows) in spec.items():
        acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
        for (k, m), mult in LAYER_SHAPES.items():
            r = sdv_case(kname, plan, pname, k, m, rows, gen, flush)
            max_err[kname] = max(max_err[kname], r["max_abs_err"])
            for key in ("ms", "plain_ms", "bytes", "ops"):
                acc[key] += mult * r[key]
            acc["library_ms"] = None if r["library_ms"] is None \
                or acc["library_ms"] is None \
                else acc["library_ms"] + mult * r["library_ms"]
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"])
        layer[kname][path] = acc
        print(f"[kernels] {kname} on the {path} path ({pname}, {rows} rows), "
              f"one layer's 7 projections: {acc['ms']:.4f} ms (bound "
              f"{acc['bound_ms']:.4f} ms by {acc['bound_by']}), _int_mm "
              f"{acc['library_ms']} ms")
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
    qmax = (1 << plan.w_b - 1) - 1          # the symmetric quantizer's
    x = torch.randint(-qmax, qmax + 1, (rows, k), generator=gen,
                      device=gen.device, dtype=torch.int32)
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


class _HostOp:
    """A host event of the profiler's raw (kineto) trace as ``host_ops``'
    predicates see it: ``key`` (its name) and ``input_shapes`` (read only
    when a predicate asks)."""
    __slots__ = ("_e",)

    def __init__(self, e):
        self._e = e

    @property
    def key(self):
        return self._e.name()

    @property
    def input_shapes(self):
        return self._e.shapes()


def device_events(prof):
    """The profiled run's device events (kernels, copies, memsets) as
    (name, ms, the host op that launched them or None), and the host ops
    by correlation id, read from the raw kineto trace.  The profiler's
    ``key_averages`` builds a Python event tree first, which takes about
    0.5 ms an event on the host: minutes for a train step.  A user
    range's own device-side copy (an annotation, not a kernel) is left
    out."""
    from torch.autograd import DeviceType
    host, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            if not e.is_async() and e.linked_correlation_id() == 0:
                host[e.correlation_id()] = e
        else:
            dev.append(e)
    ranges = {e.name() for e in host.values()
              if getattr(e, "is_user_annotation", lambda: False)()}
    return [(e.name(), e.duration_ns() / 1e6,
             host.get(e.linked_correlation_id()))
            for e in dev if e.name() not in ranges], host


def launched_under(events, host, pick):
    """Whether each of ``events`` was launched inside a host op that
    ``pick`` (a predicate on a ``_HostOp``) selects: the launching op is
    that op or runs within it on the same thread."""
    import bisect
    spans = {}
    for e in host.values():
        if pick(_HostOp(e)):
            spans.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
    merged = {}
    for tid, iv in spans.items():
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        merged[tid] = ([a for a, _ in out], [b for _, b in out])
    out = []
    for _, _, op in events:
        hit = False
        if op is not None and op.start_thread_id() in merged:
            starts, ends = merged[op.start_thread_id()]
            i = bisect.bisect_right(starts, op.start_ns()) - 1
            hit = i >= 0 and op.end_ns() <= ends[i]
        out.append(hit)
    return out


def profile(label, fn, steps, wall_ms):
    """Device busy time per call of ``fn`` (torch.profiler) against
    ``wall_ms``, the unprofiled wall time per call, and the kernels that
    take it.  Only device events count (kernels, copies, memsets): an
    aten op's own device time is that of the kernels it launched, which
    appear as device events too.  Returns (busy ms, {device event: ms})
    per call, or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    dev_ms = {}
    for name, ms, _ in device_events(prof)[0]:
        dev_ms[name] = dev_ms.get(name, 0.0) + ms / steps
    busy_ms = sum(dev_ms.values())
    if busy_ms == 0.0:
        print(f"[profile] {label}: the profiler saw no device time; "
              "device busy share not measured")
        return None
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:6]
    # each event goes to the longest port kernel name in it
    # (pack_words_kernel is a substring of unpack_words_kernel)
    ours = dict.fromkeys(PORT_KERNELS, 0.0)
    for k, v in dev_ms.items():
        hits = [name for name in PORT_KERNELS if name in k]
        if hits:
            ours[max(hits, key=len)] += v
    print(f"[profile] {label}: unprofiled wall {wall_ms:.3f} ms, device "
          f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}) over "
          f"{len(dev_ms)} distinct device events; the port's kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items() if v)
          + f", the rest {busy_ms - sum(ours.values()):.3f} ms; top device "
          "time per call: "
          + "; ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    return busy_ms, dev_ms


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


def same_bits(a, b) -> bool:
    """Tensors equal bit for bit (-0.0 != 0.0, NaN == NaN)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def dequant_case(m, nw, w, d_out, rows_per_scale, dtype, gen, flush, where,
                 edges=False, timed=True, twice=False):
    """Fused B7 on random words [m, nw] (every field value) and scales
    [m / rows_per_scale, nw * 32 / w]: against its plain version and the
    route it replaced, bit for bit; with ``edges`` the first columns'
    scales are a subnormal, two bf16 rounding ties (1 + 2^-8, 1 + 3 2^-8:
    q = +-1, +-2, +-4 land halfway) and an overflow.  Returns its time,
    plain time, bound and the replaced route's time (``timed``).
    ``twice``: a second launch must give the first one's bits."""
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
    if twice:
        check(same_bits(run(), got), f"fused B7 at {where}: a second launch "
                                     "differs from the first")
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


def spec_exactness(cfg, qparams, dev, s_max):
    """One ``verify_step`` over k + 1 columns against k + 1 sequential
    ``decode_step``s on copies of one prefilled cache at batch 8: the
    logits and every cache leaf ``torch.equal``; the verify wave is one
    B2 launch per projection (32 rows)."""
    import numpy as np
    import torch
    from repro_torch.models import (decode_step, init_cache, prefill_step,
                                    verify_step)

    per_call = 7 * cfg.n_layers
    rng = np.random.default_rng(s_max)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, ENGINE_CHUNK)),
                          dtype=torch.int32, device=dev)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, SPEC_K + 1)),
                        dtype=torch.int32, device=dev)
    cache0 = prefill_step(cfg, qparams, init_cache(cfg, BATCH, s_max,
                                                   device=dev), prompt,
                          torch.full((BATCH,), ENGINE_CHUNK,
                                     dtype=torch.int32, device=dev))
    reset_counts()
    vlogits, vcache = verify_step(
        cfg, qparams, {k: v.clone() for k, v in cache0.items()}, toks,
        torch.full((BATCH,), SPEC_K + 1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    c_verify = counts()
    check(c_verify == expect(B2=per_call),
          f"verify_step launches {c_verify}, want B2={per_call}")
    cache = {k: v.clone() for k, v in cache0.items()}
    logits = []
    for j in range(SPEC_K + 1):
        out, cache = decode_step(cfg, qparams, cache, toks[:, j:j + 1])
        logits.append(out)
    logits = torch.cat(logits, dim=1)
    check(torch.equal(vlogits, logits),
          f"b{BATCH}.s{s_max}: verify logits != sequential decode's at "
          f"{int((vlogits != logits).sum())} of {logits.numel()}")
    for name in cache:
        check(torch.equal(vcache[name], cache[name]),
              f"b{BATCH}.s{s_max}: verify cache {name} != sequential "
              "decode's")
    print(f"[spec] b{BATCH}.s{s_max}: verify_step over {SPEC_K + 1} "
          f"columns == {SPEC_K + 1} sequential decode_steps bit for bit "
          f"(logits {list(logits.shape)}, {', '.join(cache)}); "
          f"launches {c_verify}")


def spec_pair(label, cfg, params, specs, dev, card):
    """A burst of ``specs`` through a plain and a speculative engine on
    the engine phase's buckets and chunk: every outcome "ok", the same
    token stream per request, and the speculative run's launches are 3 x
    154 B1 (draft) + 154 B2 (verify) a round plus 154 B1 a prefill-slot
    call, nothing else.  Returns (the speculative engine, its launch
    counts, ms per round)."""
    import tempfile

    import torch
    from repro_torch.serving import BucketShape, Engine

    per_call = 7 * cfg.n_layers
    buckets = tuple(BucketShape(BATCH, s) for s in ENGINE_BUCKETS)
    runs = {}
    for speculative in (False, True):
        with tempfile.TemporaryDirectory() as td:
            engine = Engine(cfg, params, compute="sdv", weight_bits=4,
                            act_bits=8, plan_cache=f"{td}/absent.json",
                            buckets=buckets, prefill_chunk=ENGINE_CHUNK,
                            speculative=speculative, spec_k=SPEC_K,
                            device=dev)
        for b in buckets:            # kernel builds and first calls
            engine.warmup(b, inject=False)
        torch.cuda.synchronize()
        reset_counts()
        rids, comps, wall = engine_run(engine, specs)
        c = counts()
        check(all(engine.outcomes[r]["outcome"] == "ok" for r in rids),
              f"{label}: outcomes {[engine.outcomes.get(r) for r in rids]}")
        runs[speculative] = (engine, [comps[r].tokens for r in rids], c,
                             wall)
    (plain, p_toks, _, p_wall), (engine, s_toks, c, wall) = \
        runs[False], runs[True]
    for i, (a, b) in enumerate(zip(p_toks, s_toks)):
        check(a == b, f"{label}: request {i} speculative {b} != plain {a}")
    snap = engine.metrics.snapshot()
    sp = snap["speculative"]
    buckets_snap = snap["buckets"].values()
    pre = sum(b.get("prefill_calls", 0) for b in buckets_snap)
    dec = sum(b.get("decode_steps", 0) for b in buckets_snap)
    rounds = sp["rounds"]
    check(sp["degraded_buckets"] == 0 and dec == 0 and rounds > 0,
          f"{label}: {sp}, {dec} plain decode iterations")
    check(all(st.spec_on for key, st in engine._states.items()
              if key != "fallback"), f"{label}: speculation off")
    check(c == expect(B1=per_call * (SPEC_K * rounds + pre),
                      B2=per_call * rounds),
          f"{label}: launches {c}, want B1 = {per_call} x ({SPEC_K} x "
          f"{rounds} rounds + {pre} prefill-slot calls), B2 = {per_call} x "
          f"{rounds}")
    round_ms = 1e3 * (sp["draft_wall_s"] + sp["verify_wall_s"]) / rounds
    p_snap = plain.metrics.snapshot()
    p_dec = sum(b.get("decode_steps", 0) for b in p_snap["buckets"].values())
    p_ms = 1e3 * sum(b.get("decode_wall_s", 0.0) for b in
                     p_snap["buckets"].values()) / max(p_dec, 1)
    print(f"[spec] {label}: {len(specs)} requests, the speculative token "
          f"streams == the plain ones; speculative {wall:.3f} s "
          f"({snap['tokens_out'] / wall:.1f} tok/s) against plain "
          f"{p_wall:.3f} s ({p_snap['tokens_out'] / p_wall:.1f} tok/s); "
          f"{rounds} rounds, mean accepted {sp['mean_accepted']:.3f}, "
          f"acceptance histogram {sp['acceptance_hist']}, draft "
          f"{1e3 * sp['draft_wall_s'] / rounds:.2f} ms + verify "
          f"{1e3 * sp['verify_wall_s'] / rounds:.2f} ms a round (plain "
          f"decode iteration {p_ms:.2f} ms, {p_dec} of them), tokens per "
          f"target wave {sp['tokens_per_target_wave']:.3f} (plain "
          f"{p_snap['speculative']['tokens_per_target_wave']:.3f}), "
          f"{pre} prefill-slot calls; launches {c} ({card})")
    del plain
    return engine, c, round_ms, sp


def phase_spec(dev, card):
    """Speculative decoding of full-width tinyllama-1.1b: verify ==
    sequential decode bit for bit at the engine's buckets; the plain and
    speculative engines' bursts on random and on calibrated weights
    (same tokens); the device busy share of one round; reduced tinyllama
    calibrated on the card must accept two or more tokens in some round.
    Returns the launch counts of the random-weights speculative burst."""
    import math

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.datapath import DSP48E2, plan_sdv
    from repro_torch.models import SDVLinear, init_params
    from repro_torch.serving.spec import calibrated_params

    cfg = get_arch("tinyllama-1.1b")
    specs = engine_specs(cfg.vocab, SPEC_REQUESTS)
    params = init_params(cfg, seed=0, device=dev)
    t0 = time.perf_counter()
    engine, c_spec, round_ms, _ = spec_pair(
        f"{cfg.name} random weights", cfg, params, specs, dev, card)
    for s_max in ENGINE_BUCKETS:
        spec_exactness(cfg, engine._qparams(BATCH), dev, s_max)
    draft = plan_sdv(DSP48E2, 4, 4, signed_a=True, signed_b=True,
                     park_sign_bits=True)

    def plans(tree):
        out = []
        for v in tree.values():
            out += plans(v) if isinstance(v, dict) else \
                [v.plan] if isinstance(v, SDVLinear) else []
        return out
    got = plans(engine.spec.draft_qparams(BATCH))
    check(len(got) == 8 and all(p == draft for p in got),
          f"draft plans {got} != dsp48e2 W4A4 n=4")
    report = engine.spec_report()
    check(all(l["draft_denser"] for r in report.values()
              for l in r["layers"]), f"spec_report {report}")
    st = engine._states[f"b{BATCH}.s{ENGINE_BUCKETS[-1]}"]
    dqp = engine.spec.draft_qparams(BATCH)
    pend = torch.zeros((BATCH,), dtype=torch.int32, device=dev)
    ones = torch.ones((BATCH,), dtype=torch.int32, device=dev)
    rem = torch.full((BATCH,), SPEC_K + 1, dtype=torch.int32, device=dev)

    def one_round():
        props = engine.spec.draft(dqp, dict(st.work), pend, ones,
                                  st.draft_work)
        engine.spec.verify(st.qparams, dict(st.work), pend, props, ones, rem)
    profile(f"speculative round ({SPEC_K} draft steps + verify) at batch "
            f"{BATCH}", one_round, steps=2, wall_ms=round_ms)
    print(f"[spec] random weights: {time.perf_counter() - t0:.1f} s; "
          f"every draft layer dsp48e2 W4A4 n=4 (target n=3), strictly "
          f"denser")
    del engine, st, dqp, params

    # --- a calibrated checkpoint at full width (reported, not gated) ---
    losses = []
    t0 = time.perf_counter()
    cparams = calibrated_params(cfg, seed=0, device=dev, losses=losses,
                                **SPEC_CALIBRATION)
    train_s = time.perf_counter() - t0
    first = sum(losses[:LOSS_WINDOW]) / LOSS_WINDOW
    last = sum(losses[-LOSS_WINDOW:]) / LOSS_WINDOW
    check(all(math.isfinite(x) for x in losses) and last < first,
          f"calibration losses {losses}")
    print(f"[spec] calibrated_params({cfg.name}, steps="
          f"{SPEC_CALIBRATION['steps']}, lr={SPEC_CALIBRATION['lr']}): loss "
          f"{losses[0]:.4f} at the first step, {losses[-1]:.4f} at the last; "
          f"mean of the first {LOSS_WINDOW} {first:.4f}, of the last "
          f"{last:.4f}; {train_s:.1f} s")
    engine, _, _, _ = spec_pair(f"{cfg.name} calibrated", cfg, cparams,
                                specs, dev, card)
    del engine, cparams

    # --- reduced tinyllama calibrated on the card: acceptance >= 2 -------
    rcfg = cfg.reduced()
    losses = []
    rparams = calibrated_params(rcfg, seed=0, device=dev, losses=losses,
                                **SPEC_REDUCED_CALIBRATION)
    print(f"[spec] calibrated_params({rcfg.name}, steps="
          f"{SPEC_REDUCED_CALIBRATION['steps']}, lr="
          f"{SPEC_REDUCED_CALIBRATION['lr']}): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    engine, _, _, sp = spec_pair(f"{rcfg.name} calibrated", rcfg, rparams,
                                 engine_specs(rcfg.vocab, SPEC_REQUESTS),
                                 dev, card)
    check(any(int(k) >= 2 for k in sp["acceptance_hist"]),
          f"reduced calibrated: no round accepted 2 or more "
          f"({sp['acceptance_hist']})")
    del engine, rparams
    return c_spec


def _sub_counts(a, b):
    return {k: a[k] - b[k] for k in a}


def qat_b2_cases(flush):
    """B2 at the QAT shapes: 512 rows on the dsp48e2 W4A8 n=3 plan the
    planner picks for every tinyllama projection, at each projection
    shape and the LM head's (2048 -> 32000), against its plain version
    and the exact product; timed beside its bound and ``_int_mm``.
    Returns one layer's sums (7 projections) and the head's times."""
    import torch
    from repro_torch.core.datapath import DSP48E2, plan_sdv
    plan = plan_sdv(DSP48E2, 4, 8, signed_a=True, signed_b=True,
                    park_sign_bits=True)
    check(plan.n == 3, plan)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0)
    err = 0
    for (k, m), mult in LAYER_SHAPES.items():
        r = sdv_case("B2", plan, "dsp48e2 W4A8 n=3 (QAT)", k, m, QAT_ROWS,
                     gen, flush)
        err = max(err, r["max_abs_err"])
        for key in ("ms", "plain_ms", "bytes", "ops"):
            acc[key] += mult * r[key]
        acc["library_ms"] = None if r["library_ms"] is None \
            or acc["library_ms"] is None \
            else acc["library_ms"] + mult * r["library_ms"]
    acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"])
    head = sdv_case("B2", plan, "dsp48e2 W4A8 n=3 (QAT LM head)",
                    *LM_HEAD_SHAPE, QAT_ROWS, gen, flush)
    acc["max_abs_err"] = max(err, head["max_abs_err"])
    acc["head_ms"], acc["head_plain_ms"] = head["ms"], head["plain_ms"]
    acc["head_bound_ms"], acc["head_bound_by"] = bound_ms(head["bytes"],
                                                          head["ops"])
    acc["head_library_ms"] = head["library_ms"]
    print(f"[train] B2 at {QAT_ROWS} rows on dsp48e2 n=3, one layer's 7 "
          f"projections: {acc['ms']:.4f} ms (bound {acc['bound_ms']:.4f} ms "
          f"by {acc['bound_by']}, {acc['bound_ms'] / acc['ms']:.1%}), "
          f"_int_mm {acc['library_ms']} ms; LM head {acc['head_ms']:.4f} ms "
          f"(bound {acc['head_bound_ms']:.4f}, _int_mm "
          f"{acc['head_library_ms']})")
    return acc, plan


def ste_card_checks(dev, plan):
    """``ste_dense`` on the plan (B2) == ``ste_dense`` with ``plan=None``
    (the exact float64 product) bitwise on the card at the QAT shapes,
    its backward's float32 products against float64; ``ste_conv2d`` on
    the W4A4 BSEG plan (B3) == ``plan=None`` at UltraNet's first 64 -> 64
    3x3 stage, forward and backward one launch.  Both layers are called
    without ``use_kernel``: its default (the input is on the card) must
    launch the kernel.  Returns the B3 launches of the conv layer's
    step."""
    import torch
    from repro_torch.models.quantized import default_bseg_plan
    from repro_torch.models.ultranet import ultranet_layer_shapes
    from repro_torch.train.qat import ste

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for k, m in ((2048, 5632), (5632, 2048), LM_HEAD_SHAPE):
        x = torch.randn((QAT_ROWS, k), generator=gen, device=dev) \
            .to(torch.bfloat16).requires_grad_(True)
        w = (torch.randn((k, m), generator=gen, device=dev) * 0.02) \
            .to(torch.bfloat16).requires_grad_(True)
        reset_counts()
        y = ste.ste_dense(x, w, 4, 8, plan)
        check(counts() == expect(B2=1), f"ste_dense launches {counts()}")
        y0 = ste.ste_dense(x, w, 4, 8, None)
        check(same_bits(y, y0), f"ste_dense packed != plan=None at "
              f"{QAT_ROWS}x{k}->{m}")
        g = torch.randn(y.shape, generator=gen, device=dev)
        gx, = torch.autograd.grad(y.float(), x, g)
        qw, sw = ste.quantize_weights(w.detach(), 4)
        w_fq = qw.double() * sw.double()
        # the backward's float32 product (of the bf16-rounded output
        # gradient) before its bf16 cast, rebuilt
        gb = g.to(torch.bfloat16).float()
        want = gb.double() @ w_fq.T
        got = (gb @ (qw.float() * sw[None, :]).T).double()
        # float32 summation over m terms: eps_32 x m x max|g| max|w|;
        # a TF32 product (10-bit mantissa) would exceed it
        bound = 2.0 ** -23 * m * float(g.abs().max()) \
            * float(w_fq.abs().max())
        err = float((got - want).abs().max())
        check(err <= bound, f"STE backward product err {err} > {bound}")
        check(torch.equal(gx, got.to(torch.float32).to(torch.bfloat16)),
              "STE backward gx != its float32 product")
        print(f"[train] ste_dense {QAT_ROWS}x{k}->{m}: packed == plan=None "
              f"bitwise (1 B2); backward float32 product within "
              f"{err:.3g} of float64 (bound {bound:.3g})")
    s = next(s for s in ultranet_layer_shapes(ULTRA_SIZE, ULTRA_SIZE)
             if s["cin"] == 64 and s["k"] == 3)
    x = torch.randn((ULTRA_BATCH, s["h"], s["w"], s["cin"]), generator=gen,
                    device=dev).requires_grad_(True)
    w = torch.randn((s["cout"], s["cin"], 3, 3), generator=gen,
                    device=dev).requires_grad_(True)
    cplan = default_bseg_plan(4)
    reset_counts()
    y = ste.ste_conv2d(x, w, 4, 4, cplan)
    y.sum().backward()
    c_conv = counts()
    check(c_conv == expect(B3=1), f"ste_conv2d step launches {c_conv}")
    y0 = ste.ste_conv2d(x.detach(), w.detach(), 4, 4, None)
    check(same_bits(y.detach(), y0), "ste_conv2d packed != plan=None")
    check(bool(torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()),
          "ste_conv2d gradients not finite")
    print(f"[train] ste_conv2d {ULTRA_BATCH}x{s['h']}x{s['w']}x{s['cin']} "
          f"-> {s['cout']} (3x3, {cplan.spec.name} W4A4): packed == "
          f"plan=None bitwise; forward + backward {c_conv['B3']} B3")
    return c_conv["B3"]


def phase_train(dev, card, flush):
    """Packed QAT of full-width tinyllama-1.1b: B2 at the QAT shapes and
    the STE layers on the card (``qat_b2_cases``, ``ste_card_checks``),
    then ``qat_run`` with the launcher's ``--qat`` defaults for QAT_STEPS
    steps, the export evaluated and decoded on B1; every wrapped
    leaf on the dsp48e2 n=3 plan ``qat_b2_cases`` times.  Returns the
    phase's kernel numbers and launch counts."""
    t_phase = time.perf_counter()
    b2, plan = qat_b2_cases(flush)
    b3 = ste_card_checks(dev, plan)
    print(f"[train] kernel checks {time.perf_counter() - t_phase:.1f} s")
    run = qat_run("tinyllama-1.1b", dev, card, steps=QAT_STEPS,
                  export=True, remat_check=True,
                  tag="train")
    check(run["qat_layers"] == 8 and run["plans"] == {plan},
          f"tinyllama QAT: {run['qat_layers']} wrapped leaves on "
          f"{run['plans']}, want 8 on {plan}")
    print(f"[train] phase {time.perf_counter() - t_phase:.1f} s")
    return dict(b2=b2, split=run["split"], step_ms=run["step_ms"],
                peak=run["peak_gib"], remat_vs_off_ms=run["remat_vs_off_ms"],
                launches={"B2 train": run["b2_run"],
                          "B2 export eval": run["b2_export_eval"],
                          "B1 export decode": run["b1_decode"],
                          "B3 conv": b3})


def moe_bank_shapes(cfg):
    """The two B7 calls of one expert bank at ``cfg``'s width, W4: (rows
    [E * d_in], words, d_out, rows per scale) of ``wi_gate``/``wi_up`` and
    of ``wo``."""
    per = 32 // MEMORY_BITS
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {"wi_gate/wi_up": (e * d, f // per, f, d),
            "wo": (e * f, d // per, d, f)}


def moe_kernels(cfg, dev, flush, card):
    """B7 at both bank shapes (W4, bf16 out) against its plain version
    and the replaced route bit for bit, twice; B1 (8 rows) and B2 (128
    rows) at the attention's (K, M) on the INT32 W4A8 plan against the
    plain version and the exact product.  Returns the per-step sums:
    B7 over 3 banks x n_layers, B1/B2 over one layer's 4 projections."""
    import torch
    from repro_torch.models.quantized import default_sdv_plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    b7 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, before_ms=0.0)
    for name, (m, nw, d_out, rps) in moe_bank_shapes(cfg).items():
        r = dequant_case(m, nw, MEMORY_BITS, d_out, rps, torch.bfloat16, gen,
                         flush, f"{cfg.name} bank {name}", twice=True)
        times = cfg.n_layers * (2 if name == "wi_gate/wi_up" else 1)
        for key in ("ms", "plain_ms", "bound_ms", "before_ms"):
            b7[key] += times * r[key]
        b7[name] = r
    print(f"[moe] B7 per {cfg.name} decode step's banks ({3 * cfg.n_layers} "
          f"calls, flushed): {b7['ms']:.3f} ms (bound {b7['bound_ms']:.3f} ms "
          f"by bytes, {b7['bound_ms'] / b7['ms']:.1%}); the replaced route "
          f"{b7['before_ms']:.3f} ms; plain {b7['plain_ms']:.1f} ms ({card})")
    plan = default_sdv_plan(4, 8)
    d, kv = cfg.d_model, cfg.n_kv * cfg.hd
    attn = {(d, cfg.n_heads * cfg.hd): 1, (d, kv): 2,
            (cfg.n_heads * cfg.hd, d): 1}
    out = {"B7": b7}
    for kname, rows in (("B1", DECODE_ROWS), ("B2", PREFILL_ROWS)):
        acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0,
                   max_abs_err=0)
        for (k, m), mult in attn.items():
            r = sdv_case(kname, plan, "int32 W4A8 n=2", k, m, rows, gen, flush)
            for key in ("ms", "plain_ms", "bytes", "ops"):
                acc[key] += mult * r[key]
            acc["library_ms"] = None if r["library_ms"] is None \
                or acc["library_ms"] is None \
                else acc["library_ms"] + mult * r["library_ms"]
            acc["max_abs_err"] = max(acc["max_abs_err"], r["max_abs_err"])
        acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"])
        out[kname] = acc
        print(f"[moe] {kname} per {cfg.name} layer's 4 attention projections "
              f"at {rows} rows (int32 W4A8): {acc['ms']:.4f} ms (bound "
              f"{acc['bound_ms']:.4f} ms by {acc['bound_by']}), _int_mm "
              f"{acc['library_ms']} ms ({card})")
    return out


def moe_card_vs_cpu(dev):
    """Reduced phi3.5-moe and llama4-maverick (``moe_every`` 2, a shared
    expert) in SDV and memory modes on the card against the same models
    on the CPU (plain kernel versions): a 5-token prefill and
    ``MOE_REFERENCE_STEPS`` decode steps.  Logits within
    ``LOGIT_ATOL``; the routing (expert ids, slots, kept choices of every
    MoE call) and ``index`` bit for bit; the int8 K/V within one
    quantization step and their scales within one bf16 rounding
    (``CACHE_SCALE_RTOL``) of the CPU's: cuBLAS sums the bf16 expert
    products in another order than the CPU, so a few K/V values after a
    MoE layer move by a bf16 ulp, which can cross a quantization step
    (measured: the first layer's entries, and all of reduced
    llama4-maverick's, unscaled and truncated, come out bit for bit).
    The entries that differ are counted and printed by layer."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, serve_params)
    from repro_torch.tracing import expert_routes
    cpu = torch.device("cpu")
    for arch in MOE_REFERENCE_ARCHS:
        cfg = get_arch(arch).reduced()
        params = init_params(cfg, seed=1, device=cpu)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab, (3, 5))
        tokens = rng.integers(0, cfg.vocab, (MOE_REFERENCE_STEPS, 3, 1))
        for compute in ("sdv", "memory"):
            outs, caches, routes = {}, {}, {}
            for d in (cpu, dev):
                q = serve_params(_to(params, d), bits=4, min_size=1024,
                                 compute=compute)
                with expert_routes() as calls:
                    cache = init_cache(cfg, 3, 16, device=d)
                    cache = prefill_step(
                        cfg, q, cache,
                        torch.tensor(prompt, dtype=torch.int32, device=d),
                        torch.tensor([5, 3, 0], dtype=torch.int32, device=d))
                    logits = []
                    for t in tokens:
                        out, cache = decode_step(cfg, q, cache, torch.tensor(
                            t, dtype=torch.int32, device=d))
                        logits.append(out.cpu())
                routes[d.type] = [tuple(t.cpu() for t in r) for r in calls]
                outs[d.type] = torch.stack(logits)
                caches[d.type] = {k: v.cpu() for k, v in cache.items()}
            err = float((outs["cuda"] - outs["cpu"]).abs().max())
            check(err <= LOGIT_ATOL, f"reduced {cfg.name} ({compute}) card vs "
                                     f"CPU logits differ by {err}")
            check(len(routes["cuda"]) == len(routes["cpu"]) > 0
                  and all(all(torch.equal(a, b) for a, b in zip(rc, rh))
                          for rc, rh in zip(routes["cuda"], routes["cpu"])),
                  f"reduced {cfg.name} ({compute}): routing differs between "
                  "the card and the CPU")
            card, host = caches["cuda"], caches["cpu"]
            steps = {k: int((card[k].int() - host[k].int()).abs().max())
                     for k in ("k", "v")}
            rel = {k: float(((card[k] - host[k]).abs()
                             / host[k].abs().clamp_min(1e-30)).max())
                   for k in ("k_scale", "v_scale")}
            check(torch.equal(card["index"], host["index"])
                  and max(steps.values()) <= 1
                  and max(rel.values()) <= CACHE_SCALE_RTOL,
                  f"reduced {cfg.name} ({compute}): caches card vs CPU: "
                  f"int8 steps {steps}, scale rel {rel}")
            differ = {k: (int((card[k] != host[k]).sum()), host[k].numel(),
                          sorted({int(i) for i in (card[k] != host[k])
                                  .nonzero()[:, 0]}))
                      for k in ("k", "v", "k_scale", "v_scale")}
            print(f"[moe] reduced {cfg.name} ({compute}), prefill + "
                  f"{MOE_REFERENCE_STEPS} decode steps, card vs CPU: max "
                  f"|dlogit| {err:.4g} (tolerance {LOGIT_ATOL}); routing of "
                  f"{len(routes['cpu'])} MoE calls and index bit for bit; "
                  "cache entries that differ (of all, in layers): "
                  + ", ".join(f"{k} {n} of {m} {ls}"
                              for k, (n, m, ls) in differ.items())
                  + f"; int8 steps {steps}, scales within "
                  + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
                  + f" relative; k_scale sum "
                  f"{float(host['k_scale'].sum()):.4g}")


def step_split(tag, label, fn, wall_ms, card, kernels, host_ops,
               shapes=False):
    """One profiled call of ``fn``: device busy ms and its split into the
    port's ``kernels`` ({name: kernel function name}, by the device
    events' names), the device time under the host ops ``host_ops``
    picks ({name: predicate on a ``_HostOp``, e.g. ``aten::bmm`` on a
    bank (``shapes``: the profiler records input shapes), or one of the
    program's spans}) and the rest (``device_events``,
    ``launched_under``).  Each device event counts once, in the first
    category that takes it: the kernels, then the host ops in order.
    Returns the split, or None when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       record_shapes=shapes) as prof:
        fn()
        torch.cuda.synchronize()
    events, host = device_events(prof)
    busy = sum(ms for _, ms, _ in events)
    if busy == 0.0:
        print(f"[{tag}] {label}: the profiler saw no device time; split "
              "not measured")
        return None
    hits = {k: [name in n for n, _, _ in events]
            for k, name in kernels.items()}
    hits.update({k: launched_under(events, host, pick)
                 for k, pick in host_ops.items()})
    taken = [False] * len(events)
    split = {}
    for k, hit in hits.items():
        split[k] = sum(ms for (_, ms, _), h, t in zip(events, hit, taken)
                       if h and not t)
        taken = [t or h for t, h in zip(taken, hit)]
    split["rest"] = busy - sum(split.values())
    print(f"[{tag}] {label}: unprofiled wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall_ms:.1%}): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items())
          + f" ({card})")
    return dict(split, busy_ms=busy, wall_ms=wall_ms)


def moe_serve(cfg, dev, card, compute):
    """Full-width ``cfg`` built layer by layer
    (``packed_params_layerwise(compute=compute, min_size=1024)``): its
    B6 launches and ``count_packed``; a 16-token prefill of 8 prompts, 16
    greedy decode steps at batch 8 and the serve CLI's
    ``single_batch_loop``, each with exactly the expected launches and
    no plain call; ms/step, tok/s, peak memory, one decode step's busy
    share and split."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import (packed_params_layerwise,
                                          single_batch_loop)
    from repro_torch.models import decode_step, init_cache, prefill_step
    from repro_torch.models.quantized import count_packed

    n = cfg.n_layers
    banks, attn = 3 * n, 4 * n
    if compute == "sdv":
        want_pack, want_count = dict(B6=banks), {"memory": banks,
                                                 "sdv": attn + 1, "bseg": 0}
        want_prefill, want_step = dict(B2=attn, B7=banks), dict(B1=attn,
                                                                 B7=banks)
    else:
        want_pack = dict(B6=banks + attn + 1)
        want_count = {"memory": banks + attn + 1, "sdv": 0, "bseg": 0}
        want_prefill, want_step = dict(B7=banks + attn), dict(
            B7=banks + attn + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    qparams = packed_params_layerwise(cfg, seed=0, device=dev, bits=4,
                                      min_size=1024, compute=compute)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    c_pack = counts()
    check(c_pack == expect(**want_pack),
          f"{compute} layer-wise build launches {c_pack}, want {want_pack}")
    check(count_packed(qparams) == want_count,
          f"{compute} count_packed {count_packed(qparams)}, want {want_count}")
    peak_build = torch.cuda.max_memory_allocated(dev) / 2**30
    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[moe] {cfg.name} ({compute}): {n} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, d_ff "
          f"{cfg.d_ff}; built layer by layer in {t_build:.1f} s, launches "
          f"{c_pack}, count_packed {count_packed(qparams)}; the packed tree "
          f"holds {held:.2f} GiB, build peak {peak_build:.2f} GiB ({card})")

    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                           dtype=torch.int32, device=dev)
    n_prompt = torch.full((BATCH,), PROMPT - 1, dtype=torch.int32,
                          device=dev)
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    decode_step(cfg, qparams, cache, prompts[:, -1:])          # warm-up
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    c_prefill = counts()
    check(c_prefill == expect(**want_prefill),
          f"{compute} prefill launches {c_prefill}, want {want_prefill}")
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
    check(c_decode == expect(**{k: NEW * v for k, v in want_step.items()}),
          f"{compute} decode launches {c_decode}, want {NEW} x {want_step}")
    check(tuple(logits.shape) == (BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), f"{compute} decode logits")
    check(cache["index"].tolist() == [PROMPT - 1 + NEW] * BATCH,
          cache["index"].tolist())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = t_decode / NEW * 1e3
    print(f"[moe] {compute} prefill {BATCH}x{PROMPT}: "
          f"{t_prefill * 1e3:.1f} ms ({BATCH * PROMPT / t_prefill:.1f} tok/s),"
          f" launches {c_prefill} ({card})")
    print(f"[moe] {compute} decode {NEW} steps at batch {BATCH}: "
          f"{step_ms:.1f} ms/step, {BATCH * NEW / t_decode:.1f} tok/s, "
          f"launches {c_decode}, peak memory {peak:.2f} GiB, sample "
          f"{torch.cat(gen, 1)[0].tolist()[:8]} ({card})")
    state = {"cache": {k: v.clone() for k, v in cache.items()}}

    def step():
        _, state["cache"] = decode_step(cfg, qparams, state["cache"], tok)
    banks = [[cfg.n_experts, cfg.d_model, cfg.d_ff],
             [cfg.n_experts, cfg.d_ff, cfg.d_model]]
    split = step_split(
        "moe", f"{compute} decode step at batch {BATCH}", step, step_ms,
        card, {"B7": "unpack_dequant_kernel", "B1": "sdv_gemv_kernel",
               "B2": "sdv_gemm_kernel"},
        {"expert GEMMs": lambda e: e.key == "aten::bmm"
         and len(e.input_shapes) > 1 and list(e.input_shapes[1]) in banks},
        shapes=True)
    del state

    reset_counts()
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    toks, dt = single_batch_loop(cfg, qparams, cache, prompts, NEW)
    c_loop = counts()
    steps = PROMPT + NEW - 1
    check(c_loop == expect(**{k: steps * v for k, v in want_step.items()}),
          f"{compute} single_batch_loop launches {c_loop}")
    check(toks.shape == (BATCH, NEW) and (toks >= 0).all()
          and (toks < cfg.vocab).all(), toks.shape)
    print(f"[moe] {compute} single_batch_loop: {dt / steps * 1e3:.1f} "
          f"ms/step, {BATCH * steps / dt:.1f} tok/s ({steps} steps), "
          f"launches {c_loop} ({card})")
    del qparams, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"pack": c_pack, "prefill": c_prefill, "decode": c_decode,
            "loop": c_loop, "step_ms": step_ms, "peak_gib": peak,
            "split": split}


def phase_moe(dev, card, flush):
    """Phase 13: the MoE family.  Frees what earlier phases left on the
    card, then runs ``moe_kernels`` at full-width phi3.5-moe's shapes,
    ``moe_card_vs_cpu`` and ``moe_serve`` in SDV and memory modes."""
    import torch
    from repro_torch.configs.registry import get_arch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    cfg = get_arch(MOE_ARCH)
    kern = moe_kernels(cfg, dev, flush, card)
    moe_card_vs_cpu(dev)
    runs = {compute: moe_serve(cfg, dev, card, compute)
            for compute in ("sdv", "memory")}
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")
    return {"kernels": kern, "runs": runs}


def family_layer_shapes(cfg):
    """(K, M) of one layer's projections and how often a decode step runs
    each: a seamless decoder layer (self q/k/v/o, cross q/o, the MLP) or
    a llava layer (q/k/v/o, the MLP)."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    shapes = {}
    for k, m, n in ((d, q, 1), (d, kv, 2), (q, d, 1), (d, f, 2), (f, d, 1)):
        shapes[k, m] = shapes.get((k, m), 0) + n
    if cfg.family == "encdec":
        shapes[d, q] += 1
        shapes[q, d] += 1
    return shapes


def family_launches(cfg, compute):
    """The launches the families phase expects of ``cfg`` in ``compute``
    mode: at packing, a decode step, a prefill step (vlm) and one
    ``forward``, and its ``count_packed``.  A seamless decode step runs 9
    projections a decoder layer (the cross attention's ``wk``/``wv`` are
    packed but the decode step never calls them: reference property (g)),
    its forward 7 an encoder layer and 11 a decoder layer; a llava step
    and forward 7 a layer.  SDV mode decodes the LM head in plain torch
    (no kernel); memory mode unpacks it with one B7 a step."""
    if cfg.family == "encdec":
        step = 9 * cfg.n_dec_layers
        fwd = 7 * cfg.n_enc_layers + 11 * cfg.n_dec_layers
        leaves = 7 + 11 + 1
    else:
        step = fwd = 7 * cfg.n_layers
        leaves = 7 + 1
    packed = {"memory": 0, "sdv": 0, "bseg": 0}
    packed[compute] = fwd + 1
    if compute == "sdv":
        return dict(pack={}, step=dict(B1=step), prefill=dict(B2=step),
                    forward=dict(B2=fwd), packed=packed)
    return dict(pack=dict(B6=leaves), step=dict(B7=step + 1),
                prefill=dict(B7=step), forward=dict(B7=fwd + 1),
                packed=packed)


def family_pack_shapes(cfg):
    """The [rows, columns] of every B6 call of ``cfg``'s memory-mode
    ``serve_params`` (one call a leaf: a stack of L layers' [K, M]
    kernels packs as [L * K, M]), and the LM head's [d, vocab_padded]."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.hd, cfg.n_kv * cfg.hd
    stacks = (cfg.n_enc_layers, cfg.n_dec_layers) \
        if cfg.family == "encdec" else (cfg.n_layers,)
    shapes = {(d, cfg.vocab_padded)}
    for n in stacks:
        shapes |= {(n * k, m) for k, m in ((d, q), (d, kv), (q, d), (d, f),
                                           (f, d))}
    return sorted(shapes)


def family_kernels(dev, flush, card):
    """B1 (8 rows) and B2 (128 rows) at every projection shape of a
    seamless decoder layer (d 1024, 16 heads of 64, d_ff 8192) and a llava
    layer (d 4096, K up to 14336) on the INT32 W4A8 plan, against the
    plain version and the exact product, beside their bound and
    ``_int_mm``; B6 at every leaf shape that memory-mode ``serve_params``
    packs of both models (``family_pack_shapes``: llava's largest, the
    stacked [32 x 14336, 4096] down leaf, holds 1.88e9 values, just under
    2^31), with B7's int8 unpack of its words; the fused B7 at every
    decode-step projection shape of both models and at both LM heads,
    against its plain version and the replaced route, twice.  Returns the
    B1/B2 sums over one layer's projections a decode step by arch, and
    the B6/B7 cases."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.quantized import default_sdv_plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    plan = default_sdv_plan(4, 8)
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_arch(arch)
        for kname, rows in (("B1", DECODE_ROWS), ("B2", PREFILL_ROWS)):
            acc = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, ops=0,
                       max_abs_err=0)
            for (k, m), mult in family_layer_shapes(cfg).items():
                r = sdv_case(kname, plan, "int32 W4A8 n=2", k, m, rows, gen,
                             flush)
                for key in ("ms", "plain_ms", "bytes", "ops"):
                    acc[key] += mult * r[key]
                acc["library_ms"] = None if r["library_ms"] is None \
                    or acc["library_ms"] is None \
                    else acc["library_ms"] + mult * r["library_ms"]
                acc["max_abs_err"] = max(acc["max_abs_err"],
                                         r["max_abs_err"])
            acc["bound_ms"], acc["bound_by"] = bound_ms(acc["bytes"],
                                                        acc["ops"])
            out[arch, kname] = acc
            print(f"[families] {kname} per {cfg.name} layer's "
                  f"{sum(family_layer_shapes(cfg).values())} decode "
                  f"projections at {rows} rows (int32 W4A8): "
                  f"{acc['ms']:.4f} ms (bound {acc['bound_ms']:.4f} ms by "
                  f"{acc['bound_by']}), plain {acc['plain_ms']:.1f} ms, "
                  f"_int_mm {acc['library_ms']} ms ({card})")
    per = 32 // MEMORY_BITS
    out["B6"], out["B7"] = {}, {}
    for arch, short in zip(FAMILY_ARCHS, ("seamless", "llava")):
        cfg = get_arch(arch)
        head = (cfg.d_model, cfg.vocab_padded)
        for m, n in family_pack_shapes(cfg):
            name = f"{short} LM head" if (m, n) == head \
                else f"{short} stack {m}x{n}"
            out["B6"][name] = packbits_case(m, n, MEMORY_BITS, gen, flush,
                                            f"{cfg.name} {name}")["B6"]
            gc.collect()
            torch.cuda.empty_cache()
        for k, n in [*family_layer_shapes(cfg), head]:
            name = f"{short} LM head" if (k, n) == head \
                else f"{short} {k}x{n}"
            out["B7"][name] = dequant_case(k, n // per, MEMORY_BITS, n, k,
                                           torch.bfloat16, gen, flush,
                                           f"{cfg.name} {name}", twice=True)
    return out


def family_card_vs_cpu(dev):
    """Reduced seamless-m4t-large-v2 and llava-next-mistral-7b in SDV and
    memory modes on the card against the same models on the CPU (plain
    kernel versions): ``forward`` (seamless on {src, tokens}, llava with
    its patches), llava's 5-token prefill, and
    ``FAMILY_REFERENCE_STEPS`` decode steps.  Logits within
    ``LOGIT_ATOL`` and ``index`` bit for bit; seamless's bf16
    self-attention K/V within one bf16 rounding of their scale
    (``CACHE_SCALE_RTOL``) and its cross caches all zero on both; llava's
    int8 K/V within one quantization step and their scales within
    ``CACHE_SCALE_RTOL``.  The entries that differ are counted."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, prefill_step, serve_params)
    cpu = torch.device("cpu")
    for arch in FAMILY_ARCHS:
        cfg = get_arch(arch).reduced()
        params = init_params(cfg, seed=1, device=cpu)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab, (3, 5))
        tokens = rng.integers(0, cfg.vocab, (FAMILY_REFERENCE_STEPS, 3, 1))
        extra = ({"src": (3, 7, cfg.d_model)} if cfg.family == "encdec"
                 else {"patches": (3, cfg.n_patches, cfg.d_model)})
        extra = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in extra.items()}
        kv = ("k", "v")
        for compute in ("sdv", "memory"):
            fwd, outs, caches = {}, {}, {}
            for d in (cpu, dev):
                q = serve_params(_to(params, d), bits=4, min_size=1024,
                                 compute=compute)
                i32 = dict(dtype=torch.int32, device=d)
                batch = {"tokens": torch.tensor(prompt, **i32),
                         **{k: torch.from_numpy(v).to(d)
                            for k, v in extra.items()}}
                fwd[d.type] = forward(cfg, q, batch).cpu()
                cache = init_cache(cfg, 3, 16, device=d)
                if cfg.family == "vlm":
                    cache = prefill_step(cfg, q, cache, batch["tokens"],
                                         torch.tensor([5, 3, 0], **i32))
                logits = []
                for t in tokens:
                    out, cache = decode_step(cfg, q, cache,
                                             torch.tensor(t, **i32))
                    logits.append(out.cpu())
                outs[d.type] = torch.stack(logits)
                caches[d.type] = {k: v.cpu() for k, v in cache.items()}
            err = float((outs["cuda"] - outs["cpu"]).abs().max())
            f_err = float((fwd["cuda"] - fwd["cpu"]).abs().max())
            check(err <= LOGIT_ATOL and f_err <= LOGIT_ATOL,
                  f"reduced {cfg.name} ({compute}) card vs CPU: decode "
                  f"logits {err}, forward {f_err} > {LOGIT_ATOL}")
            card, host = caches["cuda"], caches["cpu"]
            check(torch.equal(card["index"], host["index"]),
                  f"reduced {cfg.name} ({compute}): index card vs CPU")
            if cfg.family == "encdec":
                rel = {k: float((card[k].float() - host[k].float()).abs()
                                .max() / host[k].float().abs().max())
                       for k in kv}
                zero = all(not c[k].any() for c in (card, host)
                           for k in ("cross_k", "cross_v"))
                check(max(rel.values()) <= CACHE_SCALE_RTOL and zero,
                      f"reduced {cfg.name} ({compute}): bf16 K/V card vs "
                      f"CPU {rel} of their scale, cross caches zero {zero}")
                reading = (", ".join(f"{k} within {v:.3g} of its scale"
                                     for k, v in rel.items())
                           + "; cross_k/cross_v all zero on both")
            else:
                steps = {k: int((card[k].int() - host[k].int()).abs().max())
                         for k in kv}
                rel = {k: float(((card[k] - host[k]).abs()
                                 / host[k].abs().clamp_min(1e-30)).max())
                       for k in ("k_scale", "v_scale")}
                check(max(steps.values()) <= 1
                      and max(rel.values()) <= CACHE_SCALE_RTOL,
                      f"reduced {cfg.name} ({compute}): int8 caches card vs "
                      f"CPU: steps {steps}, scale rel {rel}")
                reading = (f"int8 steps {steps}, scales within "
                           + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
                           + " relative")
            differ = {k: (int((card[k] != host[k]).sum()), host[k].numel())
                      for k in host if k != "index"}
            print(f"[families] reduced {cfg.name} ({compute}), forward + "
                  f"{'prefill + ' if cfg.family == 'vlm' else ''}"
                  f"{FAMILY_REFERENCE_STEPS} decode steps, card vs CPU: max "
                  f"|dlogit| decode {err:.4g}, forward {f_err:.4g} "
                  f"(tolerance {LOGIT_ATOL}); index bit for bit; {reading}; "
                  "cache entries that differ (of all): "
                  + ", ".join(f"{k} {n} of {m}"
                              for k, (n, m) in differ.items()))


#: recurrentgemma-2b's projection shapes (K, M) as its SDV tree packs
#: them (``serve_params(compute="sdv", min_size=1024)``)
RGEMMA_SHAPES = ((2560, 256), (2560, 2560), (2560, 7680), (7680, 2560))
#: and mamba2-130m's
MAMBA2_SHAPES = ((768, 24), (768, 256), (768, 1536), (1536, 768))


def b2_case(plan, k, m, rows, gen, flush, plain=False):
    """B2 at ``rows`` on both of its kernels, random W4 weights [M, K] in
    ``plan``'s words: ``sdv_matmul.sdv_matmul`` on the activations in the
    container the serving path casts them to (``ops.sdv_operand_dtype``),
    which takes the wgmma kernel exactly where ``takes_wgmma`` says
    (``wgmma_launches`` moves by one there, by none elsewhere); the
    mma.sync kernel (``sdv_matmul.launch`` on int32 activations) and the
    wgmma kernel (``launch_wgmma`` on their byte container) each equal to
    the exact product, and with ``plain`` all three equal to the plain
    version on the card.  Returns CUDA-event ms of each kernel (the wgmma
    one through ``sdv_matmul`` where the dispatch takes it), of
    ``_int_mm`` and (with ``plain``) the plain version's host ms; the
    bytes of ``b2_roofline_pct``'s bound (A8 activations, W4 weights,
    bf16 outputs, each once) and the operations; which kernel the
    dispatch takes."""
    import torch
    from repro_torch.kernels import ops, ref, sdv_matmul
    w = torch.randint(-8, 8, (m, k), generator=gen, device=gen.device)
    words = ops.prepare_sdv_weights(w, plan)
    g = words.shape[-1]
    qmax = (1 << plan.w_b - 1) - 1
    x = torch.randint(-qmax, qmax + 1, (rows, k), generator=gen,
                      device=gen.device, dtype=torch.int32)
    x8 = sdv_matmul.wgmma_operand(x, plan)
    xs = x.to(ops.sdv_operand_dtype(rows, words, plan))
    wgmma = sdv_matmul.takes_wgmma(rows, g, plan)

    def old():
        return sdv_matmul.launch("sdv_gemm", x, words, plan, rows, k, g)

    def new():
        if wgmma:
            return sdv_matmul.sdv_matmul(xs, words, plan=plan)
        return sdv_matmul.launch_wgmma(x8, words, plan, rows, k, g)
    where = f"K={k} M={m} rows={rows}"
    wg0 = sdv_matmul.sdv_matmul.wgmma_launches
    got = sdv_matmul.sdv_matmul(xs, words, plan=plan)
    check(sdv_matmul.sdv_matmul.wgmma_launches - wg0 == int(wgmma),
          f"B2 at {where}: the dispatch did not take the "
          f"{'wgmma' if wgmma else 'mma.sync'} kernel")
    exact = ref.sdv_matmul_ref(x, w)
    outs = {"mma.sync": old(), "wgmma": new()}
    for name, out in outs.items():
        check(torch.equal(out.reshape(rows, -1)[:, :m], exact),
              f"B2 ({name}) != exact product at {where}")
    plain_ms = None
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = sdv_matmul.sdv_matmul_plain(x, words, plan)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for name, out in (("sdv_matmul", got), *outs.items()):
            check(torch.equal(out, want), f"B2 ({name}) != plain at {where}")
    return dict(old=event_ms(old, reps=5, flush=flush),
                new=event_ms(new, reps=5, flush=flush),
                library=int_mm_ms(x, w, flush), plain=plain_ms,
                bytes=x.numel() + m * k // 2 + rows * m * 2,
                ops=2 * rows * m * k, wgmma=wgmma)


def b2_many_rows(dev, flush, card):
    """B2's two kernels on a llava-next-mistral-7b layer (7 projections,
    INT32 W4A8) at ``B2_SWEEP_ROWS`` rows, each equal to the exact
    product, timed beside the bound (``b2_case``'s bytes, or int8
    operations), ``_int_mm`` and the plain version of the layer's k/v
    projection (4096 -> 1024, on the card): the sweep that sets
    ``sdv_matmul.WGMMA_MIN_ROWS``, the smallest swept row count from
    which the wgmma kernel is the faster on every shape (printed beside
    the constant); then ``b2_shapes``: recurrentgemma-2b's and
    mamba2-130m's four projection shapes at ``B2_MANY_ROWS`` rows and the
    UltraNet head's im2col GEMM, both kernels in this one run.  Returns
    the sweep by rows."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.datapath import DATAPATHS, plan_bseg
    from repro_torch.kernels import ops, sdv_matmul
    from repro_torch.models.quantized import default_sdv_plan
    from repro_torch.models.ultranet import ultranet_layer_shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(32)
    plan = default_sdv_plan(4, 8)
    cfg = get_arch(FAMILY_ARCHS[1])
    shapes = family_layer_shapes(cfg)
    sweep = {}
    for rows in B2_SWEEP_ROWS:
        acc = dict(old=0.0, new=0.0, library=0.0, bytes=0, ops=0)
        plain_ms = None
        for (k, m), mult in shapes.items():
            r = b2_case(plan, k, m, rows, gen, flush,
                        plain=(k, m) == (cfg.d_model,
                                         cfg.n_kv * cfg.hd))
            plain_ms = r["plain"] if r["plain"] is not None else plain_ms
            acc[k, m] = (r["old"], r["new"])
            print(f"[b2]   K={k} M={m} at {rows} rows: mma.sync "
                  f"{r['old']:.4f} ms, wgmma {r['new']:.4f} ms")
            for key in ("old", "new", "library", "bytes", "ops"):
                acc[key] += mult * r[key]
        acc["bound"], acc["bound_by"] = bound_ms(acc["bytes"], acc["ops"])
        acc["plain_kv"] = plain_ms
        acc["takes_wgmma"] = sdv_matmul.takes_wgmma(rows, cfg.d_model // 2,
                                                    plan)
        sweep[rows] = acc
        print(f"[b2] llava layer (7 projections, int32 W4A8) at {rows} rows:"
              f" mma.sync {acc['old']:.4f} ms, wgmma {acc['new']:.4f} ms "
              f"(bound {acc['bound']:.4f} ms by {acc['bound_by']}: "
              f"{acc['bound'] / acc['old']:.1%} / "
              f"{acc['bound'] / acc['new']:.1%}), _int_mm "
              f"{acc['library']:.4f} ms, plain (k/v projection alone) "
              f"{plain_ms:.1f} ms; the dispatch takes "
              f"{'wgmma' if acc['takes_wgmma'] else 'mma.sync'} ({card})")
    faster = [r for r in B2_SWEEP_ROWS
              if all(sweep[r][km][1] < sweep[r][km][0] for km in shapes)]
    crossover = next((r for r in B2_SWEEP_ROWS
                      if all(q in faster for q in B2_SWEEP_ROWS if q >= r)),
                     None)
    print(f"[b2] the wgmma kernel is the faster on every shape from "
          f"{crossover} rows of this sweep; sdv_matmul.WGMMA_MIN_ROWS = "
          f"{sdv_matmul.WGMMA_MIN_ROWS} ({card})")
    head = ultranet_layer_shapes(ULTRA_SIZE, ULTRA_SIZE)[-1]
    head_plan = ops._im2col_sdv_plan(plan_bseg(DATAPATHS["int32"], 4, 4))
    for name, cplan, rows, kms in (
            ("recurrentgemma-2b", plan, B2_MANY_ROWS, RGEMMA_SHAPES),
            ("mamba2-130m", plan, B2_MANY_ROWS, MAMBA2_SHAPES),
            ("UltraNet head (im2col plan)", head_plan,
             ULTRA_BATCH * head["h"] * head["w"],
             ((head["cin"], head["cout"]),))):
        b2_shapes(name, cplan, rows, kms, gen, flush, card)
    return sweep


def b2_shapes(name, plan, rows, kms, gen, flush, card):
    """``b2_case`` at each (K, M) of ``kms``: both kernels timed in this
    one run beside ``_int_mm``, the kernel the dispatch gives activations
    in their one-byte container (int32 ones always take mma.sync) and
    the faster one, and the sum over the shapes beside its bound."""
    tot = dict(old=0.0, new=0.0, library=0.0, bytes=0, ops=0)
    for k, m in kms:
        r = b2_case(plan, k, m, rows, gen, flush)
        for key in tot:
            tot[key] += r[key]
        print(f"[b2] {name} K={k} M={m} at {rows} rows: mma.sync "
              f"{r['old']:.4f} ms, wgmma {r['new']:.4f} ms, _int_mm "
              f"{r['library']:.4f} ms; one-byte activations take "
              f"{'wgmma' if r['wgmma'] else 'mma.sync'}, the faster is "
              f"{'wgmma' if r['new'] < r['old'] else 'mma.sync'} ({card})")
    b_ms, b_by = bound_ms(tot["bytes"], tot["ops"])
    print(f"[b2] {name}, one of each projection shape at {rows} rows: "
          f"mma.sync {tot['old']:.4f} ms, wgmma {tot['new']:.4f} ms "
          f"(bound {b_ms:.4f} ms by {b_by}: {b_ms / tot['old']:.1%} / "
          f"{b_ms / tot['new']:.1%}), _int_mm {tot['library']:.4f} ms "
          f"({card})")


def family_serve(cfg, dev, card, compute):
    """Full-width ``cfg`` from a seeded torch init packed by
    ``serve_params(compute=compute, min_size=1024)`` (the bf16 tree freed
    after packing), batch 8: llava's 16-token ``prefill_step`` of 8
    prompts, seamless's 15 prompt tokens replayed through ``decode_step``
    (encdec has no chunked prefill); 16 greedy decode steps; the serve
    CLI's ``single_batch_loop``; each with exactly ``family_launches``'
    kernels and no plain call; one decode step profiled (``step_split``:
    B1 or B7, the LM head's span ``HEAD_SPAN`` (the SDV head's decode and
    its product), the other bf16 GEMMs (``aten::mm``: the memory-mode
    projections; attention runs ``aten::bmm``)); then one
    ``forward(mode="last_logits")`` at
    ``FAMILY_FORWARD``.  Returns the counts, walls, peak memory and the
    split."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import single_batch_loop
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params, prefill_step, serve_params)
    from repro_torch.models.layers import mat
    from repro_torch.models.quantized import count_packed

    want = family_launches(cfg, compute)
    vlm = cfg.family == "vlm"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    qparams = serve_params(params, bits=4, min_size=1024, compute=compute)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    c_pack = counts()
    check(c_pack == expect(**want["pack"]),
          f"{cfg.name} {compute} packing launches {c_pack}, want "
          f"{want['pack']}")
    check(count_packed(qparams) == want["packed"],
          f"{cfg.name} {compute} count_packed {count_packed(qparams)}")
    if compute == "memory":
        packed = {(p.words.numel() // p.words.shape[-1],
                   p.words.shape[-1] * (32 // p.bits))
                  for _, p in packed_leaves(qparams)}
        check(packed == set(family_pack_shapes(cfg)),
              f"{cfg.name}: B6 packed {sorted(packed)}, but family_kernels "
              f"checks {family_pack_shapes(cfg)}")
    peak_build = torch.cuda.max_memory_allocated(dev) / 2**30
    held = torch.cuda.memory_allocated(dev) / 2**30
    print(f"[families] {cfg.name} ({compute}): {cfg.family}, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads ({cfg.n_kv} KV) of {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}); "
          f"seeded init + packing {t_build:.1f} s, launches {c_pack}, "
          f"count_packed {count_packed(qparams)}; the packed tree holds "
          f"{held:.2f} GiB, build peak {peak_build:.2f} GiB ({card})")

    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                           dtype=torch.int32, device=dev)
    n_prompt = torch.full((BATCH,), PROMPT - 1, dtype=torch.int32,
                          device=dev)

    def fill(cache):
        """The first PROMPT - 1 prompt tokens into a fresh cache."""
        if vlm:
            return prefill_step(cfg, qparams, cache, prompts, n_prompt)
        for i in range(PROMPT - 1):
            _, cache = decode_step(cfg, qparams, cache, prompts[:, i:i + 1])
        return cache

    cache = fill(init_cache(cfg, BATCH, PROMPT + NEW, device=dev))
    decode_step(cfg, qparams, cache, prompts[:, -1:])          # warm-up
    del cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    cache = fill(init_cache(cfg, BATCH, PROMPT + NEW, device=dev))
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    c_prefill = counts()
    want_fill = want["prefill"] if vlm else {
        k: (PROMPT - 1) * v for k, v in want["step"].items()}
    check(c_prefill == expect(**want_fill),
          f"{cfg.name} {compute} prompt launches {c_prefill}, want "
          f"{want_fill}")
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
    check(c_decode == expect(**{k: NEW * v for k, v in want["step"].items()}),
          f"{cfg.name} {compute} decode launches {c_decode}, want {NEW} x "
          f"{want['step']}")
    check(tuple(logits.shape) == (BATCH, 1, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name} {compute} decode logits")
    check(cache["index"].tolist() == [PROMPT - 1 + NEW] * BATCH,
          cache["index"].tolist())
    if not vlm:
        check(not cache["cross_k"].any() and not cache["cross_v"].any(),
              f"{cfg.name}: the cross cache was written")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    step_ms = t_decode / NEW * 1e3
    how = f"prefill {BATCH}x{PROMPT}" if vlm else \
        f"{PROMPT - 1} prompt tokens replayed by decode_step"
    print(f"[families] {cfg.name} {compute} {how}: "
          f"{t_prefill * 1e3:.1f} ms ({BATCH * (PROMPT - 1) / t_prefill:.1f} "
          f"tok/s), launches {c_prefill} ({card})")
    print(f"[families] {cfg.name} {compute} decode {NEW} steps at batch "
          f"{BATCH}: {step_ms:.1f} ms/step, {BATCH * NEW / t_decode:.1f} "
          f"tok/s, launches {c_decode}, peak memory {peak:.2f} GiB, sample "
          f"{torch.cat(gen, 1)[0].tolist()[:8]} ({card})")
    state = {"cache": {k: v.clone() for k, v in cache.items()}}

    def step():
        _, state["cache"] = decode_step(cfg, qparams, state["cache"], tok)
    split = step_split(
        "families", f"{cfg.name} {compute} decode step at batch {BATCH}",
        step, step_ms, card,
        {"B1": "sdv_gemv_kernel", "B7": "unpack_dequant_kernel"},
        {"LM head (decode, product)": lambda e: e.key == HEAD_SPAN,
         "bf16 GEMMs": lambda e: e.key == "aten::mm"})
    head_ms = None
    if compute == "sdv":
        head_ms = event_ms(lambda: mat(qparams["lm_head"], torch.bfloat16), 3)
        print(f"[families] {cfg.name} SDV LM head's plain-torch decode "
              f"(layers.mat of the [{cfg.d_model}, {cfg.vocab_padded}] "
              f"head, CUDA events): {head_ms:.3f} ms a call ({card})")
    del state, cache

    reset_counts()
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    toks, dt = single_batch_loop(cfg, qparams, cache, prompts, NEW)
    c_loop = counts()
    steps = PROMPT + NEW - 1
    check(c_loop == expect(**{k: steps * v for k, v in want["step"].items()}),
          f"{cfg.name} {compute} single_batch_loop launches {c_loop}")
    check(toks.shape == (BATCH, NEW) and (toks >= 0).all()
          and (toks < cfg.vocab).all(), toks.shape)
    print(f"[families] {cfg.name} {compute} single_batch_loop: "
          f"{dt / steps * 1e3:.1f} ms/step, {BATCH * steps / dt:.1f} tok/s "
          f"({steps} steps), launches {c_loop} ({card})")
    del cache

    b, s_in, s_tgt = FAMILY_FORWARD[cfg.name]
    frames = torch.randn((b, s_in, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    batch = {"tokens": prompts[:b].repeat(1, -(-s_tgt // PROMPT))[:, :s_tgt],
             ("patches" if vlm else "src"): frames}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        last = forward(cfg, qparams, batch, mode="last_logits")
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    c_fwd = counts()
    check(c_fwd == expect(**want["forward"]),
          f"{cfg.name} {compute} forward launches {c_fwd}, want "
          f"{want['forward']}")
    check(tuple(last.shape) == (b, 1, cfg.vocab_padded)
          and bool(torch.isfinite(last).all()),
          f"{cfg.name} {compute} forward logits {tuple(last.shape)}")
    rows = b * (s_in + s_tgt if vlm else s_tgt)
    print(f"[families] {cfg.name} {compute} forward(mode=\"last_logits\") "
          f"at batch {b}, {s_in} {'patches' if vlm else 'source frames'} + "
          f"{s_tgt} tokens ({rows} decoder rows): {t_fwd * 1e3:.1f} ms "
          f"(first call at these shapes), launches {c_fwd}, peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
          f"({card})")
    chunk = prefill_chunk_launches(cfg, qparams, dev, card) \
        if vlm and compute == "sdv" else None
    del qparams, last, frames
    gc.collect()
    torch.cuda.empty_cache()
    return {"pack": c_pack, "prefill": c_prefill, "decode": c_decode,
            "loop": c_loop, "forward": c_fwd, "step_ms": step_ms,
            "peak_gib": peak, "split": split, "head_ms": head_ms,
            "forward_ms": t_fwd * 1e3, "chunk": chunk}


def prefill_chunk_launches(cfg, qparams, dev, card):
    """One ``prefill_step`` of a prefill chunk as the benchmark's llava
    prefill cell runs it (``CHUNK_BATCH`` prompts x ``CHUNK_COLS``
    columns: B2 at 4096 rows) on a fresh cache: 7 B2 a layer, each on the
    wgmma kernel (``sdv_matmul.wgmma_launches``), nothing else and no
    plain call.  Returns the B2 and wgmma counts and the wall."""
    import torch
    from repro_torch.kernels import sdv_matmul
    from repro_torch.models import init_cache, prefill_step
    gen = torch.Generator(device=dev).manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (CHUNK_BATCH, CHUNK_COLS),
                           generator=gen, device=dev, dtype=torch.int32)
    n_valid = torch.full((CHUNK_BATCH,), CHUNK_COLS, dtype=torch.int32,
                         device=dev)

    def chunk():
        cache = init_cache(cfg, CHUNK_BATCH, CHUNK_COLS, device=dev)
        return prefill_step(cfg, qparams, cache, tokens, n_valid)
    chunk()                                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    wg0 = sdv_matmul.sdv_matmul.wgmma_launches
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    wgmma = sdv_matmul.sdv_matmul.wgmma_launches - wg0
    want = 7 * cfg.n_layers
    check(c == expect(B2=want) and wgmma == want,
          f"{cfg.name} prefill chunk launches {c}, wgmma {wgmma}, want "
          f"B2 = wgmma = {want}")
    print(f"[families] {cfg.name} SDV prefill_step of a {CHUNK_BATCH} x "
          f"{CHUNK_COLS} chunk ({CHUNK_BATCH * CHUNK_COLS} B2 rows): "
          f"{wall * 1e3:.1f} ms, launches {c}, of which on the wgmma kernel "
          f"{wgmma} ({card})")
    return {"B2": c["B2"], "wgmma": wgmma, "ms": wall * 1e3}


def phase_families(dev, card, flush):
    """Phase 14: the encdec and vlm families.  Frees what earlier phases
    left on the card, then runs ``family_kernels`` at full-width
    seamless-m4t-large-v2's and llava-next-mistral-7b's shapes,
    ``family_card_vs_cpu`` and ``family_serve`` of each in SDV and memory
    modes."""
    import torch
    from repro_torch.configs.registry import get_arch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    kern = family_kernels(dev, flush, card)
    kern["b2_rows"] = b2_many_rows(dev, flush, card)
    family_card_vs_cpu(dev)
    runs = {(arch, compute): family_serve(get_arch(arch), dev, card, compute)
            for arch in FAMILY_ARCHS for compute in ("sdv", "memory")}
    print(f"[families] phase {time.perf_counter() - t_phase:.1f} s")
    return {"kernels": kern, "runs": runs}


# ---------------------------------------------------------------------------
# phase 15: the ssm and hybrid full-sequence forward, packed QAT, oracles
# ---------------------------------------------------------------------------

def ssm_split(label, fn, wall_ms, card, tag="ssm"):
    """``step_split`` of one call of ``fn`` into B2, B4, B7, the SSD scan,
    the RG-LRU scan, the STE weight packing (the program's spans
    ``SSM_SPANS``) and the rest (the float GEMMs outside the scans among
    it)."""
    return step_split(
        tag, label, fn, wall_ms, card,
        {"B2": "sdv_gemm_kernel", "B4": "bseg_conv1d_kernel",
         "B7": "unpack_dequant_kernel"},
        {name: (lambda e, r=r: e.key == r)
         for name, r in zip(("SSD scan", "RG-LRU scan",
                             "prepare_sdv_weights"), SSM_SPANS)})


def ssm_card_vs_cpu(dev):
    """(a) Reduced mamba2-130m and recurrentgemma-2b ``forward`` at batch
    2 x 64 tokens (past the reduced window of 16) in float, SDV and
    memory mode on the card against the same call on the CPU: logits
    within ``LOGIT_ATOL``, ``loss_fn`` within ``SSM_LOSS_ATOL``.  Then the
    scans alone at full width: ``_ssd_chunked`` at mamba2-130m's heads
    (24 x 64, state 128, 4 chunks of 256) and ``_rglru_core`` at
    recurrentgemma-2b's d_rnn 2560 within ``SSM_SCAN_RTOL`` of the CPU
    (float32 einsums and GEMMs with TF32 off sum in another order; the
    card's exp and sigmoid round otherwise), ``associative_scan`` bit for
    bit (elementwise products and sums only)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import forward, init_params, serve_params
    from repro_torch.models import rglru, ssm
    from repro_torch.models.layers import Init
    from repro_torch.train.loop import loss_fn

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: the SSD's float32 einsums would round")
    cpu = torch.device("cpu")
    rng = np.random.default_rng(3)
    for arch in SSM_ARCHS:
        cfg = get_arch(arch).reduced()
        params = init_params(cfg, seed=1, device=cpu)
        toks = rng.integers(0, cfg.vocab, (2, 64))
        for compute in ("float", "sdv", "memory"):
            outs = []                           # the CPU's, the card's
            for d in (cpu, dev):
                p = _to(params, d)
                q = p if compute == "float" else serve_params(
                    p, bits=4, min_size=1024, compute=compute)
                batch = {"tokens": torch.tensor(toks, dtype=torch.int32,
                                                device=d)}
                with torch.no_grad():
                    outs.append((forward(cfg, q, batch).cpu(),
                                 float(loss_fn(cfg, q, batch))))
            (host, host_loss), (card, card_loss) = outs
            err = float((card - host).abs().max())
            dloss = abs(card_loss - host_loss)
            check(err <= LOGIT_ATOL and dloss <= SSM_LOSS_ATOL,
                  f"reduced {cfg.name} {compute} forward card vs CPU: "
                  f"|dlogit| {err}, |dloss| {dloss}")
            print(f"[ssm] reduced {cfg.name} {compute} forward at 2 x 64, "
                  f"card vs CPU: max |dlogit| {err:.4g} (tolerance "
                  f"{LOGIT_ATOL}), loss {card_loss:.6f} vs {host_loss:.6f} "
                  f"(|d| {dloss:.3g}, tolerance {SSM_LOSS_ATOL})")

    gen = torch.Generator().manual_seed(7)
    scfg = ssm.SSMConfig(d_model=768, d_inner=1536, n_heads=24,
                         d_state=128)
    b, s, h, p, n = 2, 4 * scfg.chunk, 24, scfg.head_dim, scfg.d_state
    ins = (torch.randn((b, s, h, p), generator=gen),
           torch.nn.functional.softplus(torch.randn((b, s, h), generator=gen)),
           -torch.exp(0.5 * torch.randn(h, generator=gen)),
           torch.randn((b, s, 1, n), generator=gen),
           torch.randn((b, s, 1, n), generator=gen))
    h0 = torch.randn((b, h, n, p), generator=gen)
    want = ssm._ssd_chunked(*ins, scfg, h0=h0)

    def rel_err():
        got = ssm._ssd_chunked(*(t.to(dev) for t in ins), scfg,
                               h0=h0.to(dev))
        return [float((a.cpu() - w).abs().max() / w.abs().max())
                for a, w in zip(got, want)]
    rel = rel_err()
    check(max(rel) <= SSM_SCAN_RTOL, f"_ssd_chunked card vs CPU {rel}")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        rel_tf32 = rel_err()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    check(max(rel_tf32) > SSM_SCAN_RTOL,
          f"_ssd_chunked with TF32 on is within the tolerance: {rel_tf32}")
    print(f"[ssm] _ssd_chunked at [{b}, {s}, {h}, {p}], state {n}, "
          f"{s // scfg.chunk} chunks of {scfg.chunk}: card vs CPU y, h_final "
          f"within {rel[0]:.3g}, {rel[1]:.3g} relative (tolerance "
          f"{SSM_SCAN_RTOL}; with TF32 on {rel_tf32[0]:.3g}, "
          f"{rel_tf32[1]:.3g})")

    a = torch.rand((2, 2048, 2560), generator=gen) * 0.5 + 0.5
    x = torch.randn((2, 2048, 2560), generator=gen)
    want = rglru.associative_scan(a, x)
    got = rglru.associative_scan(a.to(dev), x.to(dev))
    check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "associative_scan card != CPU")
    rcfg = rglru.RGLRUConfig(d_model=2560, d_rnn=2560)
    rp = rglru.rglru_init(Init(gen, cpu, torch.float32), rcfg)
    u = torch.randn((2, 512, 2560), generator=gen)
    r0 = torch.randn((2, 2560), generator=gen)
    yc, hc = rglru._rglru_core(rp, u, r0)
    yd, hd = rglru._rglru_core(_to(rp, dev), u.to(dev), r0.to(dev))
    rel = [float((a.cpu() - c).abs().max() / c.abs().max())
           for a, c in ((yd, yc), (hd, hc))]
    check(max(rel) <= SSM_SCAN_RTOL, f"_rglru_core card vs CPU {rel}")
    print(f"[ssm] associative_scan at [2, 2048, 2560] card == CPU bit for "
          f"bit; _rglru_core at [2, 512, 2560] from a state: y, h within "
          f"{rel[0]:.3g}, {rel[1]:.3g} relative (tolerance {SSM_SCAN_RTOL})")


def forward_bound(tree, rows):
    """The least time of one forward's packed work over ``rows``
    activation rows: the SDV GEMMs (B2: the int32 activations, words and
    lane outputs once each, 2 rows K M operations) and the memory-packed
    weights' unpacking (B7: the words and scales read, the bf16 weights
    written).  Returns (ms, what bounds it)."""
    from repro_torch.models import PackedLinear, SDVLinear
    nbytes = ops_n = 0

    def walk(node):
        nonlocal nbytes, ops_n
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (SDVLinear, PackedLinear)):
            layers = node.words.shape[0] if node.stacked else 1
            k, g = node.words.shape[-2], node.words.shape[-1]
            nbytes += node.words.numel() * 4
            if isinstance(node, SDVLinear):
                nbytes += layers * rows * (k + g * node.plan.n) * 4
                ops_n += layers * 2 * rows * k * node.d_out
            else:
                nbytes += node.scale.numel() * 4 + layers * k * node.d_out * 2
    walk(tree)
    return bound_ms(nbytes, ops_n)


def ssm_forward(cfg, dev, card, compute):
    """(b) Full-width ``cfg`` from a seeded init packed by
    ``serve_params(compute=compute, min_size=1024)`` (the bf16 tree
    freed), one ``forward(mode="last_logits")`` at ``SSM_FORWARD`` after
    a warm-up call: exactly the packed tree's B2 + B4 (SDV) or B7
    (memory) launches, no plain call; ms, peak memory and one profiled
    call's split."""
    import torch
    from repro_torch.models import forward, init_params, serve_params
    from repro_torch.models.quantized import count_packed

    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=0, device=dev)
    qparams = serve_params(params, bits=4, min_size=1024, compute=compute)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    packed = count_packed(qparams)
    per_step = RECURRENT_STEP[cfg.name]
    want = expect(B2=packed["sdv"], B4=packed["bseg"]) \
        if compute == "sdv" else expect(B7=packed["memory"])
    check(packed == ({"memory": 0, "sdv": per_step["B1"],
                      "bseg": per_step["B4"]} if compute == "sdv" else
                     {"memory": per_step["B1"], "sdv": 0, "bseg": 0}),
          f"{cfg.name} {compute} count_packed {packed}")
    b, s = SSM_FORWARD
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen,
                                     device=dev, dtype=torch.int32)}

    def run():
        with torch.no_grad():
            return forward(cfg, qparams, batch, mode="last_logits")
    run()                                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    last = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    c = counts()
    check(c == want, f"{cfg.name} {compute} forward launches {c}, want "
                     f"{want}")
    check(tuple(last.shape) == (b, 1, cfg.vocab_padded)
          and bool(torch.isfinite(last).all()),
          f"{cfg.name} {compute} forward logits")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[ssm] {cfg.name} {compute} forward(mode=\"last_logits\") at "
          f"batch {b} x {s} tokens ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}): {ms:.1f} ms, launches "
          f"{ {k: v for k, v in c.items() if v} }, peak memory {peak:.2f} "
          f"GiB ({card})")
    split = ssm_split(f"{cfg.name} {compute} forward at {b} x {s}", run, ms,
                      card)
    kname = "B2" if compute == "sdv" else "B7"
    b_ms, b_by = forward_bound(qparams, b * s)
    if split is not None:
        print(f"[ssm] {cfg.name} {compute} forward: {kname}'s "
              f"{split[kname]:.3f} ms against its bound {b_ms:.3f} ms by "
              f"{b_by} ({b_ms / split[kname]:.1%}) ({card})")
    del qparams, last
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": c, "ms": ms, "peak_gib": peak, "split": split,
            "bound_ms": b_ms, "bound_by": b_by}


def remat_loops(cfg):
    """The layer loops of ``cfg``'s full-sequence forward: (the stacks one
    remat unit draws on, whether the loop groups under ``remat_group``),
    as ``models.transformer.forward`` runs them."""
    if cfg.family in ("dense", "moe", "vlm"):
        me = cfg.moe_every if cfg.family == "moe" else 1
        return [(("blocks",) + tuple(f"blocks_dense{j}"
                                     for j in range(1, me)), True)]
    if cfg.family == "ssm":
        return [(("blocks",), True)]
    if cfg.family == "hybrid":
        return [(("groups",), True), (("tail",), False)]
    return [(("enc_blocks",), True), (("dec_blocks",), True)]


def qat_launches(params, cfg):
    """B2 launches of one microbatch: (its forward, its forward and
    backward).  The forward makes one a wrapped projection and layer.
    The backward recomputes as ``cfg``'s remat says: under ``cfg.remat``
    every block once more; under ``remat_group = g`` (the JAX package's
    condition) every group once more, which stops at its last block's
    input when the blocks are rematerialized (``torch.utils.checkpoint``
    stops a recompute once it has every tensor it saved; the last block's
    input is the group's last) and at its last block's saved tensors
    otherwise; the LM head runs once."""
    from repro_torch.train.qat import is_qat

    def walk(t):
        if is_qat(t):
            return t.kernel.shape[0] if t.kernel.ndim == 3 else 1
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        return 0

    def per_layer(t):
        if is_qat(t):
            return 1
        if isinstance(t, dict):
            return sum(per_layer(v) for v in t.values())
        return 0
    forward = walk(params)
    step, g = forward, cfg.remat_group
    for keys, grouped in remat_loops(cfg):
        stacks = [params[k] for k in keys if k in params]
        if not stacks or not per_layer(stacks[0]):
            continue
        n = walk(stacks[0]) // per_layer(stacks[0])       # the loop's units
        unit = sum(per_layer(st) for st in stacks)
        if cfg.remat:
            step += n * unit
        if grouped and cfg.scan_layers and 1 < g < n and n % g == 0:
            step += (n // g) * (g - 1) * unit if cfg.remat else n * unit
    return forward, step


def qat_run(arch, dev, card, *, steps, ckpt_step=None, export=False,
            remat_check=False, tag="ssm"):
    """``run_qat`` of full-width ``arch`` with the launcher's ``--qat``
    defaults (W4A8, plan_policy "auto", batch 8 x 128 in 2 microbatches
    of 512 rows, so B2) for ``ckpt_step`` steps saving a checkpoint, then
    the remaining steps from memory (without ``ckpt_step``: all ``steps``
    in ``run_qat``): finite losses, every wrapped leaf on the planner's
    plan, exactly 2 x the wrapped projections' B2 a step and one
    microbatch's an eval batch, nothing else; step walls, peak memory,
    one profiled step's split.  With a checkpoint: restored bit for bit,
    the last step run from it with the same loss.  With ``export``: the
    trained tree exported (``export_for_serving``) evaluates within
    ``EXPORT_ATOL`` of the QAT eval (B2) and decodes through
    ``single_batch_loop`` (B1, and B4 on the short convs).  With
    ``remat_check``: one more step from the run's last state, on the
    registry's remat and with ``remat=False``, bit for bit alike in the
    loss and every updated parameter, and their walls."""
    import dataclasses
    import math
    import shutil
    import statistics

    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.launch.serve import single_batch_loop
    from repro_torch.models import init_cache
    from repro_torch.models.quantized import (PLANNER_DECODE_ROWS,
                                              count_packed, is_sdv)
    from repro_torch.planner import choose_plan, matmul_spec
    from repro_torch.train import checkpoint, loop
    from repro_torch.train.qat import (QATRunConfig, evaluate,
                                       export_for_serving, is_qat, run_qat)

    gc.collect()
    torch.cuda.empty_cache()
    ckpt = ROOT / "build" / "qat_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    qcfg = QATRunConfig(arch=arch, smoke=False, steps=ckpt_step or steps,
                        global_batch=QAT_BATCH, seq=QAT_SEQ,
                        microbatches=QAT_MICRO, plan_policy="auto",
                        ckpt_dir=str(ckpt) if ckpt_step else None,
                        eval_batches=1, device=str(dev))
    snaps = []

    def sync(_):
        torch.cuda.synchronize(dev)
        snaps.append(counts())
    out = {}
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        res = run_qat(qcfg, sync=sync, log=lambda m: print(f"[{tag}] {m}"))
        wall = time.perf_counter() - t0
        c_run = counts()
        cfg, ocfg, data = res["cfg"], res["ocfg"], res["data"]
        losses = list(res["losses"])
        step_ms = [t * 1e3 for t in res["step_times"]]
        params = res["params"]
        if ckpt_step:
            def on_step(s, p, o, m, dt, mon):
                losses.append(float(m["loss"]))
                step_ms.append(dt * 1e3)
            params, _, _, _ = loop.run_training(
                cfg, ocfg, res["params"], res["opt"], data, steps=steps,
                start=ckpt_step, microbatches=QAT_MICRO, sync=sync,
                on_step=on_step)
        c_total = counts()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        per_mb, per_mb_step = qat_launches(params, cfg)
        n_run = ckpt_step or steps
        check(len(losses) == steps and all(math.isfinite(x) for x in losses)
              and math.isfinite(res["qat_eval"]),
              f"{arch} QAT losses {losses}, eval {res['qat_eval']}")
        zero = dict.fromkeys(c_total, 0)
        c_eval = _sub_counts(c_run, snaps[n_run - 1])
        steps_c = [_sub_counts(b, a) for a, b in zip(
            [zero] + snaps[:n_run - 1] + [c_run], snaps)]
        for i, c in enumerate(steps_c):
            check(c == expect(B2=QAT_MICRO * per_mb_step),
                  f"{arch} QAT step {i + 1} launches {c}, want B2="
                  f"{QAT_MICRO * per_mb_step} ({QAT_MICRO} microbatches x "
                  f"{per_mb} forward + recompute {per_mb_step - per_mb})")
        check(c_eval == expect(B2=per_mb), f"{arch} QAT eval {c_eval}")
        wrapped = {}

        def walk(t, path):
            if is_qat(t):
                wrapped[path] = t
            elif isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}/{k}" if path else k)
        walk(params, "")
        check(len(wrapped) == res["qat_layers"], sorted(wrapped))
        for path, c in wrapped.items():
            plan = choose_plan(matmul_spec(
                path, PLANNER_DECODE_ROWS, c.kernel.shape[-2],
                c.kernel.shape[-1], w_bits=4, a_bits=8)).plan
            check(c.plan == plan and c.use_kernel,
                  f"{arch} {path}: plan {c.plan}, planner {plan}")
        plans = {c.plan for c in wrapped.values()}
        print(f"[{tag}] run_qat({cfg.name}: {cfg.n_layers} layers, "
              f"{sum(x.numel() for x in tree.leaves(params)) / 1e9:.3f}e9 "
              f"parameters; {QAT_BATCH}x{QAT_SEQ} tokens in {QAT_MICRO} "
              f"microbatches of {QAT_ROWS} rows; {len(wrapped)} wrapped "
              f"leaves = {per_mb} projections a microbatch's forward, "
              f"{per_mb_step} with its backward's recompute (remat "
              f"{cfg.remat}, remat_group {cfg.remat_group}), on "
              f"{sorted(f'{p.spec.name} n={p.n}' for p in plans)}) "
              f"{wall:.1f} s with its evals"
              f"{' and checkpoint' if ckpt_step else ''}; losses "
              f"{[round(x, 4) for x in losses]}, qat eval "
              f"{res['qat_eval']:.4f} (float init "
              f"{res['float_eval_at_init']:.4f}); step walls "
              f"{[round(t, 1) for t in step_ms]} ms; launches a step "
              f"{steps_c[0]}, an eval batch {c_eval}; peak memory "
              f"{peak:.2f} GiB ({card})")
        out.update(b2_run=c_total["B2"], b2_eval=c_eval["B2"],
                   per_mb=per_mb, per_mb_step=per_mb_step,
                   step_ms=step_ms, peak_gib=peak,
                   losses=losses, plans=plans, qat_layers=len(wrapped))

        step_fn = loop.make_train_step(cfg, ocfg, microbatches=QAT_MICRO)
        batch = data.device_batch(steps, dev)
        wall_ms = statistics.median(step_ms[1:] or step_ms)
        out["split"] = ssm_split(
            f"{cfg.name} QAT train step ({QAT_MICRO} x {QAT_ROWS} rows)",
            lambda: step_fn(params, res["opt"], batch), wall_ms, card,
            tag=tag)
        if remat_check:
            runs = {}
            for name, c in (("remat", cfg), ("off", dataclasses.replace(
                    cfg, remat=False, remat_group=0))):
                fn = loop.make_train_step(c, ocfg, microbatches=QAT_MICRO)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                new_p, _, m = fn(params, res["opt"], batch)
                torch.cuda.synchronize(dev)
                runs[name] = (m["loss"], tree.leaves(new_p),
                              (time.perf_counter() - t0) * 1e3)
                del new_p, m
            (la, pa, ma), (lb, pb, mb) = runs["remat"], runs["off"]
            check(same_bits(la, lb) and all(
                same_bits(a, b) for a, b in zip(pa, pb)),
                f"{arch} QAT step: remat loss {float(la)!r}, remat=False "
                f"{float(lb)!r}, or an updated parameter differs")
            print(f"[{tag}] {cfg.name} QAT step from the run's last state: "
                  f"remat (remat_group {cfg.remat_group}) loss "
                  f"{float(la)!r} == remat=False {float(lb)!r}, all "
                  f"{len(pa)} updated parameter leaves bit for bit; walls "
                  f"{ma:.1f} / {mb:.1f} ms ({card})")
            out["remat_vs_off_ms"] = (ma, mb)
            del runs, pa, pb

        if ckpt_step:
            check(checkpoint.latest_step(str(ckpt)) == ckpt_step,
                  sorted(p.name for p in ckpt.iterdir()))
            t0 = time.perf_counter()
            (p_r, o_r), _ = checkpoint.restore(str(ckpt), ckpt_step,
                                               (res["params"], res["opt"]))
            t_restore = time.perf_counter() - t0
            saved = tree.leaves((res["params"], res["opt"]))
            check(all(same_bits(a, b) for a, b in
                      zip(saved, tree.leaves((p_r, o_r)))),
                  f"{arch}: restored checkpoint != the saved state")
            del res
            resumed = []
            reset_counts()
            p_b, _, _, _ = loop.run_training(
                cfg, ocfg, p_r, o_r, data, steps=steps, start=ckpt_step,
                microbatches=QAT_MICRO, on_step=lambda s, p, o, m, dt, mon:
                resumed.append(float(m["loss"])))
            c_b = counts()
            del o_r
            check(c_b == expect(
                B2=(steps - ckpt_step) * QAT_MICRO * per_mb_step),
                f"{arch} resumed launches {c_b}")
            check(resumed == losses[ckpt_step:], f"{arch} step {steps} loss "
                  f"resumed {resumed} != from memory {losses[ckpt_step:]}")
            pa, pb = tree.leaves(params), tree.leaves(p_b)
            n_same = sum(same_bits(a, b) for a, b in zip(pa, pb))
            print(f"[{tag}] {cfg.name} checkpoint of step {ckpt_step}: "
                  f"{len(saved)} leaves restored bit for bit "
                  f"({t_restore:.1f} s); step {steps} from it: loss "
                  f"{resumed[0]!r} == from memory {losses[ckpt_step]!r}; "
                  f"{n_same} of {len(pa)} parameter leaves bit-equal after "
                  f"it; launches {c_b}")
            out["b2_resume"] = c_b["B2"]
            del p_b, p_r
        else:
            del res

        if export:
            served = export_for_serving(qcfg, params)
            packed = count_packed(served)
            # projections a step: the SDV containers but an SDV LM head,
            # which layers.mat decodes in plain torch
            n_proj = packed["sdv"] - is_sdv(served.get("lm_head"))
            reset_counts()
            served_eval = evaluate(cfg, served, data, batches=1,
                                   offset=qcfg.eval_offset)
            c_serve = counts()
            qat_eval = evaluate(cfg, params, data, batches=1,
                                offset=qcfg.eval_offset)
            check(c_serve == expect(B2=n_proj, B4=packed["bseg"]),
                  f"{arch} served eval launches {c_serve}")
            check(abs(served_eval - qat_eval) < EXPORT_ATOL,
                  f"{arch} served eval {served_eval} vs qat eval {qat_eval}")
            p_len, n_new = QAT_DECODE
            prompts = torch.tensor(np.random.default_rng(0).integers(
                0, cfg.vocab, (BATCH, p_len)), dtype=torch.int32,
                device=dev)
            reset_counts()
            toks, _ = single_batch_loop(cfg, served, init_cache(
                cfg, BATCH, p_len + n_new, device=dev), prompts, n_new)
            c_dec = counts()
            n_steps = p_len + n_new - 1
            check(c_dec == expect(B1=n_steps * n_proj,
                                  B4=n_steps * packed["bseg"]),
                  f"{arch} exported decode launches {c_dec}, packed "
                  f"{packed}")
            check(toks.shape == (BATCH, n_new) and (toks >= 0).all()
                  and (toks < cfg.vocab).all(), toks.shape)
            print(f"[{tag}] {cfg.name} step-{steps} params exported to SDV "
                  f"serving (count_packed {packed}): eval {served_eval:.4f} "
                  f"vs QAT {qat_eval:.4f} (|diff| "
                  f"{abs(served_eval - qat_eval):.4f} < {EXPORT_ATOL}), "
                  f"launches {c_serve}; single_batch_loop {p_len}+{n_new} "
                  f"tokens at batch {BATCH}: launches "
                  f"{ {k: v for k, v in c_dec.items() if v} }, sample "
                  f"{toks[0].tolist()}")
            out.update(b2_export_eval=c_serve["B2"],
                       b4_export_eval=c_serve["B4"], b1_decode=c_dec["B1"],
                       b4_decode=c_dec["B4"])
            del served
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def hybrid_qat_depth(cfg):
    """The largest depth 3g + 2 (g groups and the 2 trailing layers) of
    ``cfg`` whose reckoned QAT peak, ``QAT_BYTES_PER_PARAM`` bytes a
    parameter, is under ``QAT_PEAK_LIMIT_GIB``: (layers, parameters,
    reckoned GiB) of it and of the full depth."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.models import init_params

    def reckon(n):
        c = dataclasses.replace(cfg, n_layers=n)
        p = sum(x.numel() for x in tree.leaves(init_params(c, device="meta")))
        return n, p, p * QAT_BYTES_PER_PARAM / 2**30
    full = reckon(cfg.n_layers)
    fits = [reckon(n) for n in range(cfg.n_layers - 3 * (cfg.n_layers // 3),
                                     cfg.n_layers + 1, 3)]
    return max(r for r in fits if r[2] < QAT_PEAK_LIMIT_GIB), full


def ssm_oracles(dev, flush):
    """(e) The int64 oracles on the card, bit for bit against the kernels
    that implement them: ``core.sdv.sdv_matvec`` (torch int64 words on
    the card) against ``ops.packed_matmul`` at 8 rows (B1; B2 for
    unsigned storage, which B1 does not take) and 16 (B2) on the same
    integers (M 64, K 96) on INT32 n=2, DSP48E2 n=3 and DSP58 W4A8 plans
    with signed and unsigned weight storage;
    ``core.bseg.bseg_conv1d`` against ``ops.bseg_conv1d`` (B4) at C 37, S
    64 on the four W4A4 plans, both against the exact conv; UltraNet
    ``mode="bseg_jnp"`` against ``mode="bseg"`` at 32x32, batch 1."""
    import torch
    from repro_torch.core import bseg as cbseg
    from repro_torch.core import sdv as csdv
    from repro_torch.core.datapath import DATAPATHS, plan_bseg, plan_sdv
    from repro_torch.kernels import ops, ref
    from repro_torch.models import ultranet

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(9)
    m, k = ORACLE_SDV_SHAPE
    cases = []
    for spec in ("int32", "dsp48e2", "dsp58"):
        for signed in (True, False):
            plan = plan_sdv(DATAPATHS[spec], 4, 8, signed_a=signed,
                            signed_b=True, park_sign_bits=signed)
            lo = -8 if signed else 0
            w = torch.randint(lo, lo + 16, (m, k), generator=gen,
                              device=dev, dtype=torch.int64)
            words = ops.prepare_sdv_weights(w, plan)
            for rows in (DECODE_ROWS, 2 * DECODE_ROWS):
                # the dispatch's kernel: B1 up to 8 rows of a signed-storage
                # plan, else B2 (B1 stores signed elements only)
                kname = {"sdv_matvec": "B1", "sdv_matmul": "B2"}[
                    ops.select_packed_route(rows, plan=plan)]
                x = torch.randint(-128, 128, (rows, k), generator=gen,
                                  device=dev, dtype=torch.int64)
                reset_counts()
                y = ops.packed_matmul(x.to(torch.int32), words, plan=plan,
                                      m=m)
                c = counts()
                check(c == expect(**{kname: 1}),
                      f"packed_matmul at {rows} rows on {spec} n={plan.n} "
                      f"signed storage {signed} launched {c}, want "
                      f"{kname}")
                oracle = torch.stack([csdv.sdv_matvec(w, xr, plan)
                                      for xr in x])
                exact = ref._exact_int_matmul(x, w.T)
                check(torch.equal(oracle.long(), y.long())
                      and torch.equal(y.long(), exact.long()),
                      f"sdv_matvec oracle != {kname} on {spec} n={plan.n} "
                      f"signed storage {signed}")
            storage = "signed" if signed else "unsigned"
            cases.append(f"{spec} n={plan.n} {storage}")
    print(f"[ssm] core.sdv.sdv_matvec (int64 words on the card) == "
          f"packed_matmul at 8 rows (B1; B2 on unsigned storage) and 16 "
          f"rows (B2) == the exact product bit for bit at M {m}, K {k} on "
          f"W4A8 {cases}")
    c_, s_, n_ = ORACLE_CONV_SHAPE
    for spec in CONV_SPECS:
        plan = plan_bseg(DATAPATHS[spec], 4, 4)
        taps = torch.randint(-8, 8, (c_, n_), generator=gen, device=dev,
                             dtype=torch.int32)
        xq = torch.randint(-8, 8, (2, s_, c_), generator=gen, device=dev,
                           dtype=torch.int32)
        kappa, tap_sum = ops.prepare_bseg_taps(taps, plan)
        reset_counts()
        y = ops.bseg_conv1d(xq, kappa, tap_sum, plan=plan, n_taps=n_,
                            zero_point=8)
        check(counts() == expect(B4=1), f"ops.bseg_conv1d {counts()}")
        x_in = torch.nn.functional.pad(xq.permute(0, 2, 1), (n_ - 1, 0))
        oracle = cbseg.bseg_conv1d(taps[None].expand(2, c_, n_), x_in, plan,
                                   input_zero_point=8).permute(0, 2, 1)
        exact = ref.conv1d_ref(xq, taps, n_ - 1)
        check(torch.equal(oracle.long(), y.long())
              and torch.equal(y.long(), exact.long()),
              f"core.bseg.bseg_conv1d != B4 on {spec}")
    print(f"[ssm] core.bseg.bseg_conv1d (int64 words on the card, float32 "
          f"on fp32m) == B4 == the exact causal conv bit for bit at batch "
          f"2, C {c_}, S {s_}, {n_} taps on W4A4 {list(CONV_SPECS)}")
    params = ultranet.init_ultranet(0, device=dev)
    img = torch.randint(0, 16, (1, 32, 32, 3), generator=gen, device=dev)
    jnp_out = ultranet.ultranet_forward(params, img, mode="bseg_jnp",
                                        device=dev)
    bseg_out = ultranet.ultranet_forward(params, img, mode="bseg",
                                         device=dev)
    check(torch.equal(jnp_out.long(), bseg_out.long()),
          "UltraNet bseg_jnp != bseg on the card")
    print(f"[ssm] UltraNet-INT4 mode=\"bseg_jnp\" == mode=\"bseg\" at 32x32, "
          f"batch 1, bit for bit; oracles {time.perf_counter() - t0:.1f} s")


def phase_ssm_train(dev, card, flush):
    """Phase 15: the ssm and hybrid families' full-sequence forward and
    packed QAT, and the oracles.  Frees what earlier phases left on the
    card, then (a) ``ssm_card_vs_cpu``, (b) ``ssm_forward`` of full-size
    mamba2-130m and full-width recurrentgemma-2b in SDV and memory mode,
    (c) ``qat_run`` of full-size mamba2-130m (3 steps, a checkpoint at
    step 2, the export evaluated and decoded), (d) ``qat_run`` of
    recurrentgemma-2b at full width, cut to the depth
    ``hybrid_qat_depth`` reckons (2 steps), (e) ``ssm_oracles``."""
    import dataclasses

    import torch
    from repro_torch.configs import registry
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ssm_card_vs_cpu(dev)
    forwards = {(arch, compute): ssm_forward(registry.get_arch(arch), dev,
                                             card, compute)
                for arch in SSM_ARCHS for compute in ("sdv", "memory")}
    mamba = qat_run(SSM_ARCHS[0], dev, card, steps=QAT_STEPS,
                    ckpt_step=QAT_CKPT_STEP, export=True)
    rg = registry.get_arch(SSM_ARCHS[1])
    (n, params, gib), full = hybrid_qat_depth(rg)
    cut = dataclasses.replace(rg, name=f"{rg.name}-qat{n}", n_layers=n)
    print(f"[ssm] {rg.name} QAT depth: the full {full[0]} layers hold "
          f"{full[1] / 1e9:.3f}e9 parameters, reckoned {full[2]:.1f} GiB at "
          f"{QAT_BYTES_PER_PARAM:.2f} bytes a parameter (the train phase's "
          f"tinyllama peak over its parameters); cut to {n} layers "
          f"({n // 3} groups "
          f"and {n % 3} trailing), {params / 1e9:.3f}e9 parameters, reckoned "
          f"{gib:.1f} GiB < {QAT_PEAK_LIMIT_GIB} GiB")
    registry.ARCHS[cut.name] = cut
    registry.ALIASES[cut.name] = cut.name
    try:
        hybrid = qat_run(cut.name, dev, card, steps=2)
    finally:
        del registry.ARCHS[cut.name], registry.ALIASES[cut.name]
    hybrid["n_layers"] = n
    ssm_oracles(dev, flush)
    print(f"[ssm] phase {time.perf_counter() - t_phase:.1f} s")
    return {"forward": forwards, "mamba_qat": mamba, "hybrid_qat": hybrid}


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dist_grad_compress(mesh, dev):
    """(a): the compressed all-reduce over a full-width tinyllama-1.1b
    gradient tree on the card, packed and unpacked, and on a slice
    against the CPU."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import init_params
    from repro_torch.train import grad_compress as gc_mod
    shapes = tree.leaves(init_params(get_arch("tinyllama-1.1b"),
                                     device="meta"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    grads = [torch.randn(s.shape, generator=gen, device=dev) * 1e-3
             for s in shapes]
    errs = [torch.zeros_like(g) for g in grads]
    n_values = sum(g.numel() for g in grads)
    out, ms = {}, {}
    for pack in (True, False):
        gh, ne = gc_mod.compressed_allreduce(grads, errs, mesh,
                                             pack_words=pack)   # warm
        del gh, ne
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        gh, ne = gc_mod.compressed_allreduce(grads, errs, mesh,
                                             pack_words=pack)
        torch.cuda.synchronize(dev)
        ms[pack] = (time.perf_counter() - t0) * 1e3
        out[pack] = (gh, ne)
    for (gp, ep), (gu, eu) in zip(zip(*out[True]), zip(*out[False])):
        check(same_bits(gp, gu) and same_bits(ep, eu),
              "dist: packed != unpacked compressed all-reduce")
    # the card against the CPU on a slice (a one-rank gloo group)
    g = grads[0].reshape(-1)[:DIST_SLICE]
    e = (torch.randn(g.shape, generator=gen, device=dev) * 1e-4)
    cpu_group = dist.new_group(ranks=[0], backend="gloo")
    card = gc_mod.compress_psum(g, e, mesh.get_group("data"))
    cpu = gc_mod.compress_psum(g.cpu(), e.cpu(), cpu_group)
    check(all(same_bits(a.cpu(), b) for a, b in zip(card, cpu)),
          "dist: compressed all-reduce on the card != the CPU")
    packed_bytes = sum(-(-g.numel() // 2) * 4 for g in grads)
    res = {"values": n_values, "packed_ms": ms[True],
           "unpacked_ms": ms[False], "packed_wire_bytes": packed_bytes,
           "unpacked_wire_bytes": 4 * n_values}
    print(f"[dist] compressed all-reduce over {len(grads)} tinyllama "
          f"gradient leaves ({n_values / 1e9:.3f}e9 values): packed "
          f"{ms[True]:.1f} ms, {packed_bytes / 1e9:.3f} GB on the wire; "
          f"unpacked int32 {ms[False]:.1f} ms, {4 * n_values / 1e9:.3f} GB; "
          f"packed == unpacked bit for bit; card == CPU bit for bit on "
          f"{g.numel()} values")
    del grads, errs, out
    return res


def dist_train(dev, card):
    """(b): the launcher's --mesh 1,1 run and the same steps without a
    mesh; the mesh checkpoint restored into the plain layout."""
    import shutil

    import torch
    from repro_torch import tree
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint, loop
    ckpt = ROOT / "build" / "dist_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # the launcher's emergency-checkpoint handler holds the run's state:
    # restored after it, so the state is freed
    sigterm = signal.getsignal(signal.SIGTERM)
    try:
        mesh_run = launcher.main(["--arch", "tinyllama-1.1b", "--mesh",
                                  "1,1", "--steps", str(DIST_STEPS),
                                  "--device", str(dev), "--ckpt-dir",
                                  str(ckpt)])
    finally:
        signal.signal(signal.SIGTERM, sigterm)
    mesh_s = time.perf_counter() - t0
    mesh_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    mesh_params = [x.full_tensor() for x in tree.leaves(mesh_run["params"])]
    del mesh_run["params"], mesh_run["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    cfg, ocfg, params, opt, data = loop.init_run(
        "tinyllama-1.1b", steps=DIST_STEPS, device=dev)
    plain = {"losses": [], "step_s": []}

    def on_step(s, p, o, m, dt, mon):
        plain["losses"].append(float(m["loss"]))
        plain["step_s"].append(dt)
    params, opt, _, _ = loop.run_training(
        cfg, ocfg, params, opt, data, steps=DIST_STEPS, microbatches=2,
        on_step=on_step)
    plain_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    plain_own = plain_peak - held / 2**30
    losses = mesh_run["losses"]
    check(len(losses) == DIST_STEPS
          and all(math.isfinite(x) for x in losses + plain["losses"]),
          f"dist: losses {losses} / {plain['losses']}")
    diff = max(abs(a - b) for a, b in zip(losses, plain["losses"]))
    check(diff <= DIST_LOSS_ATOL,
          f"dist: mesh losses {losses} vs plain {plain['losses']}")
    t0 = time.perf_counter()
    (restored, _), _ = checkpoint.restore(str(ckpt), DIST_STEPS,
                                          (params, opt))
    restore_s = time.perf_counter() - t0
    got = tree.leaves(restored)
    check(len(got) == len(mesh_params) and all(
        same_bits(a, b) for a, b in zip(got, mesh_params)),
        "dist: the mesh checkpoint does not restore bit for bit")
    shutil.rmtree(ckpt, ignore_errors=True)
    res = {"mesh_losses": losses, "plain_losses": plain["losses"],
           "loss_diff": diff,
           "mesh_step_ms": [t * 1e3 for t in mesh_run["step_s"]],
           "plain_step_ms": [t * 1e3 for t in plain["step_s"]],
           "mesh_peak_gib": mesh_peak, "plain_peak_gib": plain_peak,
           "plain_own_peak_gib": plain_own,
           "mesh_run_s": mesh_s, "restore_s": restore_s}
    print(f"[dist] tinyllama-1.1b train, {DIST_STEPS} steps at the "
          f"launcher's defaults (8 x 128, 2 microbatches; {card}): "
          f"--mesh 1,1 losses {[round(x, 6) for x in losses]}, step ms "
          f"{[round(t, 1) for t in res['mesh_step_ms']]}, peak "
          f"{mesh_peak:.2f} GiB (the launcher run with its checkpoint "
          f"{mesh_s:.1f} s); plain losses "
          f"{[round(x, 6) for x in plain['losses']]}, step ms "
          f"{[round(t, 1) for t in res['plain_step_ms']]}, peak "
          f"{plain_peak:.2f} GiB ({plain_own:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before it); max |diff| "
          f"{diff:.2e} <= "
          f"{DIST_LOSS_ATOL}; the mesh checkpoint restored into the plain "
          f"layout bit for bit ({restore_s:.1f} s)")
    return res


def _decode_cell(dryrun, cfg, shape, mesh):
    """``measure_cell`` of a decode cell, with the collective operands
    shaped like a layer's local cache shard (``cache_collectives``)."""
    rk = dryrun.RankReckoner()
    res = dryrun.measure_cell(cfg, shape, mesh, rk)
    _, _, args, in_sh, _ = dryrun.build_cell(cfg, shape, mesh)
    res["cache_collectives"] = [list(map(str, op)) for op in
                                dryrun.cache_collectives(rk, args[1],
                                                         in_sh[1])]
    return res


def dryrun_cells():
    """The dry run's cells that phases 16, 18 and 19 read (on the host,
    no card), yielded as (name, cell) in the order the phases read
    them: ``measure_cell`` of REMAT_ARCH's DIST_CELLS on the 16 x 16
    production mesh (256 fake ranks); on a one-rank (1, 1) mesh, phase
    18's long step (REMAT_LONG) with the registry's remat and without,
    and phase 16's plain step (the launcher's 8 x 128 in 2 microbatches);
    LONG_ARCH's long_500k on the production mesh; SHARDED_ARCH's decode
    step at LONG_DECODE on the one-rank mesh."""
    import dataclasses

    from repro_torch.configs.base import SHAPES, ShapeCell
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from torch.distributed.device_mesh import init_device_mesh
    cfg = get_arch(REMAT_ARCH)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for name in DIST_CELLS:
            shape = SHAPES[name]
            yield name, (_decode_cell(dryrun, cfg, shape, mesh)
                         if shape.kind == "decode" else
                         dryrun.measure_cell(cfg, shape, mesh))
    b, s, mb = REMAT_LONG
    long_cfg = dataclasses.replace(cfg, train_microbatches=mb)
    long_cell = ShapeCell("remat_long", s, b, "train")
    cells = {
        "long_remat": (long_cfg, long_cell),
        "long_no_remat": (dataclasses.replace(long_cfg, remat=False,
                                              remat_group=0), long_cell),
        "dist_plain": (dataclasses.replace(cfg, train_microbatches=2),
                       ShapeCell("dist_plain", 128, 8, "train"))}
    with dryrun.fake_world(1):
        one = init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
        for name, (c, shape) in cells.items():
            yield name, dryrun.measure_cell(c, shape, one)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        yield "long_500k", _decode_cell(dryrun, get_arch(LONG_ARCH),
                                        SHAPES["long_500k"], mesh)
    b, s = LONG_DECODE
    with dryrun.fake_world(1):
        one = init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
        yield "decode_one", dryrun.measure_cell(
            get_arch(SHARDED_ARCH), ShapeCell("decode_32k", s, b, "decode"),
            one)


def _dryrun_worker(conn):
    """``dryrun_cells`` in a worker process; sends ("ok", name, cell) for
    each cell, then ("done", None, None), or ("fail", None, the error)."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    try:
        for name, cell in dryrun_cells():
            conn.send(("ok", name, cell))
            print(f"[dryrun] worker: {name} ready {time.perf_counter() - t0:.1f}"
                  f" s after its start", flush=True)
        conn.send(("done", None, None))
    except Exception as e:                  # noqa: BLE001 — the parent fails
        conn.send(("fail", None, f"{type(e).__name__}: {e}"))
    finally:
        conn.close()


class HostDryRun:
    """``dryrun_cells`` reckoned by a worker process started with the
    script: the dry run is host work on ``meta`` tensors (minutes at full
    width), so it runs beside the card's phases.  While it runs this
    process keeps one thread fewer, so the worker has a core of its own
    (oversubscribed, each parallel region waits for its slowest thread).
    ``result(*names)`` waits for those cells (every cell by default);
    ``stop`` ends the worker."""

    def __init__(self):
        import multiprocessing

        import torch
        self._threads = torch.get_num_threads()
        torch.set_num_threads(max(1, self._threads - 1))
        ctx = multiprocessing.get_context("spawn")
        self._recv, send = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=_dryrun_worker, args=(send,),
                                 daemon=True)
        self._t0 = time.perf_counter()
        self._proc.start()
        send.close()
        self._res = {}
        self._done = False

    def result(self, *names):
        t0 = time.perf_counter()
        while not self._done and not all(n in self._res for n in names):
            left = DRYRUN_WAIT_S - (time.perf_counter() - t0)
            check(left > 0 and self._recv.poll(left),
                  f"dry run: no result after {DRYRUN_WAIT_S} s")
            try:
                status, name, cell = self._recv.recv()
            except EOFError:
                raise SmokeFailure("dry run: the worker ended without its "
                                   "cells") from None
            check(status != "fail", f"dry run worker: {cell}")
            if status == "done":
                self._done = True
                self._restore_threads()
                print(f"[dryrun] the worker's cells ready "
                      f"{time.perf_counter() - self._t0:.1f} s after its "
                      f"start (waited {time.perf_counter() - t0:.1f} s)")
            else:
                self._res[name] = cell
        missing = [n for n in names if n not in self._res]
        check(not missing, f"dry run: no cells {missing}")
        return self._res

    def _restore_threads(self):
        import torch
        torch.set_num_threads(self._threads)

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()
        self._restore_threads()


def gib(n):
    return n / 2**30


def dist_dryrun(dry):
    """(c): the dry run's tinyllama-1.1b cells on the production mesh:
    the leaf counts of ``build_cell`` here, the numbers from ``dry``."""
    from repro_torch import tree
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_arch("tinyllama-1.1b")
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        for name, n_leaves in DIST_CELLS.items():
            _, _, args, in_sh, _ = dryrun.build_cell(cfg, SHAPES[name], mesh)
            counts = (len(tree.leaves(args)), len(tree.leaves(in_sh)))
            check(counts == (n_leaves, n_leaves),
                  f"dist: dry-run {name} leaf counts {counts}, want "
                  f"{n_leaves}")
    cells = dry.result(*DIST_CELLS)
    res = {}
    for name, n_leaves in DIST_CELLS.items():
        r = cells[name]
        check(r["flops"] > 0 and r["argument_bytes"] > 0
              and r["peak_bytes"] >= r["argument_bytes"]
              and r["temp_bytes"] == r["peak_bytes"] - r["argument_bytes"],
              f"dist: dry-run {name} {r}")
        if SHAPES[name].kind == "train":
            check(r["collectives"].get("all-gather", 0) > 0
                  and r["collectives"].get("reduce-scatter", 0) > 0,
                  f"dist: dry-run {name} {r}")
        res[name] = r
        print(f"[dist] dry run tinyllama-1.1b x {name} x 16x16: "
              f"{n_leaves} leaves, {r['argument_bytes'] / 2**20:.1f} MiB "
              f"of arguments a device, {r['flops']:.4e} flops "
              f"({r['flops_per_device']:.4e} a device); {rank_note(r)}; "
              f"built in {r['build_s']} s (the worker, beside the card's "
              f"phases)")
    return res


def rank_note(r):
    """One rank's reckoned memory, collectives and bytes, as printed."""
    return (f"a rank's peak {gib(r['peak_bytes']):.3f} GiB (temp "
            f"{gib(r['temp_bytes']):.3f}), outputs "
            f"{gib(r['output_bytes']):.3f} GiB, collectives "
            + (", ".join(f"{k} {gib(v):.3f}" for k, v in
                         r["collectives"].items()) or "none")
            + f" GiB ({gib(r['collective_bytes_per_device']):.3f} in all), "
            f"bytes accessed (unfused) {r['bytes_per_device']:.4e}")


def phase_dist(dev, card, dry):
    """Phase 16: distribution on a one-rank nccl group (see the module
    docstring): (a) ``dist_grad_compress``, (b) ``dist_train``, then,
    with the group gone, (c) ``dist_dryrun`` on a fake one."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    check(dist.is_available() and dist.is_nccl_available(),
          "dist: torch.distributed has no nccl")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        comp = dist_grad_compress(mesh, dev)
        gc.collect()
        torch.cuda.empty_cache()
        train = dist_train(dev, card)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    dry_cells = dist_dryrun(dry)
    print(f"[dist] phase {time.perf_counter() - t_phase:.1f} s")
    return {"compress": comp, "train": train, "dryrun": dry_cells}


# ---------------------------------------------------------------------------
# phase 17: the bf16 KV cache of the dense, moe and vlm families; examples
# ---------------------------------------------------------------------------

def kv_card_vs_cpu(dev):
    """Reduced ``KV_ARCHS`` at ``serve_kv_bits = KV_BITS`` in SDV and
    memory modes on the card against the same models on the CPU (plain
    kernel versions): a 5-token prefill and ``KV_REFERENCE_STEPS`` decode
    steps.  Logits within ``LOGIT_ATOL``, ``index`` bit for bit, the
    bf16 K/V (no scale leaves) within one bf16 rounding of their scale
    (``CACHE_SCALE_RTOL``); the entries that differ are counted."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill_step, serve_params)
    cpu = torch.device("cpu")
    for arch in KV_ARCHS:
        cfg = dataclasses.replace(get_arch(arch).reduced(),
                                  serve_kv_bits=KV_BITS)
        params = init_params(cfg, seed=1, device=cpu)
        rng = np.random.default_rng(1)
        prompt = rng.integers(0, cfg.vocab, (3, 5))
        tokens = rng.integers(0, cfg.vocab, (KV_REFERENCE_STEPS, 3, 1))
        for compute in ("sdv", "memory"):
            outs, caches = {}, {}
            for d in (cpu, dev):
                q = serve_params(_to(params, d), bits=4, min_size=1024,
                                 compute=compute)
                i32 = dict(dtype=torch.int32, device=d)
                cache = init_cache(cfg, 3, 16, device=d)
                cache = prefill_step(cfg, q, cache,
                                     torch.tensor(prompt, **i32),
                                     torch.tensor([5, 3, 0], **i32))
                logits = []
                for t in tokens:
                    out, cache = decode_step(cfg, q, cache,
                                             torch.tensor(t, **i32))
                    logits.append(out.cpu())
                outs[d.type] = torch.stack(logits)
                caches[d.type] = {k: v.cpu() for k, v in cache.items()}
            err = float((outs["cuda"] - outs["cpu"]).abs().max())
            check(err <= LOGIT_ATOL, f"reduced {cfg.name} bf16 KV ({compute}) "
                                     f"card vs CPU logits differ by {err}")
            card, host = caches["cuda"], caches["cpu"]
            check(sorted(card) == ["index", "k", "v"]
                  and card["k"].dtype == card["v"].dtype == torch.bfloat16,
                  f"reduced {cfg.name}: cache leaves "
                  f"{ {k: v.dtype for k, v in card.items()} }")
            check(torch.equal(card["index"], host["index"]),
                  f"reduced {cfg.name} ({compute}): index card vs CPU")
            rel = {k: float((card[k].float() - host[k].float()).abs().max()
                            / host[k].float().abs().max()) for k in ("k", "v")}
            check(max(rel.values()) <= CACHE_SCALE_RTOL,
                  f"reduced {cfg.name} ({compute}): bf16 K/V card vs CPU "
                  f"{rel} of their scale > {CACHE_SCALE_RTOL}")
            differ = {k: (int((card[k] != host[k]).sum()), host[k].numel())
                      for k in ("k", "v")}
            print(f"[kv] reduced {cfg.name}, bf16 KV cache ({compute}), "
                  f"prefill + {KV_REFERENCE_STEPS} decode steps, card vs CPU: "
                  f"max |dlogit| {err:.4g} (tolerance {LOGIT_ATOL}); index bit "
                  "for bit; "
                  + ", ".join(f"{k} within {v:.3g} of its scale"
                              for k, v in rel.items())
                  + "; entries that differ (of all): "
                  + ", ".join(f"{k} {n} of {m}"
                              for k, (n, m) in differ.items()))


def kv_prompts(cfg, dev):
    """The serve phase's seeded prompts [BATCH, PROMPT] and the prefill's
    n_valid (the last prompt token opens decode)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                           dtype=torch.int32, device=dev)
    return prompts, torch.full((BATCH,), PROMPT - 1, dtype=torch.int32,
                               device=dev)


def kv_decode_run(cfg, qparams, dev, card, compute, profiled=True):
    """Full-width ``cfg`` on its own cache (int8 or bf16 by
    ``serve_kv_bits``): a prefill of the first PROMPT-1 tokens of 8
    prompts and NEW greedy decode steps at batch 8, each with exactly
    the expected launches (SDV 154 B2 / 154 B1 a step, memory 154 / 155
    B7) and no plain call; ms/step, tok/s, peak memory, the cache's
    bytes and (``profiled``) one decode step's busy share split into B1 or
    B7, the KV write and attention (the program's spans ``KV_SPANS``) and
    the rest.  Returns the readings and the greedy tokens [BATCH, NEW]."""
    import torch
    from repro_torch.launch.serve import cache_note
    from repro_torch.models import decode_step, init_cache, prefill_step

    per_step = 7 * cfg.n_layers
    if compute == "sdv":
        want_pre, want_dec = expect(B2=per_step), expect(B1=NEW * per_step)
        kern = {"B1": "sdv_gemv_kernel"}
    else:
        want_pre = expect(B7=per_step)
        want_dec = expect(B7=NEW * (per_step + 1))
        kern = {"B7": "unpack_dequant_kernel"}
    label = f"{cache_note(init_cache(cfg, 1, 1, device=dev))}, {compute}"
    prompts, n_prompt = kv_prompts(cfg, dev)
    # warm-up on a throwaway cache (first calls of the allocator, cuBLAS)
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    decode_step(cfg, qparams, cache, prompts[:, -1:])
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    cache = prefill_step(cfg, qparams, cache, prompts, n_prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    c_pre = counts()
    check(c_pre == want_pre, f"{label}: prefill launches {c_pre}")
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
    c_dec = counts()
    check(c_dec == want_dec, f"{label}: decode launches {c_dec}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    check(cache["index"].tolist() == [PROMPT - 1 + NEW] * BATCH,
          f"{label}: index {cache['index'].tolist()}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    kv_bytes = {k: v.numel() * v.element_size() for k, v in cache.items()
                if k != "index"}
    ms = t_decode / NEW * 1e3
    state = {"cache": {k: v.clone() for k, v in cache.items()}}

    def step():
        _, state["cache"] = decode_step(cfg, qparams, state["cache"], tok)
    split = None
    if profiled:
        split = step_split("kv", f"{cfg.name} {label}: one decode step at "
                           f"batch {BATCH}", step, ms, card, kern,
                           {"KV write + attention (torch)":
                            lambda e: e.key in KV_SPANS})
    print(f"[kv] {cfg.name} {label}: prefill {BATCH}x{PROMPT} "
          f"{t_prefill * 1e3:.1f} ms, decode {ms:.3f} ms/step "
          f"({BATCH * NEW / t_decode:.1f} tok/s), peak {peak:.3f} GiB, cache "
          + ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in kv_bytes.items())
          + f" ({sum(kv_bytes.values()) / 1e6:.3f} MB); launches prefill "
          f"{c_pre}, decode {c_dec} ({card})")
    return {"prefill": c_pre, "decode": c_dec, "ms_step": ms,
            "tok_s": BATCH * NEW / t_decode, "peak_gib": peak,
            "kv_mb": sum(kv_bytes.values()) / 1e6, "split": split,
            "tokens": torch.cat(gen, 1).cpu()}


def kv_spec(cfg, params, qparams, dev, card, plain):
    """Speculative decoding (k = ``SPEC_K``, the W4A4 self-speculation
    draft of ``SpecDecoder``) of the serve prompts on ``cfg``'s cache,
    round by round as the engine runs it (the draft on a fork, one
    verify wave, acceptance and rollback on the device) until every row
    has NEW tokens: 3 x 154 B1 + 154 B2 a round and nothing else, and
    every row's tokens == ``plain`` (greedy decode's) — the gate of the
    int8 spec phase.  A mismatch fails with the rows and positions that
    differ (a fault for ROADMAP Queue C).  Returns the launch counts."""
    import torch
    from repro_torch.models import init_cache, prefill_step
    from repro_torch.serving import SpecDecoder

    per_step = 7 * cfg.n_layers
    spec = SpecDecoder(cfg, params)
    dqp = spec.draft_qparams(BATCH)
    prompts, n_prompt = kv_prompts(cfg, dev)
    s_max = PROMPT + NEW + SPEC_K + 1
    cache = prefill_step(cfg, qparams, init_cache(cfg, BATCH, s_max,
                                                  device=dev),
                         prompts, n_prompt)
    fork = init_cache(cfg, BATCH, s_max, device=dev)
    pending = prompts[:, -1].clone()
    remaining = torch.full((BATCH,), NEW, dtype=torch.int32, device=dev)
    out = [[] for _ in range(BATCH)]
    accepted = []
    rounds = 0
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    while int(remaining.max()) > 0:
        adv = (remaining > 0).to(torch.int32)
        props = spec.draft(dqp, cache, pending, adv, fork)
        greedy, t, cache = spec.verify(qparams, cache, pending, props, adv,
                                       remaining)
        g, tt = greedy.cpu(), t.cpu()
        for r in range(BATCH):
            n = int(tt[r])
            out[r] += g[r, :n].tolist()
            if n:
                pending[r] = g[r, n - 1]
        accepted += [int(n) for n in tt if n]
        remaining -= t
        rounds += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts()
    check(c == expect(B1=SPEC_K * per_step * rounds,
                                     B2=per_step * rounds),
          f"bf16 spec: launches {c}, want {rounds} rounds x ({SPEC_K} x "
          f"{per_step} B1 + {per_step} B2)")
    plain = plain.tolist()
    bad = {r: [j for j, (a, b) in enumerate(zip(out[r], plain[r])) if a != b]
           for r in range(BATCH) if out[r] != plain[r]}
    check(not bad, "Queue C fault: speculative tokens on the bf16 cache != "
          f"plain decode's (batch {BATCH}, prompt {PROMPT}, {NEW} new, k "
          f"{SPEC_K}); rows: positions that differ {bad}")
    print(f"[kv] {cfg.name} speculative k={SPEC_K} on the bf16 KV cache: "
          f"every row's {NEW} tokens == plain decode's; {rounds} rounds, "
          f"mean accepted {sum(accepted) / len(accepted):.3f}, "
          f"{wall / rounds * 1e3:.2f} ms a round, launches {c} ({card})")
    return c


def kv_examples():
    """``examples_torch/quickstart.py`` and ``ultranet_bseg.py`` (its
    default 64x64 frame), each in a subprocess of its own on the card,
    the two at once: exit code 0 and their "bit-exact ... True" lines."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()

    def run(name):
        return subprocess.run(
            [sys.executable, str(ROOT / "examples_torch" / f"{name}.py")],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    want = {"quickstart": 3, "ultranet_bseg": 1}
    with ThreadPoolExecutor(len(want)) as pool:
        procs = dict(zip(want, pool.map(run, want)))
    for name, proc in procs.items():
        exact = [line for line in proc.stdout.splitlines()
                 if re.search(r"bit-exact.*True", line)]
        check(proc.returncode == 0 and len(exact) == want[name],
              f"examples_torch/{name}.py: exit {proc.returncode}, "
              f"{len(exact)} bit-exact lines of {want[name]}:\n"
              f"{proc.stdout}{proc.stderr[-2000:]}")
        print(f"[kv] examples_torch/{name}.py on the card: exit 0; "
              + " | ".join(exact))
    print(f"[kv] both examples in {time.perf_counter() - t0:.1f} s")


def phase_kv_bf16(dev, card):
    """Phase 17: the bf16 KV cache (``serve_kv_bits = 16``) of the dense,
    moe and vlm families and the examples (see the module docstring).
    Frees what earlier phases left on the card first."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import single_batch_loop
    from repro_torch.models import init_cache, init_params, serve_params
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    kv_card_vs_cpu(dev)
    base = get_arch("tinyllama-1.1b")
    cfgs = {8: base, KV_BITS: dataclasses.replace(base,
                                                  serve_kv_bits=KV_BITS)}
    per_step = 7 * base.n_layers
    steps = PROMPT + NEW - 1
    params = init_params(base, seed=0, device=dev)
    runs, loops = {}, {}
    spec = None
    for compute in ("sdv", "memory"):
        qparams = serve_params(params, bits=4, min_size=1024, compute=compute)
        # int8, bf16, bf16, int8: host-bound walls drift within a call
        for i, bits in enumerate((8, KV_BITS, KV_BITS, 8)):
            run = kv_decode_run(cfgs[bits], qparams, dev, card, compute,
                                profiled=i < 2)
            if (compute, bits) in runs:
                runs[compute, bits]["ms_again"] = run["ms_step"]
            else:
                runs[compute, bits] = run
        # the serve CLI's loop on the bf16 cache
        cfg = cfgs[KV_BITS]
        reset_counts()
        toks, dt = single_batch_loop(
            cfg, qparams, init_cache(cfg, BATCH, PROMPT + NEW, device=dev),
            kv_prompts(cfg, dev)[0], NEW)
        loops[compute] = counts()
        want = (expect(B1=steps * per_step) if compute == "sdv"
                else expect(B7=steps * (per_step + 1)))
        check(loops[compute] == want and toks.shape == (BATCH, NEW),
              f"bf16 single_batch_loop ({compute}): launches "
              f"{loops[compute]}, tokens {toks.shape}")
        print(f"[kv] single_batch_loop on the bf16 KV cache ({compute}): "
              f"{BATCH * steps / dt:.1f} tok/s ({steps} steps), launches "
              f"{loops[compute]}")
        if compute == "sdv":
            spec = kv_spec(cfg, params, qparams, dev, card,
                           runs[compute, KV_BITS]["tokens"])
        del qparams
    for compute in ("sdv", "memory"):
        a, b = runs[compute, 8], runs[compute, KV_BITS]
        print(f"[kv] {compute}, bf16 against int8 KV cache in this call: "
              f"{b['ms_step']:.3f} and {b['ms_again']:.3f} / "
              f"{a['ms_step']:.3f} and {a['ms_again']:.3f} ms/step (runs "
              "int8, bf16, bf16, int8), "
              f"{b['tok_s']:.1f} / {a['tok_s']:.1f} tok/s, peak "
              f"{b['peak_gib']:.3f} / {a['peak_gib']:.3f} GiB, cache "
              f"{b['kv_mb']:.3f} / {a['kv_mb']:.3f} MB ({card})")
    del params
    kv_examples()
    print(f"[kv] phase {time.perf_counter() - t_phase:.1f} s")
    return {"runs": runs, "loops": loops, "spec": spec}


# ---------------------------------------------------------------------------
# phase 18: rematerialization; the dry run against the card
# ---------------------------------------------------------------------------

def remat_setup(dev, shape, steps):
    """Full-width REMAT_ARCH's seeded parameters and AdamW state on the
    card and the first ``steps`` batches of ``shape`` = (global batch,
    seq, microbatches), with the bytes allocated before them."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import init_params
    from repro_torch.train import optimizer
    b, s, _ = shape
    cfg = get_arch(REMAT_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    params = init_params(cfg, seed=0, device=dev)
    ocfg = optimizer.OptConfig(lr=3e-4, warmup=10, total_steps=steps)
    opt = optimizer.init(ocfg, params)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=s, global_batch=b,
                           seed=0)
    batches = [data.device_batch(i, dev) for i in range(steps)]
    return cfg, ocfg, params, opt, batches, held


def remat_steps(cfg, ocfg, state, batches, microbatches, dev, held):
    """``make_train_step`` of ``cfg`` over ``batches`` from ``state`` =
    [params, opt] (the list is emptied, so the first step's arguments
    are freed after it where the caller holds them nowhere else, as a
    training loop frees them): each step's loss tensor and wall ms, the
    last parameters, the peak of the steps above ``held`` and above what
    was allocated when they began."""
    import torch
    from repro_torch.train import loop
    step = loop.make_train_step(cfg, ocfg, microbatches=microbatches)
    p, o = state
    state.clear()
    losses, ms = [], []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    for bt in batches:
        t0 = time.perf_counter()
        p, o, m = step(p, o, bt)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"])
    top = torch.cuda.max_memory_allocated(dev)
    del o
    return losses, ms, p, (top - held, top - base)


def remat_exact(dev, card):
    """(a): REMAT_EXACT_STEPS steps of full-width REMAT_ARCH at
    REMAT_EXACT under each of REMAT_SETTINGS from the same state (held
    for all three runs, so in each run's peak): every loss and layer 0's
    updated parameters bit for bit alike; step walls and peaks."""
    import dataclasses

    from repro_torch import tree
    b, s, mb = REMAT_EXACT
    base, ocfg, params, opt, batches, held = remat_setup(
        dev, REMAT_EXACT, REMAT_EXACT_STEPS)
    runs = {}
    for name, over in REMAT_SETTINGS.items():
        cfg = dataclasses.replace(base, **over)
        losses, ms, p, (peak, own) = remat_steps(
            cfg, ocfg, [params, opt], batches, mb, dev, held)
        runs[name] = {"losses": losses, "ms": ms, "peak": peak, "own": own,
                      "remat": cfg.remat, "remat_group": cfg.remat_group,
                      "layer": [x[0].clone() for x in
                                tree.leaves(p["blocks"])]}
        del p
        print(f"[remat] (a) {REMAT_ARCH} {REMAT_EXACT_STEPS} steps at {b} x "
              f"{s} in {mb} microbatches, remat {cfg.remat}, remat_group "
              f"{cfg.remat_group}: losses "
              f"{[float(x) for x in losses]}, step ms "
              f"{[round(t, 1) for t in ms]}, peak {gib(peak):.3f} GiB "
              f"above the {gib(held):.3f} GiB held before the state, "
              f"{gib(own):.3f} GiB above the state ({card})")
    del params, opt
    ref = runs["off"]
    for name, r in runs.items():
        check(all(same_bits(a, c) for a, c in zip(r["losses"],
                                                  ref["losses"]))
              and all(same_bits(a, c) for a, c in zip(r["layer"],
                                                      ref["layer"])),
              f"remat (a): {name}'s losses or layer 0 differ from remat "
              f"off's")
    print(f"[remat] (a) every loss and layer 0's {len(ref['layer'])} updated "
          f"parameter leaves bit for bit alike under "
          f"{', '.join(REMAT_SETTINGS)}")
    return {name: {k: v for k, v in r.items() if k != "layer"}
            for name, r in runs.items()}


def remat_long(dev, card):
    """(b): REMAT_LONG_STEPS steps of full-width REMAT_ARCH at REMAT_LONG
    on the registry's remat: finite losses, the first within
    REMAT_LOSS_RTOL of ``loss_fn`` under ``no_grad`` over the same
    microbatches, averaged as the step averages them; step walls and
    the peak above what was held before the state was built."""
    import torch
    from repro_torch.models import shard_ctx
    from repro_torch.quant.quantizer import div
    from repro_torch.train import loop
    b, s, mb = REMAT_LONG
    cfg, ocfg, params, opt, batches, held = remat_setup(dev, REMAT_LONG,
                                                        REMAT_LONG_STEPS)
    t0 = time.perf_counter()
    with torch.no_grad():
        split = {k: shard_ctx.split_microbatches(v, mb)
                 for k, v in batches[0].items()}
        total = None
        for i in range(mb):
            li = loop.loss_fn(cfg, params, {k: v[i] for k, v in
                                            split.items()})
            total = li if total is None else total + li
        ref = float(div(total, mb))
    ref_ms = (time.perf_counter() - t0) * 1e3
    del split, total
    state = [params, opt]
    del params, opt                   # freed after step 1, as a loop does
    losses, ms, p, (peak, own) = remat_steps(cfg, ocfg, state, batches, mb,
                                             dev, held)
    del p
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses),
          f"remat (b): losses {losses}")
    rel = abs(losses[0] - ref) / abs(ref)
    check(rel <= REMAT_LOSS_RTOL,
          f"remat (b): step 1 loss {losses[0]!r} vs no_grad {ref!r}")
    print(f"[remat] (b) {REMAT_ARCH} {REMAT_LONG_STEPS} steps at {b} x {s} "
          f"in {mb} microbatches of {b // mb} x {s} tokens (remat "
          f"{cfg.remat}, remat_group {cfg.remat_group}): losses {losses}; "
          f"step 1 {losses[0]!r} vs the no_grad loss_fn {ref!r} (rel "
          f"{rel:.2e} <= {REMAT_LOSS_RTOL}; {ref_ms:.1f} ms); step ms "
          f"{[round(t, 1) for t in ms]}; peak {gib(peak):.3f} GiB above the "
          f"{gib(held):.3f} GiB held before the state, {gib(own):.3f} GiB "
          f"above the state ({card})")
    return {"losses": losses, "ms": ms, "peak": peak, "own": own,
            "ref_loss": ref, "rel": rel}


def remat_dryrun(long, dist, dry, card):
    """(c): the dry run's one-rank reckonings (the worker's) against the
    card: the long step's peak with the registry's remat within
    REMAT_PEAK_RTOL of (b)'s; without remat against the card; phase
    16's plain step against its measured peak."""
    cells = dry.result("long_remat", "long_no_remat", "dist_plain")
    on, off, plain = (cells[k] for k in ("long_remat", "long_no_remat",
                                         "dist_plain"))
    ratio = on["peak_bytes"] / long["peak"]
    check(abs(ratio - 1) <= REMAT_PEAK_RTOL,
          f"remat (c): reckoned peak {on['peak_bytes']} vs measured "
          f"{long['peak']}")
    own = dist["train"]["plain_own_peak_gib"] * 2**30
    print(f"[remat] (c) the dry run on a (1, 1) mesh, {REMAT_ARCH} at "
          f"{REMAT_LONG[0]} x {REMAT_LONG[1]} in {REMAT_LONG[2]} "
          f"microbatches: with remat a rank's peak "
          f"{gib(on['peak_bytes']):.3f} GiB (arguments "
          f"{gib(on['argument_bytes']):.3f}, temp "
          f"{gib(on['temp_bytes']):.3f}, the card's above its state "
          f"{gib(long['own']):.3f}) against the card's "
          f"{gib(long['peak']):.3f}: reckoned / measured {ratio:.4f}, "
          f"measured / reckoned {1 / ratio:.4f} (within "
          f"{REMAT_PEAK_RTOL:.0%}); without remat "
          f"{gib(off['peak_bytes']):.3f} GiB, "
          f"{off['peak_bytes'] / CARD_BYTES:.2f} x the card's "
          f"{CARD_BYTES / 1e9:.0f} GB, so not run; the dist phase's plain "
          f"step (8 x 128, 2 microbatches) reckoned "
          f"{gib(plain['peak_bytes']):.3f} GiB (arguments "
          f"{gib(plain['argument_bytes']):.3f}) against its measured "
          f"{gib(own):.3f} GiB above what was held before it (the loop's "
          f"caller holds the first state through every step; peak "
          f"{dist['train']['plain_peak_gib']:.2f} GiB with what was held); "
          f"built in "
          f"{on['build_s']} / {off['build_s']} / {plain['build_s']} s "
          f"({card})")
    return {"on": on, "off": off, "plain": plain, "ratio": ratio}


def phase_remat(dev, card, dry, train, ssm, dist):
    """Phase 18: rematerialization (see the module docstring), after the
    earlier phases' memory is freed: (a) ``remat_exact``, (b)
    ``remat_long``, (c) ``remat_dryrun``, (d) the QAT phases' B2 a step
    under the registry's remat (checked there) and walls."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    exact = remat_exact(dev, card)
    long = remat_long(dev, card)
    dryc = remat_dryrun(long, dist, dry, card)
    qat = {"tinyllama-1.1b": (train["launches"]["B2 train"],
                              train["step_ms"], "1024.0-1052.6"),
           "mamba2-130m": (ssm["mamba_qat"]["b2_run"],
                           ssm["mamba_qat"]["step_ms"], "611-698"),
           f"recurrentgemma-2b ({ssm['hybrid_qat']['n_layers']} layers)": (
               ssm["hybrid_qat"]["b2_run"], ssm["hybrid_qat"]["step_ms"],
               "936-1104")}
    for arch, (b2, ms, before) in qat.items():
        print(f"[remat] (d) {arch} packed QAT under the registry's remat: "
              f"{b2} B2 in the run, step ms {[round(t, 1) for t in ms]} "
              f"(earlier runs without remat: {before} ms) ({card})")
    a, o = train["remat_vs_off_ms"]
    print(f"[remat] (d) tinyllama-1.1b QAT step from one state: remat "
          f"{a:.1f} ms, remat=False {o:.1f} ms ({card})")
    print(f"[remat] phase {time.perf_counter() - t_phase:.1f} s")
    return {"exact": exact, "long": long, "dryrun": dryc}


# ---------------------------------------------------------------------------
# phase 19: the sharded decode
# ---------------------------------------------------------------------------

def sharded_greedy(cfg, params, dev, mesh=None):
    """A prefill of the first PROMPT-1 tokens of ``kv_prompts`` and NEW
    greedy decode steps of full-width ``cfg`` from the memory-packed tree
    ``params`` on a fresh cache, plainly or (``mesh``) with the tree,
    the cache and each step's tokens placed on ``mesh``
    (``place_decode``).  Returns the greedy tokens [BATCH, NEW], each
    step's logits, the final cache (full tensors), the launches of the
    prefill and of the decode steps and the decode wall in seconds."""
    import torch
    from repro_torch.launch.mesh import (batch_shardings, distribute,
                                         place_decode)
    from repro_torch.models import (decode_step, init_cache, prefill_step,
                                    shard_ctx)
    prompts, n_prompt = kv_prompts(cfg, dev)
    cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
    batch = {"tokens": prompts, "n_valid": n_prompt}
    rules, p = None, params

    def put(tok):
        return tok
    if mesh is not None:
        rules, p, cache, batch = place_decode(mesh, cfg, params, cache, batch)
        sh = batch_shardings(mesh, rules, {"tokens": prompts[:, -1:]})

        def put(tok):
            return distribute({"tokens": tok}, sh)["tokens"]

    def full(t):
        return t.full_tensor() if mesh is not None else t
    with shard_ctx.use_rules(rules), torch.no_grad():
        reset_counts()
        cache = prefill_step(cfg, p, cache, batch["tokens"],
                             batch["n_valid"])
        c_pre = counts()
        tok, gen, logits = prompts[:, -1:], [], []
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(NEW):
            out, cache = decode_step(cfg, p, cache, put(tok))
            out = full(out)
            tok = torch.argmax(out[:, -1:, :cfg.vocab], dim=-1).to(
                torch.int32)
            gen.append(tok)
            logits.append(out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c_dec = counts()
    return (torch.cat(gen, 1), logits, {k: full(v) for k, v in
                                        cache.items()}, c_pre, c_dec, wall)


def sharded_exact(cfg, qparams, dev, card, mesh):
    """(a): the greedy prefill + decode of ``sharded_greedy`` plainly and
    on the one-rank mesh, on the int8 and the bf16 cache: tokens, every
    step's logits and every cache leaf bit for bit alike; 154 B7 a
    prefill and 155 a decode step on both paths, no plain call."""
    import dataclasses
    per_step = 7 * cfg.n_layers
    want_pre, want_dec = expect(B7=per_step), expect(B7=NEW * (per_step + 1))
    res = {}
    for kv_bits in (8, KV_BITS):
        c = dataclasses.replace(cfg, serve_kv_bits=kv_bits)
        runs = {"plain": sharded_greedy(c, qparams, dev),
                "mesh": sharded_greedy(c, qparams, dev, mesh)}
        for path, (_, _, _, c_pre, c_dec, _) in runs.items():
            check(c_pre == want_pre and c_dec == want_dec,
                  f"sharded (a) {path} kv{kv_bits}: launches prefill "
                  f"{c_pre}, decode {c_dec}")
        (pt, pl, pc, *_, pw), (mt, ml, mc, *_, mw) = runs["plain"], \
            runs["mesh"]
        check(same_bits(pt, mt), f"sharded (a) kv{kv_bits}: tokens differ")
        check(all(same_bits(a, b) for a, b in zip(pl, ml)),
              f"sharded (a) kv{kv_bits}: logits differ")
        check(set(pc) == set(mc) and all(same_bits(pc[k], mc[k])
                                          for k in pc),
              f"sharded (a) kv{kv_bits}: caches differ")
        check(all(bool(x.isfinite().all()) for x in ml),
              f"sharded (a) kv{kv_bits}: non-finite logits")
        res[kv_bits] = {"plain_ms": pw / NEW * 1e3, "mesh_ms": mw / NEW * 1e3,
                        "prefill": runs["mesh"][3], "decode": runs["mesh"][4]}
        print(f"[sharded] (a) {cfg.name} memory W{cfg.serve_weight_bits}, "
              f"{'int8' if kv_bits == 8 else 'bf16'} cache: prefill "
              f"{BATCH}x{PROMPT - 1} + {NEW} greedy steps at batch {BATCH} "
              f"on the (1, 1) mesh (nccl, one rank) == the plain decode: "
              f"tokens, {NEW} steps' logits and {len(pc)} cache leaves bit "
              f"for bit; B7 {runs['mesh'][3]['B7']} a prefill, "
              f"{runs['mesh'][4]['B7'] // NEW} a step on the mesh (plain "
              f"{runs['plain'][4]['B7'] // NEW}); decode "
              f"{res[kv_bits]['mesh_ms']:.1f} ms/step on the mesh, "
              f"{res[kv_bits]['plain_ms']:.1f} plain ({card})")
    return res


def sharded_syncs(cfg, trees, dev):
    """(b): one decode step of each tree (SDV and memory) under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing op
    left, by the source line that called it; none in the cache writes
    (``layers.decode_writes``, ``prefill_writes``, ``_put``,
    ``_write_kv``)."""
    import collections
    import inspect
    import traceback
    import warnings

    import torch
    from repro_torch.models import (decode_step, init_cache, layers,
                                    prefill_step)
    spans = []
    for fn in (layers.decode_writes, layers.prefill_writes, layers._put,
               layers._write_kv):
        lines, first = inspect.getsourcelines(fn)
        spans.append((inspect.getsourcefile(fn), first, first + len(lines)))
    prompts, n_prompt = kv_prompts(cfg, dev)
    res = {}
    for compute, q in trees.items():
        cache = init_cache(cfg, BATCH, PROMPT + NEW, device=dev)
        syncs = []

        def seen(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" in str(message):
                stack = traceback.extract_stack()[:-1]
                ours = [f for f in stack if "repro_torch" in f.filename] \
                    or [f for f in stack if "/torch/" not in f.filename
                        and not f.filename.endswith("warnings.py")]
                syncs.append((f"{Path(filename).parent.name}/"
                              f"{Path(filename).name}:{lineno}",
                              (f"{Path(ours[-1].filename).name}:"
                               f"{ours[-1].lineno} {ours[-1].name}")
                              if ours else "-",
                              [(f.filename, f.lineno) for f in stack]))
        with torch.no_grad():
            cache = prefill_step(cfg, q, cache, prompts, n_prompt)
            _, cache = decode_step(cfg, q, cache, prompts[:, -1:])
            torch.cuda.synchronize()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = seen
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    decode_step(cfg, q, cache, prompts[:, -1:])
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        where = collections.Counter(f"{a} from {b}" for a, b, _ in syncs)
        in_writes = [a for a, _, stack in syncs
                     if any(fn == f and lo <= n < hi for fn, n in stack
                            for f, lo, hi in spans)]
        check(not in_writes, f"sharded (b) {compute}: the cache writes "
              f"synchronize at {in_writes}")
        res[compute] = dict(where)
        print(f"[sharded] (b) {cfg.name} {compute}: one decode step at batch "
              f"{BATCH} under set_sync_debug_mode('warn'): {len(syncs)} "
              f"synchronizing ops left"
              + (", at " + ", ".join(f"{k} x{n}" for k, n in where.items())
                 if where else "") + "; none in the cache writes")
    return res


def sharded_long(dev, card, mesh, dry):
    """(c): full-width SHARDED_ARCH's decode_32k step (LONG_DECODE: batch
    128, s_max 32768, int8 cache, W4 memory-packed weights) on the
    one-rank mesh: every row at position s_max - 1 but the last, which
    sits at s_max under advance 0.  Each of the others writes position
    s_max - 1 in every layer, the last row writes nothing (its
    s_max - 1 stays empty) and nothing else is written; 155 B7; finite
    logits; the step's wall; the card's peak (above what was held
    before the state) against the one-rank dry run's reckoning of the
    same step, within LONG_PEAK_RTOL."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import (batch_shardings, distribute,
                                         place_decode)
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    serve_params, shard_ctx)
    b, s = LONG_DECODE
    cfg = get_arch(SHARDED_ARCH)
    cell = dry.result("decode_one")["decode_one"]
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    check(cell["peak_bytes"] < free,
          f"sharded (c): the reckoned peak {gib(cell['peak_bytes']):.2f} GiB "
          f"does not fit the {gib(free):.2f} GiB free")
    held = torch.cuda.memory_allocated(dev)
    qparams = serve_params(init_params(cfg, seed=0, device=dev),
                           bits=cfg.serve_weight_bits)
    cache = init_cache(cfg, b, s, device=dev)
    cache["index"].fill_(s - 1)
    cache["index"][-1] = s
    advance = torch.ones(b, dtype=torch.int32, device=dev)
    advance[-1] = 0
    tokens = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, 1)), dtype=torch.int32, device=dev)
    rules, p, c, bt = place_decode(mesh, cfg, qparams, cache,
                                   {"tokens": tokens})
    check(c["k"].to_local().data_ptr() == cache["k"].data_ptr(),
          "sharded (c): placing the cache on the mesh copied it")
    adv = distribute({"a": advance}, batch_shardings(mesh, rules,
                                                     {"a": advance}))["a"]
    del cache
    gc.collect()
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated(dev) - held
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    with shard_ctx.use_rules(rules), torch.no_grad():
        for i in range(2):
            reset_counts()
            t0 = time.perf_counter()
            logits, c = decode_step(cfg, p, c, bt["tokens"], advance=adv)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launched = counts()
            if i == 0:
                peak = torch.cuda.max_memory_allocated(dev) - held
                k, ks = c["k"].to_local(), c["k_scale"].to_local()
                wrote = bool((k[:, :-1, s - 1].abs().amax(dim=(-1, -2))
                              > 0).all()) and bool((ks[:, :-1, s - 1]
                                                    > 0).all())
                kept = not bool(k[:, -1, s - 1].any()) \
                    and not bool(ks[:, -1, s - 1].any())
                rest = not bool(k[:, :, s - 2].any())
                index = c["index"].to_local().tolist()
                finite = bool(logits.to_local().isfinite().all())
            check(launched == expect(B7=7 * cfg.n_layers + 1),
                  f"sharded (c): launches {launched}")
    check(wrote and kept and rest,
          f"sharded (c): writes at s_max - 1: rows {wrote}, the row at "
          f"s_max untouched {kept}, nothing else {rest}")
    check(index == [s] * b, f"sharded (c): index {index[-3:]}")
    check(finite and tuple(logits.shape) == (b, 1, cfg.vocab),
          f"sharded (c): logits {tuple(logits.shape)} finite {finite}")
    ratio = cell["peak_bytes"] / peak
    temp_ratio = cell["temp_bytes"] / (peak - state)
    check(abs(ratio - 1) <= LONG_PEAK_RTOL,
          f"sharded (c): reckoned peak {cell['peak_bytes']} vs measured "
          f"{peak}")
    del logits, c, p, qparams
    print(f"[sharded] (c) {cfg.name} decode_32k on the (1, 1) mesh: batch "
          f"{b}, s_max {s}, int8 cache, W{cfg.serve_weight_bits} memory "
          f"weights: {b - 1} rows wrote position {s - 1} in all "
          f"{cfg.n_layers} layers, the row at {s} (advance 0) wrote "
          f"nothing, position {s - 2} untouched; index {s} for every row; "
          f"finite logits; B7 {launched['B7']} a step; step walls "
          f"{[round(w, 1) for w in walls]} ms (the second: every row at "
          f"s_max or masked, no write); state {gib(state):.3f} GiB, peak "
          f"{gib(peak):.3f} GiB (temp {gib(peak - state):.3f}); the dry "
          f"run's one-rank reckoning {gib(cell['peak_bytes']):.3f} GiB "
          f"(arguments {gib(cell['argument_bytes']):.3f}, temp "
          f"{gib(cell['temp_bytes']):.3f}): reckoned / measured "
          f"{ratio:.4f} (within {LONG_PEAK_RTOL:.0%}), temp {temp_ratio:.4f}"
          f"; built in {cell['build_s']} s ({card})")
    return {"walls_ms": walls, "peak": peak, "state": state,
            "reckoned": cell["peak_bytes"], "ratio": ratio,
            "temp_ratio": temp_ratio, "launches": launched}


def sharded_dryrun(dry):
    """(d): the worker's decode cells on the 16 x 16 production mesh,
    SHARDED_ARCH's decode_32k and LONG_ARCH's long_500k: reckoned, and no
    collective on a layer's local cache shard."""
    cells = dry.result("decode_32k", "long_500k")
    for name, arch in (("decode_32k", SHARDED_ARCH),
                       ("long_500k", LONG_ARCH)):
        r = cells[name]
        check(r["peak_bytes"] >= r["argument_bytes"] > 0
              and r["cache_collectives"] == [],
              f"sharded (d): {arch} {name} {r}")
        print(f"[sharded] (d) dry run {arch} x {name} x 16x16: "
              f"{gib(r['argument_bytes']):.3f} GiB of arguments a device, "
              f"{r['flops']:.4e} flops; {rank_note(r)}; no collective on a "
              f"cache shard; built in {r['build_s']} s (the worker)")
    return {name: cells[name] for name in ("decode_32k", "long_500k")}


def phase_sharded_decode(dev, card, dry):
    """Phase 19: the sharded decode (see the module docstring) on a
    one-rank nccl group: (a) ``sharded_exact``, (b) ``sharded_syncs``,
    (c) ``sharded_long``, then (d) ``sharded_dryrun``."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import init_params, serve_params
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = get_arch(SHARDED_ARCH)
        params = init_params(cfg, seed=0, device=dev)
        trees = {"memory": serve_params(params,
                                        bits=cfg.serve_weight_bits),
                 "sdv": serve_params(params, bits=cfg.serve_weight_bits,
                                     compute="sdv")}
        del params
        exact = sharded_exact(cfg, trees["memory"], dev, card, mesh)
        syncs = sharded_syncs(cfg, trees, dev)
        del trees
        long = sharded_long(dev, card, mesh, dry)
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    cells = sharded_dryrun(dry)
    print(f"[sharded] phase {time.perf_counter() - t_phase:.1f} s")
    return {"exact": exact, "syncs": syncs, "long": long, "dryrun": cells}


def _to(v, d):
    if isinstance(v, dict):
        return {k: _to(x, d) for k, x in v.items()}
    return v.to(d)


def timed(phase, *args):
    """``phase(*args)``, its wall printed as ``[time] <name> <s> s``."""
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        print(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s",
              flush=True)


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
    dry = HostDryRun()
    try:
        timed(phase_build)
        flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
        flush = flush_buf.zero_                # evicts the 50 MB L2
        layer = timed(phase_kernels, dev, flush)
        launches = timed(phase_serve, dev)
        timed(phase_reference, dev)
        conv, per_layer, head_ms = timed(phase_conv_kernels, dev, flush)
        ultra = timed(phase_ultranet, dev, per_layer, card)
        conv1d = timed(phase_conv1d_kernels, dev, flush)
        recurrent = timed(phase_recurrent, dev, card, flush)
        memory = timed(phase_memory_kernels, dev, flush)
        mem_launches = timed(phase_memory_serve, dev, card)
        timed(phase_reference, dev, "memory")
        eng = timed(phase_engine, dev, card)
        spec = timed(phase_spec, dev, card)
        train = timed(phase_train, dev, card, flush)
        moe = timed(phase_moe, dev, card, flush)
        fam = timed(phase_families, dev, card, flush)
        ssm = timed(phase_ssm_train, dev, card, flush)
        dist = timed(phase_dist, dev, card, dry)
        kv = timed(phase_kv_bf16, dev, card)
        timed(phase_remat, dev, card, dry, train, ssm, dist)
        sharded = timed(phase_sharded_decode, dev, card, dry)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        dry.stop()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    sources = {"B1": ("sdv_matvec", "src/repro/kernels/sdv_matvec.py:46"),
               "B2": ("sdv_matmul", "src/repro/kernels/sdv_matmul.py:178")}
    by_path = {"B1": {"tinyllama decode": launches["B1"],
                      "mamba2 decode": recurrent["mamba2-130m"]["B1"],
                      "recurrentgemma decode":
                          recurrent["recurrentgemma-2b"]["B1"],
                      "tinyllama engine": eng["B1"],
                      "tinyllama spec engine": spec["B1"],
                      "tinyllama QAT export decode":
                          train["launches"]["B1 export decode"],
                      "phi3.5-moe SDV decode":
                          moe["runs"]["sdv"]["decode"]["B1"],
                      **{f"{a} SDV decode": fam["runs"][a, "sdv"]["decode"]
                         ["B1"] for a in FAMILY_ARCHS},
                      "mamba2-130m QAT export decode":
                          ssm["mamba_qat"]["b1_decode"],
                      "tinyllama bf16-KV SDV decode":
                          kv["runs"]["sdv", KV_BITS]["decode"]["B1"],
                      "tinyllama bf16-KV single_batch_loop":
                          kv["loops"]["sdv"]["B1"],
                      "tinyllama bf16-KV speculative (draft)":
                          kv["spec"]["B1"]},
               "B2": {"tinyllama prefill": launches["B2"],
                      "ultranet int32": ultra["int32"]["B2"],
                      "tinyllama spec engine": spec["B2"],
                      "tinyllama QAT train": train["launches"]["B2 train"],
                      "tinyllama QAT export eval":
                          train["launches"]["B2 export eval"],
                      "phi3.5-moe SDV prefill":
                          moe["runs"]["sdv"]["prefill"]["B2"],
                      f"{FAMILY_ARCHS[1]} SDV prefill":
                          fam["runs"][FAMILY_ARCHS[1], "sdv"]["prefill"]["B2"],
                      f"{FAMILY_ARCHS[1]} SDV prefill chunk (wgmma)":
                          fam["runs"][FAMILY_ARCHS[1], "sdv"]["chunk"]["B2"],
                      **{f"{a} SDV forward": fam["runs"][a, "sdv"]["forward"]
                         ["B2"] for a in FAMILY_ARCHS},
                      **{f"{a} SDV forward": ssm["forward"][a, "sdv"]
                         ["launches"]["B2"] for a in SSM_ARCHS},
                      "mamba2-130m QAT train": ssm["mamba_qat"]["b2_run"],
                      "mamba2-130m QAT resume": ssm["mamba_qat"]["b2_resume"],
                      "mamba2-130m QAT export eval":
                          ssm["mamba_qat"]["b2_export_eval"],
                      f"recurrentgemma-2b ({ssm['hybrid_qat']['n_layers']} "
                      "layers) QAT train": ssm["hybrid_qat"]["b2_run"],
                      "tinyllama bf16-KV SDV prefill":
                          kv["runs"]["sdv", KV_BITS]["prefill"]["B2"],
                      "tinyllama bf16-KV speculative (verify)":
                          kv["spec"]["B2"]}}
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
                    "int32 W4A8 plan; " + (
                        f"draft_*: at {DECODE_ROWS} rows on the W4A4 draft's "
                        "dsp48e2 n=4 plan" if kname == "B1" else
                        f"verify_*: at {VERIFY_ROWS} rows on the target's "
                        f"dsp48e2 n=3 plan; qat_*: at {QAT_ROWS} rows on "
                        "the same plan (the STE forward), qat_head_*: the "
                        "LM head (2048 -> 32000) at those rows")),
        })
        path = "draft" if kname == "B1" else "verify"
        kernels[-1].update({f"{path}_{key}": acc[path][key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    kernels[1]["ultranet_head_ms"] = head_ms
    qat = train["b2"]
    kernels[1].update({f"qat_{key}": qat[key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "head_ms",
        "head_plain_ms", "head_bound_ms", "head_bound_by",
        "head_library_ms")})
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"],
                                    qat["max_abs_err"])
    for i, kname in enumerate(("B1", "B2")):
        acc = moe["kernels"][kname]
        kernels[i].update({f"moe_attn_{key}": acc[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        kernels[i]["max_abs_err"] = max(kernels[i]["max_abs_err"],
                                        acc["max_abs_err"])
        kernels[i]["per"] += (f"; moe_attn_*: one {MOE_ARCH} layer's 4 "
                              f"attention projections (K, M in 4096, 1024) "
                              "on the int32 W4A8 plan")
        for arch, short in zip(FAMILY_ARCHS, ("seamless", "llava")):
            acc = fam["kernels"][arch, kname]
            kernels[i].update({f"{short}_layer_{key}": acc[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
            kernels[i]["max_abs_err"] = max(kernels[i]["max_abs_err"],
                                            acc["max_abs_err"])
        kernels[i]["per"] += ("; seamless_layer_*: one seamless-m4t-large-v2 "
                              "decoder layer's 9 decode projections (1024 -> "
                              "1024 x6, 1024 -> 8192 x2, 8192 -> 1024); "
                              "llava_layer_*: one llava-next-mistral-7b "
                              "layer's 7 (4096 -> 4096 x2, 4096 -> 1024 x2, "
                              "4096 -> 14336 x2, 14336 -> 4096), int32 W4A8")
    b3_paths = {f"ultranet {name}": c["B3"] for name, c in ultra.items()}
    b3_paths["ste_conv2d QAT layer step"] = train["launches"]["B3 conv"]
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
                "recurrentgemma decode": recurrent["recurrentgemma-2b"]["B4"],
                **{f"{a} SDV forward": ssm["forward"][a, "sdv"]["launches"]
                   ["B4"] for a in SSM_ARCHS},
                "mamba2-130m QAT export eval":
                    ssm["mamba_qat"]["b4_export_eval"],
                "mamba2-130m QAT export decode":
                    ssm["mamba_qat"]["b4_decode"]}
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
                "tinyllama memory engine serve_params": eng["B6"],
                "phi3.5-moe SDV layer-wise build":
                    moe["runs"]["sdv"]["pack"]["B6"],
                "phi3.5-moe memory layer-wise build":
                    moe["runs"]["memory"]["pack"]["B6"],
                **{f"{a} memory serve_params": fam["runs"][a, "memory"]
                   ["pack"]["B6"] for a in FAMILY_ARCHS}},
               ("one tinyllama serve_params(compute=\"memory\"): 7 stacked "
                "W4 leaves of 22 layers + the LM head; no single PyTorch "
                "call packs bit fields: no library time")),
        "B7": ("unpack_dequant", "packbits.cu",
               "src/repro/kernels/packbits.py:41",
               {"tinyllama memory prefill": mem_launches["B7 prefill"],
                "tinyllama memory decode": mem_launches["B7 decode"],
                "tinyllama memory engine": eng["B7"],
                **{f"phi3.5-moe {c} {path}": moe["runs"][c][path]["B7"]
                   for c in ("sdv", "memory")
                   for path in ("prefill", "decode")},
                **{f"{a} memory {path}": fam["runs"][a, "memory"][path]["B7"]
                   for a in FAMILY_ARCHS
                   for path in ("prefill", "decode", "forward")},
                **{f"{a} memory forward": ssm["forward"][a, "memory"]
                   ["launches"]["B7"] for a in SSM_ARCHS},
                "tinyllama bf16-KV memory prefill":
                    kv["runs"]["memory", KV_BITS]["prefill"]["B7"],
                "tinyllama bf16-KV memory decode":
                    kv["runs"]["memory", KV_BITS]["decode"]["B7"],
                "tinyllama bf16-KV memory single_batch_loop":
                    kv["loops"]["memory"]["B7"],
                **{f"tinyllama (1, 1) mesh {kind} {path}":
                   sharded["exact"][bits][path]["B7"]
                   for bits, kind in ((8, "int8-KV"), (KV_BITS, "bf16-KV"))
                   for path in ("prefill", "decode")},
                "tinyllama (1, 1) mesh decode_32k (2 steps)":
                    2 * sharded["long"]["launches"]["B7"]},
               ("one tinyllama memory decode step: 154 W4 projections + the "
                "LM head, unpacked and dequantized to bf16 in one pass "
                "(unpack_dequant_kernel); before_ms: the route it replaced "
                "(int8 B7 + scale, trim and cast in torch); int8_*: the "
                "int8 unpack_words_kernel at the same shapes; no single "
                "PyTorch call unpacks bit fields: no library time; moe_*: "
                f"the {MOE_ARCH} expert banks of one decode step, "
                "3 x 32 calls on [16 * 4096, 800] and [16 * 6400, 512] "
                "words")),
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
        if kname in ("B6", "B7"):
            for case, r in fam["kernels"][kname].items():
                key = case.lower().replace(" ", "_")
                entry.update({f"{key}_{k}": r[k] for k in (
                    "ms", "plain_ms", "bound_ms")})
            entry["per"] += (
                "; seamless_* / llava_*: seamless-m4t-large-v2's and "
                "llava-next-mistral-7b's " + (
                    "LM heads and stacked leaves (stack_RxC: L layers' "
                    "[K, C] kernels as [L * K, C]), W4"
                    if kname == "B6" else
                    "LM heads and decode projections (KxM), W4, bf16"))
        if kname == "B7":
            bank = moe["kernels"]["B7"]
            entry.update({f"moe_{key}": bank[key] for key in (
                "ms", "plain_ms", "bound_ms", "before_ms")})
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
