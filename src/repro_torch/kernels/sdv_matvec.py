"""SDV packed GEMV (kernel B1) — torch port of
``repro.kernels.sdv_matvec``.

The decode-micro-batch form of the SDV GEMM: K-major activations
``[K, B]`` with B <= 8 rows.  On a CUDA tensor it launches
``csrc/sdv.cu::sdv_gemv_kernel`` — one thread per lane group streams
its column of words once and keeps every row's accumulator and spill
counters in registers.  On a CPU tensor it runs the plain version
(``sdv_matmul.sdv_matmul_plain`` on the transposed activations).
"""
from __future__ import annotations

import torch

from . import build
from .sdv_matmul import (GEMV_MAX_ROWS, GEMV_THREADS, check_operands,
                         k_chunk, plan_flags, sdv_matmul_plain)

#: smallest K chunk one GEMV block takes
_GEMV_K_STEP = 64


def sdv_matvec(x_t: torch.Tensor, w_words: torch.Tensor, *,
               plan) -> torch.Tensor:
    """Packed GEMV (kernel B1).

    Args:
      x_t: [K, B] int32 activations (K-major), B <= 8, values within
        w_b bits.
      w_words: [K, G] int32 storage words, or [2, K, G] limb planes.
      plan: SDV lane plan on an exact-wrap datapath, n <= 15.

    Returns:
      [B, G, n] int32 — exact per-lane dot products.
    """
    b, k, g = check_operands(x_t, w_words, plan, k_axis=0)
    if b > GEMV_MAX_ROWS:
        raise ValueError(f"the GEMV takes at most {GEMV_MAX_ROWS} rows, "
                         f"got {b}")
    if x_t.device.type == "cpu":
        return sdv_matmul_plain(x_t.T, w_words, plan)
    out = torch.empty((b, g, plan.n), dtype=torch.int32, device=x_t.device)
    chunk = k_chunk(k, -(-g // GEMV_THREADS), _GEMV_K_STEP, x_t.device)
    lib = build.library("sdv")
    err = lib.sdv_gemv(x_t.data_ptr(), w_words.data_ptr(), out.data_ptr(),
                       b, k, g, plan.n, plan.lane, plan.w_a,
                       plan.packed_width, plan_flags(plan), chunk,
                       torch.cuda.current_stream(x_t.device).cuda_stream)
    build.check(lib, err, "sdv_gemv")
    sdv_matvec.launches += 1
    return out


sdv_matvec.launches = 0
