"""SDV packed GEMV (kernel B1) — torch port of
``repro.kernels.sdv_matvec``.

The decode-micro-batch form of the SDV GEMM: K-major activations
``[K, B]`` with B <= 8 rows.  On a CUDA tensor it launches
``csrc/sdv.cu::sdv_gemv_kernel``: the B rows are one N = 8 tensor-core
tile, each block decodes its word columns once into int8 lanes and the
K loop is split across blocks to fill the card.  On a CPU tensor it runs
the plain version (``sdv_matmul.sdv_matmul_plain`` on the transposed
activations).
"""
from __future__ import annotations

import torch

from ..device import plain_route
from .sdv_matmul import (GEMV_MAX_ROWS, check_operands, launch,
                         sdv_matmul_plain)


def sdv_matvec(x_t: torch.Tensor, w_words: torch.Tensor, *,
               plan) -> torch.Tensor:
    """Packed GEMV (kernel B1).

    Args:
      x_t: [K, B] activations (K-major), B <= 8, values within w_b
        bits: int32, or the one-byte container at w_b <= 8.
      w_words: [K, G] int32 storage words, or [2, K, G] limb planes.
      plan: SDV lane plan on an exact-wrap datapath, n <= 15, any
        operand widths.

    Returns:
      [B, G, n] int32 — exact per-lane dot products.
    """
    b, k, g = check_operands(x_t, w_words, plan, k_axis=0)
    if b > GEMV_MAX_ROWS:
        raise ValueError(f"the GEMV takes at most {GEMV_MAX_ROWS} rows, "
                         f"got {b}")
    if plain_route(x_t):
        return sdv_matmul_plain(x_t.T, w_words, plan)
    out = launch("sdv_gemv", x_t.to(torch.int32).contiguous(), w_words,
                 plan, b, k, g)
    sdv_matvec.launches += 1
    return out


sdv_matvec.launches = 0
