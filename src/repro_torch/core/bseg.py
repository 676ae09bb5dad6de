"""Binary Segmentation (BSEG) packing helpers of the conv path (paper
Sec. III-D, Figs. 6/7).

Torch port of the part of ``repro.core.bseg`` that the conv path needs:
the pre-adder packing of the reversed kernel taps, the word dtype of a
plan's datapath, and the wide-multiply count of one 1-D BSEG conv.
Every packed value is computed in int64 (exact for every datapath);
``kernels.ops.prepare_bseg_conv2d`` narrows it to the plan's transport.
"""
from __future__ import annotations

import torch

from .datapath import BSEGPlan
from .signed_split import pack_signed


def word_dtype(plan: BSEGPlan) -> torch.dtype:
    """The datapath word's dtype: float32 for FP32M, int32 for words of
    at most 32 bits, int64 for the wide DSP48E2/DSP58 words."""
    if not plan.spec.exact_wrap:
        return torch.float32
    return torch.int32 if plan.spec.w_word <= 32 else torch.int64


def bseg_pack_kernel(taps: torch.Tensor, plan: BSEGPlan) -> torch.Tensor:
    """Pack (reversed) kernel taps [..., n_k] into the first factor via
    the pre-adder (taps are signed).  Returns the exact int64 words."""
    assert taps.shape[-1] == plan.n_k
    return pack_signed(taps.flip(-1), plan.w_k, plan.lane)


def bseg_num_multiplies(n_taps: int, m: int, plan: BSEGPlan) -> int:
    """Wide multiplies consumed by one 1-D BSEG conv of ``n_taps`` taps
    over ``m`` inputs (the density / resource accounting)."""
    groups = -(-n_taps // plan.n_k)
    m_out = m - n_taps + 1
    n_steps = -(-(m_out + plan.n_k - 1) // plan.n_i)
    return groups * n_steps
