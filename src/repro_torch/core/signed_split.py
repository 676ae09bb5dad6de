"""Packing of signed values via the DSP pre-adder (paper Fig. 3).

In two's complement, a ``w``-bit value is  v = -2^(w-1) s + r  with sign
bit ``s`` (negative radix weight) and non-negative remainder ``r``.
After slicing the sign bit off every element, the remainders concatenate
into one word ``D`` and the sign bits (at their lane positions, weighted
2^(w-1)) collect into a word ``A``.  A *single* subtraction

    packed = D - A = sum_i 2^(i L) v_i

performed by the DSP's internal pre-adder packs an arbitrary number of
signed values with zero external logic.

Torch port of ``repro.core.signed_split``: every word is one int64
tensor (wrapping mod 2^64), which covers both the int32 word and the
wide DSP48E2/DSP58 words that the JAX package carries as two int32
limbs; ``core.limbs.to_planes`` gives the limb transport layout.
"""
from __future__ import annotations

import torch


def split_signed(values: torch.Tensor, width: int):
    """Slice the sign bit off each ``width``-bit signed element.

    Returns (r, s): non-negative remainders (width-1 bits) and sign bits,
    such that  v = r - 2^(width-1) * s.
    """
    if values.dtype == torch.bool:
        values = values.to(torch.int32)
    mag = (1 << (width - 1)) - 1
    r = values & mag
    s = (values >> (width - 1)) & 1
    return r, s


def lane_shifts(n: int, lane: int, device=None) -> torch.Tensor:
    """Per-element lane scale factors 2^(i*L), i = 0..n-1, as int64."""
    return torch.tensor([1 << (i * lane) for i in range(n)],
                        dtype=torch.int64, device=device)


def pack_signed(values: torch.Tensor, width: int, lane: int) -> torch.Tensor:
    """Pre-adder packing of signed elements along the last axis.

    values: integer tensor [..., n], elements in [-2^(w-1), 2^(w-1)).
    Returns the packed int64 words [...]:  D - A.
    """
    n = values.shape[-1]
    r, s = split_signed(values.to(torch.int64), width)
    scale = lane_shifts(n, lane, values.device)
    d_word = (r * scale).sum(-1)
    a_word = ((s << (width - 1)) * scale).sum(-1)
    return d_word - a_word           # the pre-adder subtraction


def pack_unsigned(values: torch.Tensor, width: int,
                  lane: int) -> torch.Tensor:
    """Plain concatenation packing of unsigned elements (last axis)."""
    del width  # kept for interface symmetry; values must be non-negative
    n = values.shape[-1]
    scale = lane_shifts(n, lane, values.device)
    return (values.to(torch.int64) * scale).sum(-1)


def pack(values: torch.Tensor, width: int, lane: int, *,
         signed: bool) -> torch.Tensor:
    return (pack_signed if signed else pack_unsigned)(values, width, lane)
