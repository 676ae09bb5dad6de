"""Transport planes for the 33..64-bit DSP words.

Torch has native int64, so inside the port a wide word is one int64
tensor whose bit pattern is the word mod 2^64.  At the kernel boundary
(and for bit-for-bit comparison with the JAX package) a word travels as
one int32 array with a leading ``(2,)`` plane axis: ``planes[0]`` = bits
0..31 (lo), ``planes[1]`` = bits 32..63 (hi), each holding a uint32 bit
pattern — the layout of ``repro.core.limbs.stack_planes``.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _as_int32(u32: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 tensor with that bit
    pattern (explicit wrap: no reliance on narrowing-cast behaviour)."""
    return (u32 - ((u32 >> 31) << 32)).to(torch.int32)


def lo32(word: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 word as an int32 bit pattern."""
    return _as_int32(word & _U32)


def to_planes(word: torch.Tensor) -> torch.Tensor:
    """int64 words [...] -> int32 planes [2, ...] (lo, hi)."""
    return torch.stack([lo32(word), lo32(word >> 32)])


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """Zero-extend an int32 bit pattern to int64."""
    return x.to(torch.int64) & _U32


def from_planes(planes: torch.Tensor) -> torch.Tensor:
    """int32 planes [2, ...] -> int64 words [...] (hi << 32 | lo)."""
    return (planes[1].to(torch.int64) << 32) | from_u32(planes[0])
