"""Lane pack (kernel B6) and unpack (kernel B7) — torch port of
``repro.kernels.packbits``.

The HBM storage layout of the memory-packed serving mode: ``32 // w``
consecutive values of the minor axis share one int32 word (two's-
complement w-bit fields, word j holding columns ``j*per .. j*per+per-1``;
the sign is restored on unpack).

On a CUDA tensor ``pack_words`` / ``unpack_words`` launch the
hand-written Hopper kernels ``csrc/packbits.cu::pack_words_kernel`` /
``unpack_words_kernel``; on a CPU tensor they run ``pack_words_plain`` /
``unpack_words_plain`` (``ref.pack_words_ref`` / ``unpack_words_ref``).
There is no fallback between the two: a CUDA tensor that the kernel
cannot take raises.  The reference's TPU tile (``block``) is gone: the
kernels take any number of rows and words.
"""
from __future__ import annotations

import torch

from ..device import sm_count
from . import build, ref

#: threads per block, and resident blocks per SM the grid-stride loop
#: is sized for
BLOCK_THREADS = 256
BLOCKS_PER_SM = 8
#: the int8 side moves as 16-byte vectors for w = 2 (8 bytes for w = 4)
_ALIGN = 16


def _check_w(w: int) -> int:
    if not 2 <= w <= 8:
        raise ValueError(f"field width w must be in 2..8, got {w}")
    return 32 // w


def _grid(n_words: int, device: torch.device) -> int:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return max(1, min(-(-n_words // BLOCK_THREADS),
                      BLOCKS_PER_SM * sm_count(index)))


def _check_int8_side(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % _ALIGN:
        raise ValueError(f"{what} must start {_ALIGN}-byte aligned")


def pack_words_plain(vals: torch.Tensor, *, w: int) -> torch.Tensor:
    """Plain torch version of B6 (same operands and result)."""
    pack_words_plain.calls += 1
    return ref.pack_words_ref(vals, w=w)


pack_words_plain.calls = 0


def unpack_words_plain(packed: torch.Tensor, *, w: int) -> torch.Tensor:
    """Plain torch version of B7 (same operands and result)."""
    unpack_words_plain.calls += 1
    return ref.unpack_words_ref(packed, w=w)


unpack_words_plain.calls = 0


def pack_words(vals: torch.Tensor, *, w: int) -> torch.Tensor:
    """int8 [m, n] -> int32 [m, n // (32 // w)] lane words (kernel B6).

    ``n`` must be a multiple of ``32 // w``; each value is masked to its
    w low bits (two's complement)."""
    per = _check_w(w)
    if vals.dtype != torch.int8 or vals.ndim != 2:
        raise ValueError(f"values must be 2-D int8, got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    m, n = vals.shape
    if n % per:
        raise ValueError(f"{n} columns are not a multiple of the {per} "
                         f"fields of a W{w} word")
    if not vals.is_contiguous():
        raise ValueError("values must be contiguous")
    if vals.device.type == "cpu":
        return pack_words_plain(vals, w=w)
    out = torch.empty((m, n // per), dtype=torch.int32, device=vals.device)
    if out.numel() == 0:
        return out
    _check_int8_side(vals, "values")
    lib = build.library("packbits")
    err = lib.pack_words(vals.data_ptr(), out.data_ptr(), out.numel(), w,
                         _grid(out.numel(), vals.device), BLOCK_THREADS,
                         torch.cuda.current_stream(vals.device).cuda_stream)
    build.check(lib, err, "pack_words")
    pack_words.launches += 1
    return out


pack_words.launches = 0


def unpack_words(packed: torch.Tensor, *, w: int) -> torch.Tensor:
    """int32 [m, nw] lane words -> int8 [m, nw * (32 // w)],
    sign-extended (kernel B7)."""
    per = _check_w(w)
    if packed.dtype != torch.int32 or packed.ndim != 2:
        raise ValueError(f"words must be 2-D int32, got "
                         f"{tuple(packed.shape)} {packed.dtype}")
    if not packed.is_contiguous():
        raise ValueError("words must be contiguous")
    if packed.device.type == "cpu":
        return unpack_words_plain(packed, w=w)
    m, nw = packed.shape
    out = torch.empty((m, nw * per), dtype=torch.int8, device=packed.device)
    if out.numel() == 0:
        return out
    _check_int8_side(out, "the unpacked values")
    lib = build.library("packbits")
    err = lib.unpack_words(packed.data_ptr(), out.data_ptr(), packed.numel(),
                           w, _grid(packed.numel(), packed.device),
                           BLOCK_THREADS,
                           torch.cuda.current_stream(packed.device)
                           .cuda_stream)
    build.check(lib, err, "unpack_words")
    unpack_words.launches += 1
    return out


unpack_words.launches = 0
