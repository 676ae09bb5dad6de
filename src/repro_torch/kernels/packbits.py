"""Lane pack (kernel B6), unpack (kernel B7) and the fused unpack-and-
dequantize that memory-mode serving runs as B7 — torch port of
``repro.kernels.packbits`` and of the dequant in
``repro.models.quantized.materialize``.

The HBM storage layout of the memory-packed serving mode: ``32 // w``
consecutive values of the minor axis share one int32 word (two's-
complement w-bit fields, word j holding columns ``j*per .. j*per+per-1``;
the sign is restored on unpack).

On a CUDA tensor ``pack_words`` / ``unpack_words`` / ``unpack_dequant``
launch the hand-written Hopper kernels ``csrc/packbits.cu::
pack_words_kernel`` / ``unpack_words_kernel`` / ``unpack_dequant_kernel``;
on a CPU tensor they run ``pack_words_plain`` / ``unpack_words_plain`` /
``unpack_dequant_plain``.  There is no fallback between the two: a CUDA
tensor that the kernel cannot take raises.  The reference's TPU tile
(``block``) is gone: the kernels take any number of rows and words.
``unpack_dequant`` writes the dequantized weights (bf16 or float32) in
one pass, bit for bit what ``unpack_words`` followed by the reference's
scale, trim and cast gives; ``unpack_words`` stays as the counterpart of
the TPU kernel and is on no model path.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import plain_route, sm_count
from . import build, ref

#: threads per block, and resident blocks per SM the grid-stride loop
#: is sized for
BLOCK_THREADS = 256
BLOCKS_PER_SM = 8
#: the int8 side moves as 16-byte vectors for w = 2 (8 bytes for w = 4)
_ALIGN = 16
#: unpack_dequant: words a warp owns in a row (32 lanes x 4), warps per
#: block (they split a slab's rows), the blocks an SM holds (the
#: kernel's ``kMinBlocks``: one wave of them is the grid), and the grid's
#: y limit
SPAN_WORDS = 128
DEQUANT_WARPS = 8
DEQUANT_BLOCKS_PER_SM = 2
MAX_GRID_Y = 65535
#: the output dtypes of unpack_dequant (csrc: out_f32 0 / 1)
DEQUANT_DTYPES = (torch.bfloat16, torch.float32)


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
    if plain_route(vals):
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
    if plain_route(packed):
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


def _check_dequant(words: torch.Tensor, scale: torch.Tensor, *, w: int,
                   d_out: int, rows_per_scale: int, dtype) -> None:
    per = _check_w(w)
    if dtype not in DEQUANT_DTYPES:
        raise ValueError(f"unpack_dequant writes bfloat16 or float32, not "
                         f"{dtype}")
    if words.dtype != torch.int32 or words.ndim != 2:
        raise ValueError(f"words must be 2-D int32, got "
                         f"{tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous() or not scale.is_contiguous():
        raise ValueError("words and scale must be contiguous")
    m, nw = words.shape
    if rows_per_scale < 1 or m % rows_per_scale:
        raise ValueError(f"{m} rows are not a whole number of groups of "
                         f"rows_per_scale={rows_per_scale}")
    want = (m // rows_per_scale, nw * per)
    if scale.dtype != torch.float32 or tuple(scale.shape) != want:
        raise ValueError(f"scale must be float32 {want} (one row of "
                         f"{nw * per} column scales per group), got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not 1 <= d_out <= nw * per:
        raise ValueError(f"d_out={d_out} is not in 1..{nw * per}")
    if scale.device != words.device:
        raise ValueError(f"words on {words.device}, scale on "
                         f"{scale.device}")


def unpack_dequant_plain(words: torch.Tensor, scale: torch.Tensor, *,
                         w: int, d_out: int, rows_per_scale: int,
                         dtype) -> torch.Tensor:
    """Plain torch version of the fused B7, step for step the chain it
    replaces: the int8 unpack (``unpack_words_plain``), ``.to(float32)``
    times each group's scale row, the trim to ``d_out``, ``.to(dtype)``."""
    unpack_dequant_plain.calls += 1
    q = unpack_words_plain(words, w=w)
    m, n_pad = q.shape
    deq = q.to(torch.float32).reshape(-1, rows_per_scale, n_pad) \
        * scale[:, None, :]
    return deq.reshape(m, n_pad)[:, :d_out].to(dtype)


unpack_dequant_plain.calls = 0


def store_unit(w: int, dtype) -> int:
    """Bytes a vector store of ``unpack_dequant_kernel`` moves: the widest
    of 16, 8 and 4 that divides one word's ``32 // w`` outputs (else
    one element), as ``csrc/packbits.cu::store_unit``."""
    size = (32 // w) * dtype.itemsize
    return next((u for u in (16, 8, 4) if size % u == 0), dtype.itemsize)


def vector_store(w: int, dtype, d_out: int) -> bool:
    """Whether the vector-store instantiation can write rows of ``d_out``
    outputs: every row must start aligned to ``store_unit`` (the output
    is a fresh allocation, so its base is)."""
    unit = store_unit(w, dtype)
    return unit > dtype.itemsize and (d_out * dtype.itemsize) % unit == 0


def launch_shape(m: int, nw: int, rows_per_scale: int, *, sms: int,
                 blocks_per_sm: int = DEQUANT_BLOCKS_PER_SM):
    """(spans, slabs, rows per slab) of one ``unpack_dequant`` launch.

    A block of ``DEQUANT_WARPS`` warps owns one span of ``SPAN_WORDS``
    words (grid x) and one slab of rows inside one group of
    ``rows_per_scale`` rows (grid y: the groups' slabs in order); its
    warps take every ``DEQUANT_WARPS``-th row of the slab, their scales
    in registers.  Each group is cut into as many slabs (a multiple of
    ``DEQUANT_WARPS`` rows each) as make one wave of ``blocks_per_sm``
    blocks on every SM: a second wave would run part empty."""
    groups = m // rows_per_scale
    spans = -(-nw // SPAN_WORDS)
    per_group = max(1, blocks_per_sm * sms // (spans * groups))
    rows = -(-rows_per_scale // per_group)
    rows = -(-rows // DEQUANT_WARPS) * DEQUANT_WARPS
    return spans, groups * -(-rows_per_scale // rows), rows


def unpack_dequant(words: torch.Tensor, scale: torch.Tensor, *, w: int,
                   d_out: int, rows_per_scale: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """int32 lane words [m, nw] and float32 scales [m / rows_per_scale,
    nw * (32 // w)] -> [m, d_out] ``dtype`` (bfloat16 or float32):
    ``out[r, c] = dtype(float(field c of row r) * scale[r //
    rows_per_scale, c])`` — the fused unpack-and-dequantize (kernel B7 as
    memory-mode serving runs it).  A stacked container is one call, one
    group of ``rows_per_scale`` rows a layer."""
    _check_dequant(words, scale, w=w, d_out=d_out,
                   rows_per_scale=rows_per_scale, dtype=dtype)
    if plain_route(words):
        return unpack_dequant_plain(words, scale, w=w, d_out=d_out,
                                    rows_per_scale=rows_per_scale,
                                    dtype=dtype)
    from torch.distributed.tensor import DTensor
    if isinstance(words, DTensor) or isinstance(scale, DTensor):
        # no data pointer of its own: materialize launches on each rank's
        # local shard instead
        raise TypeError(
            "unpack_dequant launches on plain CUDA tensors, not DTensors: "
            "materialize a PackedLinear of DTensors (it runs the kernel on "
            "each rank's local shard), or pass to_local() shards")
    if words.shape[0] // rows_per_scale > MAX_GRID_Y:
        raise ValueError(f"the kernel takes at most {MAX_GRID_Y} groups of "
                         f"rows_per_scale rows, got "
                         f"{words.shape[0] // rows_per_scale}")
    if (32 // w) % 4 == 0 and scale.data_ptr() % _ALIGN:
        raise ValueError(f"scale must start {_ALIGN}-byte aligned (the "
                         "kernel loads a word's scales as 16-byte runs)")
    out = launch_dequant(words, scale, w=w, d_out=d_out,
                         rows_per_scale=rows_per_scale, dtype=dtype)
    unpack_dequant.launches += 1
    return out


unpack_dequant.launches = 0


def launch_dequant(words: torch.Tensor, scale: torch.Tensor, *, w: int,
                   d_out: int, rows_per_scale: int, dtype,
                   rows: Optional[int] = None, lib=None) -> torch.Tensor:
    """Launch ``csrc/packbits.cu::unpack_dequant_kernel`` on checked CUDA
    operands.  ``rows`` (per slab) defaults to ``launch_shape``'s and
    ``lib`` to the built source (a breakdown script passes others)."""
    m, nw = words.shape
    out = torch.empty((m, d_out), dtype=dtype, device=words.device)
    if rows is None:
        index = words.device.index if words.device.index is not None \
            else torch.cuda.current_device()
        rows = launch_shape(m, nw, rows_per_scale, sms=sm_count(index))[2]
    vec_load = nw % 4 == 0 and words.data_ptr() % 16 == 0
    if lib is None:
        lib = build.library("packbits")
    err = lib.unpack_dequant(
        words.data_ptr(), scale.data_ptr(), out.data_ptr(), m, nw, d_out,
        rows_per_scale, w, int(dtype == torch.float32),
        int(vector_store(w, dtype, d_out)), int(vec_load), rows,
        torch.cuda.current_stream(words.device).cuda_stream)
    build.check(lib, err, "unpack_dequant")
    return out
