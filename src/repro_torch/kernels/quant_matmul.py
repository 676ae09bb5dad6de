"""Unpack-in-kernel quantized matmul (kernel B5) — torch port of
``repro.kernels.quant_matmul`` (the ``packed_memory`` route of the
packed-matmul dispatch).

``y = x @ (unpack(words) * scale)``: weights stay in HBM as int32 lane
words (``32 // w`` w-bit fields each, the ``packbits`` layout) and are
unpacked and sign-extended inside the kernel; the products of x and the
fields are summed in float32 and the per-output-channel scale is applied
to the sum, as in the reference.

On a CUDA tensor ``quant_matmul`` launches the hand-written Hopper kernel
``csrc/quant_matmul.cu::quant_matmul_kernel``: each word is decoded once
into bf16 fields (exact, |field| <= 128; ``decode_fields_plain`` mirrors
the decode) and multiplied on the bf16 tensor cores with float32
accumulation, which forms every product exactly; float32 x is split
exactly into three bf16 parts (``split_x_plain``), never rounded to
TF32.  The accumulator restarts every ``ACC_STAGES`` stages of 64 k into
a float32 total, K is split across blocks where the grid is small
(``launch_geometry``), and the splits are added in a fixed order, so a
launch is deterministic (``summation_model_plain`` repeats the order).
On a CPU tensor it runs ``quant_matmul_plain`` (``ref.quant_matmul_ref``
on ``ref.unpack_words_ref``'s integers).  There is no fallback between
the two: a CUDA tensor that the kernel cannot take raises.  The
reference's TPU blocks (``bm``, ``bn``, ``bk``, which had to divide the
shape) are gone: the kernel takes any m, n and k.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import plain_route, sm_count
from . import build, ref

#: activation dtypes the kernel reads (others are the caller's to widen)
X_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel's tiles (mirrors csrc/quant_matmul.cu): output columns per
#: block (A rows), k per stage, x rows per block at m <= 8 and above
TILE_COLS = 128
TILE_K = 64
DECODE_ROWS = 8
PREFILL_ROWS = 64
#: blocks per SM the K split aims for, and the fewest stages a split
#: takes (more at 64 rows, whose partial tiles are 8x larger)
BLOCKS_PER_SM = 2
MIN_SPLIT_STAGES = {DECODE_ROWS: 2, PREFILL_ROWS: 4}
#: stages of 64 k between restarts of the MMA accumulator, whose chunk
#: sums are added into a float32 total (mirrors csrc/quant_matmul.cu's
#: kAccStages)
ACC_STAGES = 1


def words_per_tile(w: int) -> int:
    """Word columns of one block: as many of ``32 // w`` fields as fit
    ``TILE_COLS``, rounded down to a multiple of 4 (so a tile's words
    start 16-byte aligned): 128 columns at w = 2, 4, 7, 8, 120 else."""
    return TILE_COLS // (32 // w) // 4 * 4


def check_operands(x: torch.Tensor, w_packed: torch.Tensor,
                   scale: torch.Tensor, *, w: int) -> int:
    """Validate B5's operands; returns n, the unpacked column count."""
    if not 2 <= w <= 8:
        raise ValueError(f"field width w must be in 2..8, got {w}")
    if x.dtype not in X_DTYPES or x.ndim != 2:
        raise ValueError(f"x must be 2-D float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w_packed.dtype != torch.int32 or w_packed.ndim != 2:
        raise ValueError(f"words must be 2-D int32, got "
                         f"{tuple(w_packed.shape)} {w_packed.dtype}")
    k, nw = w_packed.shape
    n = nw * (32 // w)
    if x.shape[1] != k or k < 1 or x.shape[0] < 1 or nw < 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, words "
                         f"{tuple(w_packed.shape)}: need x [m, k] against "
                         "words [k, nw], all nonzero")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be float32 [{n}], got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not (x.device == w_packed.device == scale.device):
        raise ValueError(f"operands on {x.device}, {w_packed.device} and "
                         f"{scale.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return n


def error_bound(x: torch.Tensor, w_int: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|y - exact|`` for any float32 evaluation of
    B5's function (the k products summed in any order, then one product
    with the scale): gamma_{k+1} (|x| @ |w_int|) |scale|, with gamma_j =
    j u / (1 - j u) and u = 2^-24 (the standard inner-product bound),
    computed in float64.  Against the exact float64 result both the
    kernel and its plain version lie within it, so they lie within twice
    it of each other."""
    k = x.shape[-1]
    u = 2.0 ** -24
    gamma = (k + 1) * u / (1 - (k + 1) * u)
    mag = x.to(torch.float64).abs() @ w_int.to(torch.float64).abs()
    return gamma * mag * scale.to(torch.float64).abs().reshape(1, -1)


#: the limit on ``|y - exact|`` in units of ``rounding_scale``, set from
#: readings (chip_smoke.py on an H100, tinyllama shapes at 8 and 128
#: rows): the kernel's float32 FMA chain in order k = 0, 1, ... reads at
#: most 4.1 at the worst output of a case (1.4 on bf16 x); x rounded to
#: TF32's 10 mantissa bits reads 187-460, and bf16-rounded x 1400-3500
ROUNDING_LIMIT = 8.0


def rounding_scale(x: torch.Tensor, w_int: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Elementwise typical size of float32 rounding in B5's function:
    sqrt(k) u sqrt(sum_j (x_j w_j)^2) |scale|, u = 2^-24, in float64.
    Each partial sum of the k products is rounded by up to u of itself,
    and random roundings add as a random walk, so a sound float32
    evaluation lies within a few of it of the exact result, about
    sqrt(k) closer than ``error_bound``; one that rounds x (TF32, bf16)
    lies far outside.  Held at ``ROUNDING_LIMIT`` beside the bound."""
    k = x.shape[-1]
    sq = x.to(torch.float64).square() @ w_int.to(torch.float64).square()
    return (k ** 0.5 * 2.0 ** -24) * sq.sqrt() \
        * scale.to(torch.float64).abs().reshape(1, -1)


def decode_fields_plain(w_packed: torch.Tensor, *, w: int) -> torch.Tensor:
    """The kernel's decode, plain: words [k, nw] -> its bf16 A tiles in
    slot order, [n, k] (row ``j (32 // w) + i`` holds field i of word
    column j, k contiguous; a block's tile is rows ``[x 128, +128)`` of
    it, 120 at w = 3, 5, 6), each field sign-extended and exact in
    bf16."""
    return ref.unpack_words_ref(w_packed, w=w).T.to(torch.bfloat16)


def split_x_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """float32 x -> (hi, mid, lo) bf16 with ``hi + mid + lo == x``, as the
    kernel splits it: hi keeps x's top 8 significand bits (truncated, so
    the largest float32 stays finite), mid the top 8 of the exact
    remainder, lo the rest.  Exact for |x| >= 2^-110 and 0; below,
    bits under bf16's smallest subnormal 2^-133 are lost."""
    def trunc(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)
    hi = trunc(x)
    r = x - hi
    mid = trunc(r)
    return (hi.to(torch.bfloat16), mid.to(torch.bfloat16),
            (r - mid).to(torch.bfloat16))


class Geometry(NamedTuple):
    rows: int        # x rows per block: 8 or 64
    words: int       # word columns per block
    kchunk: int      # k per split, a multiple of TILE_K
    grid: tuple      # (column tiles, row tiles, splits)
    workspace: int   # float32 partials, [splits][m][n] (0 for one split)
    tickets: int     # one int per (column tile, row tile) (0 likewise)


def launch_geometry(m: int, n: int, k: int, w: int, sms: int) -> Geometry:
    """The kernel's launch for x [m, k] against n columns of w-bit fields:
    blocks of ``words_per_tile(w)`` word columns x 8 rows (m <= 8) or 64,
    with K split until about ``BLOCKS_PER_SM`` blocks per SM are in flight
    (each split a multiple of ``TILE_K`` and at least
    ``MIN_SPLIT_STAGES`` stages)."""
    rows = DECODE_ROWS if m <= DECODE_ROWS else PREFILL_ROWS
    words = words_per_tile(w)
    gx = -(-(n // (32 // w)) // words)
    gy = -(-m // rows)
    stages = -(-k // TILE_K)
    split = max(1, min(stages // MIN_SPLIT_STAGES[rows],
                       -(-sms * BLOCKS_PER_SM // (gx * gy))))
    kchunk = -(-stages // split) * TILE_K
    gz = -(-k // kchunk)
    return Geometry(rows, words, kchunk, (gx, gy, gz),
                    gz * m * n if gz > 1 else 0, gx * gy if gz > 1 else 0)


def summation_model_plain(x: torch.Tensor, w_int: torch.Tensor,
                          scale: torch.Tensor, geo: Geometry, *,
                          acc_stages: int = ACC_STAGES) -> torch.Tensor:
    """A plain model of the kernel's float32 summation order, for x [m, k]
    (float32 or bf16) and integer weights [k, n]: in each split, MMA
    steps of 16 k (three per step for float32 x, its lo, mid and hi parts
    in that order) whose exact products are added to the accumulator and
    the sum truncated toward zero to float32 (a pessimistic model of the
    tensor cores' alignment), the accumulator added into a float32 total
    every ``acc_stages`` stages (round to nearest; 0: never), the splits'
    partials added in order 0..S-1, then the scale.  Float64 carries the
    exact sums."""
    xf = x.to(torch.float32)
    parts = ([p.to(torch.float64) for p in reversed(split_x_plain(xf))]
             if x.dtype == torch.float32 else [xf.to(torch.float64)])
    wd = w_int.to(torch.float64)
    k = x.shape[1]

    def rz(v):   # float64 -> float32, rounded toward zero
        f = v.to(torch.float32)
        over = f.to(torch.float64).abs() > v.abs()
        return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)

    out = None
    for k0 in range(0, k, geo.kchunk):
        kend = min(k, k0 + geo.kchunk)
        acc = torch.zeros((x.shape[0], w_int.shape[1]), dtype=torch.float32)
        total = torch.zeros_like(acc)
        for t, s in enumerate(range(k0, kend, TILE_K)):
            for ks in range(s, min(kend, s + TILE_K), 16):
                ke = min(kend, ks + 16)
                for part in parts:
                    acc = rz(acc.to(torch.float64)
                             + part[:, ks:ke] @ wd[ks:ke])
            if acc_stages and (t + 1) % acc_stages == 0:
                total = total + acc
                acc = torch.zeros_like(acc)
        partial = total + acc
        out = partial if out is None else out + partial
    return out * scale


def quant_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor, *, w: int) -> torch.Tensor:
    """Plain torch version of B5 (same operands and result, up to the
    float32 summation order)."""
    quant_matmul_plain.calls += 1
    return ref.quant_matmul_ref(x, ref.unpack_words_ref(w_packed, w=w),
                                scale)


quant_matmul_plain.calls = 0


#: per (device, stream): the zeroed split-K tickets, which each launch
#: leaves zero again
_tickets: dict = {}


def _ticket_buffer(n: int, device: torch.device, stream) -> torch.Tensor:
    key = (device, stream.cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def launch(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
           *, w: int, geo: Optional[Geometry] = None,
           lib=None) -> torch.Tensor:
    """Launch ``csrc/quant_matmul.cu`` on checked CUDA operands; returns
    y.  ``geo`` defaults to ``launch_geometry``'s and ``lib`` to the
    built source (a breakdown script passes patched copies)."""
    m, k = x.shape
    n = w_packed.shape[1] * (32 // w)
    dev = x.device
    if geo is None:
        geo = launch_geometry(m, n, k, w,
                              sm_count(dev.index if dev.index is not None
                                       else torch.cuda.current_device()))
    stream = torch.cuda.current_stream(dev)
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    ws = tickets = None
    if geo.workspace:
        ws = torch.empty(geo.workspace, dtype=torch.float32, device=dev)
        tickets = _ticket_buffer(geo.tickets, dev, stream)
    if lib is None:
        lib = build.library("quant_matmul")
    err = lib.quant_matmul(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), m, k,
        w_packed.shape[1], w, int(x.dtype == torch.bfloat16), geo.rows,
        geo.kchunk, stream.cuda_stream)
    build.check(lib, err, "quant_matmul")
    return out


def quant_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                      scale: torch.Tensor, *, w: int) -> torch.Tensor:
    """Launch kernel B5 (``quant_matmul`` on CUDA tensors)."""
    check_operands(x, w_packed, scale, w=w)
    if x.device.type != "cuda":
        raise ValueError(f"kernel B5 runs on CUDA tensors, got {x.device}")
    out = launch(x, w_packed, scale, w=w)
    quant_matmul.launches += 1
    return out


def quant_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                 scale: torch.Tensor, *, w: int) -> torch.Tensor:
    """x [m, k] (bf16/f32) @ packed weights [k, n/(32/w)] int32 -> [m, n]
    float32 (kernel B5); ``scale`` is the per-output-channel
    dequantization scale [n] float32."""
    if plain_route(x):
        check_operands(x, w_packed, scale, w=w)
        return quant_matmul_plain(x, w_packed, scale, w=w)
    return quant_matmul_cuda(x, w_packed, scale, w=w)


quant_matmul.launches = 0
