"""SDV packed GEMM (kernel B2) — torch port of
``repro.kernels.sdv_matmul``.

``sdv_matmul`` computes the exact per-lane dot products of row-major
integer activations ``[R, K]`` against SDV storage words ``[K, G]``
(``[2, K, G]`` limb planes for the wide DSP48E2/DSP58 words), returning
``[R, G, n]`` int32.

On a CUDA tensor it launches one of two hand-written Hopper kernels,
chosen from the row count, the plan and the word columns
(``takes_wgmma``) and the activations' container:

- ``csrc/sdv_wgmma.cu::sdv_gemm_kernel_wgmma`` for many rows
  (``WGMMA_MIN_ROWS`` and up) of single-limb words and operands of at
  most 8 bits, brought in their one-byte container (the quantizer of the
  model's linears casts to it, ``ops.sdv_operand_dtype``): persistent
  blocks of 2 x 64 lane slots x 256 rows fed by TMA through a ring of
  mbarrier stages, the words decoded once a block for all 256 rows and
  multiplied by ``wgmma`` on int8 (uint8) activations (``wgmma_operand``;
  ``wgmma_slot_channels`` mirrors its tile layout);
- ``csrc/sdv.cu::sdv_gemm_kernel`` for the rest (fewer rows, the
  two-limb DSP48E2/DSP58 words, operands wider than 8 bits, int32
  activations): it decodes each word once into its ``n`` lanes as int8
  and multiplies them with ``mma.sync`` (``decode_lanes_plain`` mirrors
  that decode and its tile layout), splitting K to fill the card.  Operands wider than 8 bits go
  through in byte slices, one slice pair per block, shifted together
  mod 2^32 (``slice_counts``, ``slice_pairs``).

On a CPU tensor it runs ``sdv_matmul_plain``, the paper's packed arithmetic
step by step in int64 tensor ops: the in-word pre-adder ``D - A``, one
wide multiply per (row, group, k) carrying ``n`` MACs, mod-4 spill-over
tracking at every lane boundary (with a virtual observer lane at
``n L``) and the Eq. 3 extractor.  Both give the exact integer sums.
There is no fallback between the two: a CUDA tensor that the kernel
cannot take raises.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import limbs
from ..device import plain_route, sm_count
from . import bseg_common, build

#: the kernels' limits and tiles (mirrors csrc/sdv.cu): lane slots
#: (output channels) and word columns per block, k per pipeline stage,
#: the row tiles of B1 and B2, the blocks per SM the K split aims at, and
#: the most byte slices of an operand (its low 32 bits)
MAX_LANES = 15
GEMV_MAX_ROWS = 8
TILE_M, MAX_GROUPS, TILE_K = 128, 64, 64
GEMM_ROWS = 128
GEMV_BLOCKS_PER_SM, GEMM_BLOCKS_PER_SM = 2, 1
MAX_SLICES = 4
#: the wgmma kernel (mirrors csrc/sdv_wgmma.cu): consumer warpgroups a
#: block, lane slots (M) a warpgroup, activation rows (N) a block, k a
#: stage, the deepest ring of loads, the decoded A tiles in flight, the
#: block's shared-memory limit
WGMMA_CONSUMERS, WGMMA_SLOTS, WGMMA_ROWS, WGMMA_TILE_K = 2, 64, 256, 64
WGMMA_MAX_STAGES, WGMMA_A_BUFS = 6, 2
SMEM_LIMIT = 232448
#: rows from which B2 runs on the wgmma kernel: the smallest row count of
#: chip_smoke's sweep on a llava layer from which it is the faster on
#: every one of the layer's projection shapes (below it a narrow
#: projection's few 256-row tiles leave the card idle where the mma.sync
#: kernel splits K).  Row count and plan alone decide: at the other
#: many-row shapes (recurrentgemma-2b, mamba2-130m, the UltraNet head) it
#: is the faster too, but for mamba2's 768 -> 24 by ~1 us (PERF.md)
WGMMA_MIN_ROWS = 512
_SIGNED_A, _SIGNED_B, _TWO_LIMB = 1, 2, 4
_SLICES_A, _SLICES_B = 3, 5      # flag bits of (slices - 1)


def check_operands(x: torch.Tensor, w_words: torch.Tensor, plan, *,
                   k_axis: int):
    """Validate the kernels' operands; returns (rows, K, G).

    ``k_axis`` is the activation's K axis: 1 for the GEMM's row-major
    ``[R, K]``, 0 for the GEMV's K-major ``[K, B]``."""
    ws = bseg_common.sdv_word_spec(plan)
    if not ws.exact_wrap:
        raise ValueError(f"SDV kernels need exact-wrap arithmetic; datapath "
                         f"{plan.spec.name} rounds (fp32)")
    if bseg_common.sdv_layout_bits(plan) > plan.spec.w_word:
        raise ValueError(f"plan overruns its {plan.spec.name} word: {plan}")
    if plan.n > MAX_LANES or plan.n * plan.lane + 2 > 64:
        raise ValueError(f"plan n={plan.n}, L={plan.lane} exceeds the "
                         f"kernels' limit of {MAX_LANES} lanes in 64 bits")
    dtypes = operand_dtypes(plan)
    if x.dtype not in dtypes or x.ndim != 2:
        raise ValueError(f"activations must be 2-D "
                         f"{' or '.join(map(str, dtypes))}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    want_ndim = 3 if ws.limbs == 2 else 2
    if w_words.dtype != torch.int32 or w_words.ndim != want_ndim:
        raise ValueError(f"storage words must be int32 with {want_ndim} "
                         f"dims for this plan, got {tuple(w_words.shape)} "
                         f"{w_words.dtype}")
    if ws.limbs == 2 and w_words.shape[0] != 2:
        raise ValueError(f"limb planes must lead with 2, got "
                         f"{tuple(w_words.shape)}")
    k = x.shape[k_axis]
    if w_words.shape[-2] != k or k < 1:
        raise ValueError(f"K mismatch: activations {tuple(x.shape)}, words "
                         f"{tuple(w_words.shape)}")
    if x.device != w_words.device:
        raise ValueError(f"operands on {x.device} and {w_words.device}")
    if not (x.is_contiguous() and w_words.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return x.shape[1 - k_axis], k, w_words.shape[-1]


def _stored_words(w_words: torch.Tensor) -> torch.Tensor:
    """Transport array -> int64 words [K, G] (zero-extended int32, or
    hi:lo limb planes)."""
    if w_words.ndim == 3:
        return limbs.from_planes(w_words)
    return limbs.from_u32(w_words)


def sdv_matmul_plain(x: torch.Tensor, w_words: torch.Tensor,
                     plan) -> torch.Tensor:
    """Plain torch version of the SDV GEMM: x [R, K] ints, words
    [K, G] / [2, K, G] -> [R, G, n] int32.

    Repeats the kernel's word arithmetic step by step in int64 tensors
    (wrapping mod 2^64 like the kernel's uint64), vectorized over
    (rows, groups, lane boundaries) and looping over k: pre-adder,
    wide MAC, mod-4 spill tracking, Eq. 3 extraction."""
    sdv_matmul_plain.calls += 1
    n, lane, w_a = plan.n, plan.lane, plan.w_a
    sign_shift = plan.packed_width
    spill_signed = plan.signed_a or plan.signed_b
    dev = x.device
    words = _stored_words(w_words)                          # [K, G]
    d = words & ((1 << sign_shift) - 1)
    bound = torch.arange(1, n + 1, device=dev)              # boundaries 1..n
    if plan.signed_a:
        sbits = (words >> sign_shift) & ((1 << n) - 1)
        el = torch.arange(n, device=dev)
        bits = (sbits[..., None] >> el) & 1                 # [K, G, n]
        packed = d - (bits << (el * lane + w_a - 1)).sum(-1)
    else:
        sbits = torch.zeros_like(d)
        packed = d
    # (a_i mod 4) at boundary i; the observer lane n expects 0
    lsb2 = (d[..., None] >> (bound * lane)) & 3              # [K, G, n]
    if plan.signed_a and w_a < 3:
        lsb2 = (lsb2 + 2 * ((sbits[..., None] >> bound) & 1)) & 3
    lsb2 = torch.where(bound < n, lsb2, 0)
    shifts = bound * lane

    xs = x.to(torch.int64)
    r, k = xs.shape
    acc = torch.zeros((r, words.shape[1]), dtype=torch.int64, device=dev)
    spill = torch.zeros((r, words.shape[1], n), dtype=torch.int64,
                        device=dev)
    for j in range(k):
        xk = xs[:, j:j + 1]                                  # [R, 1]
        acc2 = acc + packed[j] * xk                          # wide MAC
        mm = ((acc2[..., None] >> shifts) - (acc[..., None] >> shifts)
              - lsb2[j] * (xk & 3)[..., None]) & 3           # [R, G, n]
        if spill_signed:
            mm = torch.where(mm == 3, -1, mm)
        spill += mm
        acc = acc2
    fields = (acc[..., None] >> (torch.arange(n, device=dev) * lane)) \
        & ((1 << lane) - 1)
    prev = torch.nn.functional.pad(spill[..., :-1], (1, 0))
    return limbs.lo32(spill * (1 << lane) + fields - prev)


sdv_matmul_plain.calls = 0


def block_groups(n: int) -> int:
    """Word columns one block decodes: its ``n`` lanes fill at most
    ``TILE_M`` slots, in multiples of 4 columns (16-byte word loads)."""
    return min(MAX_GROUPS, TILE_M // n // 4 * 4)


class Geometry(NamedTuple):
    bg: int          # word columns per block
    row_tile: int    # activation rows per block
    chunk: int       # K per block (a multiple of TILE_K)
    grid: tuple      # (column blocks, row blocks, K splits)


def launch_geometry(rows: int, k: int, g: int, n: int, *, gemv: bool,
                    sms: int, pairs: int = 1) -> Geometry:
    """The kernels' launch: blocks of ``block_groups(n)`` word columns x
    ``row_tile`` rows for each of ``pairs`` byte-slice pairs, K split
    until about ``*_BLOCKS_PER_SM`` blocks per SM are in flight (each
    split a multiple of ``TILE_K``); the grid's z axis runs over slice
    pairs x K splits."""
    bg = block_groups(n)
    row_tile = GEMV_MAX_ROWS if gemv else GEMM_ROWS
    blocks = -(-g // bg) * -(-rows // row_tile) * pairs
    target = sms * (GEMV_BLOCKS_PER_SM if gemv else GEMM_BLOCKS_PER_SM)
    split = max(1, min(-(-k // TILE_K), -(-target // blocks)))
    per_split = -(-k // split)
    chunk = -(-per_split // TILE_K) * TILE_K
    return Geometry(bg, row_tile, chunk,
                    (-(-g // bg), -(-rows // row_tile),
                     -(-k // chunk) * pairs))


def slice_counts(plan) -> tuple:
    """Byte slices of (decoded lanes, activations): one int8 per 8 bits
    of the operand, at most ``MAX_SLICES`` (only an operand's low 32
    bits reach a sum mod 2^32)."""
    return (min(MAX_SLICES, -(-plan.w_a // 8)),
            min(MAX_SLICES, -(-plan.w_b // 8)))


def slice_pairs(plan) -> list:
    """The kernels' slice pairs (ia, ib) in launch order: every lane
    slice against every activation slice whose product lands below bit
    32 (ia + ib <= 3; higher ones vanish mod 2^32)."""
    sa, sb = slice_counts(plan)
    return [(ia, ib) for ia in range(sa)
            for ib in range(min(sb, MAX_SLICES - ia))]


def mma_types(plan) -> tuple:
    """The tensor-core operand types of the top byte slices of
    (decoded lanes, activations): ``u8`` for unsigned storage / unsigned
    activations (255 at 8 bits), else ``s8``.  Lower slices are ``u8``."""
    return ("s8" if plan.signed_a else "u8",
            "s8" if plan.signed_b else "u8")


def plan_flags(plan) -> int:
    a, b = mma_types(plan)
    flags = (_SIGNED_A if a == "s8" else 0) | (_SIGNED_B if b == "s8" else 0)
    if bseg_common.sdv_word_spec(plan).limbs == 2:
        flags |= _TWO_LIMB
    sa, sb = slice_counts(plan)
    return flags | (sa - 1) << _SLICES_A | (sb - 1) << _SLICES_B


def slot_channels(g: int, n: int) -> torch.Tensor:
    """Output channel of each A-tile slot of ``decode_lanes_plain`` (-1
    for padding): block ``b``'s slot ``i * bg + gl`` is lane ``i`` of
    group ``b * bg + gl``."""
    bg = block_groups(n)
    tiles = -(-g // bg)
    slot = torch.arange(TILE_M)
    i, gl = slot // bg, slot % bg
    grp = torch.arange(tiles)[:, None] * bg + gl
    chan = torch.where((slot < n * bg) & (grp < g), grp * n + i, -1)
    return chan.reshape(-1)


def _slice_byte(v: torch.Tensor, j: int, top: bool,
                signed: bool) -> torch.Tensor:
    """Byte ``j`` of int64 values as the kernels' int8 tile holds it:
    ``int8`` for the top slice of a signed operand, else ``uint8``."""
    b = ((v >> 8 * j) & 0xFF).to(torch.uint8)
    return b.view(torch.int8) if top and signed else b


def decode_lanes_plain(w_words: torch.Tensor, plan,
                       a_slice: int = 0) -> torch.Tensor:
    """The kernels' decode, plain: storage words -> the int8 A tiles
    [tiles * TILE_M, K] (channel slots, K contiguous), block by block as
    ``slot_channels`` orders them; padding slots and the zero words past
    G decode to 0.  Each tile holds byte ``a_slice`` of the lanes: int8
    for the top slice of signed storage, else uint8 (at w_a <= 8 the one
    slice is the lane's value).

    Lane i: signed, the (w_a - 1)-bit field at i L minus the parked sign
    bit at packed_width + i moved to bit w_a - 1; unsigned, the w_a-bit
    field at i L."""
    n, lane, w_a = plan.n, plan.lane, plan.w_a
    words = _stored_words(w_words)                           # [K, G]
    k, g = words.shape
    bg = block_groups(n)
    tiles = -(-g // bg)
    words = torch.nn.functional.pad(words, (0, tiles * bg - g))
    if plan.signed_a:
        rmask, smask = (1 << w_a - 1) - 1, 1 << w_a - 1
    else:
        rmask, smask = (1 << w_a) - 1, 0
    lanes = []
    for i in range(n):
        t = plan.packed_width + i - (w_a - 1) if plan.signed_a else 0
        lanes.append(((words >> i * lane) & rmask) - ((words >> t) & smask))
    v = torch.stack(lanes).reshape(n, k, tiles, bg)
    a = torch.zeros((tiles, TILE_M, k), dtype=torch.int64)
    a[:, :n * bg] = v.permute(2, 0, 3, 1).reshape(tiles, n * bg, k)
    top = a_slice == slice_counts(plan)[0] - 1
    return _slice_byte(a.reshape(tiles * TILE_M, k), a_slice, top,
                       plan.signed_a)


def wgmma_groups(n: int) -> int:
    """Word columns one warpgroup of the wgmma kernel decodes: its ``n``
    lanes fill at most ``WGMMA_SLOTS`` slots, in multiples of 4 columns
    (the word tile's 16-byte TMA rows)."""
    return WGMMA_SLOTS // n // 4 * 4


def wgmma_slot_channels(g: int, n: int) -> torch.Tensor:
    """Output channel of each A-tile slot of the wgmma kernel (-1 for
    padding), warpgroup by warpgroup: warpgroup ``c`` of column tile
    ``t`` decodes groups ``(t * WGMMA_CONSUMERS + c) * bgw`` onwards, and
    its slot ``s`` holds lane ``s % n`` of its group ``s // n``, so the
    slots below ``n * bgw`` are consecutive output channels."""
    bgw = wgmma_groups(n)
    wgs = -(-g // (WGMMA_CONSUMERS * bgw)) * WGMMA_CONSUMERS
    slot = torch.arange(WGMMA_SLOTS)
    chan = torch.arange(wgs)[:, None] * bgw * n + slot
    chan = torch.where((slot < n * bgw) & (chan < g * n), chan, -1)
    return chan.reshape(-1)


def activation_slice_plain(x: torch.Tensor, plan,
                           b_slice: int) -> torch.Tensor:
    """The kernels' B tile of activation byte ``b_slice``, plain: int8
    for the top slice of signed activations, else uint8."""
    top = b_slice == slice_counts(plan)[1] - 1
    return _slice_byte(x.to(torch.int64), b_slice, top, plan.signed_b)


def byte_dtype(plan) -> torch.dtype:
    """The one-byte container of activations within ``plan.w_b <= 8``
    bits: int8 for signed activations, uint8 for unsigned."""
    return torch.int8 if plan.signed_b else torch.uint8


def takes_wgmma(rows: int, g: int, plan) -> bool:
    """Whether B2 runs on the wgmma kernel: ``WGMMA_MIN_ROWS`` rows or
    more, single-limb exact-wrap words whose ``g`` columns are 16-byte
    TMA rows (``g % 4 == 0``), and operands of at most 8 bits (one byte
    slice each).  Everything else takes the mma.sync kernel."""
    return (rows >= WGMMA_MIN_ROWS and g % 4 == 0 and plan.spec.exact_wrap
            and bseg_common.sdv_word_spec(plan).limbs == 1
            and slice_counts(plan) == (1, 1))


def operand_dtypes(plan) -> tuple:
    """The activation containers ``sdv_matmul`` takes: int32, and at
    ``plan.w_b <= 8`` (one byte slice) ``byte_dtype(plan)``, the one its
    wgmma kernel reads as it is."""
    if slice_counts(plan)[1] > 1:
        return (torch.int32,)
    return (torch.int32, byte_dtype(plan))


class WgmmaGeometry(NamedTuple):
    bgw: int          # word columns a warpgroup
    stages: int       # the ring's depth
    row_tiles: int    # blocks of WGMMA_ROWS rows
    col_tiles: int    # blocks of WGMMA_CONSUMERS * bgw word columns
    k_stages: int     # stages of WGMMA_TILE_K along K
    grid: int         # persistent blocks: one an SM, at most one a tile


def wgmma_smem_bytes(bgw: int, stages: int) -> int:
    """Dynamic shared memory of one wgmma block (mirrors
    ``csrc/sdv_wgmma.cu::smem_bytes``): the 1024-byte alignment, per
    stage the activation tile, the word tile and two barriers, and
    ``WGMMA_A_BUFS`` A tiles a warpgroup."""
    x_stage = WGMMA_ROWS * WGMMA_TILE_K
    w_stage = WGMMA_TILE_K * WGMMA_CONSUMERS * bgw * 4
    a_buf = WGMMA_CONSUMERS * WGMMA_SLOTS * WGMMA_TILE_K
    return 1024 + stages * (x_stage + w_stage + 16) + WGMMA_A_BUFS * a_buf


def wgmma_geometry(rows: int, k: int, g: int, n: int, *,
                   sms: int) -> WgmmaGeometry:
    """The wgmma kernel's launch: tiles of 2 x ``wgmma_groups(n)`` word
    columns x ``WGMMA_ROWS`` rows, row tiles fastest (tile ``i`` is row
    tile ``i % row_tiles`` of column tile ``i // row_tiles``), walked by
    ``min(tiles, sms)`` persistent blocks; the ring as deep as shared
    memory allows, at most ``WGMMA_MAX_STAGES``."""
    bgw = wgmma_groups(n)
    stages = WGMMA_MAX_STAGES
    while wgmma_smem_bytes(bgw, stages) > SMEM_LIMIT:
        stages -= 1
    row_tiles = -(-rows // WGMMA_ROWS)
    col_tiles = -(-g // (WGMMA_CONSUMERS * bgw))
    return WgmmaGeometry(bgw, stages, row_tiles, col_tiles,
                         -(-k // WGMMA_TILE_K),
                         min(row_tiles * col_tiles, sms))


def wgmma_operand(x: torch.Tensor, plan) -> torch.Tensor:
    """Activations [R, K] as the wgmma kernel's TMA reads them: the
    plan's byte container (``byte_dtype``), K padded with zeros to a
    multiple of 16 (16-byte rows), on a 16-byte boundary."""
    k = x.shape[1]
    kp = -(-k // 16) * 16
    x8 = x.to(byte_dtype(plan))
    if kp != k:
        x8 = torch.nn.functional.pad(x8, (0, kp - k))
    return x8.clone() if x8.data_ptr() % 16 else x8


def launch_wgmma(x8: torch.Tensor, w_words: torch.Tensor, plan, rows: int,
                 k: int, g: int, *, lib=None) -> torch.Tensor:
    """Launch ``csrc/sdv_wgmma.cu``'s kernel on CUDA tensors (``x8`` from
    ``wgmma_operand``); returns [rows, G, n] int32.  ``lib`` defaults to
    the built source (a breakdown script passes patched copies)."""
    dev = x8.device.index if x8.device.index is not None \
        else torch.cuda.current_device()
    geo = wgmma_geometry(rows, k, g, plan.n, sms=sm_count(dev))
    out = torch.empty((rows, g, plan.n), dtype=torch.int32, device=x8.device)
    if lib is None:
        lib = build.library("sdv_wgmma")
    flags = (_SIGNED_A if plan.signed_a else 0) \
        | (_SIGNED_B if plan.signed_b else 0)
    err = lib.sdv_gemm_wgmma(
        x8.data_ptr(), w_words.data_ptr(), out.data_ptr(), rows, k,
        x8.shape[1], g, plan.n, plan.lane, plan.w_a, plan.packed_width,
        flags, geo.bgw, geo.stages, geo.grid,
        torch.cuda.current_stream(x8.device).cuda_stream)
    build.check(lib, err, "sdv_gemm_wgmma")
    return out


def launch(name: str, x: torch.Tensor, w_words: torch.Tensor, plan,
           rows: int, k: int, g: int, *, lib=None) -> torch.Tensor:
    """Launch ``csrc/sdv.cu``'s ``name`` (``sdv_gemv`` or ``sdv_gemm``)
    on CUDA tensors; returns [rows, G, n] int32.  ``lib`` defaults to the
    built source (a breakdown script passes patched copies)."""
    geo = launch_geometry(rows, k, g, plan.n, gemv=name == "sdv_gemv",
                          sms=sm_count(x.device.index
                                       if x.device.index is not None
                                       else torch.cuda.current_device()),
                          pairs=len(slice_pairs(plan)))
    out = torch.empty((rows, g, plan.n), dtype=torch.int32, device=x.device)
    if lib is None:
        lib = build.library("sdv")
    err = getattr(lib, name)(
        x.data_ptr(), w_words.data_ptr(), out.data_ptr(), rows, k, g,
        plan.n, plan.lane, plan.w_a, plan.packed_width, plan_flags(plan),
        geo.bg, geo.chunk, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, name)
    return out


def sdv_matmul(x_q: torch.Tensor, w_words: torch.Tensor, *,
               plan) -> torch.Tensor:
    """Packed GEMM (kernel B2).

    Args:
      x_q: [R, K] activations (row-major), values within w_b bits
        (signed or unsigned per ``plan.signed_b``): int32, or at
        ``plan.w_b <= 8`` the byte container ``byte_dtype(plan)``, which
        takes the wgmma kernel where ``takes_wgmma`` (else it is widened
        to int32).  int32 always takes the mma.sync kernel: at the sizes
        its callers bring (the UltraNet head's im2col GEMM) the cast to
        one byte costs more than the kernel gains (PERF.md).
      w_words: [K, G] int32 storage words (``ops.prepare_sdv_weights``),
        or [2, K, G] limb planes for the wide words.
      plan: SDV lane plan on an exact-wrap datapath, n <= 15, any
        operand widths.

    Returns:
      [R, G, n] int32 — exact per-lane dot products (mod 2^32).  Any K.
    """
    r, k, g = check_operands(x_q, w_words, plan, k_axis=1)
    if plain_route(x_q):
        return sdv_matmul_plain(x_q, w_words, plan)
    if x_q.dtype != torch.int32 and takes_wgmma(r, g, plan):
        out = launch_wgmma(wgmma_operand(x_q, plan), w_words, plan, r, k, g)
        sdv_matmul.wgmma_launches += 1
    else:
        out = launch("sdv_gemm", x_q.to(torch.int32), w_words, plan, r, k, g)
    sdv_matmul.launches += 1
    return out


#: B2 launches (either kernel), and those on the wgmma kernel
sdv_matmul.launches = 0
sdv_matmul.wgmma_launches = 0


def sdv_num_multiplies(rows: int, m: int, k: int, plan) -> int:
    """Wide multiplies an SDV GEMM spends on an ``[rows, k] @ [k, m]``
    product: one multiply covers ``plan.n`` output channels, so the
    reduction vs the naive count ``rows * m * k`` is exactly the packing
    density."""
    groups = -(-m // plan.n)
    return rows * groups * k
