"""Cross-channel BSEG packed conv2d (kernel B3) — torch port of
``repro.kernels.bseg_conv2d`` (paper Sec. III-D, Figs. 6/7).

A dense stride-1 ``kh x kw`` conv over ``C_in`` channels through the
BSEG datapath: every (kernel row r, input channel ci) pair is a 1-D
BSEG row conv — its ``kw`` taps packed (reversed, pre-adder) into
``ceil(kw / n_k)`` tap groups, ``n_i`` input samples packed per step, so
one wide multiply performs ``n_k * n_i`` MACs.  Each (output row, pipeline
(r, ci), tap group, output channel) runs its own carry word through
``n_steps`` steps in order; Fig. 7 slicing happens per pipeline, and
the extracted lanes are summed over (r, ci, group) — the paper's adder
tree — into an output-row accumulator whose index ``c + n_k - 1`` is
output column ``c``.

With its guard bits every lane of that arithmetic is exact, so the
result is the plain correlation of ``x_pad`` with the taps decoded from
``kappa`` (mod 2^32).  On a CUDA tensor ``bseg_conv2d`` launches the
hand-written Hopper kernel ``csrc/bseg.cu::bseg_conv2d_kernel``, which
computes it that way: it decodes the taps once per block into int8 tiles
(byte slices for taps wider than 8 bits; ``decode_taps_plain`` mirrors
the decode) and runs an implicit GEMM on the int8 tensor cores.  On a CPU
tensor it runs ``bseg_conv2d_plain``, the paper's word arithmetic step
by step in int64 tensors.  There is no fallback between the two: a CUDA
tensor that the kernel cannot take raises.  The reference's TPU tile
arguments (``bh``/``bco``) are gone: the kernel picks its own Hopper
tiles (``launch_shape``).
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..core import limbs
from ..device import plain_route, sm_count
from . import bseg_common, build

#: the plans the kernel takes: at most MAX_LANES product lanes (plan_bseg
#: gives at most 12 at w <= 8)
MAX_LANES = 12
#: the kernel's tiles (mirrors csrc/bseg.cu): warps per block, each MT
#: m16 tiles of pixels (MT = 1, 2 or 4, MT x N <= 64); output channels
#: per block (N = 8, 16, 32 or 64); input channels per chunk; byte slices
#: of a tap; shared memory per block and per SM (a block reserves 1 KB
#: more)
WARPS = 8
MAX_MT = 4
MAX_N_TILE = 64
MAX_CHANNEL_CHUNK = 64
MAX_SLICES = 4
MAX_SHARED_BYTES = 227 * 1024
SM_SHARED_BYTES = 228 * 1024
BLOCKS_PER_SM = 2


def check_operands(x_pad: torch.Tensor, kappa: torch.Tensor, plan, *,
                   h_out: int, w_out: int):
    """Validate B3's operands; returns (n_groups, kh, c_out)."""
    if plan.n_lanes * plan.lane > plan.spec.w_word:
        raise ValueError(f"plan overruns the {plan.spec.name} accumulator "
                         f"word: {plan}")
    ws = bseg_common.word_spec(plan)
    if plan.n_lanes > MAX_LANES:
        raise ValueError(f"plan has {plan.n_lanes} lanes; the kernel takes "
                         f"at most {MAX_LANES}")
    if plan.w_i > 7:
        raise ValueError(f"activations are staged in int8: plan.w_i must "
                         f"be <= 7, got {plan.w_i}")
    if x_pad.dtype != torch.int8 or x_pad.ndim != 4:
        raise ValueError(f"x_pad must be 4-D int8 [B, H_pad, W_pad, C_in], "
                         f"got {tuple(x_pad.shape)} {x_pad.dtype}")
    want_ndim = 5 if ws.limbs == 2 else 4
    if kappa.dtype != ws.dtype or kappa.ndim != want_ndim:
        raise ValueError(f"kappa must be {ws.dtype} with {want_ndim} dims "
                         f"for this plan, got {tuple(kappa.shape)} "
                         f"{kappa.dtype}")
    if ws.limbs == 2 and kappa.shape[0] != 2:
        raise ValueError(f"limb planes must lead with 2, got "
                         f"{tuple(kappa.shape)}")
    n_groups, kh, kc, c_out = kappa.shape[-4:]
    b, h_pad, w_pad, c_in = x_pad.shape
    if kc != c_in:
        raise ValueError(f"kappa C_in {kc} != activation channels {c_in}")
    if h_out < 1 or w_out < 1 or h_pad < h_out + kh - 1:
        raise ValueError(f"x_pad has {h_pad} rows; h_out={h_out} with "
                         f"kh={kh} needs {h_out + kh - 1}")
    _, need = bseg_common.schedule(plan, w_out, n_groups)
    if w_pad < need:
        raise ValueError(f"x_pad has {w_pad} columns; the step schedule "
                         f"reads {need}")
    if x_pad.device != kappa.device:
        raise ValueError(f"operands on {x_pad.device} and {kappa.device}")
    if not (x_pad.is_contiguous() and kappa.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return n_groups, kh, c_out


def bseg_conv2d_plain(x_pad: torch.Tensor, kappa: torch.Tensor, plan, *,
                      h_out: int, w_out: int) -> torch.Tensor:
    """Plain torch version of B3 (same operands and result).

    Repeats the kernel's word arithmetic step by step in int64 tensors,
    vectorized over (B, H, kh * C_in, C_out) and looping over tap groups
    and steps: pack the input factor, one wide multiply-add onto the
    carry word, ``split_word``, and the adder tree over (r, ci) into the
    row accumulator."""
    bseg_conv2d_plain.calls += 1
    n_i, n_k, n_lanes = plan.n_i, plan.n_k, plan.n_lanes
    kap = bseg_common.kappa_words(kappa, plan)   # [G, kh, C_in, C_out]
    n_groups, kh, c_in, c_out = kap.shape
    khc = kh * c_in
    kap = kap.reshape(n_groups, khc, c_out)
    b = x_pad.shape[0]
    n_steps, _ = bseg_common.schedule(plan, w_out, n_groups)
    # xf[b, y, w, r * C_in + ci] = x_pad[b, y + r, w, ci]
    xf = torch.cat([x_pad[:, r:r + h_out] for r in range(kh)], dim=-1)
    buf = torch.zeros((b, h_out, n_steps * n_i + n_lanes, c_out),
                      dtype=torch.int64, device=x_pad.device)
    bias_full = bseg_common.bias_word_full(plan)
    for g in range(n_groups):
        carry = torch.full((b, h_out, khc, c_out), bias_full,
                           dtype=torch.int64, device=x_pad.device)
        for t in range(n_steps):
            tau = t * n_i
            seg = xf[:, :, tau + g * n_k:tau + g * n_k + n_i]
            iota = bseg_common.pack_iota(seg, plan, dim=2)   # [B, H, khc]
            word = kap[g] * iota[..., None] + carry
            lanes, carry = bseg_common.split_word(word, plan)
            buf[:, :, tau:tau + n_lanes] += torch.stack(
                [lane.sum(dim=2) for lane in lanes], dim=2)
    return limbs.lo32(buf[:, :, n_k - 1:n_k - 1 + w_out])


bseg_conv2d_plain.calls = 0


def tap_slices(plan) -> int:
    """Byte slices of a decoded tap: one int8 per 8 bits of ``w_k``, at
    most ``MAX_SLICES`` (only a tap's low 32 bits reach a sum mod
    2^32)."""
    return min(MAX_SLICES, -(-plan.w_k // 8))


def decode_taps_plain(kappa: torch.Tensor, plan) -> List[torch.Tensor]:
    """The kernel's tap decode, plain: packed factors in the plan's
    transport layout -> its int8 B tiles, one per byte slice, each
    [C_out, kh, S, C_in] (S = n_groups * n_k; the kernel lays K out in
    this (r, s, ci) order): uint8, int8 for the top slice.

    Each word's lanes hold the arithmetic sum of its group's reversed
    taps: lane i, sign-extended from L bits after the lower lanes are
    taken off (borrow), is tap ``g n_k + n_k - 1 - i``
    (``bseg_common.decode_group_taps``).  ``join_slices`` gives back the
    taps."""
    t = bseg_common.decode_group_taps(bseg_common.kappa_words(kappa, plan),
                                      plan)   # [G, n_k, kh, C_in, C_out]
    g, n_k, kh, c_in, c_out = t.shape
    t = t.reshape(g * n_k, kh, c_in, c_out).permute(3, 1, 0, 2)
    n = tap_slices(plan)
    out = []
    for j in range(n):
        b = ((t >> 8 * j) & 0xFF).to(torch.uint8).contiguous()
        out.append(b.view(torch.int8) if j == n - 1 else b)
    return out


def join_slices(slices: List[torch.Tensor]) -> torch.Tensor:
    """Byte slices (low first) -> their int64 sum ``sum_j 2^(8j) s_j``."""
    return sum(s.to(torch.int64) << 8 * j for j, s in enumerate(slices))


def correlate_plain(x_pad: torch.Tensor, taps: torch.Tensor, *, h_out: int,
                    w_out: int) -> torch.Tensor:
    """The kernel's function, plain: the correlation of ``x_pad`` [B,
    H_pad, W_pad, C_in] with taps [C_out, kh, S, C_in], [B, h_out, w_out,
    C_out] int32 (mod 2^32)."""
    c_out, kh, taps_w, c_in = taps.shape
    x = x_pad.to(torch.int64)
    out = torch.zeros((x.shape[0], h_out, w_out, c_out), dtype=torch.int64)
    for r in range(kh):
        for s in range(taps_w):
            out += x[:, r:r + h_out, s:s + w_out] @ taps[:, r, s].T
    return limbs.lo32(out)


class Geometry(NamedTuple):
    n_tile: int      # output channels per block
    mt: int          # m16 pixel tiles a warp
    tr: int          # output rows of a pixel tile
    tc: int          # output columns of a pixel tile
    cc: int          # input channels per chunk: 16, 32 or 64
    tiles: tuple     # pixel tiles (per row, per image, in all)
    grid: tuple      # (channel tiles, blocks per channel tile)
    smem: int        # dynamic shared memory per block, bytes


def smem_bytes(n_tile: int, tr: int, tc: int, cc: int, kh: int, taps: int,
               slices: int) -> int:
    """Shared memory of one block (mirrors csrc/bseg.cu's ``layout``): the
    B tiles, the K-chunk offsets, two activation strips and the warps'
    output stages."""
    cpc = cc // 16
    pp = 16 * (cpc if cpc % 2 else cpc + 1)
    nq = kh * taps * cpc
    bp = 16 * (nq + nq % 2 + 1)
    strip = (tr + kh - 1) * (tc + taps - 1) * pp
    q_table = -(-(nq + 1) * 4 // 16) * 16
    return (slices * n_tile * bp + q_table + 2 * strip
            + WARPS * 8 * (n_tile + 4) * 4)


def launch_shape(b: int, h_out: int, w_out: int, c_in: int, c_out: int,
                 kh: int, taps: int, slices: int, *, sms: int) -> Geometry:
    """The kernel's tiles and persistent grid for one launch.

    A pixel tile is ``tr`` output rows x ``tc`` columns (at most 64) of
    one image, at most ``16 WARPS MT`` pixels with ``MT x n_tile <= 64``;
    a block owns ``n_tile`` output channels (``C_out`` up to 64) and
    walks every ``grid[1]``-th pixel tile.  Shared memory is fitted by
    fewer channels per chunk, then fewer output channels, then fewer
    rows; the card is filled (two (pixel tile, channel tile) items per
    SM) by fewer rows down to 64 pixels, then fewer output channels down
    to 16, then fewer rows.  MT is the fewest m16 tiles a warp that
    cover the pixel tile."""
    n_tile = 8
    while n_tile < min(c_out, MAX_N_TILE):
        n_tile *= 2
    cc = 16                                # 16, 32 or 64 channels a chunk
    while cc < min(c_in, MAX_CHANNEL_CHUNK):
        cc *= 2
    tiles_x = -(-w_out // 64)
    tc = -(-w_out // tiles_x)
    mt_max = min(MAX_MT, MAX_N_TILE // n_tile)
    tr = max(1, min(h_out, 16 * WARPS * mt_max // tc))

    def smem():
        return smem_bytes(n_tile, tr, tc, cc, kh, taps, slices)

    while smem() > MAX_SHARED_BYTES:
        if cc > 16:
            cc //= 2
        elif n_tile > 8:
            n_tile //= 2
        elif tr > 1:
            tr -= 1
        else:
            raise ValueError(
                f"a {kh}-row kernel of {taps} taps at {tc} columns needs "
                f"{smem()} bytes of shared memory; the kernel has "
                f"{MAX_SHARED_BYTES}")

    def items():
        return (b * -(-h_out // tr) * tiles_x) * -(-c_out // n_tile)

    while items() < 2 * sms:
        if tr > 1 and tr * tc > 64:
            tr = -(-tr // 2)
        elif n_tile > 16:
            n_tile //= 2
        elif tr > 1:
            tr = -(-tr // 2)
        else:
            break
    n_tiles = b * -(-h_out // tr) * tiles_x
    co_tiles = -(-c_out // n_tile)
    resident = max(1, min(BLOCKS_PER_SM,
                          SM_SHARED_BYTES // (smem() + 1024)))
    grid_y = min(n_tiles, -(-sms * resident // co_tiles))
    mt = 1
    while 16 * WARPS * mt < tr * tc:
        mt *= 2
    return Geometry(n_tile, mt, tr, tc, cc,
                    (tiles_x, -(-h_out // tr), n_tiles), (co_tiles, grid_y),
                    smem())


def launch(x_pad: torch.Tensor, kappa: torch.Tensor, plan, *, h_out: int,
           w_out: int, lib=None) -> torch.Tensor:
    """Launch ``csrc/bseg.cu`` on checked CUDA operands; returns [B,
    h_out, w_out, C_out] int32.  ``lib`` defaults to the built source (a
    breakdown script passes patched copies)."""
    n_groups, kh, c_out = kappa.shape[-4], kappa.shape[-3], kappa.shape[-1]
    ws = bseg_common.word_spec(plan)
    if ws.dtype == torch.float32:
        # FP32M factors are exact integers below 2^24: the kernel runs
        # the word in integers (exact conversion, not a fallback)
        kappa = kappa.to(torch.int32)
    b, h_pad, w_pad, c_in = x_pad.shape
    slices = tap_slices(plan)
    geo = launch_shape(b, h_out, w_out, c_in, c_out, kh,
                       n_groups * plan.n_k, slices,
                       sms=sm_count(x_pad.device.index
                                    if x_pad.device.index is not None
                                    else torch.cuda.current_device()))
    out = torch.empty((b, h_out, w_out, c_out), dtype=torch.int32,
                      device=x_pad.device)
    if lib is None:
        lib = build.library("bseg")
    err = lib.bseg_conv2d(
        x_pad.data_ptr(), kappa.data_ptr(), out.data_ptr(), b, h_pad, w_pad,
        c_in, kh, n_groups, c_out, h_out, w_out, plan.n_k, plan.lane,
        slices, int(ws.limbs == 2), geo.n_tile, geo.mt, geo.tr, geo.tc,
        geo.cc, geo.grid[1], geo.smem,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    build.check(lib, err, "bseg_conv2d")
    return out


def bseg_conv2d(x_pad: torch.Tensor, kappa: torch.Tensor, *, plan,
                h_out: int, w_out: int) -> torch.Tensor:
    """Dense stride-1 conv2d through the BSEG datapath (kernel B3).

    Args:
      x_pad: [B, H_pad, W_pad, C_in] int8, unsigned values in
        [0, 2^w_i), 'same'-padded on H (H_pad >= h_out + kh - 1) and
        padded on W to cover the step schedule (``ops.packed_conv2d``
        computes the amount).
      kappa: packed kernel-row factors, one per tap group, pre-adder
        applied (``ops.prepare_bseg_conv2d``): [G, kh, C_in, C_out]
        int32 (INT32) or float32 (FP32M), or [2, G, kh, C_in, C_out]
        int32 limb planes (DSP48E2/DSP58).
      plan: BSEG plan whose biased word fits its datapath word.
      h_out / w_out: output frame size.

    Returns:
      [B, h_out, w_out, C_out] int32 — exact correlation totals summed
      over kernel rows, input channels and tap groups (guard bias
      removed; zero-point correction is the caller's), mod 2^32.  Any
      tap width ``plan_bseg`` admits.
    """
    check_operands(x_pad, kappa, plan, h_out=h_out, w_out=w_out)
    if plain_route(x_pad):
        return bseg_conv2d_plain(x_pad, kappa, plan, h_out=h_out,
                                 w_out=w_out)
    out = launch(x_pad, kappa, plan, h_out=h_out, w_out=w_out)
    bseg_conv2d.launches += 1
    return out


bseg_conv2d.launches = 0


def bseg_conv2d_num_multiplies(h_out: int, w_out: int, c_in: int,
                               c_out: int, kh: int, kw: int, plan) -> int:
    """Wide multiplies one ``bseg_conv2d`` launch spends per image —
    the operational-density currency.  Every (output row, kernel row,
    input channel, output channel, tap group, step) is one wide
    multiply."""
    n_groups = -(-kw // plan.n_k)
    n_steps = -(-(w_out + plan.n_k - 1) // plan.n_i)
    return h_out * kh * c_in * c_out * n_groups * n_steps
