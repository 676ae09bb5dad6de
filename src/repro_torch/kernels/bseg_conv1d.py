"""Depthwise causal BSEG conv1d (kernel B4) — torch port of
``repro.kernels.bseg_conv1d`` (paper Sec. III-D, Figs. 6/7).

The short depthwise conv of the Mamba2 and Griffin (RG-LRU) blocks
through the BSEG datapath: each channel's taps are packed (reversed,
pre-adder) into ``ceil(taps / n_k)`` tap groups, ``n_i`` input samples
are packed per step, so one wide multiply performs ``n_k * n_i`` MACs.
Each (batch row, channel, tap group) runs its own carry word through
``n_steps`` steps in order; Fig. 7 slicing splits every carried lane
into a resident low part (into the next carry word) and a high part
that goes straight to the row accumulator, whose index ``s + n_k - 1``
is output ``s``.

With its guard bits every lane of that arithmetic is exact, so the
result is the plain correlation of ``x_pad`` with the taps decoded from
``kappa`` (mod 2^32).  On a CUDA tensor ``bseg_conv1d`` launches the
hand-written Hopper kernel ``csrc/bseg1d.cu::bseg_conv1d_kernel``, which
computes it that way: each thread decodes its channels' taps
(``decode_conv1d_taps_plain`` mirrors the decode) and sums tap x sample
over a strip of outputs (``correlate1d_plain``), with no carry word and
no serial step chain.  On a CPU tensor it runs ``bseg_conv1d_plain``,
the paper's word arithmetic step by step in int64 tensors.  There is no
fallback between the two: a CUDA tensor that the kernel cannot take
raises.  The reference's TPU channel tile (``bc``) is gone: the kernel
picks its own Hopper launch (``launch_shape``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core import limbs
from ..device import plain_route, sm_count
from . import bseg_common, build

#: the kernel's limits (mirrors csrc/bseg1d.cu)
MAX_LANES = 12
MAX_GROUPS = 8
#: the most threads per block (4 channels each), the threads an SM holds,
#: the waves of them a long row is cut for, and the fewest outputs a strip
#: of a long row gets
BLOCK_THREADS = 128
SM_THREADS = 2048
WAVES = 2
MIN_STRIP = 16
#: word forms of the launcher (csrc/bseg1d.cu ``Kind``)
_KIND_INT32, _KIND_FP32, _KIND_TWO_LIMB = 0, 1, 2


def check_operands(x_pad: torch.Tensor, kappa: torch.Tensor, plan, *,
                   s_out: int) -> int:
    """Validate B4's operands; returns the number of tap groups."""
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
    if x_pad.dtype != torch.int8 or x_pad.ndim != 3:
        raise ValueError(f"x_pad must be 3-D int8 [B, S_pad, C], got "
                         f"{tuple(x_pad.shape)} {x_pad.dtype}")
    want_ndim = 3 if ws.limbs == 2 else 2
    if kappa.dtype != ws.dtype or kappa.ndim != want_ndim:
        raise ValueError(f"kappa must be {ws.dtype} with {want_ndim} dims "
                         f"for this plan, got {tuple(kappa.shape)} "
                         f"{kappa.dtype}")
    if ws.limbs == 2 and kappa.shape[0] != 2:
        raise ValueError(f"limb planes must lead with 2, got "
                         f"{tuple(kappa.shape)}")
    n_groups, kc = kappa.shape[-2:]
    if n_groups > MAX_GROUPS:
        raise ValueError(f"{n_groups} tap groups; the kernel takes at most "
                         f"{MAX_GROUPS}")
    b, s_pad, c = x_pad.shape
    if kc != c:
        raise ValueError(f"kappa channels {kc} != activation channels {c}")
    if s_out < 1:
        raise ValueError(f"s_out must be positive, got {s_out}")
    _, need = bseg_common.schedule(plan, s_out, n_groups)
    if s_pad < need:
        raise ValueError(f"x_pad has {s_pad} samples; the step schedule "
                         f"reads {need}")
    if x_pad.device != kappa.device:
        raise ValueError(f"operands on {x_pad.device} and {kappa.device}")
    if not (x_pad.is_contiguous() and kappa.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return n_groups


def bseg_conv1d_plain(x_pad: torch.Tensor, kappa: torch.Tensor, plan, *,
                      s_out: int) -> torch.Tensor:
    """Plain torch version of B4 (same operands and result).

    Repeats the kernel's word arithmetic step by step in int64 tensors,
    vectorized over (B, C) and looping over tap groups and steps: pack
    the input factor, one wide multiply-add onto the carry word,
    ``split_word``, and the lanes into the row accumulator."""
    bseg_conv1d_plain.calls += 1
    n_i, n_k, n_lanes = plan.n_i, plan.n_k, plan.n_lanes
    kap = bseg_common.kappa_words(kappa, plan)           # [G, C]
    n_groups = kap.shape[0]
    b, _, c = x_pad.shape
    n_steps, _ = bseg_common.schedule(plan, s_out, n_groups)
    buf = torch.zeros((b, n_steps * n_i + n_lanes, c), dtype=torch.int64,
                      device=x_pad.device)
    bias_full = bseg_common.bias_word_full(plan)
    for g in range(n_groups):
        carry = torch.full((b, c), bias_full, dtype=torch.int64,
                           device=x_pad.device)
        for t in range(n_steps):
            tau = t * n_i
            seg = x_pad[:, tau + g * n_k:tau + g * n_k + n_i]   # [B, n_i, C]
            iota = bseg_common.pack_iota(seg, plan, dim=1)      # [B, C]
            word = kap[g] * iota + carry
            lanes, carry = bseg_common.split_word(word, plan)
            buf[:, tau:tau + n_lanes] += torch.stack(lanes, dim=1)
    return limbs.lo32(buf[:, n_k - 1:n_k - 1 + s_out])


bseg_conv1d_plain.calls = 0


def decode_conv1d_taps_plain(kappa: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's tap decode, plain: packed factors in the plan's
    transport layout ([G, C] int32 / float32, or [2, G, C] limb planes)
    -> the taps, [C, G n_k] int64, tap ``g n_k + n_k - 1 - i`` from lane i
    of group g (``bseg_common.decode_group_taps``)."""
    t = bseg_common.decode_group_taps(bseg_common.kappa_words(kappa, plan),
                                      plan)              # [G, n_k, C]
    return t.reshape(-1, t.shape[-1]).T


def correlate1d_plain(x_pad: torch.Tensor, taps: torch.Tensor, *,
                      s_out: int) -> torch.Tensor:
    """The kernel's function, plain: ``out[b, s, c] = sum_j taps[c, j] *
    x_pad[b, s + j, c]`` for x_pad [B, S_pad, C] and taps [C, S], as
    [B, s_out, C] int32 (mod 2^32)."""
    x = x_pad.to(torch.int64)
    out = torch.zeros((x.shape[0], s_out, x.shape[2]), dtype=torch.int64)
    for j in range(taps.shape[1]):
        out += x[:, j:j + s_out] * taps[:, j]
    return limbs.lo32(out)


def launch_shape(b: int, c: int, s_out: int, *, sms: int):
    """(threads per block, outputs per strip) for one launch.

    A thread owns 4 adjacent channels of one batch row and one strip of
    outputs; when the ``B * ceil(C / 4)`` rows of channel quads are too
    few to fill the card ``WAVES`` times (``SM_THREADS`` threads per SM),
    each row's outputs are cut into strips of at least ``MIN_STRIP`` (a
    multiple of the kernel's 8-output sub-strip), one thread each."""
    quads = -(-c // 4)
    threads = min(BLOCK_THREADS, -(-quads // 32) * 32)
    strips = max(1, min(-(-WAVES * sms * SM_THREADS // (b * quads)),
                        -(-s_out // MIN_STRIP)))
    strip = -(-s_out // strips)
    if strip > 8:
        strip = -(-strip // 8) * 8
    return threads, strip


def launch(x_pad: torch.Tensor, kappa: torch.Tensor, plan, *, s_out: int,
           shape: Optional[Tuple[int, int]] = None,
           lib=None) -> torch.Tensor:
    """Launch ``csrc/bseg1d.cu`` on checked CUDA operands; returns [B,
    s_out, C] int32.  ``shape`` (threads per block, outputs per strip)
    defaults to ``launch_shape``'s and ``lib`` to the built source (a
    breakdown script passes other shapes and patched copies)."""
    n_groups = kappa.shape[-2]
    ws = bseg_common.word_spec(plan)
    # FP32M factors are exact integers below 2^24: the kernel converts
    # them itself
    kind = (_KIND_TWO_LIMB if ws.limbs == 2 else
            _KIND_FP32 if ws.dtype == torch.float32 else _KIND_INT32)
    b, s_pad, c = x_pad.shape
    threads, strip = shape or launch_shape(
        b, c, s_out, sms=sm_count(x_pad.device.index
                                  if x_pad.device.index is not None
                                  else torch.cuda.current_device()))
    out = torch.empty((b, s_out, c), dtype=torch.int32, device=x_pad.device)
    if lib is None:
        lib = build.library("bseg1d")
    err = lib.bseg_conv1d(
        x_pad.data_ptr(), kappa.data_ptr(), out.data_ptr(), b, s_pad, c,
        n_groups, s_out, plan.n_k, plan.lane, kind, strip, threads,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    build.check(lib, err, "bseg_conv1d")
    return out


def bseg_conv1d(x_pad: torch.Tensor, kappa: torch.Tensor, *, plan,
                s_out: int) -> torch.Tensor:
    """Depthwise causal conv through the BSEG datapath (kernel B4).

    Args:
      x_pad: [B, S_pad, C] int8, unsigned values in [0, 2^w_i), already
        left-padded (``ops.bseg_conv1d_x_pad`` computes the padding and
        the right end the step schedule reads).
      kappa: packed tap-group factors, one per tap group and channel,
        pre-adder applied (``ops.prepare_bseg_taps``): [G, C] int32
        (INT32) or float32 (FP32M), or [2, G, C] int32 limb planes
        (DSP48E2/DSP58).
      plan: BSEG plan whose biased word fits its datapath word.
      s_out: number of output samples.

    Returns:
      [B, S_out, C] int32 — exact correlation totals (guard bias
      removed; the zero-point correction is the caller's).
    """
    check_operands(x_pad, kappa, plan, s_out=s_out)
    if plain_route(x_pad):
        return bseg_conv1d_plain(x_pad, kappa, plan, s_out=s_out)
    out = launch(x_pad, kappa, plan, s_out=s_out)
    bseg_conv1d.launches += 1
    return out


bseg_conv1d.launches = 0
