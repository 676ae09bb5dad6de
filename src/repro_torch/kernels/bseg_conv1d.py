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

On a CUDA tensor ``bseg_conv1d`` launches the hand-written Hopper
kernel ``csrc/bseg1d.cu::bseg_conv1d_kernel``; on a CPU tensor it runs
``bseg_conv1d_plain``, the same word arithmetic step by step in int64
tensors.  There is no fallback between the two: a CUDA tensor that the
kernel cannot take raises.  The reference's TPU channel tile (``bc``)
is gone: the kernel picks its own Hopper launch.
"""
from __future__ import annotations

import torch

from ..core import limbs
from ..device import sm_count
from . import bseg_common, build

#: the kernel's limits (mirrors csrc/bseg1d.cu)
MAX_LANES = 12
MAX_GROUPS = 8
#: threads per block (one channel each), and the fewest outputs one
#: thread's chunk of a long row gets
BLOCK_THREADS = 256
MIN_CHUNK = 64


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


def launch_shape(b: int, c: int, s_out: int, device: torch.device):
    """(threads per block, outputs per thread) for one launch.

    A thread owns one (row, channel) chain; when the B * C chains are
    too few to fill the card (2048 threads per SM), each row's outputs
    are cut into chunks of at least ``MIN_CHUNK``, one thread each."""
    threads = min(BLOCK_THREADS, -(-c // 32) * 32)
    target = 2048 * sm_count(device.index if device.index is not None
                             else torch.cuda.current_device())
    chunks = max(1, min(-(-target // (b * c)), -(-s_out // MIN_CHUNK)))
    return threads, -(-s_out // chunks)


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
    n_groups = check_operands(x_pad, kappa, plan, s_out=s_out)
    if x_pad.device.type == "cpu":
        return bseg_conv1d_plain(x_pad, kappa, plan, s_out=s_out)
    ws = bseg_common.word_spec(plan)
    if ws.dtype == torch.float32:
        # FP32M factors are exact integers below 2^24: the kernel runs
        # the word in integers (exact conversion, not a fallback)
        kappa = kappa.to(torch.int32)
    b, s_pad, c = x_pad.shape
    threads, chunk = launch_shape(b, c, s_out, x_pad.device)
    out = torch.empty((b, s_out, c), dtype=torch.int32, device=x_pad.device)
    lib = build.library("bseg1d")
    err = lib.bseg_conv1d(
        x_pad.data_ptr(), kappa.data_ptr(), out.data_ptr(), b, s_pad, c,
        n_groups, s_out, plan.n_i, plan.n_k, plan.n_lanes, plan.lane,
        plan.w_l, ws.bias_full, ws.bias_top, int(ws.limbs == 2), chunk,
        threads, torch.cuda.current_stream(x_pad.device).cuda_stream)
    build.check(lib, err, "bseg_conv1d")
    bseg_conv1d.launches += 1
    return out


bseg_conv1d.launches = 0
