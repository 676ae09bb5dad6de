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

On a CUDA tensor ``bseg_conv2d`` launches the hand-written Hopper
kernel ``csrc/bseg.cu::bseg_conv2d_kernel``; on a CPU tensor it runs
``bseg_conv2d_plain``, the same word arithmetic step by step in int64
tensors.  There is no fallback between the two: a CUDA tensor that the
kernel cannot take raises.  The reference's TPU tile arguments
(``bh``/``bco``) are gone: the kernel picks its own Hopper tiles.
"""
from __future__ import annotations

import torch

from ..core import limbs
from ..device import sm_count
from . import bseg_common, build

#: the kernel's limits (mirrors csrc/bseg.cu)
MAX_LANES = 12
MAX_SHARED_BYTES = 227 * 1024
#: threads per block the launch aims at, and the widest output-channel
#: tile (one warp)
BLOCK_THREADS = 256
MAX_CO_TILE = 32


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


def launch_shape(b: int, h_out: int, w_out: int, khc: int, c_out: int,
                 plan, device: torch.device):
    """Hopper tiles for one launch: (co_tile, pipe_threads,
    pipes_per_block, shared bytes).

    A block owns one output row of one batch image and ``co_tile``
    output channels (a warp's worth, or fewer when the row accumulator
    would not fit shared memory); its ``pipe_threads`` thread rows share
    the (r, ci) pipelines.  The pipelines are split across blocks (with
    integer atomics into a zeroed output) until about four blocks per SM
    are in flight: UltraNet's 26x26 layers have few rows."""
    n_steps, _ = bseg_common.schedule(plan, w_out, 1)
    buf = n_steps * plan.n_i
    co_tile = MAX_CO_TILE
    while co_tile > 1 and co_tile // 2 >= c_out:
        co_tile //= 2
    while co_tile > 1 and buf * co_tile * 4 > MAX_SHARED_BYTES:
        co_tile //= 2
    smem = buf * co_tile * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"output rows of {w_out} columns need {smem} bytes "
                         f"of shared memory; the kernel has "
                         f"{MAX_SHARED_BYTES}")
    pipe_threads = max(1, min(khc, BLOCK_THREADS // co_tile))
    blocks = b * h_out * -(-c_out // co_tile)
    target = 4 * sm_count(device.index if device.index is not None
                           else torch.cuda.current_device())
    split = max(1, min(-(-khc // pipe_threads), -(-target // blocks)))
    per_block = -(-khc // split)
    pipes_per_block = -(-per_block // pipe_threads) * pipe_threads
    return co_tile, pipe_threads, pipes_per_block, smem


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
      removed; zero-point correction is the caller's).
    """
    n_groups, kh, c_out = check_operands(x_pad, kappa, plan, h_out=h_out,
                                         w_out=w_out)
    if x_pad.device.type == "cpu":
        return bseg_conv2d_plain(x_pad, kappa, plan, h_out=h_out,
                                 w_out=w_out)
    ws = bseg_common.word_spec(plan)
    if ws.dtype == torch.float32:
        # FP32M factors are exact integers below 2^24: the kernel runs
        # the word in integers (exact conversion, not a fallback)
        kappa = kappa.to(torch.int32)
    b, h_pad, w_pad, c_in = x_pad.shape
    co_tile, pipe_threads, pipes_per_block, smem = launch_shape(
        b, h_out, w_out, kh * c_in, c_out, plan, x_pad.device)
    out = torch.empty((b, h_out, w_out, c_out), dtype=torch.int32,
                      device=x_pad.device)
    lib = build.library("bseg")
    err = lib.bseg_conv2d(
        x_pad.data_ptr(), kappa.data_ptr(), out.data_ptr(), b, h_pad, w_pad,
        c_in, kh, n_groups, c_out, h_out, w_out, plan.n_i, plan.n_k,
        plan.n_lanes, plan.lane, plan.w_l, ws.bias_full, ws.bias_top,
        int(ws.limbs == 2), co_tile,
        pipe_threads, pipes_per_block, smem,
        torch.cuda.current_stream(x_pad.device).cuda_stream)
    build.check(lib, err, "bseg_conv2d")
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
