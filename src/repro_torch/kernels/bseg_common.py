"""Storage-word layout rules shared by the packers, the route gates and
the kernels.

Torch port of ``repro.kernels.bseg_common``.  The port computes every
word in 64-bit integers, so of the JAX package's ``WordSpec`` only the
transport form matters:

  * SDV storage words (``sdv_layout_bits``, ``sdv_word_spec``): one
    int32 array, or two int32 limb planes ``[2, ...]`` for the wide
    DSP48E2/DSP58 words;
  * BSEG conv factors (``word_spec``): int32 ``[G, kh, C_in, C_out]`` on
    the INT32 lane, float32 on FP32M, int32 limb planes
    ``[2, G, kh, C_in, C_out]`` on DSP48E2/DSP58.

``pack_iota`` and ``split_word`` are the per-word Fig. 6/7 step of the
BSEG pipeline, written as int64 tensor ops (the plain version of kernel
B3 runs them): the ``n_i`` completed low lanes come out with the guard
bias removed, and each carried lane is sliced into a resident low
``w_l``-bit part, re-biased and shifted down ``n_i`` lanes into the next
carry word (the DSP C-port / cascade), and a high part that goes to the
fabric adder tree (Fig. 7).  On every datapath the word is a
non-negative integer below ``2^(n_lanes L)`` (guard-bit dimensioning),
so int64 shifts and masks give the reference's lanes: the INT32 word's
mod-2^32 wrap and the wide words' mod-2^64 limbs agree with it on every
bit the split reads, and FP32M's floor-divides and ``mod`` are exact
shifts and masks on its exact integers below 2^24.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..core import limbs


@dataclasses.dataclass(frozen=True)
class SDVWordSpec:
    """Transport of an SDV plan's storage words.

    Attributes:
      width: bits of the datapath word (``plan.spec.w_word``).
      exact_wrap: True when the datapath wraps losslessly (integers).
      limbs: 1 for one int32 array ``[K, G]``, 2 for limb planes
        ``[2, K, G]``.
    """
    width: int
    exact_wrap: bool
    limbs: int


def sdv_layout_bits(plan) -> int:
    """Bits one SDV storage word actually uses: the packed field plus
    the parked sign bits (signed-element layout only)."""
    return plan.packed_width + (plan.n if plan.signed_a else 0)


def sdv_word_spec(plan) -> SDVWordSpec:
    """One int32 limb when both the datapath word and the storage layout
    fit 32 bits, two int32 limb planes otherwise (the wide DSP48E2/DSP58
    words, and any hand-built plan whose layout overruns its own
    datapath word)."""
    spec = plan.spec
    wide = spec.w_word > 32 or sdv_layout_bits(plan) > 32
    return SDVWordSpec(width=spec.w_word, exact_wrap=spec.exact_wrap,
                       limbs=2 if wide else 1)


def bias_word_full(plan) -> int:
    """All ``n_lanes`` lanes loaded with the 2^(L-1) guard bias."""
    return sum((1 << (p * plan.lane)) * plan.bias
               for p in range(plan.n_lanes))


def bias_word_top(plan) -> int:
    """Fresh bias for the ``n_i`` lanes newly exposed at the top after
    the carry word shifts down ``n_i`` lanes."""
    return sum((1 << (p * plan.lane)) * plan.bias
               for p in range(plan.n_lanes - plan.n_i, plan.n_lanes))


@dataclasses.dataclass(frozen=True)
class WordSpec:
    """Transport of a BSEG plan's packed factors and carry words.

    Attributes:
      dtype: torch dtype of the transport array (int32, or float32 on
        FP32M).
      width: exact bits of the datapath word (``w_word``).
      exact_wrap: True when overflow wraps losslessly (integers).
      bias_full / bias_top: ``bias_word_full`` / ``bias_word_top``.
      limbs: 1 for one array element per word, 2 for the wide words'
        ``[2, ...]`` limb planes (lo, hi).
    """
    dtype: torch.dtype
    width: int
    exact_wrap: bool
    bias_full: int
    bias_top: int
    limbs: int = 1


def word_spec(plan) -> WordSpec:
    """The conv word transport for a plan's datapath: float32 on FP32M,
    one int32 limb for integer words of at most 32 bits, two int32 limb
    planes for the wide DSP48E2/DSP58 words.

    The biased accumulation word spans ``n_lanes * L`` bits; a plan that
    overruns its word cannot come out of ``plan_bseg`` (the route layer
    sends hand-built ones to ref)."""
    spec = plan.spec
    assert plan.n_lanes * plan.lane <= spec.w_word, (
        f"plan overruns the {spec.name} accumulator word: "
        f"{plan.n_lanes} lanes x L={plan.lane} vs w_word={spec.w_word}")
    if spec.exact_wrap and spec.w_word > 32:
        dtype, n_limbs = torch.int32, 2
    elif spec.exact_wrap:
        dtype, n_limbs = torch.int32, 1
    else:
        dtype, n_limbs = torch.float32, 1
    return WordSpec(dtype=dtype, width=spec.w_word,
                    exact_wrap=spec.exact_wrap,
                    bias_full=bias_word_full(plan),
                    bias_top=bias_word_top(plan), limbs=n_limbs)


def pack_iota(seg: torch.Tensor, plan, *, dim: int) -> torch.Tensor:
    """Pack ``n_i`` unsigned input samples (size-``n_i`` dimension
    ``dim`` of ``seg``, any integer dtype) into one int64 input factor
    per position."""
    segs = seg.to(torch.int64).movedim(dim, 0)
    iota = torch.zeros(segs.shape[1:], dtype=torch.int64, device=seg.device)
    for j in range(plan.n_i):
        iota = iota + (segs[j] << (j * plan.lane))
    return iota


def split_word(word: torch.Tensor,
               plan) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """One Fig. 6/7 post-multiply step on int64 words (any shape).

    Returns ``(lanes, c_next)``: ``plan.n_lanes`` int64 tensors shaped
    like ``word`` — the first ``n_i`` are completed outputs (bias
    removed), the rest the extracted high parts of the carried lanes —
    and the re-biased carry word for the next step (resident low parts
    shifted down ``n_i`` lanes, fresh bias on the newly exposed top
    lanes)."""
    n_i, n_lanes, lane = plan.n_i, plan.n_lanes, plan.lane
    mask, lo_mask, bias = (1 << lane) - 1, (1 << plan.w_l) - 1, plan.bias
    lanes = []
    c_next = torch.full_like(word, bias_word_top(plan))
    for p in range(n_lanes):
        f = (word >> (p * lane)) & mask
        if p < n_i:                              # completed outputs
            lanes.append(f - bias)
        else:                                    # carried: hi/lo slice
            lo = f & lo_mask
            lanes.append(f - lo - bias)
            c_next = c_next + ((lo + bias) << ((p - n_i) * lane))
    return lanes, c_next


def schedule(plan, s_out: int, n_groups: int) -> Tuple[int, int]:
    """(n_steps, need): steps of the Fig. 6 schedule for ``s_out``
    outputs of one row, and the padded input length they read."""
    n_steps = -(-(s_out + plan.n_k - 1) // plan.n_i)
    need = (n_steps - 1) * plan.n_i + (n_groups - 1) * plan.n_k + plan.n_i
    return n_steps, need


def decode_group_taps(words: torch.Tensor, plan) -> torch.Tensor:
    """Exact signed factors [G, ...] (``kappa_words``) -> their taps
    [G, n_k, ...] int64.  Each word holds the arithmetic sum of its
    group's reversed taps: lane i, sign-extended from L bits after the
    lower lanes are taken off (borrow), is tap ``n_k - 1 - i`` of the
    group."""
    lane = plan.lane
    rem, taps = words, []
    for i in range(plan.n_k):
        f = (rem >> i * lane) & ((1 << lane) - 1)
        v = torch.where(f >= 1 << lane - 1, f - (1 << lane), f)
        rem = rem - (v << i * lane)
        taps.append(v)
    return torch.stack(taps[::-1], dim=1)


def kappa_words(kappa: torch.Tensor, plan) -> torch.Tensor:
    """Packed factors in the plan's transport layout -> their exact
    signed int64 values (int32 sign-extended, FP32M's exact float
    integers, or the hi:lo limb planes joined; the plane axis goes)."""
    if word_spec(plan).limbs == 2:
        return limbs.from_planes(kappa)
    return kappa.to(torch.int64)
