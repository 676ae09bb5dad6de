"""Soft Datapath Vectorization (paper Sec. III-C, Figs. 2b & 4) — torch
port of ``repro.core.sdv``, the cycle-level int64 oracle of the SDV
datapath.

SDV packs ``n`` elements a_0..a_{n-1} into the multiplicand of a wide
multiplier and runs a shared multiplier b through the other port:

    (sum_i 2^{iL} a_i) * b = sum_i 2^{iL} (a_i b)

With the Eq. 4 lane size  L >= w_a + w_b - 1  (one bit *narrower* than
the product), products regularly spill into the neighbouring lane.  The
architecture tracks those spills externally:

  * a cheap reference multiplier (on FPGA: one fractured LUT) produces
    the two LSBs of every true product — here, ``(a & 3)(b & 3) & 3``;
  * after each accumulator update, the observed low two bits of each
    lane are compared against the predicted ones; the mod-4 mismatch
    *is* the spill received from the right-hand neighbour (the possible
    spill values, [-1:1] signed or [0:2] unsigned, are fully separated
    mod 4 — the paper's dimensioning argument);
  * spill totals S_i are accumulated in fabric and the final lane
    results are fixed up per Eq. 3:
        R̂_i = (2^L S_i + R_i) - S_{i-1}.

Everything here is exact integer arithmetic on torch int32 words (the
INT32 datapath) or int64 words (the wide DSP48E2/DSP58 words): a word
wraps mod 2^32 or 2^64, which detection tolerates because it is
differential (mod 4) — why the technique needs ``exact_wrap`` datapaths
(int32 / DSP ALUs), not fp32.  The int32 products are formed in int64
and narrowed, so the wrap is two's complement by construction.  The JAX
package's ``lax.scan`` over the K MAC steps is a loop here; the words
equal the reference's (int64 under x64) bit for bit.  It is an oracle:
the serving path runs kernels B1/B2 (``kernels/ops.packed_matmul``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .datapath import SDVPlan
from .signed_split import pack


def word_dtype(plan: SDVPlan) -> torch.dtype:
    if not plan.spec.exact_wrap:
        raise ValueError(
            f"SDV spill-over tracking needs exact-wrap arithmetic; "
            f"datapath {plan.spec.name} rounds (fp32)")
    return torch.int32 if plan.spec.w_word <= 32 else torch.int64


def sdv_pack(values: torch.Tensor, plan: SDVPlan) -> torch.Tensor:
    """Pack elements along the last axis (size plan.n) into words."""
    assert values.shape[-1] == plan.n, (tuple(values.shape), plan.n)
    return pack(values, plan.w_a, plan.lane,
                signed=plan.signed_a).to(word_dtype(plan))


def _lane_starts(plan: SDVPlan):
    """Bit offsets of the n real lanes plus the virtual observer lane
    above the top element (tracks spill out of lane n-1)."""
    starts = [i * plan.lane for i in range(plan.n + 1)]
    if starts[-1] + 2 > plan.spec.w_word:
        raise ValueError(
            f"no room for the virtual observer lane: {plan}")
    return starts


def _fields_mod4(word: torch.Tensor, plan: SDVPlan) -> torch.Tensor:
    """Low two bits of every (real + virtual) lane: [..., n+1]."""
    return torch.stack([word >> s for s in _lane_starts(plan)], dim=-1) & 3


def _decode_spill(mismatch: torch.Tensor, signed: bool) -> torch.Tensor:
    """Map a mod-4 residue mismatch to the actual spill value.

    signed products: possible spills [-1, 0, 1]  -> {3, 0, 1}
    unsigned:        possible spills [0, 1, 2]   -> {0, 1, 2}
    """
    if signed:
        return torch.where(mismatch == 3, -1, mismatch)
    return mismatch


def sdv_macc(packed: torch.Tensor, lsb2: torch.Tensor, bs: torch.Tensor,
             plan: SDVPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a packed multiply-accumulate chain with spill tracking.

    Args:
      packed: [K, ...] packed multiplicand words (one per MAC step).
      lsb2:   [K, ..., n] the two LSBs of each *element* (a_i & 3) —
              the fabric side-band feeding the reference multiplier.
      bs:     [K, ...] shared multipliers (integers within w_b).
      plan:   lane plan.

    Returns:
      (word, spills): final accumulator word [...] and spill totals
      [..., n] (S_0..S_{n-1}) int32.
    """
    wdt = word_dtype(plan)
    signed = plan.signed_a or plan.signed_b
    n = plan.n
    word = torch.zeros(packed.shape[1:], dtype=wdt, device=packed.device)
    spills = torch.zeros(packed.shape[1:] + (n,), dtype=torch.int32,
                         device=packed.device)
    for pw, l2, b in zip(packed, lsb2, bs):
        prev = _fields_mod4(word, plan)                    # [..., n+1]
        # the DSP MAC, formed in int64 and wrapped at the word top
        word = (word.long() + pw.long() * b.long()).to(wdt)
        obs = _fields_mod4(word, plan)
        # reference products, two LSBs only (fractured-LUT analogue):
        p4 = (l2 * (b.to(l2.dtype) & 3)[..., None]) & 3    # [..., n]
        pred = torch.cat([(prev[..., :n] + p4) & 3, prev[..., n:]], dim=-1)
        mismatch = (obs - pred) & 3                        # [..., n+1]
        delta = _decode_spill(mismatch, signed)
        # spill observed entering lane i came out of lane i-1:
        spills = spills + delta[..., 1:].to(torch.int32)
    return word, spills


def sdv_extract(word: torch.Tensor, spills: torch.Tensor,
                plan: SDVPlan) -> torch.Tensor:
    """Eq. 3 fix-up:  R̂_i = (2^L S_i + R_i) - S_{i-1}  -> [..., n], in
    the word's dtype (wrapping as the word does)."""
    mask = (1 << plan.lane) - 1
    starts = _lane_starts(plan)[: plan.n]
    fields = torch.stack([(word >> s) & mask for s in starts], dim=-1)
    s_prev = torch.cat([torch.zeros_like(spills[..., :1]),
                        spills[..., :-1]], dim=-1)
    res = (spills.long() << plan.lane) + fields.long() - s_prev.long()
    return res.to(word.dtype)


def sdv_matvec(w_mat: torch.Tensor, x_vec: torch.Tensor,
               plan: SDVPlan) -> torch.Tensor:
    """Exact integer matrix-vector product through the SDV datapath.

    FINN mapping: lanes = output channels (PE direction), MAC steps =
    input channels.  w_mat [M, K] (elements within w_a), x_vec [K]
    (within w_b).  Returns y [M] = w_mat @ x_vec, bit-exact, in the
    word's dtype.
    """
    m, k = w_mat.shape
    n = plan.n
    groups = -(-m // n)
    pad = torch.zeros((groups * n - m, k), dtype=w_mat.dtype,
                      device=w_mat.device)
    wp = torch.cat([w_mat, pad]).reshape(groups, n, k)
    steps = wp.movedim(-1, 0)                              # [K, groups, n]
    packed = sdv_pack(steps, plan)                         # [K, groups]
    lsb2 = steps & 3
    bs = x_vec[:, None].expand(k, groups)
    word, spills = sdv_macc(packed, lsb2, bs, plan)
    lanes = sdv_extract(word, spills, plan)                # [groups, n]
    return lanes.reshape(groups * n)[:m]
