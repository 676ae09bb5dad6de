"""Wide-multiplier datapath specifications and lane-dimensioning math.

A copy of ``repro.core.datapath`` (pure Python, no array library), kept
in the torch package so the port imports nothing of the JAX package.

This module encodes the paper's Sec. III dimensioning rules:

  * SDV lane size (Eq. 4):        L >= w_a + w_b - 1
  * BSEG port constraints (Eq. 7/8):
        (n_k - 1) L + w_k + 1 <= w_A
        (n_i - 1) L + w_i + 1 <= w_B
  * BSEG guard-bit conditions (Eq. 9/10), with lane bias 2^(L-1):
        2^(L-1) >= min(n_k, n_i) * 2^(w_k-1) * (2^w_i - 1)
        2^(L-1) >  min(n_k, n_i) * (2^(w_k-1) - 1) * (2^w_i - 1) + (2^w_l - 1)

Datapaths:
  * DSP48E2 / DSP58 — the paper's FPGA targets; the port computes
    their >32-bit words in one 64-bit integer and transports them as
    two int32 planes (``core/limbs.py``).
  * INT32 — a 32-bit integer multiply.  Integer mod-2^32 wrap is
    value-preserving for every bit position below 32, exactly like the
    DSP's 48-bit ALU dropping carries past bit 47, so SDV spill-over
    tracking works unchanged.
  * FP32M — an fp32 multiply.  Exact only while every
    intermediate stays below 2^24 (the fp32 mantissa), therefore it is
    restricted to guard-bit (BSEG-style, spill-free) dimensioning:
    ``exact_wrap=False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class DatapathSpec:
    """A fixed-width multiply(-accumulate) datapath.

    Attributes:
      name: identifier used in configs / benchmark CSVs.
      w_packed: width of the input port that receives the packed word
        (the pre-adder / A:D side on DSP48E2: 27 bits).
      w_other: width of the second multiplier port (B side: 18 bits).
      w_word: width of the accumulator word (48 for DSP48E2).  For the
        TPU datapaths this is the width at which products are computed
        (32 for int32, 24 for the fp32 mantissa).
      exact_wrap: True when arithmetic past ``w_word`` wraps losslessly
        for the bits below (two's-complement hardware).  False means any
        overflow is *rounded* (fp32) and must be prevented outright.
      native_density: operational density of the unpacked datapath
        (DSP58 has a native INT8 mode computing three 9x8 products).
    """

    name: str
    w_packed: int
    w_other: int
    w_word: int
    exact_wrap: bool = True
    native_density: int = 1

    @property
    def w_packed_eff(self) -> int:
        """Usable packed-port width.

        On FPGA the multiplier port itself is the limit.  On the TPU
        datapaths the limit is the exact product budget: packed word
        bits + multiplier bits must fit in ``w_word``.
        """
        return min(self.w_packed, self.w_word - 1)

    def packed_port_budget(self, w_other_used: int) -> int:
        """Packed-word bits available when the other port uses
        ``w_other_used`` bits (product must stay inside ``w_word``)."""
        return min(self.w_packed, self.w_word - w_other_used)


DSP48E2 = DatapathSpec("dsp48e2", w_packed=27, w_other=18, w_word=48)
DSP58 = DatapathSpec("dsp58", w_packed=27, w_other=24, w_word=58,
                     native_density=3)
# word-level datapaths of a vector processor (DESIGN.md §2).
INT32 = DatapathSpec("int32", w_packed=32, w_other=32, w_word=32)
FP32M = DatapathSpec("fp32m", w_packed=24, w_other=24, w_word=24,
                     exact_wrap=False)

DATAPATHS = {d.name: d for d in (DSP48E2, DSP58, INT32, FP32M)}


# ---------------------------------------------------------------------------
# SDV dimensioning (Sec. III-C)
# ---------------------------------------------------------------------------

def sdv_lane_size(w_a: int, w_b: int) -> int:
    """Minimum SDV lane size with mod-4 spill-over tracking (Eq. 4)."""
    return w_a + w_b - 1


@dataclasses.dataclass(frozen=True)
class SDVPlan:
    spec: DatapathSpec
    w_a: int            # width of each packed element
    w_b: int            # width of the shared multiplier
    lane: int           # lane size L
    n: int              # number of packed elements (= MACs / multiply)
    signed_a: bool
    signed_b: bool

    @property
    def density(self) -> int:
        return self.n

    @property
    def packed_width(self) -> int:
        """Bits used by the packed word (leftmost lane needs w_a + 1)."""
        return (self.n - 1) * self.lane + self.w_a + 1


def plan_sdv(spec: DatapathSpec, w_a: int, w_b: int, *,
             signed_a: bool = True, signed_b: bool = True,
             lane: Optional[int] = None, n: Optional[int] = None,
             park_sign_bits: bool = False) -> SDVPlan:
    """Dimension an SDV packing for ``n`` elements of width ``w_a``
    against a shared ``w_b``-bit multiplier.

    The leftmost element only needs its own width plus one protection
    bit (leading zero for unsigned, sign-guard MSB for signed — Sec.
    III-C), so:   (n-1)*L + w_a + 1 <= port budget.
    """
    if w_a < 1 or w_b < 1:
        raise ValueError("bit-widths must be >= 1")
    L = sdv_lane_size(w_a, w_b) if lane is None else lane
    if L < sdv_lane_size(w_a, w_b):
        raise ValueError(f"lane {L} below Eq.4 minimum {sdv_lane_size(w_a, w_b)}")
    if L < 2:
        L = 2  # mod-4 tracking needs two observable bits per lane
    budget = spec.packed_port_budget(w_b)
    n_max = 1 + max(0, (budget - w_a - 1)) // L
    if park_sign_bits:
        # storage words park the n sign bits above the packed field
        # (kernels/sdv_matvec layout): (n-1)L + w_a + 1 + n <= w_word
        while n_max > 1 and (n_max - 1) * L + w_a + 1 + n_max > spec.w_word:
            n_max -= 1
    if n_max < 1 or w_a + 1 > budget:
        raise ValueError(
            f"{spec.name}: cannot pack even one {w_a}-bit element against "
            f"a {w_b}-bit multiplier")
    if n is None:
        n = n_max
    elif n > n_max:
        raise ValueError(f"n={n} exceeds max {n_max} for {spec.name}")
    return SDVPlan(spec=spec, w_a=w_a, w_b=w_b, lane=L, n=n,
                   signed_a=signed_a, signed_b=signed_b)


def sdv_density(spec: DatapathSpec, w_a: int, w_b: int) -> int:
    """Operational density (MACs / multiply / cycle) — Fig. 5a."""
    try:
        return plan_sdv(spec, w_a, w_b).n
    except ValueError:
        return 0


def sdv_max_accumulation_depth(plan: SDVPlan) -> int:
    """Number of MAC steps before the *top* lane can overrun the word.

    Lower lanes may wrap freely (spill-over is tracked); the top lane
    accumulates into the word's headroom.  Its field spans
    [ (n-1)L , w_word ), so its total must stay representable there.
    """
    top_start = (plan.n - 1) * plan.lane
    head = plan.spec.w_word - top_start
    # worst-case |product| = 2^(w_a-1) * 2^(w_b-1) for signed/signed
    max_prod_bits = plan.w_a + plan.w_b - (1 if plan.signed_a else 0) \
        - (1 if plan.signed_b else 0)
    depth = 2 ** max(0, head - 1 - max_prod_bits)
    return max(1, depth)


# ---------------------------------------------------------------------------
# BSEG dimensioning (Sec. III-D, Eqs. 7-10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BSEGPlan:
    spec: DatapathSpec
    w_k: int            # kernel element width (signed)
    w_i: int            # input element width (unsigned)
    lane: int           # lane size L
    n_k: int            # kernel elements packed into the A factor
    n_i: int            # input elements packed into the B factor
    w_l: int            # low-part width kept on the datapath between stages

    @property
    def density(self) -> int:
        return self.n_k * self.n_i

    @property
    def bias(self) -> int:
        """Per-lane guard offset 2^(L-1) centering the accumulation."""
        return 1 << (self.lane - 1)

    @property
    def n_lanes(self) -> int:
        """Product lanes: n_k + n_i - 1."""
        return self.n_k + self.n_i - 1


def _bseg_guard_ok(L: int, n_k: int, n_i: int, w_k: int, w_i: int,
                   w_l: int) -> bool:
    m = min(n_k, n_i)
    bias = 1 << (L - 1)
    eq9 = bias >= m * (1 << (w_k - 1)) * ((1 << w_i) - 1)
    eq10 = bias > m * ((1 << (w_k - 1)) - 1) * ((1 << w_i) - 1) + ((1 << w_l) - 1)
    return eq9 and eq10


def plan_bseg(spec: DatapathSpec, w_k: int, w_i: int, *,
              n_k: Optional[int] = None, n_i: Optional[int] = None,
              lane: Optional[int] = None,
              w_l: Optional[int] = None) -> BSEGPlan:
    """Dimension a BSEG packing. If n_k/n_i are not given, maximize the
    operational density n_k * n_i subject to Eqs. 7, 8 and 9 (w_l = 0),
    then maximize w_l under Eq. 10 (Sec. III-D: minimum lane size; the
    resource estimator may re-plan with lane+1 and pick the cheaper)."""
    if w_k < 1 or w_i < 1:
        raise ValueError("bit-widths must be >= 1")
    best = None
    nk_range = [n_k] if n_k else range(1, 32)
    for nk in nk_range:
        ni_range = [n_i] if n_i else range(1, 32)
        for ni in ni_range:
            # minimum lane from Eq. 9 (w_l = 0):
            m = min(nk, ni)
            need = m * (1 << (w_k - 1)) * ((1 << w_i) - 1)
            Lmin = 1
            while (1 << (Lmin - 1)) < need:
                Lmin += 1
            # lanes must also hold one product of each pair:
            Lmin = max(Lmin, w_k + w_i)
            L = lane if lane is not None else Lmin
            if L < Lmin:
                continue
            # Eq. 7 / Eq. 8 (ports: kernels -> packed port, inputs -> other).
            wa_used = (nk - 1) * L + w_k + 1
            wb_used = (ni - 1) * L + w_i + 1
            # product of the two packed factors must stay in the word:
            if wa_used + wb_used > spec.w_word:
                continue
            # ... and so must the *biased* accumulation word: every one
            # of the n_k + n_i - 1 product lanes carries the 2^(L-1)
            # guard bias and stays within [0, 2^L) (Eqs. 9/10), so the
            # accumulator (the DSP P register / the TPU word) holds up
            # to (n_k + n_i - 1) * L bits.  With guard-swept lanes
            # (L > w_k + w_i) this can exceed the port-product bound
            # above — the top lane's bias would fall off the word.
            if (nk + ni - 1) * L > spec.w_word:
                continue
            if wa_used > spec.w_packed or wb_used > spec.w_other:
                continue
            # maximize the low-part width under Eq. 10:
            if w_l is None:
                wl = 0
                while wl + 1 <= L and _bseg_guard_ok(L, nk, ni, w_k, w_i, wl + 1):
                    wl += 1
            else:
                wl = w_l
            if not _bseg_guard_ok(L, nk, ni, w_k, w_i, wl):
                continue
            cand = BSEGPlan(spec=spec, w_k=w_k, w_i=w_i, lane=L,
                            n_k=nk, n_i=ni, w_l=wl)
            key = (cand.density, cand.w_l, -cand.lane)
            if best is None or key > (best.density, best.w_l, -best.lane):
                best = cand
    if best is None:
        raise ValueError(
            f"{spec.name}: no feasible BSEG packing for w_k={w_k}, w_i={w_i}"
            + (f", n_k={n_k}, n_i={n_i}" if n_k or n_i else ""))
    return best


def bseg_density(spec: DatapathSpec, w_k: int, w_i: int) -> int:
    """Operational density (MACs / multiply / cycle) — Fig. 5b."""
    try:
        return plan_bseg(spec, w_k, w_i).density
    except ValueError:
        return 0
