"""SDV storage-word layout rules shared by the packer, the route gate
and the kernels.

Torch port of the SDV part of ``repro.kernels.bseg_common``
(``sdv_layout_bits`` and ``sdv_word_spec``).  The port computes every
word in 64-bit integers, so of the JAX package's ``WordSpec`` only the
transport form matters: one int32 array, or two int32 limb planes
``[2, ...]`` for the wide DSP48E2/DSP58 words.
"""
from __future__ import annotations

import dataclasses


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
