"""FPGA resource / throughput model for the SDV and BSEG units.

A copy of ``repro.finnlite.resource`` (pure Python, imports only
``core.datapath``), kept in the torch package so the port imports
nothing of the JAX package.

No FPGA synthesis runs here, so the paper's LUT/DSP/FPS
tables are reproduced through a *first-principles support-logic model*
whose per-bit constants were calibrated once against the paper's own
anchor points and then held fixed across every other table:

  * DSP counts are exact combinatorics: MACs-per-cycle / operational
    density (the density solver is the exact Sec. III math).
  * SDV support LUTs per DSP: n lanes x (2-LSB reference product +
    mod-4 compare/decode + spill accumulator + Eq. 3 fix-up adder)
    ~ n * (L + 10) LUTs.  At the paper's Tab. IV operating point
    (n=4, L=7 -> 68/DSP) this lands on the measured 69.4/DSP.
  * BSEG support LUTs per DSP: hi/lo slicing (n_k-1)(L-w_l) + lane
    emission adders n_i*L + fixed ~8 control ~ 34/DSP vs measured 33.9.
  * LUTRAM input-generator: (k-1) line buffers * W * C * w bits at
    64 bits/LUT with a wiring factor (calibrated on Tab. III).

Every benchmark prints model-vs-paper deltas so the calibration quality
is visible rather than hidden.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..core.datapath import DSP48E2, DatapathSpec, plan_bseg, plan_sdv

# calibration constants (fit once on Tab. II/IV anchors)
_SDV_LUT_C = 1.02
_BSEG_LUT_C = 1.0
_BSEG_CTRL = 8.0
_LUTRAM_WIRING = 5.2
_STREAM_CTRL = 550          # fixed AXI-stream control overhead per unit


@dataclasses.dataclass
class UnitEstimate:
    dsp: int
    lut: int
    bram: float
    macs_per_cycle: int
    density: float

    def fps(self, macs_per_frame: int, f_mhz: float = 250.0) -> float:
        return self.macs_per_cycle * f_mhz * 1e6 / macs_per_frame


def sdv_matvec_unit(m: int, k: int, w_a: int, w_b: int, *,
                    cycles: int, spec: DatapathSpec = DSP48E2,
                    extra_model_lut: int = 0) -> UnitEstimate:
    """FINN-style MatVec unit: the full m x k product in ``cycles``."""
    plan = plan_sdv(spec, w_a, w_b)
    macs_per_cycle = -(-m * k // cycles)
    dsp = -(-macs_per_cycle // plan.n)
    lut_per_dsp = _SDV_LUT_C * plan.n * (plan.lane + 10)
    # weight streaming / folding control scales with matrix bits
    lut = int(dsp * lut_per_dsp + _STREAM_CTRL
              + 0.004 * m * k * w_a) + extra_model_lut
    return UnitEstimate(dsp=dsp, lut=lut, bram=m * k * w_a / 18432.0,
                        macs_per_cycle=macs_per_cycle, density=plan.n)


def bseg_conv_unit(c_out: int, k_taps: int, depth: int, w_img: int,
                   w_k: int, w_i: int, *, out_per_cycle: int,
                   spec: DatapathSpec = DSP48E2,
                   input_gen: str = "bram",
                   two_d: bool = False) -> UnitEstimate:
    """BSEG convolution unit: 1-D kernel of ``k_taps`` x ``depth``
    channels, ``c_out`` filters, sustaining ``out_per_cycle`` output
    elements per cycle."""
    plan = plan_bseg(spec, w_k, w_i)
    macs_per_cycle = out_per_cycle * k_taps * depth
    chains = -(-k_taps // plan.n_k)
    units = -(-macs_per_cycle // (plan.density * chains))
    dsp = int(units * chains * 1.12)         # pipeline granularity factor
    lut_per_dsp = _BSEG_LUT_C * ((plan.n_k - 1) * (plan.lane - plan.w_l)
                                 + plan.n_i * plan.lane + _BSEG_CTRL)
    lut = int(dsp * lut_per_dsp + _STREAM_CTRL
              + 0.09 * c_out * k_taps * depth * w_k / 8)
    # input generator: 2-D convs buffer (k-1) full image lines; 1-D
    # convs only need a (k-1)-deep shift window.  Channel reordering for
    # FINN's channels-last layout costs ~80 LUT/channel (Tab. III
    # calibration; this is what makes deep-channel layers 3/4 expensive
    # — "the input generator based on FINN's tensor layout gets costly
    # for many input channels").
    lines = w_img if two_d else 1
    buf_bits = max(0, (k_taps - 1)) * lines * depth * w_i
    bram = 0.0
    if two_d:
        lut += int(80 * depth)
    if input_gen == "lutram":
        lut += int(buf_bits / 64 * _LUTRAM_WIRING)
    else:
        bram = buf_bits / 18432.0
    return UnitEstimate(dsp=dsp, lut=lut, bram=bram,
                        macs_per_cycle=macs_per_cycle,
                        density=plan.density)


# ---------------------------------------------------------------------------
# UltraNet tables (paper Tabs. II / III / IV)
# ---------------------------------------------------------------------------

_ULTRA = [  # (cin, cout, k, w_img after pools)
    (3, 16, 3, 416), (16, 32, 3, 208), (32, 64, 3, 104), (64, 64, 3, 52),
    (64, 64, 3, 26), (64, 64, 3, 26), (64, 64, 3, 26), (64, 64, 3, 26),
]

PAPER_TAB2 = {
    "Base": {"lut": 43000, "dsp": 360, "fps": 248},
    "HiKonv": {"lut": 48000, "dsp": 327, "fps": 401},
    "FINN-FM": {"lut": 63000, "dsp": 586, "fps": 636},
    "BSEG-FM": {"lut": 46000, "dsp": 422, "fps": 636},
    "BSEG-Conv": {"lut": 31000, "dsp": 422, "fps": 636},
}

PAPER_TAB3 = {  # layer: (FINN lut, B1 lut, B2 lut, FINN dsp, B dsp)
    0: (4959, 1380, 2231, 27, 18),
    1: (7028, 3536, 5658, 72, 48),
    2: (8465, 4785, 6261, 96, 64),
    3: (4417, 5871, 7338, 144, 64),
    4: (2746, 5856, 6623, 32, 64),
}

PAPER_TAB4 = {"finn": {"lut": 17761, "dsp": 256, "mhz": 580},
              "bseg": {"lut": 6505, "dsp": 192, "mhz": 590}}


def ultranet_tables() -> dict:
    """Model estimates for the first UltraNet conv layers vs paper."""
    tab3 = {}
    # per-layer throughput chosen to sustain 636 FPS at 250 MHz
    for li, (cin, cout, k, w_img) in enumerate(_ULTRA[:5]):
        pixels = w_img * w_img
        macs_frame = pixels * cout * cin * k * k
        opc = max(1, int(macs_frame * 636 / 250e6 / (k * k * cin)))
        est_b1 = bseg_conv_unit(cout, k, cin, w_img, 4, 4,
                                out_per_cycle=opc, input_gen="bram",
                                two_d=True)
        est_b2 = bseg_conv_unit(cout, k, cin, w_img, 4, 4,
                                out_per_cycle=opc, input_gen="lutram",
                                two_d=True)
        # FINN baseline folds the same frame rate through an SDV matvec:
        # one matvec (cout x cin*k^2) per output pixel.
        macs_per_cycle_budget = max(1, int(macs_frame * 636 / 250e6))
        mv_cycles = max(1, cout * cin * k * k // macs_per_cycle_budget)
        est_finn = sdv_matvec_unit(cout, cin * k * k, 4, 4,
                                   cycles=mv_cycles)
        tab3[li] = {"model_b1_lut": est_b1.lut, "model_b2_lut": est_b2.lut,
                    "model_dsp": est_b1.dsp, "model_finn_lut": est_finn.lut,
                    "model_finn_dsp": est_finn.dsp,
                    "paper": PAPER_TAB3[li]}
    # Tab IV reference layer: 1x1500x16 input, 128 kernels 1x8x16
    t4_bseg = bseg_conv_unit(128, 8, 16, 1500, 4, 4, out_per_cycle=8,
                             input_gen="lutram")
    t4_finn = sdv_matvec_unit(128, 8 * 16, 4, 4,
                              cycles=128 // 8)
    tab4 = {"model": {"bseg_lut": t4_bseg.lut, "bseg_dsp": t4_bseg.dsp,
                      "finn_lut": t4_finn.lut, "finn_dsp": t4_finn.dsp},
            "paper": PAPER_TAB4}
    return {"tab3": tab3, "tab4": tab4, "paper_tab2": PAPER_TAB2}
