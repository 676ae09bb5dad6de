"""Core arithmetic-packing library of the torch port — the paper's
contribution: the datapath specs and dimensioning (Fig. 5), the
pre-adder split, the int32 plane transport of wide words, and the
cycle-level SDV (matvec) and BSEG (conv) engines, the int64 oracles the
kernels are held against."""
from .datapath import (BSEGPlan, DATAPATHS, DSP48E2, DSP58, DatapathSpec,
                       FP32M, INT32, SDVPlan, bseg_density, plan_bseg,
                       plan_sdv, sdv_density, sdv_lane_size,
                       sdv_max_accumulation_depth)
from .signed_split import pack, pack_signed, pack_unsigned, split_signed
from .sdv import sdv_extract, sdv_macc, sdv_matvec, sdv_pack
from .bseg import (bseg_conv1d, bseg_conv1d_grouped, bseg_num_multiplies,
                   bseg_pack_inputs, bseg_pack_kernel)

__all__ = [
    "BSEGPlan", "DATAPATHS", "DSP48E2", "DSP58", "DatapathSpec", "FP32M",
    "INT32", "SDVPlan", "bseg_density", "plan_bseg", "plan_sdv",
    "sdv_density", "sdv_lane_size", "sdv_max_accumulation_depth",
    "pack", "pack_signed", "pack_unsigned", "split_signed",
    "sdv_extract", "sdv_macc", "sdv_matvec", "sdv_pack",
    "bseg_conv1d", "bseg_conv1d_grouped", "bseg_num_multiplies",
    "bseg_pack_inputs", "bseg_pack_kernel",
]
