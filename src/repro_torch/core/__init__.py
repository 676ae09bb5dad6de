"""Core packing math of the torch port: datapath dimensioning, the
pre-adder split and the int32 plane transport of wide words."""
from .datapath import (BSEGPlan, DATAPATHS, DSP48E2, DSP58, DatapathSpec,
                       FP32M, INT32, SDVPlan, plan_bseg, plan_sdv)

__all__ = ["BSEGPlan", "DATAPATHS", "DSP48E2", "DSP58", "DatapathSpec",
           "FP32M", "INT32", "SDVPlan", "plan_bseg", "plan_sdv"]
