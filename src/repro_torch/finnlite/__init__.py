"""FINN-analogue dataflow resource/throughput estimator (a copy of
``repro.finnlite``)."""
from .resource import (UnitEstimate, bseg_conv_unit, sdv_matvec_unit,
                       ultranet_tables)

__all__ = ["UnitEstimate", "bseg_conv_unit", "sdv_matvec_unit",
           "ultranet_tables"]
