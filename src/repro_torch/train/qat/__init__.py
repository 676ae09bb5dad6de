"""Packed quantization-aware training — torch port of
``repro.train.qat``.

Closes the loop from training to the packed serving stack: the STE
forward runs the *same* integer arithmetic the serving containers run
(``ste``; kernel B2 on the card), per-layer bitwidths are searched
jointly with packing plans against the route-aware cost model
(``bitsearch``), and the QAT run exports serving-ready params plus a
warm plan cache (``loop``).
"""
from .ste import (QATLinear, count_qat_layers, float_params, is_qat,
                  qat_params, quantize_acts, quantize_weights, ste_conv2d,
                  ste_dense)
from .bitsearch import (BitwidthChoice, search_bitwidths,
                        sensitivity_proxy, write_search_report)
from .loop import QATRunConfig, evaluate, export_for_serving, run_qat

__all__ = [
    "QATLinear", "count_qat_layers", "float_params", "is_qat",
    "qat_params", "quantize_acts", "quantize_weights", "ste_conv2d",
    "ste_dense",
    "BitwidthChoice", "search_bitwidths", "sensitivity_proxy",
    "write_search_report",
    "QATRunConfig", "evaluate", "export_for_serving", "run_qat",
]
