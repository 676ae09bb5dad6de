"""Quantization rules of the torch port: symmetric per-channel integer
quantization, QAT fake-quant and the ``QuantizedTensor`` container."""
from . import quantizer
from .quantizer import (QuantizedTensor, asymmetric_levels,
                        asymmetric_qvalues, asymmetric_scale,
                        asymmetric_zero_point, dequantize, fake_quant,
                        quantize_symmetric, symmetric_qmax,
                        symmetric_qvalues, symmetric_scale)

__all__ = ["QuantizedTensor", "asymmetric_levels", "asymmetric_qvalues",
           "asymmetric_scale", "asymmetric_zero_point", "dequantize",
           "fake_quant", "quantize_symmetric", "quantizer",
           "symmetric_qmax", "symmetric_qvalues", "symmetric_scale"]
