"""Quantization rules of the torch port."""
from .quantizer import (asymmetric_levels, asymmetric_qvalues,
                        asymmetric_scale, asymmetric_zero_point,
                        symmetric_qmax, symmetric_qvalues, symmetric_scale)

__all__ = ["asymmetric_levels", "asymmetric_qvalues", "asymmetric_scale",
           "asymmetric_zero_point", "symmetric_qmax", "symmetric_qvalues",
           "symmetric_scale"]
