"""Symmetric per-channel quantization (the FINN-style fixed-point model).

Torch port of the rule in ``repro.quant.quantizer``:

  * signed symmetric (weights, SDV matmul activations):
        qmax  = 2^(bits-1) - 1
        scale = max(amax, 1e-8) / qmax
        q     = clip(round(x / scale), -qmax, qmax)
  * unsigned asymmetric (BSEG conv activations, Eqs. 9/10 unsigned
    domain): ``levels = 2^bits - 1``, ``scale = max(hi-lo, 1e-6) /
    levels``, zero point ``2^(bits-1)``.

``QuantizedTensor`` (int8 values + scale), ``quantize_symmetric``,
``dequantize`` and ``fake_quant`` (the straight-through form QAT uses)
are built on that rule.

``torch.round`` rounds half to even like ``jnp.round``, and the float32
division comes before the clip in both, so the two packages produce
the same integers from the same float32 inputs — on the card too: a
division by a Python number goes through ``div``, which divides by a
tensor (torch's CUDA kernel multiplies by the divisor's reciprocal
instead, which can be one ulp off the quotient, and move a scale and
the integers quantized with it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import constant
from ..tree import register_container


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device, as the JAX package
    computes it: the divisor is a 0-dim tensor of ``x``'s dtype on
    ``x``'s device (``device.constant``, made once and reused)."""
    return x / constant(d, x.dtype, x.device)


def symmetric_qmax(bits: int) -> int:
    """Largest magnitude of a ``bits``-wide symmetric signed value."""
    return (1 << (bits - 1)) - 1


def symmetric_scale(amax: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-channel dequantization scale from the abs-max statistic."""
    return div(torch.clamp_min(amax, 1e-8), symmetric_qmax(bits))


def symmetric_qvalues(x: torch.Tensor, scale: torch.Tensor,
                      bits: int) -> torch.Tensor:
    """Round-and-clip ``x / scale`` into the symmetric signed range.

    Returns float values holding exact integers in [-qmax, qmax];
    callers pick the container dtype."""
    qmax = symmetric_qmax(bits)
    return torch.clamp(torch.round(x / scale), -qmax, qmax)


def asymmetric_levels(bits: int) -> int:
    """Number of steps of the unsigned ``bits``-wide domain."""
    return (1 << bits) - 1


def asymmetric_zero_point(bits: int) -> int:
    """The mid-domain zero point (Eqs. 9/10 signed-to-unsigned shift)."""
    return 1 << (bits - 1)


def asymmetric_scale(lo: torch.Tensor, hi: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """Step size of the unsigned asymmetric (min/max) rule."""
    return div(torch.clamp_min(hi - lo, 1e-6), asymmetric_levels(bits))


def asymmetric_qvalues(x: torch.Tensor, lo: torch.Tensor,
                       scale: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-and-clip into the unsigned [0, 2^bits) domain."""
    return torch.clamp(torch.round((x - lo) / scale), 0,
                       asymmetric_levels(bits))


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedTensor:
    """Integer values + dequantization scale (axis: per leading channel)."""
    values: torch.Tensor         # int8 container, values within `bits`
    scale: torch.Tensor          # f32, broadcastable against values
    bits: int

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        return (self.values.to(torch.float32) * self.scale).to(dtype)


register_container(QuantizedTensor, ("values", "scale"))


def quantize_symmetric(x: torch.Tensor, bits: int, *,
                       axis: Optional[int] = -1) -> QuantizedTensor:
    """Per-channel symmetric quantization along ``axis`` (None: per-tensor)."""
    if axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    scale = symmetric_scale(amax, bits)
    q = symmetric_qvalues(x, scale, bits).to(torch.int8)
    return QuantizedTensor(values=q, scale=scale.to(torch.float32),
                           bits=bits)


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    return qt.dequantize(dtype)


def fake_quant(x: torch.Tensor, bits: int, *, axis: Optional[int] = -1):
    """Straight-through fake quantization (QAT): the dequantized value
    forward, the identity's gradient backward."""
    qt = quantize_symmetric(x, bits, axis=axis)
    xq = qt.dequantize(x.dtype)
    return x + (xq - x).detach()
