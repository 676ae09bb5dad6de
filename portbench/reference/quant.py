"""The quantization rule the configurations state, frozen here for the
plain reference: symmetric, round half to even, clip to +-qmax.

  * weights: per output column, ``scale = max(amax over d_in, 1e-8) /
    qmax``, qmax = 2^(bits-1) - 1 (W4: 7);
  * activations of a packed projection: per row (token), the same rule
    over the row (A8: 127);
  * the KV cache: per (position, head) over the head dimension, int8
    (127).

Every quotient divides by a tensor, so it is correctly rounded on every
device.
"""
from __future__ import annotations

import torch


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize(x: torch.Tensor, bits: int, dim: int):
    """float32 ``x`` -> (integer values as float32, float32 scale with
    ``dim`` kept), the scale from the abs-max along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = _div(torch.clamp_min(amax, 1e-8), qmax(bits))
    q = torch.clamp(torch.round(x / scale), -qmax(bits), qmax(bits))
    return q, scale


def dequantized_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """[..., d_in, d_out] -> the W-bit per-output-column weight, float32."""
    q, s = quantize(w.to(torch.float32), bits, dim=-2)
    return q * s


def weight_codes(w: torch.Tensor, bits: int):
    """[d_in, d_out] -> (integer codes float32 [d_in, d_out], scale
    [d_out])."""
    q, s = quantize(w.to(torch.float32), bits, dim=-2)
    return q, s[..., 0, :]


def packed_linear(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                  act_bits: int) -> torch.Tensor:
    """A packed projection: ``x`` quantized per row to ``act_bits``, the
    integer product (exact in float32: every partial sum is an integer
    below 2^24 at these widths), then both scales."""
    xq, xs = quantize(x, act_bits, dim=-1)
    return (xq @ codes) * xs * scale


def kv_roundtrip(t: torch.Tensor):
    """[..., hd] K or V -> (int8 codes, scale [...]): the cache's rule."""
    q, s = quantize(t, 8, dim=-1)
    return q.to(torch.int8), s[..., 0]
