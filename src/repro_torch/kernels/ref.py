"""Plain oracles for the packed kernels (torch port of
``repro.kernels.ref``: the lane pack/unpack and quantized matmul of the
memory-packed path, the SDV GEMM, conv1d and conv2d).

They use no packing arithmetic at all: the storage words are decoded
back to integers and multiplied exactly.  The GEMM and conv2d products
are taken in float64, which is exact while |sum| < 2^53 (every plan
with w_a, w_b <= 8 at any K below 2^37), and works on the card, where
torch has no integer matmul or integer convolution; the depthwise
conv1d has a few taps and runs in int32 elementwise ops, as the JAX
package's does.
"""
from __future__ import annotations

import torch

from ..core import limbs


def unpack_words_ref(packed: torch.Tensor, *, w: int) -> torch.Tensor:
    """int32 lane words [m, nw] -> int8 [m, nw * (32 // w)]: word j's
    field i (bits i*w .. i*w+w-1, two's complement) is column
    j * (32 // w) + i, sign-extended."""
    per = 32 // w
    word = limbs.from_u32(packed)
    parts = []
    for i in range(per):
        f = (word >> (i * w)) & ((1 << w) - 1)
        parts.append(torch.where(f >= (1 << (w - 1)), f - (1 << w), f))
    return torch.stack(parts, dim=-1).reshape(packed.shape[0], -1) \
        .to(torch.int8)


def pack_words_ref(vals: torch.Tensor, *, w: int) -> torch.Tensor:
    """Ints [m, n] (w-bit two's complement; n a multiple of 32 // w) ->
    int32 lane words [m, n // (32 // w)], the inverse of
    ``unpack_words_ref``.  Fields are masked to w bits and assembled in
    int64, so the top field lands in the sign bit by an explicit wrap."""
    per = 32 // w
    m, n = vals.shape
    v = vals.to(torch.int64).reshape(m, n // per, per)
    word = torch.zeros((m, n // per), dtype=torch.int64, device=vals.device)
    for i in range(per):
        word = word | ((v[..., i] & ((1 << w) - 1)) << (i * w))
    return limbs.lo32(word)


def quant_matmul_ref(x: torch.Tensor, w_int: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x [m, k] float @ (w_int [k, n] ints * scale [n]) -> [m, n] f32:
    the product in float32, then the per-channel scale."""
    return (x.to(torch.float32) @ w_int.to(torch.float32)) \
        * scale.reshape(1, -1).to(torch.float32)


def _exact_int_matmul(x_int: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    y = x_int.to(torch.float64) @ w_t.to(torch.float64)
    return limbs.lo32(y.to(torch.int64))


def sdv_matvec_ref(x_int: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """Exact integer GEMV batch: x [b, k] ints, w [m, k] ints -> [b, m] i32."""
    return _exact_int_matmul(x_int, w_int.T)


def sdv_matmul_ref(x_int: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """Exact integer GEMM with arbitrary leading batch dims:
    x [..., k] ints, w [m, k] ints -> [..., m] i32."""
    return _exact_int_matmul(x_int, w_int.T)


def sdv_unpack_words_ref(w_words: torch.Tensor, *, plan) -> torch.Tensor:
    """Decode [K, G] SDV storage words (or [2, K, G] limb planes) back
    to integer elements [K, G*n] int32 (lane-major: group g's lanes are
    columns g*n .. g*n+n-1).

    Signed layout: remainder fields in the low ``plan.packed_width``
    bits, sign bits parked above (value = r - 2^(w_a-1) s).  Unsigned
    layout: the lane fields are the values.
    """
    if w_words.ndim == 3:
        word = limbs.from_planes(w_words)
    else:
        word = limbs.from_u32(w_words)
    k, g = word.shape
    vals = []
    for i in range(plan.n):
        if plan.signed_a:
            r_i = (word >> (i * plan.lane)) & ((1 << (plan.w_a - 1)) - 1)
            s_i = (word >> (plan.packed_width + i)) & 1
            vals.append(r_i - (s_i << (plan.w_a - 1)))
        else:
            vals.append((word >> (i * plan.lane)) & ((1 << plan.w_a) - 1))
    return torch.stack(vals, dim=-1).reshape(k, g * plan.n).to(torch.int32)


def conv1d_ref(x_int: torch.Tensor, taps: torch.Tensor,
               left_pad: int) -> torch.Tensor:
    """Exact depthwise 1-D correlation with an explicit alignment.

    x [b, s, c] ints, taps [c, n] ints -> y [b, s, c] int32 with
    y[b, s, c] = sum_q taps[c, q] * x[b, s - left_pad + q, c]
    (zero padding on both ends as needed).
    """
    n = taps.shape[-1]
    s = x_int.shape[1]
    x32 = x_int.to(torch.int32)
    xp = torch.nn.functional.pad(x32, (0, 0, left_pad,
                                       max(0, n - 1 - left_pad)))
    y = torch.zeros_like(x32)
    for q in range(n):
        y = y + taps[:, q][None, None, :].to(torch.int32) * xp[:, q:q + s, :]
    return y


def conv1d_causal_ref(x_int: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Exact depthwise *causal* 1-D correlation (left zero pad n-1)."""
    return conv1d_ref(x_int, taps, taps.shape[-1] - 1)


def conv2d_int_ref(x_int: torch.Tensor, w_int: torch.Tensor) -> torch.Tensor:
    """Exact stride-1 'same'-pad integer conv2d (the conv oracle).

    x [b, h, w, c_in * groups] ints, w [c_out, c_in, kh, kw] ints ->
    [b, h, w, c_out] int32 (``c_in == 1`` with ``c_out`` equal to the
    activation channels is the depthwise conv).  One float64 product
    per kernel tap, summed in float64: exact while |sum| < 2^53, on
    both devices (no float32 convolution, which the card runs in TF32).
    """
    c_out, c_in, kh, kw = w_int.shape
    b, h, w, c = x_int.shape
    groups = c // c_in
    xp = torch.nn.functional.pad(x_int.to(torch.float64),
                                 (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    xg = xp.reshape(b, h + 2 * (kh // 2), w + 2 * (kw // 2), groups, c_in)
    wg = w_int.to(torch.float64).reshape(groups, c_out // groups, c_in,
                                         kh, kw)
    y = torch.zeros((b, h, w, groups, c_out // groups), dtype=torch.float64,
                    device=x_int.device)
    for r in range(kh):
        for q in range(kw):
            y += torch.einsum("bhwgi,goi->bhwgo", xg[:, r:r + h, q:q + w],
                              wg[..., r, q])
    return limbs.lo32(y.reshape(b, h, w, c_out).to(torch.int64))
