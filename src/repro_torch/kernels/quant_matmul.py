"""Unpack-in-kernel quantized matmul (kernel B5) — torch port of
``repro.kernels.quant_matmul`` (the ``packed_memory`` route of the
packed-matmul dispatch).

``y = x @ (unpack(words) * scale)``: weights stay in HBM as int32 lane
words (``32 // w`` w-bit fields each, the ``packbits`` layout) and are
unpacked and sign-extended inside the kernel; activations are widened to
float32, the products are summed in float32 and the per-output-channel
scale is applied to the sum, as in the reference.

On a CUDA tensor ``quant_matmul`` launches the hand-written Hopper kernel
``csrc/quant_matmul.cu::quant_matmul_kernel`` (float32 FMAs, no TF32);
on a CPU tensor it runs ``quant_matmul_plain`` (``ref.quant_matmul_ref``
on ``ref.unpack_words_ref``'s integers).  There is no fallback between
the two: a CUDA tensor that the kernel cannot take raises.  The
reference's TPU blocks (``bm``, ``bn``, ``bk``, which had to divide the
shape) are gone: the kernel takes any m, n and k.
"""
from __future__ import annotations

import torch

from . import build, ref

#: activation dtypes the kernel reads (others are the caller's to widen)
X_DTYPES = (torch.float32, torch.bfloat16)


def check_operands(x: torch.Tensor, w_packed: torch.Tensor,
                   scale: torch.Tensor, *, w: int) -> int:
    """Validate B5's operands; returns n, the unpacked column count."""
    if not 2 <= w <= 8:
        raise ValueError(f"field width w must be in 2..8, got {w}")
    if x.dtype not in X_DTYPES or x.ndim != 2:
        raise ValueError(f"x must be 2-D float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if w_packed.dtype != torch.int32 or w_packed.ndim != 2:
        raise ValueError(f"words must be 2-D int32, got "
                         f"{tuple(w_packed.shape)} {w_packed.dtype}")
    k, nw = w_packed.shape
    n = nw * (32 // w)
    if x.shape[1] != k or k < 1 or x.shape[0] < 1 or nw < 1:
        raise ValueError(f"shapes x {tuple(x.shape)}, words "
                         f"{tuple(w_packed.shape)}: need x [m, k] against "
                         "words [k, nw], all nonzero")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"scale must be float32 [{n}], got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if not (x.device == w_packed.device == scale.device):
        raise ValueError(f"operands on {x.device}, {w_packed.device} and "
                         f"{scale.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("operands must be contiguous")
    return n


def error_bound(x: torch.Tensor, w_int: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Elementwise bound on ``|y - exact|`` for any float32 evaluation of
    B5's function (the k products summed in any order, then one product
    with the scale): gamma_{k+1} (|x| @ |w_int|) |scale|, with gamma_j =
    j u / (1 - j u) and u = 2^-24 (the standard inner-product bound),
    computed in float64.  Against the exact float64 result both the
    kernel and its plain version lie within it, so they lie within twice
    it of each other."""
    k = x.shape[-1]
    u = 2.0 ** -24
    gamma = (k + 1) * u / (1 - (k + 1) * u)
    mag = x.to(torch.float64).abs() @ w_int.to(torch.float64).abs()
    return gamma * mag * scale.to(torch.float64).abs().reshape(1, -1)


#: the limit on ``|y - exact|`` in units of ``rounding_scale``, set from
#: readings (chip_smoke.py on an H100, tinyllama shapes at 8 and 128
#: rows): the kernel's float32 FMA chain in order k = 0, 1, ... reads at
#: most 4.1 at the worst output of a case (1.4 on bf16 x); x rounded to
#: TF32's 10 mantissa bits reads 187-460, and bf16-rounded x 1400-3500
ROUNDING_LIMIT = 8.0


def rounding_scale(x: torch.Tensor, w_int: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Elementwise typical size of float32 rounding in B5's function:
    sqrt(k) u sqrt(sum_j (x_j w_j)^2) |scale|, u = 2^-24, in float64.
    Each partial sum of the k products is rounded by up to u of itself,
    and random roundings add as a random walk, so a sound float32
    evaluation lies within a few of it of the exact result, about
    sqrt(k) closer than ``error_bound``; one that rounds x (TF32, bf16)
    lies far outside.  Held at ``ROUNDING_LIMIT`` beside the bound."""
    k = x.shape[-1]
    sq = x.to(torch.float64).square() @ w_int.to(torch.float64).square()
    return (k ** 0.5 * 2.0 ** -24) * sq.sqrt() \
        * scale.to(torch.float64).abs().reshape(1, -1)


def quant_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor, *, w: int) -> torch.Tensor:
    """Plain torch version of B5 (same operands and result, up to the
    float32 summation order)."""
    quant_matmul_plain.calls += 1
    return ref.quant_matmul_ref(x, ref.unpack_words_ref(w_packed, w=w),
                                scale)


quant_matmul_plain.calls = 0


def quant_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                 scale: torch.Tensor, *, w: int) -> torch.Tensor:
    """x [m, k] (bf16/f32) @ packed weights [k, n/(32/w)] int32 -> [m, n]
    float32 (kernel B5); ``scale`` is the per-output-channel
    dequantization scale [n] float32."""
    n = check_operands(x, w_packed, scale, w=w)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_packed, scale, w=w)
    m, k = x.shape
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    lib = build.library("quant_matmul")
    err = lib.quant_matmul(x.data_ptr(), w_packed.data_ptr(),
                           scale.data_ptr(), out.data_ptr(), m, k,
                           w_packed.shape[1], w,
                           int(x.dtype == torch.bfloat16),
                           torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "quant_matmul")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
