"""Int8 gradient all-reduce with error feedback, SDV-packed on the wire —
torch port of ``repro.train.grad_compress``.

The paper packs low-bit values onto wide datapaths; the same idea
applied to the *interconnect* shrinks gradient all-reduce bytes.
Protocol (each rank holds its local gradient; ``torch.distributed``
collectives over the reduction group):

  1. g' = g + e            (add the residual from the previous step)
  2. s  = all-reduce-max(|g'|) / 127     (shared scale, one scalar per
     tensor)
  3. q  = round(g'/s) int8, then SDV-pack PAIRS of int8 values into one
     int32 word via ``core/signed_split.pack_signed`` (16-bit lanes:
     word = v0 + 2^16 v1, the pre-adder D - A form) and all-reduce the
     WORDS — summing packed words sums every lane independently, the
     paper's Eq. 4 linearity, so one int32 word on the wire carries two
     int8 gradients (2 bytes/element vs 4 for the int32-per-element
     reduce).  Lane sums stay in signed 16 bits up to
     ``MAX_PACKED_DEVICES`` ranks; beyond that the unpacked int32
     reduce is used automatically.
  4. decode lanes low-to-high with borrow (exact), g_hat = q_sum * s /
     n_ranks ; e = g' - dequant(own q)   (feedback)

Exact all-reduce of the quantized values — packing is algebraically
lossless (packed == unpacked bit for bit); the only loss is the
quantization itself, which error feedback pushes to O(1/steps).  The
words and both results equal the JAX package's bit for bit.  Every
division goes through a 0-dim device tensor (``quantizer.div``): on
the card ``x / python_number`` multiplies by the reciprocal and lands
an ulp off.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from .. import tree
from ..core import signed_split
from ..quant.quantizer import div

#: bits per lane of the packed gradient word (two lanes per int32)
GRAD_LANE = 16
#: devices whose +/-127 lane contributions still fit a signed 16-bit
#: lane sum: 127 * 258 = 32766 <= 2^15 - 1 (and the int32 word total
#: 127 * 65537 * 258 stays under 2^31)
MAX_PACKED_DEVICES = 258


def pack_grad_words(q: torch.Tensor) -> torch.Tensor:
    """int8-valued [...]-shaped q -> int32 SDV words [ceil(size/2)].

    Flattens, zero-pads to an even count, and packs value pairs
    through the pre-adder form (``pack_signed``: D - A with 16-bit
    lanes).  ``pack_signed`` forms the words in int64; a pair of int8
    values, v0 + 2^16 v1, fits int32, so the cast is exact."""
    flat = q.reshape(-1).to(torch.int32)
    if flat.shape[0] % 2:
        flat = torch.nn.functional.pad(flat, (0, 1))
    pairs = flat.reshape(-1, 2)
    return signed_split.pack_signed(pairs, GRAD_LANE, GRAD_LANE) \
        .to(torch.int32)


def unpack_grad_words(words: torch.Tensor, size: int) -> torch.Tensor:
    """Decode summed words back to per-element lane sums [size] int32.

    Low-to-high with borrow: the low lane is recovered mod 2^16 into
    the signed 16-bit range (exact while lane sums fit — the
    ``MAX_PACKED_DEVICES`` bound), then subtracted off so the
    arithmetic shift yields the high lane exactly."""
    half = 1 << (GRAD_LANE - 1)
    mask = (1 << GRAD_LANE) - 1
    v0 = ((words + half) & mask) - half
    v1 = (words - v0) >> GRAD_LANE
    return torch.stack([v0, v1], dim=-1).reshape(-1)[:size]


def compress_psum(g: torch.Tensor, err: torch.Tensor,
                  group: Optional[dist.ProcessGroup] = None,
                  pack_words: bool = True):
    """Int8 all-reduce with error feedback of this rank's ``g`` over
    ``group`` (the default group when None).

    ``pack_words`` reduces SDV-packed int32 words (two int8 values per
    word — half the wire bytes); the caller must guarantee the group
    holds at most ``MAX_PACKED_DEVICES`` ranks (``compressed_allreduce``
    checks).  Packed and unpacked paths are bit-exact equals.

    Returns (g_hat mean-reduced, new_err)."""
    gf = g.to(torch.float32) + err
    amax = gf.abs().amax()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = div(torch.clamp_min(amax, 1e-12), 127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    red = pack_grad_words(q) if pack_words else q.to(torch.int32)
    dist.all_reduce(red, op=dist.ReduceOp.SUM, group=group)
    qsum = unpack_grad_words(red, g.numel()).reshape(g.shape) \
        if pack_words else red
    n = dist.get_world_size(group)
    g_hat = div(qsum.to(torch.float32) * scale, n).to(g.dtype)
    return g_hat, new_err


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh`` along ``axis``: a ``DeviceMesh``, or a
    stand-in whose ``shape`` is a {name: size} dict."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return int(shape[axis])
    return int(tuple(shape)[list(mesh.mesh_dim_names).index(axis)])


def compressed_allreduce(grads: Any, errs: Any, mesh, axis: str = "data",
                         pack_words: Optional[bool] = None):
    """The protocol over a tree, across the ranks of ``mesh`` along
    ``axis`` (a ``DeviceMesh``).

    Each rank passes its local ``grads``/``errs`` leaves (what the JAX
    package's ``shard_map`` body sees as ``g[0]``).  ``pack_words=None``
    packs whenever the rank count allows it; ``pack_words=True`` above
    ``MAX_PACKED_DEVICES`` raises before any collective.  Returns
    (mean-reduced g_hat, the same on every rank; this rank's new
    errors)."""
    n_dev = axis_size(mesh, axis)
    if pack_words is None:
        pack_words = n_dev <= MAX_PACKED_DEVICES
    elif pack_words and n_dev > MAX_PACKED_DEVICES:
        raise ValueError(
            f"packed gradient all-reduce overflows 16-bit lane sums at "
            f"{n_dev} devices (max {MAX_PACKED_DEVICES})")
    group = mesh.get_group(axis)
    outs = [compress_psum(g, e, group, pack_words=pack_words)
            for g, e in zip(tree.leaves(grads), tree.leaves(errs))]
    return (tree.unflatten(grads, [o[0] for o in outs]),
            tree.unflatten(grads, [o[1] for o in outs]))
