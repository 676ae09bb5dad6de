"""Carry parameters from the JAX package to the port through numpy.

``params_from_numpy`` takes the JAX package's value tree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, values(init_params(...)))``)
and returns the port's tree: the same keys, torch tensors of the same
dtypes on ``device``.  bfloat16 arrays (numpy's ``ml_dtypes`` extension
type) cross as their 16-bit patterns, so every value is carried bit for
bit.  ``packed_from_numpy`` does the same for a memory-packed serve
tree (``jax.tree_util.tree_map(np.asarray, serve_params(...,
compute="memory"))``), whose ``PackedLinear`` leaves cross with their
words and scales as they are, so both packages run the same words.
``ultranet_params_from_numpy`` does the same for UltraNet's conv weights
(``[np.asarray(w) for w in params.convs]``, ``params.head``).
``opt_state_from_numpy`` does the same for the JAX package's AdamW
state (``jax.tree_util.tree_map(np.asarray, opt_state)``): its 8-bit
``Q8`` moments become the port's ``train.optimizer.Q8``, and a moment
held in a QAT container (the reference's moment tree keeps
``QATLinear`` nodes) becomes its bare kernel, whose leaves sit in the
same place of the leaf order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .quantized import PackedLinear, _stacked_leading_axis
from .ultranet import UltraNetParams


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)               # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of torch tensors."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev)

    return walk(tree)


def opt_state_from_numpy(tree, device="cuda"):
    """The JAX package's optimizer state as numpy -> the port's."""
    from ..train.optimizer import Q8
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if hasattr(node, "_fields") and set(node._fields) == {"q", "scale"}:
            return Q8(q=_tensor(node.q, dev), scale=_tensor(node.scale, dev))
        if hasattr(node, "qat_apply"):
            return walk(node.kernel)
        return _tensor(node, dev)

    return walk(tree)


def packed_from_numpy(tree, device="cuda"):
    """A memory-packed serve tree as numpy -> the port's: nested dicts of
    arrays, whose lane-packed leaves (any object with ``words``,
    ``scale``, ``bits`` and ``d_out``, as the JAX package's
    ``PackedLinear`` has) become the port's ``PackedLinear``, stacked
    where they sit under a layer-stack container (``blocks``,
    ``blocks_dense{j}``, ...: the MoE expert banks too)."""
    dev = resolve_device(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if all(hasattr(node, f) for f in ("words", "scale", "bits",
                                           "d_out")):
            words = _tensor(node.words, dev)
            return PackedLinear(
                words=words, scale=_tensor(node.scale, dev),
                bits=int(node.bits), d_out=int(node.d_out),
                stacked=_stacked_leading_axis(path) and words.ndim > 2)
        return _tensor(node, dev)

    return walk(tree, "")


def ultranet_params_from_numpy(convs, head, device="cuda") -> UltraNetParams:
    """The reference's UltraNet weights (numpy int8 ``[C_out, C_in, k,
    k]`` stages and head) -> the port's ``UltraNetParams``."""
    dev = resolve_device(device)
    return UltraNetParams(convs=[_tensor(w, dev) for w in convs],
                          head=_tensor(head, dev))
