"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
torch port of ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``_rglru_core`` runs the recurrence as the JAX package does, an
associative scan over the sequence (``associative_scan``: log-depth, the
odd/even recursion of ``jax.lax.associative_scan``, differentiable by
autograd); decode passes one token, for which the scan is ``a h0 + x``.
The short conv runs on kernel B4 once ``serve_params`` has packed it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..tracing import span
from .layers import Init, dense_apply, dense_init, gelu_tanh
from .ssm import short_conv_apply, short_conv_init, softplus

_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int
    d_conv: int = 4


def rglru_init(ini: Init, cfg: RGLRUConfig):
    d, dr = cfg.d_model, cfg.d_rnn
    return {
        "in_x": dense_init(ini, d, dr, ("fsdp", "tp")),
        "in_gate": dense_init(ini, d, dr, ("fsdp", "tp")),
        "conv": short_conv_init(ini, dr, cfg.d_conv),
        "w_a": dense_init(ini, dr, dr, ("tp", None),
                          std=1.0 / math.sqrt(dr)),
        "w_x": dense_init(ini, dr, dr, ("tp", None),
                          std=1.0 / math.sqrt(dr)),
        "lam": ini.full((dr,), (None,), 2.0, dtype=torch.float32),
        "out": dense_init(ini, dr, d, ("tp", "fsdp")),
    }


def _combine(e1, e2):
    """The recurrence h_t = a_t h_{t-1} + b_t as an associative operator on
    (a, b) pairs, ``e1`` the earlier."""
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along dim 1 (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, n:]], dim=1)


def associative_scan(a, b):
    """Inclusive scan of ``_combine`` over dim 1 of the pairs (a, b):
    returns (prod a, h) with h_t = a_t h_{t-1} + b_t, h_{-1} = 0.

    The recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan that half-length sequence (its results are the odd positions),
    then combine each with the next even element; the same operations on
    the same operands, so float32 results equal the JAX package's bit for
    bit where both round each product and sum alone."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                              (a[:, 1::2], b[:, 1::2])))
    m = odd_a.shape[1] - (n % 2 == 0)
    even_a, even_b = _combine((odd_a[:, :m], odd_b[:, :m]),
                              (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _rglru_core(params, u, h0: Optional[torch.Tensor]):
    """u [B, S, dr] -> (y [B, S, dr], h_last [B, dr] float32) via the
    associative scan, ``h0`` folded into the first element as
    ``gated_0 + a_0 h0`` (one token: the decode step's arithmetic)."""
    r = torch.sigmoid(dense_apply(params["w_a"], u).to(torch.float32))
    i = torch.sigmoid(dense_apply(params["w_x"], u).to(torch.float32))
    log_a = -_C * softplus(params["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * u.to(torch.float32)
    if h0 is not None:
        first = gated[:, :1] + a[:, :1] * h0.to(torch.float32)[:, None]
        gated = torch.cat([first, gated[:, 1:]], dim=1)
    with span("repro_torch.rglru.scan"):
        _, h = associative_scan(a, gated)
    return h.to(u.dtype), h[:, -1, :]


def rglru_apply(params, cfg: RGLRUConfig, x, *, conv_state=None,
                rnn_state=None):
    """Griffin recurrent block: gate branch * (conv -> RG-LRU) branch.

    x [B, S, d_model] -> (y, (conv_state, rnn_state))."""
    gate = gelu_tanh(dense_apply(params["in_gate"], x))
    u = dense_apply(params["in_x"], x)
    u, conv_state = short_conv_apply(params["conv"], u, state=conv_state)
    y, rnn_state = _rglru_core(params, u, rnn_state)
    return dense_apply(params["out"], y * gate), (conv_state, rnn_state)
