"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427) —
torch port of ``repro.models.rglru``.

    r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
    log a_t = -c * softplus(Lambda) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX package runs the recurrence as an associative scan over the
sequence (training and prefill); decode passes one token, so the port's
``_rglru_core`` is a plain loop over S.  The short conv runs on kernel
B4 once ``serve_params`` has packed it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

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
        "in_x": dense_init(ini, d, dr),
        "in_gate": dense_init(ini, d, dr),
        "conv": short_conv_init(ini, dr, cfg.d_conv),
        "w_a": dense_init(ini, dr, dr, std=1.0 / math.sqrt(dr)),
        "w_x": dense_init(ini, dr, dr, std=1.0 / math.sqrt(dr)),
        "lam": ini.full((dr,), 2.0, dtype=torch.float32),
        "out": dense_init(ini, dr, d),
    }


def _rglru_core(params, u, h0: Optional[torch.Tensor]):
    """u [B, S, dr] -> (y [B, S, dr], h_last [B, dr] float32), one step
    of the recurrence per sample."""
    r = torch.sigmoid(dense_apply(params["w_a"], u).to(torch.float32))
    i = torch.sigmoid(dense_apply(params["w_x"], u).to(torch.float32))
    log_a = -_C * softplus(params["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * u.to(torch.float32)
    h = torch.zeros_like(gated[:, 0]) if h0 is None \
        else h0.to(torch.float32)
    ys = []
    for t in range(u.shape[1]):
        h = a[:, t] * h + gated[:, t]
        ys.append(h)
    y = torch.stack(ys, dim=1)
    return y.to(u.dtype), h


def rglru_apply(params, cfg: RGLRUConfig, x, *, conv_state=None,
                rnn_state=None):
    """Griffin recurrent block: gate branch * (conv -> RG-LRU) branch.

    x [B, S, d_model] -> (y, (conv_state, rnn_state))."""
    gate = gelu_tanh(dense_apply(params["in_gate"], x))
    u = dense_apply(params["in_x"], x)
    u, conv_state = short_conv_apply(params["conv"], u, state=conv_state)
    y, rnn_state = _rglru_core(params, u, rnn_state)
    return dense_apply(params["out"], y * gate), (conv_state, rnn_state)
