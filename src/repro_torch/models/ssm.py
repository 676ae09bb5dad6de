"""Mamba2 (SSD) block and the shared short depthwise causal conv of the
Mamba2 and RG-LRU blocks — torch port of the decode half of
``repro.models.ssm``.

The short conv is the model-level site of the paper's BSEG datapath:
``serve_params(compute="sdv")`` replaces its container with a
``BSEGConv``, which runs on kernel B4; the float container is the plain
float conv.  ``ssm_apply`` is ported for decode (``decode=True``, the
single-step recurrence); the chunked SSD scan that training and the
full-sequence ``forward`` take is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .layers import (Init, dense_apply, dense_init, rmsnorm_apply,
                     rmsnorm_init, silu)
from .quantized import BSEGConv, bseg_conv_apply


def short_conv_init(ini: Init, channels: int, taps: int):
    return {"w": ini.normal((channels, taps), std=1.0 / math.sqrt(taps)),
            "b": ini.zeros((channels,))}


def short_conv_apply(params, x, *, state: Optional[torch.Tensor] = None):
    """x [B, S, C].  ``state`` [B, taps-1, C] carries decode history.
    Returns (y [B, S, C], new_state).

    A ``BSEGConv`` container runs on the packed BSEG datapath (kernel
    B4); a float {'w': [C, taps], 'b': [C]} dict runs the float conv in
    the activation dtype.
    """
    if isinstance(params, BSEGConv):
        return bseg_conv_apply(params, x, state=state)
    taps = params["w"].shape[-1]
    if state is None:
        state = torch.zeros((x.shape[0], taps - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for q in range(taps):
        y = y + params["w"][:, q].to(x.dtype) * xp[:, q:q + x.shape[1], :]
    y = y + params["b"].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (taps - 1):, :]
    return y, new_state


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int            # = expand * d_model
    n_heads: int            # H ; head_dim P = d_inner // H
    d_state: int            # N
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 256

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def ssm_init(ini: Init, cfg: SSMConfig):
    """Input projections split per component (z / x / BC / dt), as in
    the JAX package; ``a_log``, ``d_skip`` and ``dt_bias`` are float32."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
    gn = cfg.n_groups * cfg.d_state
    return {
        "in_z": dense_init(ini, d, di),
        "in_x": dense_init(ini, d, di),
        "in_bc": dense_init(ini, d, 2 * gn),
        "in_dt": dense_init(ini, d, h),
        "conv": short_conv_init(ini, di + 2 * gn, cfg.d_conv),
        "a_log": ini.zeros((h,), dtype=torch.float32),
        "d_skip": ini.ones((h,), dtype=torch.float32),
        "dt_bias": ini.zeros((h,), dtype=torch.float32),
        "norm": rmsnorm_init(ini, di),
        "out_proj": dense_init(ini, di, d),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus (``logaddexp(x, 0)``, with no linear cut-off, which
    torch's ``softplus`` has above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_apply(params, cfg: SSMConfig, x, *, conv_state=None,
              ssm_state=None, decode: bool = False):
    """Mamba2 block. x [B, S, d_model] -> (y, (conv_state, ssm_state)).

    Only ``decode=True`` (S = 1, the single-step recurrence
    h' = exp(dt a) h + dt B x^T) is ported; the chunked SSD scan of the
    full-sequence path raises."""
    if not decode:
        raise NotImplementedError(
            "the chunked SSD scan (decode=False: training and the "
            "full-sequence forward) is not ported yet; it comes with the "
            "ssm/hybrid forward slice")
    bsz, s, _ = x.shape
    di, h, p = cfg.d_inner, cfg.n_heads, cfg.head_dim
    gn = cfg.n_groups * cfg.d_state
    z = dense_apply(params["in_z"], x)
    xin = dense_apply(params["in_x"], x)
    bc = dense_apply(params["in_bc"], x)
    dt = dense_apply(params["in_dt"], x)
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_state = short_conv_apply(params["conv"], conv_in,
                                            state=conv_state)
    conv_out = silu(conv_out)
    xs, bs, cs = torch.split(conv_out, [di, gn, gn], dim=-1)
    xh = xs.reshape(bsz, s, h, p)
    bh = bs.reshape(bsz, s, cfg.n_groups, cfg.d_state)
    ch = cs.reshape(bsz, s, cfg.n_groups, cfg.d_state)
    dtp = softplus(dt.to(torch.float32) + params["dt_bias"][None, None, :])
    a = -torch.exp(params["a_log"])                          # [H] negative

    rep = h // cfg.n_groups
    dt1 = dtp[:, 0]                                          # [B,H]
    dec = torch.exp(dt1 * a[None, :])                        # [B,H]
    bh1 = torch.repeat_interleave(bh[:, 0], rep, dim=1)      # [B,H,N]
    ch1 = torch.repeat_interleave(ch[:, 0], rep, dim=1)
    xdt = xh[:, 0].to(torch.float32) * dt1[..., None]        # [B,H,P]
    if ssm_state is None:
        ssm_state = torch.zeros((bsz, h, cfg.d_state, p),
                                dtype=torch.float32, device=x.device)
    ssm_state = dec[..., None, None] * ssm_state \
        + torch.einsum("bhn,bhp->bhnp", bh1.to(torch.float32), xdt)
    y = torch.einsum("bhn,bhnp->bhp", ch1.to(torch.float32), ssm_state)
    y = y[:, None]                                           # [B,1,H,P]
    y = y + params["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm_apply(params["norm"], y * silu(z))
    return dense_apply(params["out_proj"], y), (conv_state, ssm_state)
