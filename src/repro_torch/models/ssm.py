"""Mamba2 (SSD) block and the shared short depthwise causal conv of the
Mamba2 and RG-LRU blocks — torch port of ``repro.models.ssm``.

The short conv is the model-level site of the paper's BSEG datapath:
``serve_params(compute="sdv")`` replaces its container with a
``BSEGConv``, which runs on kernel B4; the float container is the plain
float conv.  ``ssm_apply`` runs decode (``decode=True``, the single-step
recurrence) and the full sequence of training and ``forward``
(``_ssd_chunked``, the chunked SSD scan of arXiv:2405.21060: a quadratic
intra-chunk term and a linear inter-chunk state recurrence, one chunk at
a time, in float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..tracing import spanned
from . import shard_ctx
from .layers import (Init, dense_apply, dense_init, rmsnorm_apply,
                     rmsnorm_init, silu)
from .quantized import BSEGConv, bseg_conv_apply


def short_conv_init(ini: Init, channels: int, taps: int):
    return {"w": ini.normal((channels, taps), ("tp", None),
                            std=1.0 / math.sqrt(taps)),
            "b": ini.zeros((channels,), ("tp",))}


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
    # on a mesh the new samples join the state on its shards (a partial
    # sum is reduced first, not the state with it)
    x = shard_ctx.follow(x, state, {0: 0, 2: 2})
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
        "in_z": dense_init(ini, d, di, ("fsdp", "tp")),
        "in_x": dense_init(ini, d, di, ("fsdp", "tp")),
        "in_bc": dense_init(ini, d, 2 * gn, ("fsdp", "tp")),
        "in_dt": dense_init(ini, d, h, ("fsdp", None)),
        "conv": short_conv_init(ini, di + 2 * gn, cfg.d_conv),
        "a_log": ini.zeros((h,), (None,), dtype=torch.float32),
        "d_skip": ini.ones((h,), (None,), dtype=torch.float32),
        "dt_bias": ini.zeros((h,), (None,), dtype=torch.float32),
        "norm": rmsnorm_init(ini, di),
        "out_proj": dense_init(ini, di, d, ("tp", "fsdp")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus (``logaddexp(x, 0)``, with no linear cut-off, which
    torch's ``softplus`` has above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@spanned("repro_torch.ssm.scan")
def _ssd_chunked(x, dt, a, b_in, c_in, cfg: SSMConfig,
                 h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x [B, S, H, P]; dt [B, S, H] (already softplus'ed, positive);
    a [H] (negative); b_in/c_in [B, S, G, N].
    Returns (y [B, S, H, P] float32, h_final [B, H, N, P] float32).

    The JAX package's ``lax.scan`` over the ``S / q`` chunks is a loop
    here, with its float32 arithmetic: the quadratic intra-chunk term
    only ever exists for one chunk, so memory is O(q^2 H) at any S.  The
    causal segment matrix masks before its ``exp`` (the reference masks
    after): the same values, and a gradient that stays finite where an
    upper-triangle segment sum overflows float32 (its masked ``exp``
    gives inf there, and 0 x inf in the backward).
    """
    bsz, s, h, p = x.shape
    g, n = b_in.shape[2], b_in.shape[3]
    q = min(cfg.chunk, s)
    assert s % q == 0, (s, q)
    rep = h // g
    f32 = torch.float32
    causal = torch.ones((q, q), dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=x.device)
    hprev = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device) \
        if h0 is None else h0.to(f32)
    ys = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        dtc = dt[:, sl].to(f32)                                # [B,q,H]
        cum = torch.cumsum(dtc * a[None, None, :], dim=1)
        seg = cum[:, -1, :]                                    # [B,H]
        li = cum[:, :, None, :] - cum[:, None, :, :]           # [B,q,q,H]
        l_mat = torch.exp(torch.where(causal, li, neg_inf))
        bc = b_in[:, sl].to(f32)
        cc = c_in[:, sl].to(f32)
        scores = torch.einsum("bqgn,bkgn->bqkg", cc, bc)       # [B,q,q,G]
        scores = torch.repeat_interleave(scores, rep, dim=-1)  # [B,q,q,H]
        xdt = x[:, sl].to(f32) * dtc[..., None]                # [B,q,H,P]
        y_intra = torch.einsum("bqkh,bkhp->bqhp", scores * l_mat, xdt)
        ch = torch.repeat_interleave(cc, rep, dim=2)
        y_inter = torch.einsum("bqhn,bhnp->bqhp",
                               ch * torch.exp(cum)[..., None], hprev)
        decay_state = torch.exp(seg[:, None, :] - cum)         # [B,q,H]
        bh = torch.repeat_interleave(bc, rep, dim=2)
        s_c = torch.einsum("bqhn,bqhp->bhnp",
                           bh * decay_state[..., None], xdt)
        hprev = torch.exp(seg)[..., None, None] * hprev + s_c
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), hprev


def ssm_apply(params, cfg: SSMConfig, x, *, conv_state=None,
              ssm_state=None, decode: bool = False):
    """Mamba2 block. x [B, S, d_model] -> (y, (conv_state, ssm_state)).

    ``decode=True`` (S = 1) runs the single-step recurrence
    h' = exp(dt a) h + dt B x^T; otherwise the chunked SSD scan
    (``_ssd_chunked``) runs over the sequence from ``ssm_state``."""
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

    if decode:
        rep = h // cfg.n_groups
        dt1 = dtp[:, 0]                                      # [B,H]
        dec = torch.exp(dt1 * a[None, :])                    # [B,H]
        bh1 = torch.repeat_interleave(bh[:, 0], rep, dim=1)  # [B,H,N]
        ch1 = torch.repeat_interleave(ch[:, 0], rep, dim=1)
        xdt = xh[:, 0].to(torch.float32) * dt1[..., None]    # [B,H,P]
        if ssm_state is None:
            ssm_state = torch.zeros((bsz, h, cfg.d_state, p),
                                    dtype=torch.float32, device=x.device)
        # on a mesh the update runs on the state's shards
        like = (ssm_state, "bhnp")
        dec = shard_ctx.follow(dec, ssm_state, {0: 0, 1: 1})
        ssm_state = dec[..., None, None] * ssm_state \
            + shard_ctx.einsum("bhn,bhp->bhnp", bh1.to(torch.float32), xdt,
                               like=like)
        y = shard_ctx.einsum("bhn,bhnp->bhp", ch1.to(torch.float32),
                             ssm_state, like=like)
        y = y[:, None]                                       # [B,1,H,P]
    else:
        y, ssm_state = _ssd_chunked(xh, dtp, a, bh, ch, cfg, h0=ssm_state)
    y = y + params["d_skip"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = rmsnorm_apply(params["norm"], y * silu(z))
    return dense_apply(params["out_proj"], y), (conv_state, ssm_state)
