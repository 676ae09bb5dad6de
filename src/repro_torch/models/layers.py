"""Layer library of the decoders — torch port of the dense parts of
``repro.models.layers``: RMSNorm, projections, rotary embedding, decode
and chunked-prefill attention against an int8 KV cache, gated MLP; and
the sliding-window decode attention of the hybrid (Griffin) family
against a bf16 ring buffer (the JAX package's
``transformer._decode_attn_ring``).

Layouts and dtypes follow the JAX package: activations [B, S, d] in the
model dtype, int8 KV caches [B, S_max, KV, hd] with per-(position, head)
f32 scales, f32 softmax.  The caches are updated in place (the JAX
package returns new arrays).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..device import constant
from ..quant import quantizer
from .quantized import is_packed, is_sdv, materialize, sdv_matmul_apply


class Init:
    """Seeded parameter init, the JAX package's ``param.Init`` and
    ``StackedInit`` in one: normal draws come from ``gen`` (a
    ``torch.Generator`` on ``device``) in float32 and are cast to the
    model ``dtype``; a stacked init prepends its layer axis ``lead`` to
    every shape.  The numbers are not JAX's (``convert`` carries those
    over).  With ``gen=None`` (the ``meta`` device) nothing is drawn:
    ``normal`` gives an empty tensor of the shape and dtype."""

    def __init__(self, gen: Optional[torch.Generator], device: torch.device,
                 dtype: torch.dtype, lead=()):
        self.gen, self.device, self.dtype, self.lead = gen, device, dtype, \
            tuple(lead)

    def stacked(self, n: int) -> "Init":
        return Init(self.gen, self.device, self.dtype, (n,))

    def normal(self, shape, *, std: float, dtype=None):
        if self.gen is None:
            return torch.empty(self.lead + tuple(shape),
                               dtype=dtype or self.dtype, device=self.device)
        v = torch.randn(self.lead + tuple(shape), generator=self.gen,
                        dtype=torch.float32, device=self.device)
        return (v * std).to(dtype or self.dtype)

    def full(self, shape, value: float, dtype=None):
        return torch.full(self.lead + tuple(shape), value,
                          dtype=dtype or self.dtype, device=self.device)

    def zeros(self, shape, dtype=None):
        return self.full(shape, 0.0, dtype)

    def ones(self, shape, dtype=None):
        return self.full(shape, 1.0, dtype)


def dense_init(ini: Init, d_in: int, d_out: int, *, bias: bool = False,
               std: Optional[float] = None):
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"kernel": ini.normal((d_in, d_out), std=std)}
    if bias:
        p["bias"] = ini.zeros((d_out,))
    return p


def rmsnorm_init(ini: Init, dim: int):
    return {"scale": ini.ones((dim,), dtype=torch.float32)}


def attention_init(ini: Init, cfg: "AttnConfig", d_model: int,
                   qkv_bias: bool = False):
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    return {
        "wq": dense_init(ini, d_model, h * hd, bias=qkv_bias),
        "wk": dense_init(ini, d_model, kv * hd, bias=qkv_bias),
        "wv": dense_init(ini, d_model, kv * hd, bias=qkv_bias),
        "wo": dense_init(ini, h * hd, d_model),
    }


def mlp_init(ini: Init, d_model: int, d_ff: int):
    return {
        "wi_gate": dense_init(ini, d_model, d_ff),
        "wi_up": dense_init(ini, d_model, d_ff),
        "wo": dense_init(ini, d_ff, d_model),
    }


def mat(w, dtype):
    """Materialize a kernel: PackedLinear / SDVLinear -> dense, else
    cast."""
    return materialize(w, dtype) if is_packed(w) else w.to(dtype)


def silu(x):
    """jax.nn.silu's arithmetic in the activation dtype: x * 1/(1 +
    exp(-x)), each step rounded to that dtype."""
    return x * (1 / (1 + torch.exp(-x)))


def scalar_like(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of ``like``'s dtype on its device
    (``device.constant``, made once and reused): JAX rounds a Python
    scalar to the array's dtype before the op (weak typing); torch would
    compute with the unrounded value."""
    return constant(value, like.dtype, like.device)


def gelu_tanh(x):
    """jax.nn.gelu(approximate=True) op by op in the activation dtype,
    its constants rounded to that dtype:
    x * 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3)))."""
    c = scalar_like(math.sqrt(2 / math.pi), x)
    inner = c * (x + scalar_like(0.044715, x) * (x * x * x))
    half, one = scalar_like(0.5, x), scalar_like(1.0, x)
    return x * (half * (one + torch.tanh(inner)))


def rmsnorm_apply(params, x, *, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"].to(x.dtype)


def dense_apply(params, x):
    w = params["kernel"]
    if is_sdv(w):
        # arithmetic packing: the GEMM runs on the SDV datapath through
        # the packed_matmul dispatch (never materialized)
        y = sdv_matmul_apply(w, x)
    else:
        y = x @ mat(w, x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(x.dtype)
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10000.0):
    """x [B, S, H, D]; positions [B, S] (int32)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta)
                     * torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq         # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0


def _quantize_kv(t):
    """[B, S, G, hd] -> (int8 values, [B, S, G] f32 scale)."""
    tf = t.to(torch.float32)
    amax = tf.abs().amax(dim=-1)
    scale = quantizer.div(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.round(tf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def decode_writes(cache_index, write_mask, s_max: int):
    """The (row, position) pairs one decode step writes: every row whose
    ``write_mask`` is set (all rows when None) and whose position
    ``cache_index[row]`` is inside the cache.  The JAX package scatters
    the other rows out of bounds with ``mode="drop"``; torch has no drop
    mode (and an out-of-bounds index on CUDA is a device assert), so the
    kept rows are selected first."""
    keep = cache_index < s_max
    if write_mask is not None:
        keep = keep & write_mask
    rows = keep.nonzero().squeeze(1)
    return rows, cache_index[rows].long()


def prefill_writes(cache_index, n_valid, c: int, s_max: int):
    """The (row, column, position) triples a prefill chunk writes: the
    first ``n_valid[row]`` of the C columns of each row, where inside
    the cache."""
    cols = torch.arange(c, dtype=torch.int32, device=cache_index.device)
    pos = cache_index[:, None] + cols[None, :]                   # [B, C]
    keep = (cols[None, :] < n_valid[:, None]) & (pos < s_max)
    rows, cidx = keep.nonzero(as_tuple=True)
    return rows, cidx, pos[rows, cidx].long()


def _qkv(params, cfg: AttnConfig, x, pos):
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = dense_apply(params["wq"], x).reshape(b, s, h, hd)
    k = dense_apply(params["wk"], x).reshape(b, s, g, hd)
    v = dense_apply(params["wv"], x).reshape(b, s, g, hd)
    return (rope(q, pos, theta=cfg.rope_theta),
            rope(k, pos, theta=cfg.rope_theta), v)


def _write_kv(cache, k, v, rows, src, dest):
    """Quantize k/v [B, S, G, hd] and write the selected entries: cache
    position ``dest[j]`` of row ``rows[j]`` takes entry ``src[j]``."""
    kq, ks = _quantize_kv(k)
    vq, vs = _quantize_kv(v)
    cache_k, cache_v, k_scale, v_scale = cache
    cache_k[rows, dest] = kq[rows, src]
    cache_v[rows, dest] = vq[rows, src]
    k_scale[rows, dest] = ks[rows, src]
    v_scale[rows, dest] = vs[rows, src]
    return (cache_k.to(torch.float32) * k_scale[..., None],
            cache_v.to(torch.float32) * v_scale[..., None])


def _attend(q, kc_f, vc_f, valid, scores_eq: str, out_eq: str, hd: int):
    s = quantizer.div(torch.einsum(scores_eq, q.to(torch.float32), kc_f),
                      math.sqrt(hd))
    s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum(out_eq, p, vc_f)


def decode_attention(params, cfg: AttnConfig, x, *, cache, cache_index,
                     writes):
    """Single-token decode against an int8 KV cache.

    x [B, 1, d]; ``cache`` = (k, v, k_scale, v_scale) of one layer,
    [B, S_max, KV, hd] / [B, S_max, KV]; cache_index [B] int32: each
    slot's count of valid entries (the new token goes to that slot's
    position); ``writes`` = ``decode_writes(...)``: the rows that write.
    Returns y [B, 1, d]; the cache is updated in place.
    """
    b = x.shape[0]
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    r = h // g
    s_max = cache[0].shape[1]
    q, k, v = _qkv(params, cfg, x, cache_index[:, None])
    rows, dest = writes
    kc_f, vc_f = _write_kv(cache, k, v, rows, torch.zeros_like(rows), dest)
    kpos = torch.arange(s_max, device=x.device)
    valid = kpos[None, :] <= cache_index[:, None]
    out = _attend(q.reshape(b, g, r, hd), kc_f, vc_f,
                  valid[:, None, None, :], "bgrd,bkgd->bgrk",
                  "bgrk,bkgd->bgrd", hd)
    return dense_apply(params["wo"], out.reshape(b, 1, h * hd).to(x.dtype))


def prefill_attention(params, cfg: AttnConfig, x, *, cache, cache_index,
                      writes):
    """Teacher-forced chunked prefill against an int8 KV cache.

    x [B, C, d]; ``cache`` as in ``decode_attention``; cache_index [B]
    int32 (each slot's filled length); ``writes`` = ``prefill_writes(...)``:
    the first ``n_valid`` columns of each row.  Returns y [B, C, d]; the
    cache is updated in place.
    """
    b, c, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    r = h // g
    s_max = cache[0].shape[1]
    pos = cache_index[:, None] + torch.arange(c, dtype=torch.int32,
                                              device=x.device)[None, :]
    q, k, v = _qkv(params, cfg, x, pos)
    rows, cols, dest = writes
    kc_f, vc_f = _write_kv(cache, k, v, rows, cols, dest)
    kpos = torch.arange(s_max, device=x.device)
    valid = kpos[None, None, :] <= pos[:, :, None]                # [B, C, S]
    out = _attend(q.reshape(b, c, g, r, hd), kc_f, vc_f,
                  valid[:, None, None, :, :], "bcgrd,bsgd->bgrcs",
                  "bgrcs,bsgd->bcgrd", hd)
    return dense_apply(params["wo"], out.reshape(b, c, h * hd).to(x.dtype))


def decode_attention_ring(params, cfg: AttnConfig, x, *, k_cache, v_cache,
                          cache_index, window: int):
    """Sliding-window single-token decode against a bf16 ring buffer of
    ``window`` entries (the hybrid family's local attention).

    x [B, 1, d]; k_cache/v_cache [B, window, KV, hd] of one layer;
    cache_index [B] int32: each slot's position, which is also its ring
    write head (``index mod window``) and fixes the entry ages.  Returns
    y [B, 1, d]; the ring is updated in place.
    """
    b = x.shape[0]
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    slot = torch.remainder(cache_index, window)                   # [B]
    q, k, v = _qkv(params, cfg, x, cache_index[:, None])
    rows = torch.arange(b, device=x.device)
    k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
    # entry ages: slot s holds position index - ((slot - s) mod window)
    offs = torch.remainder(
        slot[:, None] - torch.arange(window, device=x.device)[None, :],
        window)
    entry_pos = cache_index[:, None] - offs                        # [B, W]
    valid = (entry_pos >= 0) & (entry_pos >= cache_index[:, None]
                                - window + 1)
    out = _attend(q.reshape(b, g, h // g, hd), k_cache.to(torch.float32),
                  v_cache.to(torch.float32), valid[:, None, None, :],
                  "bgrd,bkgd->bgrk", "bgrk,bkgd->bgrd", hd)
    return dense_apply(params["wo"], out.reshape(b, 1, h * hd).to(x.dtype))


def mlp_apply(params, x, *, act: str = "swiglu"):
    gate = dense_apply(params["wi_gate"], x)
    up = dense_apply(params["wi_up"], x)
    if act == "swiglu":
        a = silu(gate)
    elif act == "geglu":
        a = gelu_tanh(gate)
    else:
        raise ValueError(act)
    return dense_apply(params["wo"], a * up)
