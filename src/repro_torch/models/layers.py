"""Layer library of the dense decoder — torch port of the dense parts of
``repro.models.layers``: RMSNorm, projections, rotary embedding, decode
and chunked-prefill attention against an int8 KV cache, gated MLP.

Layouts and dtypes follow the JAX package: activations [B, S, d] in the
model dtype, int8 KV caches [B, S_max, KV, hd] with per-(position, head)
f32 scales, f32 softmax.  The caches are updated in place (the JAX
package returns new arrays).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .quantized import is_sdv, materialize, sdv_matmul_apply


def mat(w, dtype):
    """Materialize a kernel: SDVLinear -> dense, else cast."""
    return materialize(w, dtype) if is_sdv(w) else w.to(dtype)


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
    scale = torch.clamp_min(amax, 1e-8) / 127.0
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
    s = torch.einsum(scores_eq, q.to(torch.float32), kc_f) / math.sqrt(hd)
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


def mlp_apply(params, x, *, act: str = "swiglu"):
    gate = dense_apply(params["wi_gate"], x)
    up = dense_apply(params["wi_up"], x)
    if act == "swiglu":
        # jax.nn.silu's bf16 arithmetic: x * 1/(1 + exp(-x)), each step
        # rounded to the activation dtype
        a = gate * (1 / (1 + torch.exp(-gate)))
    elif act == "geglu":
        a = torch.nn.functional.gelu(gate, approximate="tanh")
    else:
        raise ValueError(act)
    return dense_apply(params["wo"], a * up)
