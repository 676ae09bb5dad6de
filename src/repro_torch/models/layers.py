"""Layer library of the decoders — torch port of the dense and MoE parts
of ``repro.models.layers``: RMSNorm, projections, rotary embedding,
decode and chunked-prefill attention against an int8 KV cache (and
decode against the bf16 self-attention cache of the encoder-decoder
family), gated MLP, the mixture-of-experts FFN (token-choice top-k
routing with the reference's capacity drop); the
sliding-window decode attention of the hybrid (Griffin) family against
a bf16 ring buffer (the JAX package's ``transformer._decode_attn_ring``);
the encoder-decoder's decode-time cross attention against its cross
cache; and the full-sequence self- and cross-attention of
``transformer.forward`` (``attention_apply``: the chunked online softmax
of the JAX package's ``_stream_attend`` / ``_stream_attend_diff``,
differentiable by autograd).

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
from ..tracing import record_route, span, spanned
from . import shard_ctx
from .param import P, Rules
from .quantized import is_packed, is_sdv, materialize, sdv_matmul_apply


class Init:
    """Seeded parameter init, the JAX package's ``param.Init`` and
    ``StackedInit`` in one: normal draws come from ``gen`` (a
    ``torch.Generator`` on ``device``) in float32 and are cast to the
    model ``dtype``; a stacked init prepends its layer axis ``lead`` to
    every shape.  The numbers are not JAX's (``convert`` carries those
    over).  With ``gen=None`` (the ``meta`` device) nothing is drawn:
    ``normal`` gives an empty tensor of the shape and dtype.

    Every call names the logical axes of its parameter, as the JAX
    package's does (the stacked layer axis is never sharded).  With
    ``rules`` (``param.Rules``) each call returns ``param.P(value,
    spec)``, the spec resolved from those axes; without, the bare value.
    The axes never change a draw."""

    def __init__(self, gen: Optional[torch.Generator], device: torch.device,
                 dtype: torch.dtype, lead=(), rules: Optional[Rules] = None):
        self.gen, self.device, self.dtype, self.lead = gen, device, dtype, \
            tuple(lead)
        self.rules = rules

    def stacked(self, n: int) -> "Init":
        return Init(self.gen, self.device, self.dtype, (n,), self.rules)

    def _leaf(self, value: torch.Tensor, axes):
        if self.rules is None:
            return value
        return P(value, self.rules.resolve((None,) * len(self.lead)
                                           + tuple(axes)))

    def normal(self, shape, axes, *, std: float, dtype=None):
        if self.gen is None:
            return self._leaf(torch.empty(self.lead + tuple(shape),
                                          dtype=dtype or self.dtype,
                                          device=self.device), axes)
        v = torch.randn(self.lead + tuple(shape), generator=self.gen,
                        dtype=torch.float32, device=self.device)
        return self._leaf((v * std).to(dtype or self.dtype), axes)

    def full(self, shape, axes, value: float, *, dtype=None):
        return self._leaf(torch.full(self.lead + tuple(shape), value,
                                     dtype=dtype or self.dtype,
                                     device=self.device), axes)

    def zeros(self, shape, axes, *, dtype=None):
        return self.full(shape, axes, 0.0, dtype=dtype)

    def ones(self, shape, axes, *, dtype=None):
        return self.full(shape, axes, 1.0, dtype=dtype)


def dense_init(ini: Init, d_in: int, d_out: int, axes, *,
               bias: bool = False, std: Optional[float] = None):
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"kernel": ini.normal((d_in, d_out), axes, std=std)}
    if bias:
        p["bias"] = ini.zeros((d_out,), (axes[1],))
    return p


def rmsnorm_init(ini: Init, dim: int):
    return {"scale": ini.ones((dim,), (None,), dtype=torch.float32)}


def attention_init(ini: Init, cfg: "AttnConfig", d_model: int,
                   qkv_bias: bool = False):
    h, kv, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    return {
        "wq": dense_init(ini, d_model, h * hd, ("fsdp", "tp"),
                         bias=qkv_bias),
        "wk": dense_init(ini, d_model, kv * hd, ("fsdp", "tp"),
                         bias=qkv_bias),
        "wv": dense_init(ini, d_model, kv * hd, ("fsdp", "tp"),
                         bias=qkv_bias),
        "wo": dense_init(ini, h * hd, d_model, ("tp", "fsdp")),
    }


def mlp_init(ini: Init, d_model: int, d_ff: int):
    return {
        "wi_gate": dense_init(ini, d_model, d_ff, ("fsdp", "tp")),
        "wi_up": dense_init(ini, d_model, d_ff, ("fsdp", "tp")),
        "wo": dense_init(ini, d_ff, d_model, ("tp", "fsdp")),
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
    elif hasattr(w, "qat_apply"):
        # QAT container (train/qat/ste.QATLinear): STE fake-quant
        # forward, optionally through the packed dispatch — duck-typed
        # so the model library never imports the training stack
        y = w.qat_apply(x)
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
    freq = shard_ctx.replicated_like(freq, positions)
    ang = positions[..., None].to(torch.float32) * freq         # [B,S,half]
    cos = shard_ctx.replicated_like(torch.cos(ang)[:, :, None, :], x)
    sin = shard_ctx.replicated_like(torch.sin(ang)[:, :, None, :], x)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """``window``: the sliding window of ``attention_apply`` (None: the
    whole causal past; the decode and prefill attentions take none, as
    the JAX package's decode configs set none).  Self attention always
    rotates queries and keys; cross attention never calls ``_qkv``, so
    it takes no RoPE."""
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    window: Optional[int] = None
    free_qkv_sharding: bool = False  # skip explicit q/k/v constraints


def _stream_step(qf, kch, vch, carry, *, qpos, kpos, sk: int,
                 causal: bool, window: Optional[int], scalef: float,
                 p_dtype):
    """One KV chunk of the streaming softmax: scores, mask, running max,
    rescaled sum and accumulator (``_stream_attend``'s ``inner``).  The
    products accumulate in float32; ``p_dtype`` is the dtype the
    probabilities are rounded to before the value product."""
    m, l, acc = carry
    s = torch.einsum("bqgrd,bkgd->bqgrk", qf, kch) * scalef
    mask = (kpos < sk)[None, None, None, None, :]
    if causal:
        mask = mask & (kpos[None, None, None, None, :]
                       <= qpos[None, :, None, None, None])
    if window is not None:
        mask = mask & (kpos[None, None, None, None, :]
                       > qpos[None, :, None, None, None] - window)
    s = torch.where(mask, s, -1e30)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bqgrk,bkgd->bqgrd", p.to(p_dtype).to(torch.float32),
                      vch)
    return m_new, l_new, acc * corr[..., None] + pv


def _stream_attend_impl(q, k, v, *, q_start: int, causal: bool,
                        window: Optional[int], chunk: int, p_dtype):
    """The chunked online softmax of both streaming variants: q [B, Sq,
    KV, R, D] at positions q_start.., k/v [B, Sk, KV, D] at 0..; each
    query chunk walks only the KV chunks it can see (causal upper bound,
    sliding-window lower bound).  Returns [B, Sq, KV, R, D] in q's
    dtype."""
    b, sq, kvh, r, d = q.shape
    sk = k.shape[1]
    scalef = 1.0 / math.sqrt(d)
    nkv = -(-sk // chunk)
    nq = -(-sq // chunk)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nkv * chunk - sk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nkv * chunk - sk))
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, nq * chunk - sq))
    ar = torch.arange(chunk, device=q.device)
    outs = []
    for qi in range(nq):
        qf = qp[:, qi * chunk:(qi + 1) * chunk].to(torch.float32)
        qpos = q_start + qi * chunk + ar
        hi = min(nkv, -(-(q_start + (qi + 1) * chunk) // chunk)) \
            if causal else nkv
        lo = max(0, (q_start + qi * chunk - window) // chunk) \
            if window is not None else 0
        carry = (torch.full((b, chunk, kvh, r), -1e30, device=q.device),
                 torch.zeros((b, chunk, kvh, r), device=q.device),
                 torch.zeros((b, chunk, kvh, r, d), device=q.device))
        for ci in range(lo, max(hi, lo + 1)):
            sl = slice(ci * chunk, (ci + 1) * chunk)
            carry = _stream_step(
                qf, kp[:, sl].to(torch.float32), vp[:, sl].to(torch.float32),
                carry, qpos=qpos, kpos=ci * chunk + ar, sk=sk, causal=causal,
                window=window, scalef=scalef, p_dtype=p_dtype)
        _, l, acc = carry
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None])
                    .to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


def _stream_attend(q, k, v, *, q_start: int, causal: bool,
                   window: Optional[int], chunk: int):
    """Two-level streaming softmax attention with float32 operands (the
    JAX package's ``_stream_attend``: a scan over query chunks, a loop
    with dynamic bounds over the visible KV chunks; Python loops here).
    q [B, Sq, KV, R, D], k/v [B, Sk, KV, D]; returns [B, Sq, KV, R, D]."""
    return _stream_attend_impl(q, k, v, q_start=q_start, causal=causal,
                               window=window, chunk=chunk,
                               p_dtype=torch.float32)


def _stream_attend_diff(q, k, v, *, q_start: int, causal: bool,
                        window: Optional[int], chunk: int):
    """The differentiable variant (the JAX package's
    ``_stream_attend_diff``): the same walk, with the operands kept in
    q's dtype (bf16) and float32 accumulation — a bf16 product is exact
    in float32, so the operands are widened before each einsum, and the
    probabilities are rounded to q's dtype before the value product.
    torch's autograd differentiates the loops as they are."""
    return _stream_attend_impl(q, k, v, q_start=q_start, causal=causal,
                               window=window, chunk=chunk, p_dtype=q.dtype)


def attention_apply(params, cfg: AttnConfig, x, *, positions,
                    kv: Optional[tuple] = None, causal: bool = True,
                    chunk: int = 1024, differentiable: bool = True):
    """Full-sequence self- (``kv=None``) or cross-attention
    (``kv=(k_in, v_in)``, activations [B, Sk, d] that ``wk``/``wv``
    project, without RoPE), queries from position 0, within
    ``cfg.window``.  x [B, S, d]; positions [B, S]; returns ([B, S, d],
    (k, v)).  The chunk is taken from the query length, as in the JAX
    package."""
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    if kv is None:
        q, k, v = _qkv(params, cfg, x, positions)
    else:
        q = shard_ctx.split_heads(dense_apply(params["wq"], x), h, hd)
        k_in, v_in = kv
        k = shard_ctx.split_heads(dense_apply(params["wk"], k_in), g, hd)
        v = shard_ctx.split_heads(dense_apply(params["wv"], v_in), g, hd)
    tp = shard_ctx.tp_size()
    if not cfg.free_qkv_sharding and h % tp == 0:
        # head-parallel attention (heads divide the model axis); else
        # the placement is left to the sharding propagation
        q = shard_ctx.constrain(q, "batch", None, "tp", None)
        k = shard_ctx.constrain(k, "batch", None,
                                "tp" if g % tp == 0 else None, None)
        v = shard_ctx.constrain(v, "batch", None,
                                "tp" if g % tp == 0 else None, None)
    attend = _stream_attend_diff if differentiable else _stream_attend
    # on a mesh the chunk loop runs on each rank's batch rows
    out = shard_ctx.batch_local(
        lambda q4, k4, v4: attend(q4.reshape(q4.shape[0], s, g, h // g, hd),
                                  k4, v4, q_start=0, causal=causal,
                                  window=cfg.window,
                                  chunk=min(chunk, max(s, 16))),
        q, k, v)
    return dense_apply(params["wo"], out.reshape(b, s, h * hd)), (k, v)


def _quantize_kv(t):
    """[B, S, G, hd] -> (int8 values, [B, S, G] f32 scale)."""
    tf = t.to(torch.float32)
    amax = tf.abs().amax(dim=-1)
    scale = quantizer.div(torch.clamp_min(amax, 1e-8), 127.0)
    q = torch.round(tf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def decode_writes(cache_index, write_mask, s_max: int):
    """The cache positions one decode step writes, as ``(dest, keep)``
    [B, 1]: row b writes position ``cache_index[b]`` where it is inside
    the cache and ``write_mask[b]`` is set (every row when None).  The
    JAX package scatters the other rows out of bounds with
    ``mode="drop"``; here every row scatters (``_put``) and a row that
    drops writes back what its slot holds (``prefill_writes``)."""
    keep = cache_index < s_max
    if write_mask is not None:
        keep = keep & write_mask
    return torch.remainder(cache_index, s_max)[:, None].long(), \
        keep[:, None]


def prefill_writes(cache_index, n_valid, c: int, s_max: int):
    """The cache positions a prefill chunk of ``c`` columns writes, as
    ``(dest, keep)`` [B, min(c, s_max)]: column j of row b goes to
    position ``cache_index[b] + j`` where j < ``n_valid[b]`` and the
    position is inside the cache; columns at or past ``s_max`` never
    write.  ``dest`` is that position mod ``s_max``, so the columns of a
    row name distinct positions and a dropped column (``keep`` False)
    writes back the entry it lands on: a fixed-shape scatter with the
    reference's drop semantics (a clamp to ``s_max - 1`` would collide
    with the kept column there)."""
    cols = shard_ctx.replicated_like(
        torch.arange(min(c, s_max), dtype=torch.int32,
                     device=cache_index.device), cache_index)
    pos = cache_index[:, None] + cols[None, :]                   # [B, C]
    keep = (cols[None, :] < n_valid[:, None]) & (pos < s_max)
    return torch.remainder(pos, s_max).long(), keep


#: [B, S or C, heads, hd] tensors that lie as the KV cache does: batch,
#: heads and head dimension at the same places (``shard_ctx.follow``)
_SAME = {0: 0, 2: 2, 3: 3}


def _put(leaf, dest, keep, vals):
    """Write vals [B, C, ...] into leaf [B, S, ...] at positions dest
    [B, C] along dimension 1, in place, where ``keep`` [B, C] holds
    (every entry when None); the other entries take back the value
    they land on.  One gather and one scatter of fixed shape: no host
    sync.  A ``DTensor`` leaf (its positions never sharded) is written
    on each rank's local shard, ``vals`` and the rows of ``dest`` and
    ``keep`` put on its shards first: DTensor has no in-place scatter
    rule for a sharded leaf in every torch release."""
    if shard_ctx.is_dtensor(leaf):
        same = {d: d for d in range(leaf.ndim)}
        _put(leaf.to_local(),
             shard_ctx.follow(dest, leaf, {0: 0}).to_local(),
             None if keep is None else
             shard_ctx.follow(keep, leaf, {0: 0}).to_local(),
             shard_ctx.follow(vals, leaf, same).to_local())
        return
    shape = tuple(dest.shape) + (1,) * (leaf.ndim - 2)
    ix = dest.reshape(shape).expand(tuple(vals.shape))
    if keep is not None:
        vals = torch.where(keep.reshape(shape), vals,
                           torch.gather(leaf, 1, ix))
    leaf.scatter_(1, ix, vals)


@spanned("repro_torch.attn.qkv")
def _qkv(params, cfg: AttnConfig, x, pos):
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = shard_ctx.split_heads(dense_apply(params["wq"], x), h, hd)
    k = shard_ctx.split_heads(dense_apply(params["wk"], x), g, hd)
    v = shard_ctx.split_heads(dense_apply(params["wv"], x), g, hd)
    return (rope(q, pos, theta=cfg.rope_theta),
            rope(k, pos, theta=cfg.rope_theta), v)


@spanned("repro_torch.attn.kv")
def _write_kv(cache, k, v, writes):
    """Write k/v [B, C, G, hd] into the cache at ``writes`` = (dest,
    keep) [B, C] (``decode_writes``/``prefill_writes``; ``_put``).
    Returns the whole K and V as float32.

    A float cache (the encoder-decoder's bf16 self-attention cache) takes
    k/v cast to its dtype.  An int8 cache with scales takes them
    quantized per (position, head).  An int8 cache without scales
    (``k_scale is None``) takes them cast to int8 as XLA casts
    (truncated toward zero, saturating) and is read back unscaled, as the
    JAX package's attention does when it is called without
    ``cache_k_scale``: the moe family's ``moe_every > 1`` layers call it
    so, and the scales stay zero (ROADMAP Queue C, reference property
    (e))."""
    cache_k, cache_v, k_scale, v_scale = cache
    dest, keep = writes
    c = dest.shape[1]
    k = shard_ctx.follow(k[:, :c], cache_k, _SAME)
    v = shard_ctx.follow(v[:, :c], cache_k, _SAME)
    if cache_k.dtype != torch.int8:
        for leaf, t in ((cache_k, k), (cache_v, v)):
            _put(leaf, dest, keep, t.to(leaf.dtype))
        return cache_k.to(torch.float32), cache_v.to(torch.float32)
    if k_scale is None:
        for leaf, t in ((cache_k, k), (cache_v, v)):
            _put(leaf, dest, keep, torch.clamp(t.to(torch.float32), -128,
                                               127).to(torch.int8))
        return cache_k.to(torch.float32), cache_v.to(torch.float32)
    for leaf, sc, t in ((cache_k, k_scale, k), (cache_v, v_scale, v)):
        q, s = _quantize_kv(t)
        _put(leaf, dest, keep, q)
        _put(sc, dest, keep, s)
    return (cache_k.to(torch.float32) * k_scale[..., None],
            cache_v.to(torch.float32) * v_scale[..., None])


@spanned("repro_torch.attn.core")
def _attend(q, kc_f, vc_f, valid, scores_eq: str, out_eq: str, hd: int):
    """Softmax attention in float32; ``valid`` masks the scores (None:
    every key).  On a mesh both products run on the K/V's shards
    (``shard_ctx.einsum``): scores summed over a sharded head dimension
    are reduced before the mask, and the output leaves only its batch
    and head shards (a head-dimension shard cannot be flattened into
    the model width)."""
    kv = scores_eq.split("->")[0].split(",")[1]
    s = quantizer.div(shard_ctx.einsum(scores_eq, q.to(torch.float32),
                                       kc_f, like=(kc_f, kv)),
                      math.sqrt(hd))
    if valid is not None:
        s = torch.where(valid, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = shard_ctx.einsum(out_eq, p, vc_f, like=(vc_f, kv))
    o = out_eq.split("->")[1]
    return shard_ctx.follow(out, vc_f, {0: o.index("b"), 2: o.index("g")})


@spanned("repro_torch.attn")
def decode_attention(params, cfg: AttnConfig, x, *, cache, cache_index,
                     writes):
    """Single-token decode against a KV cache.

    x [B, 1, d]; ``cache`` = (k, v, k_scale, v_scale) of one layer,
    [B, S_max, KV, hd] / [B, S_max, KV]: int8 with scales, int8 without
    (None: written and read unscaled) or bf16 (scales None; written in
    its dtype, read as float32), ``_write_kv``; cache_index [B] int32: each
    slot's count of valid entries (the new token goes to that slot's
    position); ``writes`` = ``decode_writes(...)``: the rows that write.
    Returns y [B, 1, d]; the cache is updated in place.
    """
    b = x.shape[0]
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    r = h // g
    s_max = cache[0].shape[1]
    q, k, v = _qkv(params, cfg, x, cache_index[:, None])
    kc_f, vc_f = _write_kv(cache, k, v, writes)
    kpos = shard_ctx.replicated_like(torch.arange(s_max, device=x.device),
                                     cache_index)
    valid = kpos[None, :] <= cache_index[:, None]
    # on a mesh the products run on the cache's batch and head shards
    q4 = shard_ctx.follow(q, kc_f, _SAME).reshape(b, g, r, hd)
    out = _attend(q4, kc_f, vc_f, valid[:, None, None, :], "bgrd,bkgd->bgrk",
                  "bgrk,bkgd->bgrd", hd)
    with span("repro_torch.attn.out"):
        return dense_apply(params["wo"],
                           out.reshape(b, 1, h * hd).to(x.dtype))


@spanned("repro_torch.attn")
def cross_decode_attention(params, cfg: AttnConfig, x, *, cross_k,
                           cross_v):
    """The encoder-decoder's decode-time cross attention, as the JAX
    package's ``decode_step`` computes it: the query ``wq(x)`` against
    the cross cache's K/V [B, S, KV, hd] as they are (no ``wk``/``wv``,
    no RoPE, no position mask).  x [B, 1, d]; returns ``wo`` of the
    attended values, [B, 1, d]."""
    b = x.shape[0]
    h, g, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = dense_apply(params["wq"], x).reshape(b, g, h // g, hd)
    out = _attend(q, cross_k.to(torch.float32), cross_v.to(torch.float32),
                  None, "bgrd,bkgd->bgrk", "bgrk,bkgd->bgrd", hd)
    with span("repro_torch.attn.out"):
        return dense_apply(params["wo"],
                           out.reshape(b, 1, h * hd).to(x.dtype))


@spanned("repro_torch.attn")
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
    cols = shard_ctx.replicated_like(
        torch.arange(c, dtype=torch.int32, device=x.device), cache_index)
    pos = cache_index[:, None] + cols[None, :]
    q, k, v = _qkv(params, cfg, x, pos)
    kc_f, vc_f = _write_kv(cache, k, v, writes)
    kpos = shard_ctx.replicated_like(torch.arange(s_max, device=x.device),
                                     cache_index)
    valid = kpos[None, None, :] <= pos[:, :, None]                # [B, C, S]
    q5 = shard_ctx.follow(q, kc_f, _SAME).reshape(b, c, g, r, hd)
    out = _attend(q5, kc_f, vc_f, valid[:, None, None, :, :],
                  "bcgrd,bsgd->bgrcs",
                  "bgrcs,bsgd->bcgrd", hd)
    with span("repro_torch.attn.out"):
        return dense_apply(params["wo"],
                           out.reshape(b, c, h * hd).to(x.dtype))


@spanned("repro_torch.attn")
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
    dest = slot[:, None].long()
    for leaf, t in ((k_cache, k), (v_cache, v)):
        _put(leaf, dest, None, t.to(leaf.dtype))
    # entry ages: slot s holds position index - ((slot - s) mod window)
    ring = shard_ctx.replicated_like(torch.arange(window, device=x.device),
                                     cache_index)
    offs = torch.remainder(slot[:, None] - ring[None, :], window)
    entry_pos = cache_index[:, None] - offs                        # [B, W]
    valid = (entry_pos >= 0) & (entry_pos >= cache_index[:, None]
                                - window + 1)
    q4 = shard_ctx.follow(q, k_cache, _SAME).reshape(b, g, h // g, hd)
    out = _attend(q4, k_cache.to(torch.float32),
                  v_cache.to(torch.float32), valid[:, None, None, :],
                  "bgrd,bkgd->bgrk", "bgrk,bkgd->bgrd", hd)
    with span("repro_torch.attn.out"):
        return dense_apply(params["wo"],
                           out.reshape(b, 1, h * hd).to(x.dtype))


@spanned("repro_torch.mlp")
def mlp_apply(params, x, *, act: str = "swiglu"):
    gate = shard_ctx.constrain(dense_apply(params["wi_gate"], x),
                               "batch", None, "tp")
    up = shard_ctx.constrain(dense_apply(params["wi_up"], x),
                             "batch", None, "tp")
    if act == "swiglu":
        a = silu(gate)
    elif act == "geglu":
        a = gelu_tanh(gate)
    else:
        raise ValueError(act)
    return dense_apply(params["wo"], a * up)


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4-style always-on expert
    act: str = "swiglu"


def moe_init(ini: Init, cfg: MoEConfig):
    """The router ([d, E], std 0.01), the expert banks ``wi_gate`` /
    ``wi_up`` [E, d, f] and ``wo`` [E, f, d], and the shared expert's
    MLP where the config has one."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    p = {
        "router": dense_init(ini, d, e, (None, None), std=0.01),
        "wi_gate": ini.normal((e, d, f), ("ep", "fsdp", None),
                              std=1.0 / math.sqrt(d)),
        "wi_up": ini.normal((e, d, f), ("ep", "fsdp", None),
                            std=1.0 / math.sqrt(d)),
        "wo": ini.normal((e, f, d), ("ep", None, "fsdp"),
                         std=1.0 / math.sqrt(f)),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_init(ini, d, f)
    return p


def _softmax(logits):
    """jax.nn.softmax's arithmetic: exp(x - max) / sum."""
    un = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return un / un.sum(dim=-1, keepdim=True)


def moe_route(params, cfg: MoEConfig, xt):
    """Token-choice routing of xt [T, d]: (top_e [T, k] expert ids,
    top_p [T, k] float32 weights renormalized over the k choices, slot
    [T*k] each choice's position in its expert's queue, keep [T*k]
    slot < capacity, cap).  The slot is the running count of earlier
    choices of the same expert in token-major order, so the tokens past
    an expert's capacity are dropped exactly as in the JAX package."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(math.ceil(t * k * cfg.capacity_factor / e)))
    probs = _softmax(dense_apply(params["router"], xt.to(torch.float32)))
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    flat_e = top_e.reshape(-1)
    # one_hot's own range check reads the ids back to the host
    experts = shard_ctx.replicated_like(
        torch.arange(e, device=xt.device), flat_e)
    onehot = (flat_e[:, None] == experts[None, :]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1   # [T*k, E]
    slot = pos.gather(1, flat_e[:, None])[:, 0]
    return top_e, top_p, slot, slot < cap, cap


@spanned("repro_torch.moe")
def moe_apply(params, cfg: MoEConfig, x):
    """x [B, S, d] -> [B, S, d]: capacity-dropped token-choice routing
    (``moe_route``), dispatch into an [E, cap, d] buffer, the expert
    FFNs as batched products in x's dtype on each bank (``mat``: a
    memory-packed bank is one kernel-B7 call), combine weighted by the
    routing probabilities, plus the shared expert.  The capacity counts
    every token of the call, so a token's output depends on the other
    tokens of the batch (ROADMAP Queue C, reference property (f)).  The
    routing goes, as returned, to the open ``tracing.expert_routes``
    records."""
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    # the capacity counts every token: on a mesh the routing, dispatch
    # and combine see them all (GSPMD gathers them too)
    xt = shard_ctx.replicate(x.reshape(t, d))
    with span("repro_torch.moe.route"):
        top_e, top_p, slot, keep, cap = moe_route(params, cfg, xt)
    record_route(top_e, slot, keep)
    flat_e = top_e.reshape(-1)
    with span("repro_torch.moe.dispatch"):
        # the JAX package's fixed-shape scatter-add, a dropped choice
        # adding 0 into its expert's last slot (a slot sums +0, one kept
        # row at most and zeros: the same bits in any order)
        buf = shard_ctx.replicated_like(
            torch.zeros((cfg.n_experts * cap, d), dtype=x.dtype,
                        device=x.device), xt)
        src = xt.repeat_interleave(k, dim=0)                   # [T*k, d]
        row = flat_e * cap + torch.where(keep, slot, cap - 1)
        buf.scatter_add_(0, row[:, None].expand(-1, d),
                         torch.where(keep[:, None], src, 0))
        buf = buf.reshape(cfg.n_experts, cap, d)
        buf = shard_ctx.constrain(buf, "ep", None, None)
    with span("repro_torch.moe.experts"):
        gate = torch.einsum("ecd,edf->ecf", buf,
                            mat(params["wi_gate"], x.dtype))
        up = torch.einsum("ecd,edf->ecf", buf, mat(params["wi_up"], x.dtype))
        a = silu(gate) if cfg.act == "swiglu" else gelu_tanh(gate)
        out_e = torch.einsum("ecf,efd->ecd", a * up,
                             mat(params["wo"], x.dtype))       # [E, C, d]
    with span("repro_torch.moe.combine"):
        gathered = out_e[flat_e, torch.where(keep, slot, 0)]   # [T*k, d]
        gathered = gathered.masked_fill(~keep[:, None], 0)
        w = top_p.reshape(-1)[:, None].to(x.dtype)
        y = (gathered * w).reshape(t, k, d).sum(dim=1).reshape(b, s, d)
        if cfg.shared_expert:
            y = y + mlp_apply(params["shared"], x, act=cfg.act)
    return y


def moe_aux_loss(params, cfg: MoEConfig, x):
    """Switch-style load-balance auxiliary loss: E * sum over experts of
    (share of tokens whose top choice it is) x (mean router
    probability)."""
    t = x.shape[0] * x.shape[1]
    probs = _softmax(dense_apply(params["router"],
                                 x.reshape(t, -1).to(torch.float32)))
    top_e = probs.argmax(dim=-1)
    frac = torch.nn.functional.one_hot(top_e, cfg.n_experts) \
        .to(torch.float32).mean(dim=0)
    imp = probs.mean(dim=0)
    return cfg.n_experts * (frac * imp).sum()
