"""The dense decoder — torch port of the dense family of
``repro.models.transformer``: seeded init, the int8 KV cache with
per-slot positions, ``decode_step`` (with the ``advance[B]`` mask) and
chunked ``prefill_step``.

Parameters are a plain dict tree with the JAX package's keys and the
stacked layer axis first; the JAX package's ``lax.scan`` over layers is
a Python loop over that axis here.  The cache is updated in place.
Not ported yet: ``forward``, ``verify_step``, the ``*_slot`` helpers
and ``rollback_slot`` (the engine slice), and the other families.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers as L
from .quantized import SDVLinear


def _attn_cfg(cfg: ArchConfig) -> L.AttnConfig:
    return L.AttnConfig(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                        head_dim=cfg.hd, rope_theta=cfg.rope_theta)


def _require_dense(cfg: ArchConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only)")
    if cfg.serve_kv_bits != 8:
        raise NotImplementedError("only the int8 KV cache is ported")


# ---------------------------------------------------------------------------
# seeded init
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes and stds
    (``transformer.init_params`` / ``layers.dense_init``), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  The numbers
    are not JAX's; ``convert.params_from_numpy`` carries JAX's over."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(shape, std):
        v = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (v * std).to(cfg.dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def dense(n, d_in, d_out, bias=False):
        p = {"kernel": normal((n, d_in, d_out), 1.0 / math.sqrt(d_in))}
        if bias:
            p["bias"] = torch.zeros((n, d_out), dtype=cfg.dtype, device=dev)
        return p

    n, d, hd = cfg.n_layers, cfg.d_model, cfg.hd
    h, kv = cfg.n_heads, cfg.n_kv
    p: Dict[str, Any] = {
        "embed": normal((cfg.vocab_padded, d), 0.02),
        "ln_f": {"scale": ones((d,))},
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, cfg.vocab_padded), 0.02)
    p["blocks"] = {
        "ln_attn": {"scale": ones((n, d))},
        "attn": {
            "wq": dense(n, d, h * hd, cfg.qkv_bias),
            "wk": dense(n, d, kv * hd, cfg.qkv_bias),
            "wv": dense(n, d, kv * hd, cfg.qkv_bias),
            "wo": dense(n, h * hd, d),
        },
        "ln_mlp": {"scale": ones((n, d))},
        "mlp": {
            "wi_gate": dense(n, d, cfg.d_ff),
            "wi_up": dense(n, d, cfg.d_ff),
            "wo": dense(n, cfg.d_ff, d),
        },
    }
    return p


def layer_params(stacked, i: int):
    """Slice layer ``i`` off a stacked parameter tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    if isinstance(stacked, SDVLinear):
        return stacked.layer(i)
    return stacked[i]


# ---------------------------------------------------------------------------
# embed / unembed
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.act == "geglu":                 # gemma family scales embeddings
        x = x * math.sqrt(cfg.d_model)
    return x.to(cfg.dtype)


def _unembed(cfg: ArchConfig, params, x):
    x = L.rmsnorm_apply(params["ln_f"], x)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].to(x.dtype).T
    else:
        # the LM head is materialized and multiplied in bf16, as in the
        # JAX package: a plain product, not a packed-kernel call
        logits = x @ L.mat(params["lm_head"], x.dtype)
    return logits.to(torch.float32)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, s_max: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The decode cache: per-slot positions ``index[B]`` and int8 KV
    tensors with the stacked layer axis first ([L, B, S_max, KV, hd]),
    with per-(position, head) f32 scales ([L, B, S_max, KV])."""
    _require_dense(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, s_max, cfg.n_kv, cfg.hd)
    return {"index": torch.zeros((batch_size,), dtype=torch.int32,
                                 device=dev),
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=dev)}


def _layer_cache(cache, i: int):
    return tuple(cache[name][i] for name in ("k", "v", "k_scale", "v_scale"))


def _mlp_residual(cfg: ArchConfig, bp, y):
    z = L.rmsnorm_apply(bp["ln_mlp"], y)
    return y + L.mlp_apply(bp["mlp"], z, act=cfg.act)


# ---------------------------------------------------------------------------
# decode / prefill
# ---------------------------------------------------------------------------

def decode_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                advance=None):
    """One decode step.  tokens [B, 1] int; returns (logits [B, 1, V]
    f32, cache).

    ``cache["index"]`` is the per-slot position vector [B] int32.
    ``advance`` [B] int (optional): slots with 0 neither write KV nor
    move their index — their logits are discarded.  Omitted means every slot
    advances.  The cache's KV tensors are updated in place; the returned
    dict carries the new index tensor.
    """
    _require_dense(cfg)
    index = cache["index"]
    if advance is None:
        bump, wmask = 1, None
    else:
        bump = torch.as_tensor(advance, dtype=torch.int32,
                               device=index.device)
        wmask = bump > 0
    # the written rows, selected once for every layer
    writes = L.decode_writes(index, wmask, cache["k"].shape[2])
    acfg = _attn_cfg(cfg)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = L.decode_attention(
            bp["attn"], acfg, L.rmsnorm_apply(bp["ln_attn"], x),
            cache=_layer_cache(cache, i), cache_index=index, writes=writes)
        x = _mlp_residual(cfg, bp, x + h)
    return _unembed(cfg, params, x), dict(cache, index=index + bump)


def _prefill_forward(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                     n_valid: torch.Tensor):
    """Chunked teacher-forcing core: returns (final hidden states
    [B, C, d], cache)."""
    _require_dense(cfg)
    index = cache["index"]
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                              device=index.device)
    writes = L.prefill_writes(index, n_valid, tokens.shape[1],
                              cache["k"].shape[2])
    acfg = _attn_cfg(cfg)          # same attention config as decode_step
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = L.prefill_attention(
            bp["attn"], acfg, L.rmsnorm_apply(bp["ln_attn"], x),
            cache=_layer_cache(cache, i), cache_index=index, writes=writes)
        x = _mlp_residual(cfg, bp, x + h)
    return x, dict(cache, index=index + n_valid)


def prefill_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                 n_valid: torch.Tensor):
    """One chunked-prefill step.

    tokens [B, C] int — a teacher-forced prompt chunk per slot,
    zero-padded; n_valid [B] int in [0, C] says how many columns of
    each row are real.  Slots with n_valid == 0 are untouched.  Returns
    the cache only — prefill logits are never sampled.
    """
    _, new_cache = _prefill_forward(cfg, params, cache, tokens, n_valid)
    return new_cache
