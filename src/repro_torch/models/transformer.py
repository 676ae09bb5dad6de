"""The decoders — torch port of the dense, ssm and hybrid families of
``repro.models.transformer``: seeded init, the decode caches with
per-slot positions, ``decode_step`` and (dense only) chunked
``prefill_step``.

  * dense (tinyllama): int8 KV cache, ``decode_step`` with the
    ``advance[B]`` mask, ``prefill_step``;
  * ssm (Mamba2): a stack of SSD blocks; the cache holds each layer's
    short-conv history (bf16) and SSM state (float32);
  * hybrid (Griffin / RecurrentGemma): groups of (RG-LRU, RG-LRU,
    sliding-window attention) layers plus trailing RG-LRU layers; the
    cache holds a bf16 KV ring buffer of ``min(window, s_max)`` entries
    per attention layer and each recurrent layer's conv history (bf16)
    and RNN state (float32).

The recurrent families replay prompts one token per ``decode_step``, as
in the JAX package: ``prefill_step`` and the ``advance`` mask raise for
them.  The serving engine's slot helpers: ``reset_slot`` clears one
batch slot of any family's cache, ``prefill_slot`` prefills one slot of
a dense cache.

Parameters are a plain dict tree with the JAX package's keys and the
stacked layer axis first; the JAX package's ``lax.scan`` over layers
is a Python loop over that axis here.  The cache is updated in place.
Not ported yet: ``forward``, ``verify_step``, ``verify_slot`` and
``rollback_slot`` (speculative decoding), and the moe, encdec and vlm
families.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import layers as L
from . import rglru as R
from . import ssm as S
from .quantized import BSEGConv, PackedLinear, SDVLinear


def _attn_cfg(cfg: ArchConfig) -> L.AttnConfig:
    return L.AttnConfig(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                        head_dim=cfg.hd, rope_theta=cfg.rope_theta)


def _ssm_cfg(cfg: ArchConfig) -> S.SSMConfig:
    return S.SSMConfig(d_model=cfg.d_model, d_inner=cfg.d_inner,
                       n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
                       n_groups=cfg.ssm_groups)


def _rg_cfg(cfg: ArchConfig) -> R.RGLRUConfig:
    return R.RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_rnn)


#: the families each entry point runs
_DECODE_FAMILIES = ("dense", "ssm", "hybrid")


def _require_family(cfg: ArchConfig, what: str):
    if cfg.family not in _DECODE_FAMILIES:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(_DECODE_FAMILIES)})")
    if cfg.family == "dense" and cfg.serve_kv_bits != 8:
        raise NotImplementedError("only the int8 KV cache is ported")


# ---------------------------------------------------------------------------
# seeded init
# ---------------------------------------------------------------------------

def _rec_layer_init(ini: L.Init, cfg: ArchConfig):
    return {"ln_mix": L.rmsnorm_init(ini, cfg.d_model),
            "rec": R.rglru_init(ini, _rg_cfg(cfg)),
            "ln_mlp": L.rmsnorm_init(ini, cfg.d_model),
            "mlp": L.mlp_init(ini, cfg.d_model, cfg.d_ff)}


def init_params(cfg: ArchConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes, dtypes and stds
    (``transformer.init_params`` and the block inits), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  The numbers
    are not JAX's; ``convert.params_from_numpy`` carries JAX's over.
    On ``device="meta"`` the tree holds shapes and dtypes only: nothing
    is drawn or allocated (the planner's shape walk)."""
    _require_family(cfg, "init_params")
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    ini = L.Init(gen, dev, cfg.dtype)
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": ini.normal((cfg.vocab_padded, d), std=0.02),
        "ln_f": L.rmsnorm_init(ini, d),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.normal((d, cfg.vocab_padded), std=0.02)
    if cfg.family == "dense":
        sini = ini.stacked(cfg.n_layers)
        p["blocks"] = {
            "ln_attn": L.rmsnorm_init(sini, d),
            "attn": L.attention_init(sini, _attn_cfg(cfg), d,
                                     qkv_bias=cfg.qkv_bias),
            "ln_mlp": L.rmsnorm_init(sini, d),
            "mlp": L.mlp_init(sini, d, cfg.d_ff),
        }
    elif cfg.family == "ssm":
        sini = ini.stacked(cfg.n_layers)
        p["blocks"] = {"ln": L.rmsnorm_init(sini, d),
                       "ssm": S.ssm_init(sini, _ssm_cfg(cfg))}
    else:                                       # hybrid
        n_groups = cfg.n_layers // 3
        n_tail = cfg.n_layers - 3 * n_groups    # trailing rec layers
        gini = ini.stacked(n_groups)
        p["groups"] = {
            "rec0": _rec_layer_init(gini, cfg),
            "rec1": _rec_layer_init(gini, cfg),
            "ln_attn": L.rmsnorm_init(gini, d),
            "attn": L.attention_init(gini, _attn_cfg(cfg), d,
                                     qkv_bias=cfg.qkv_bias),
            "ln_mlp": L.rmsnorm_init(gini, d),
            "mlp": L.mlp_init(gini, d, cfg.d_ff),
        }
        if n_tail:
            p["tail"] = _rec_layer_init(ini.stacked(n_tail), cfg)
    return p


def layer_params(stacked, i: int):
    """Slice layer ``i`` off a stacked parameter tree."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    if isinstance(stacked, (PackedLinear, SDVLinear, BSEGConv)):
        return stacked.layer(i)
    return stacked[i]


# ---------------------------------------------------------------------------
# embed / unembed
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params, tokens):
    x = params["embed"][tokens.long()]
    if cfg.act == "geglu":                 # gemma family scales embeddings
        x = x * L.scalar_like(math.sqrt(cfg.d_model), x)
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
    """The decode cache, stacked layer axis first, with per-slot
    positions ``index[B]``:

      * dense: int8 KV [L, B, S_max, KV, hd] with per-(position, head)
        f32 scales [L, B, S_max, KV];
      * ssm: ``conv`` [L, B, d_conv-1, conv channels] in the model dtype,
        ``ssm`` [L, B, H, N, P] float32;
      * hybrid: a KV ring ``k``/``v`` [groups, B, min(window, S_max),
        KV, hd] in the model dtype, and per recurrent layer position
        ``{g,t}_conv{r}`` [n, B, 3, d_rnn] (model dtype) and
        ``{g,t}_rnn{r}`` [n, B, d_rnn] float32.
    """
    _require_family(cfg, "init_cache")
    dev = resolve_device(device)
    b = batch_size

    def zeros(shape, dtype=cfg.dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    cache = {"index": zeros((b,), torch.int32)}
    if cfg.family == "dense":
        shape = (cfg.n_layers, b, s_max, cfg.n_kv, cfg.hd)
        cache.update(k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                     k_scale=zeros(shape[:-1], torch.float32),
                     v_scale=zeros(shape[:-1], torch.float32))
    elif cfg.family == "ssm":
        scfg = _ssm_cfg(cfg)
        cache["conv"] = zeros((cfg.n_layers, b, scfg.d_conv - 1,
                               scfg.conv_channels))
        cache["ssm"] = zeros((cfg.n_layers, b, scfg.n_heads, scfg.d_state,
                              scfg.head_dim), torch.float32)
    else:                                       # hybrid
        n_groups = cfg.n_layers // 3
        n_tail = cfg.n_layers - 3 * n_groups
        w = min(cfg.window, s_max)
        cache["k"] = zeros((n_groups, b, w, cfg.n_kv, cfg.hd))
        cache["v"] = zeros((n_groups, b, w, cfg.n_kv, cfg.hd))
        for pref, n, reps in (("g", n_groups, 2), ("t", n_tail, 1)):
            for r in range(reps):
                cache[f"{pref}_conv{r}"] = zeros((n, b, 3, cfg.d_rnn))
                cache[f"{pref}_rnn{r}"] = zeros((n, b, cfg.d_rnn),
                                                torch.float32)
    return cache


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
    ``advance`` [B] int (optional, dense only, as in the JAX package):
    slots with 0 neither write KV nor move their index — their logits
    are discarded.  Omitted means every slot advances.  The cache's
    tensors are updated in place; the returned dict carries the new
    index tensor.
    """
    _require_family(cfg, "decode_step")
    if advance is not None and cfg.family != "dense":
        raise ValueError(
            f"advance mask unsupported for family {cfg.family!r}")
    index = cache["index"]
    x = _embed(cfg, params, tokens)
    if cfg.family == "ssm":
        x = _decode_ssm(cfg, params, cache, x)
        return _unembed(cfg, params, x), dict(cache, index=index + 1)
    if cfg.family == "hybrid":
        x = _decode_hybrid(cfg, params, cache, x, index)
        return _unembed(cfg, params, x), dict(cache, index=index + 1)
    if advance is None:
        bump, wmask = 1, None
    else:
        bump = torch.as_tensor(advance, dtype=torch.int32,
                               device=index.device)
        wmask = bump > 0
    # the written rows, selected once for every layer
    writes = L.decode_writes(index, wmask, cache["k"].shape[2])
    acfg = _attn_cfg(cfg)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = L.decode_attention(
            bp["attn"], acfg, L.rmsnorm_apply(bp["ln_attn"], x),
            cache=_layer_cache(cache, i), cache_index=index, writes=writes)
        x = _mlp_residual(cfg, bp, x + h)
    return _unembed(cfg, params, x), dict(cache, index=index + bump)


def _decode_ssm(cfg: ArchConfig, params, cache, x):
    """The Mamba2 layers of one decode step; the conv and SSM states are
    written back into the cache."""
    scfg = _ssm_cfg(cfg)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h, (conv, ssm) = S.ssm_apply(
            bp["ssm"], scfg, L.rmsnorm_apply(bp["ln"], x),
            conv_state=cache["conv"][i], ssm_state=cache["ssm"][i],
            decode=True)
        cache["conv"][i] = conv
        cache["ssm"][i] = ssm
        x = x + h
    return x


def _rec_layer_apply(rp, cfg: ArchConfig, x, cache, conv: str, rnn: str,
                     i: int):
    """One RG-LRU layer (+ MLP); its conv and RNN states are the
    cache's ``conv``/``rnn`` entries of layer ``i``, written back."""
    h, (c, r) = R.rglru_apply(rp["rec"], _rg_cfg(cfg),
                              L.rmsnorm_apply(rp["ln_mix"], x),
                              conv_state=cache[conv][i],
                              rnn_state=cache[rnn][i])
    cache[conv][i] = c
    cache[rnn][i] = r
    return _mlp_residual(cfg, rp, x + h)


def _decode_hybrid(cfg: ArchConfig, params, cache, x, index):
    """The Griffin layers of one decode step: each group runs two RG-LRU
    layers and a sliding-window attention layer on the KV ring, then the
    trailing RG-LRU layers run."""
    acfg = _attn_cfg(cfg)
    w = cache["k"].shape[2]
    for i in range(cfg.n_layers // 3):
        gp = layer_params(params["groups"], i)
        x = _rec_layer_apply(gp["rec0"], cfg, x, cache, "g_conv0", "g_rnn0",
                             i)
        x = _rec_layer_apply(gp["rec1"], cfg, x, cache, "g_conv1", "g_rnn1",
                             i)
        h = L.decode_attention_ring(
            gp["attn"], acfg, L.rmsnorm_apply(gp["ln_attn"], x),
            k_cache=cache["k"][i], v_cache=cache["v"][i], cache_index=index,
            window=w)
        x = _mlp_residual(cfg, gp, x + h)
    for i in range(cfg.n_layers % 3):
        x = _rec_layer_apply(layer_params(params["tail"], i), cfg, x, cache,
                             "t_conv0", "t_rnn0", i)
    return x


def reset_slot(cache, slot: int):
    """Zero batch slot ``slot`` across every cache leaf.

    Leaves are laid out (layers, B, ...); ``index`` is the per-slot
    position vector [B].  Clearing the position plus all per-slot state
    (KV rows, quant scales, ring buffers, conv/SSM/RNN state) is what
    makes a freed slot safe to hand to a new session mid-wave, as in the
    reference.  The leaves are zeroed in place, as ``decode_step``
    updates them; the returned dict carries a new ``index`` tensor (the
    one passed in is left as it was).
    """
    out = {}
    for name, leaf in cache.items():
        if name == "index":
            index = leaf.clone()
            index[slot] = 0
            out[name] = index
        else:
            leaf[:, slot] = 0
            out[name] = leaf
    return out


def _prefill_forward(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                     n_valid: torch.Tensor):
    """Chunked teacher-forcing core: returns (final hidden states
    [B, C, d], cache)."""
    if cfg.family not in ("dense", "moe", "vlm"):
        # as in the JAX package: the recurrent families replay prompts
        # one token per decode_step
        raise ValueError(f"prefill_step: unsupported family {cfg.family}")
    _require_family(cfg, "prefill_step")       # moe and vlm: not ported
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


def prefill_slot(cfg: ArchConfig, params, cache, slot: int,
                 tokens: torch.Tensor, n_valid: torch.Tensor):
    """Chunked prefill of a SINGLE batch slot.

    tokens [1, C] int; n_valid [1] int.  The slot's row of every cache
    leaf (a view: ``leaf[:, slot:slot+1]``, ``index[slot:slot+1]``) is
    prefilled as a batch of one through ``prefill_step``, which writes
    the K/V rows and scales through the views in place; the slot's new
    position is written back into a copy of ``index``, which the
    returned dict carries (the one passed in is left as it was).  As in
    the reference, a prompt's replay runs the same [1, C] program on the
    same single-row operands whether it opens a wave or joins one.
    """
    sub = {name: leaf[slot:slot + 1] if name == "index"
           else leaf[:, slot:slot + 1] for name, leaf in cache.items()}
    new = prefill_step(cfg, params, sub, tokens, n_valid)
    index = cache["index"].clone()
    index[slot:slot + 1] = new["index"]
    return dict(cache, index=index)
