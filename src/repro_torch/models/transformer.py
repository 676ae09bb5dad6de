"""The models — torch port of ``repro.models.transformer``, every family
of the JAX package: seeded init, the decode caches with per-slot
positions, ``decode_step``, and (dense, moe and vlm) chunked
``prefill_step``.

  * dense (tinyllama): int8 KV cache, ``decode_step`` with the
    ``advance[B]`` mask, ``prefill_step``;
  * moe (phi3.5-moe, llama4-maverick): the dense decoder with a
    mixture-of-experts FFN (``layers.moe_apply``); under ``moe_every =
    me > 1`` the layers come in groups of ``me``, member 0 with the MoE
    FFN (``blocks``), member j >= 1 a dense block (``blocks_dense{j}``),
    and layer ``g*me + j`` of the int8 cache is member j of group g;
  * vlm (llava-next): the dense decoder with ``proj_patches``, which
    ``forward`` applies to the patch embeddings it puts ahead of the
    text; serving is text only (the patches enter only ``forward``, as
    in the JAX package: ROADMAP Queue C, reference property (h));
  * encdec (seamless-m4t): an encoder stack (``enc_blocks``, no causal
    mask) and a decoder stack (``dec_blocks``) whose blocks add a cross
    attention over the encoder output.  The decode cache holds the
    decoder's self-attention K/V in bf16 and a cross cache that no entry
    point writes: ``decode_step`` attends to it as it is, zeros after
    ``init_cache`` (reference property (g)).  Prompts replay one token
    per ``decode_step``;
  * ssm (Mamba2): a stack of SSD blocks; the cache holds each layer's
    short-conv history (bf16) and SSM state (float32);
  * hybrid (Griffin / RecurrentGemma): groups of (RG-LRU, RG-LRU,
    sliding-window attention) layers plus trailing RG-LRU layers; the
    cache holds a bf16 KV ring buffer of ``min(window, s_max)`` entries
    per attention layer and each recurrent layer's conv history (bf16)
    and RNN state (float32).

The recurrent families and encdec replay prompts one token per
``decode_step``, as in the JAX package: ``prefill_step`` and the
``advance`` mask raise for them.  The serving engine's slot helpers:
``reset_slot`` clears one batch slot of any family's cache,
``prefill_slot`` prefills one slot of a dense, moe or vlm cache.
Speculative decoding's entry points (dense, moe and vlm):
``verify_step`` / ``verify_slot`` score a chunk of tokens with the
logits of every column, bit for bit those of sequential
``decode_step``s on the dense family, and ``rollback_slot`` rewinds one
slot's position (on the moe family a token's expert capacity counts the
whole call's tokens, so columns and slots are not independent there:
ROADMAP Queue C, property (f)).  ``forward`` (every family) is
the full-sequence forward of training, with the streaming attention of
``layers.attention_apply``, the chunked SSD scan and the RG-LRU's
associative scan, differentiable by autograd.

Parameters are a plain dict tree with the JAX package's keys and the
stacked layer axis first; the JAX package's ``lax.scan`` over layers
is a Python loop over that axis here (``_layer_loop``).  ``forward``
rematerializes as the JAX package does when autograd records:
``cfg.remat`` checkpoints every block (``_maybe_remat``), and
``cfg.remat_group = g > 1`` under ``cfg.scan_layers`` checkpoints each
run of g blocks as well, so only the block (group) boundaries are kept
and the backward pass recomputes the rest.  The cache is updated in
place.

``init_top_params`` and ``init_group_params`` draw a decoder's tree in
parts (the leaves outside the layer stacks, then one layer group at a
time from its own seed), so a model whose bf16 tree exceeds the card can
be packed group by group (``launch/serve.py::packed_params_layerwise``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..tracing import spanned
from . import layers as L
from . import rglru as R
from . import shard_ctx
from . import ssm as S
from .param import PartitionSpec, Rules, specs
from .quantized import BSEGConv, PackedLinear, SDVLinear


def _attn_cfg(cfg: ArchConfig, *, window=None) -> L.AttnConfig:
    return L.AttnConfig(n_heads=cfg.n_heads, n_kv=cfg.n_kv,
                        head_dim=cfg.hd, rope_theta=cfg.rope_theta,
                        window=window,
                        free_qkv_sharding=cfg.free_qkv_sharding)


def _moe_cfg(cfg: ArchConfig) -> L.MoEConfig:
    return L.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts, top_k=cfg.top_k,
                       shared_expert=cfg.shared_expert, act=cfg.act)


def _ssm_cfg(cfg: ArchConfig) -> S.SSMConfig:
    return S.SSMConfig(d_model=cfg.d_model, d_inner=cfg.d_inner,
                       n_heads=cfg.ssm_heads, d_state=cfg.ssm_state,
                       n_groups=cfg.ssm_groups)


def _rg_cfg(cfg: ArchConfig) -> R.RGLRUConfig:
    return R.RGLRUConfig(d_model=cfg.d_model, d_rnn=cfg.d_rnn)


#: the families each entry point runs
_DECODE_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "encdec")
#: the decoder-only families with a KV cache (int8 at ``serve_kv_bits ==
#: 8``, else the model dtype), chunked prefill and speculative
#: verification
_KV_FAMILIES = ("dense", "moe", "vlm")


def _require_family(cfg: ArchConfig, what: str):
    if cfg.family not in _DECODE_FAMILIES:
        raise NotImplementedError(
            f"{what}: family {cfg.family!r} is not ported yet (ported: "
            f"{', '.join(_DECODE_FAMILIES)})")


def _kv8(cfg: ArchConfig) -> bool:
    """Whether the cache of ``cfg`` is int8 with per-(position, head)
    scales: the decoder-only families at ``serve_kv_bits == 8``."""
    return cfg.family in _KV_FAMILIES and cfg.serve_kv_bits == 8


# ---------------------------------------------------------------------------
# seeded init
# ---------------------------------------------------------------------------

def _rec_layer_init(ini: L.Init, cfg: ArchConfig):
    return {"ln_mix": L.rmsnorm_init(ini, cfg.d_model),
            "rec": R.rglru_init(ini, _rg_cfg(cfg)),
            "ln_mlp": L.rmsnorm_init(ini, cfg.d_model),
            "mlp": L.mlp_init(ini, cfg.d_model, cfg.d_ff)}


def _init(seed: int, device):
    dev = resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    return gen, dev


def _top_params(cfg: ArchConfig, ini: L.Init) -> Dict[str, Any]:
    """The leaves outside the layer stacks: the embedding, ``ln_f``, the
    untied LM head and, for a vision frontend, ``proj_patches`` (the
    patch-embedding projection ahead of the text)."""
    d = cfg.d_model
    p: Dict[str, Any] = {
        "embed": ini.normal((cfg.vocab_padded, d), ("tp", "fsdp"),
                            std=0.02),
        "ln_f": L.rmsnorm_init(ini, d),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = ini.normal((d, cfg.vocab_padded), ("fsdp", "tp"),
                                  std=0.02)
    if cfg.frontend == "vision":
        p["proj_patches"] = L.dense_init(ini, d, d, (None, None))
    return p


def _moe_every(cfg: ArchConfig) -> int:
    return cfg.moe_every if cfg.family == "moe" else 1


def _decoder_block_init(ini: L.Init, cfg: ArchConfig, *,
                        cross: bool = False):
    """A block: self attention and the FFN (the MoE FFN on the moe
    family), and with ``cross`` the encoder-decoder's cross attention
    (``ln_cross``, ``cross``)."""
    d = cfg.d_model
    p = {"ln_attn": L.rmsnorm_init(ini, d),
         "attn": L.attention_init(ini, _attn_cfg(cfg), d,
                                  qkv_bias=cfg.qkv_bias),
         "ln_mlp": L.rmsnorm_init(ini, d)}
    if cfg.family == "moe":
        p["moe"] = L.moe_init(ini, _moe_cfg(cfg))
    else:
        p["mlp"] = L.mlp_init(ini, d, cfg.d_ff)
    if cross:
        p["ln_cross"] = L.rmsnorm_init(ini, d)
        p["cross"] = L.attention_init(ini, _attn_cfg(cfg), d,
                                      qkv_bias=cfg.qkv_bias)
    return p


def _decoder_stacks(cfg: ArchConfig, ini: L.Init, n: int):
    """The stacked blocks of the dense, moe and vlm families, ``n`` layers
    (layer groups under ``moe_every > 1``) on the leading axis:
    ``blocks``, and under ``moe_every > 1`` the dense members
    ``blocks_dense{j}`` drawn from a dense config, as in the JAX
    package."""
    sini = ini.stacked(n)
    p = {"blocks": _decoder_block_init(sini, cfg)}
    dense_cfg = dataclasses.replace(cfg, family="dense")
    for j in range(1, _moe_every(cfg)):
        p[f"blocks_dense{j}"] = _decoder_block_init(sini, dense_cfg)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, device="cuda",
                rules: Optional[Rules] = None) -> Dict[str, Any]:
    """Random parameters with the JAX package's shapes, dtypes and stds
    (``transformer.init_params`` and the block inits), drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``.  The numbers
    are not JAX's; ``convert.params_from_numpy`` carries JAX's over.
    On ``device="meta"`` the tree holds shapes and dtypes only: nothing
    is drawn or allocated (the planner's shape walk).  With ``rules``
    every leaf is a ``param.P(value, spec)`` (the JAX package's P-tree;
    ``param.values`` / ``param.specs`` split it), the same draws."""
    _require_family(cfg, "init_params")
    gen, dev = _init(seed, device)
    ini = L.Init(gen, dev, cfg.dtype, rules=rules)
    d = cfg.d_model
    p = _top_params(cfg, ini)
    if cfg.family in _KV_FAMILIES:
        p.update(_decoder_stacks(cfg, ini, cfg.n_layers // _moe_every(cfg)))
    elif cfg.family == "ssm":
        sini = ini.stacked(cfg.n_layers)
        p["blocks"] = {"ln": L.rmsnorm_init(sini, d),
                       "ssm": S.ssm_init(sini, _ssm_cfg(cfg))}
    elif cfg.family == "encdec":
        p["enc_blocks"] = _decoder_block_init(ini.stacked(cfg.n_enc_layers),
                                              cfg)
        p["dec_blocks"] = _decoder_block_init(ini.stacked(cfg.n_dec_layers),
                                              cfg, cross=True)
        p["ln_enc"] = L.rmsnorm_init(ini, d)
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


def n_groups(cfg: ArchConfig) -> int:
    """The length of a dense, moe or vlm tree's layer stacks: the layers, or
    the groups of ``moe_every`` layers."""
    return cfg.n_layers // _moe_every(cfg)


def init_top_params(cfg: ArchConfig, seed: int = 0,
                    device="cuda") -> Dict[str, Any]:
    """The leaves of ``init_params(cfg, seed)`` outside the layer stacks
    (``embed``, ``ln_f``, ``lm_head``, ``proj_patches``), the same
    numbers: they are drawn first."""
    _require_family(cfg, "init_top_params")
    gen, dev = _init(seed, device)
    return _top_params(cfg, L.Init(gen, dev, cfg.dtype))


def init_group_params(cfg: ArchConfig, group: int, seed: int = 0,
                      device="cuda") -> Dict[str, Any]:
    """The stacked block containers of a decoder-only tree (``blocks``,
    ``blocks_dense{j}``) for layer group ``group`` alone, with a leading
    layer axis of 1, drawn from a generator of their own seeded with
    (``seed``, ``group``).  ``init_top_params`` and these groups,
    concatenated on the layer axis, make a whole tree; it is not
    ``init_params``'s, whose stacks are drawn in one piece."""
    if cfg.family not in _KV_FAMILIES:
        raise ValueError(f"init_group_params: family {cfg.family!r} has no "
                         "decoder layer stacks")
    if not 0 <= group < n_groups(cfg):
        raise ValueError(f"group {group} not in 0..{n_groups(cfg) - 1}")
    gen, dev = _init((seed << 32) | (group + 1), device)
    return _decoder_stacks(cfg, L.Init(gen, dev, cfg.dtype), 1)


def layer_params(stacked, i: int):
    """Slice layer ``i`` off a stacked parameter tree (a list of trees:
    off each).  A container (``PackedLinear``, ``SDVLinear``,
    ``BSEGConv``, the QAT ``QATLinear``) slices itself with
    ``layer(i)``."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    if type(stacked) is list:
        return [layer_params(v, i) for v in stacked]
    if isinstance(stacked, (PackedLinear, SDVLinear, BSEGConv)) \
            or hasattr(stacked, "qat_apply"):
        return stacked.layer(i)
    return stacked[i]


# ---------------------------------------------------------------------------
# embed / unembed
# ---------------------------------------------------------------------------

def _embed(cfg: ArchConfig, params, tokens):
    # on a mesh the lookup takes every rank's tokens: torch's DTensor
    # cannot yet differentiate it on batch-sharded indices everywhere
    x = params["embed"][shard_ctx.replicate(tokens).long()]
    if cfg.act == "geglu":                 # gemma family scales embeddings
        x = x * L.scalar_like(math.sqrt(cfg.d_model), x)
    return shard_ctx.constrain(x.to(cfg.dtype), "batch", None, None)


@spanned("repro_torch.head")
def unembed_hidden(cfg: ArchConfig, params, h):
    """Project already-normed hidden states to float32 logits.  The LM
    head is materialized and multiplied in bf16, as in the JAX package:
    a plain product, not a packed-kernel call.  Under QAT the head is a
    ``QATLinear`` and runs its STE forward (the packed dispatch)."""
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    elif hasattr(params["lm_head"], "qat_apply"):
        logits = params["lm_head"].qat_apply(h)   # QAT STE (train/qat)
    else:
        logits = h @ L.mat(params["lm_head"], h.dtype)
    return shard_ctx.constrain(logits.to(torch.float32),
                               "batch", None, "tp")


def _unembed(cfg: ArchConfig, params, x):
    return unembed_hidden(cfg, params, L.rmsnorm_apply(params["ln_f"], x))


# ---------------------------------------------------------------------------
# full forward (training)
# ---------------------------------------------------------------------------

def _finish(cfg: ArchConfig, params, x, mode: str):
    if mode == "hidden":
        return L.rmsnorm_apply(params["ln_f"], x)
    if mode == "last_logits":
        return _unembed(cfg, params, x[:, -1:, :])
    if mode == "logits":
        return _unembed(cfg, params, x)
    raise ValueError(f"unknown forward mode {mode!r}")


def _block_apply(cfg: ArchConfig, bp, x, positions, *, diff: bool,
                 window=None, causal: bool = True, cross_kv=None):
    """One block of the full-sequence forward: self attention (within
    ``window``, ``causal`` or not), with ``cross_kv`` the cross attention
    over it, then the FFN; each a residual."""
    h, _ = L.attention_apply(
        bp["attn"], _attn_cfg(cfg, window=window),
        L.rmsnorm_apply(bp["ln_attn"], x), positions=positions,
        causal=causal, chunk=cfg.attn_chunk, differentiable=diff)
    x = x + h
    if cross_kv is not None:
        h, _ = L.attention_apply(
            bp["cross"], _attn_cfg(cfg),
            L.rmsnorm_apply(bp["ln_cross"], x), positions=positions,
            kv=cross_kv, causal=False, chunk=cfg.attn_chunk,
            differentiable=diff)
        x = x + h
    return _mlp_residual(cfg, bp, x)


def _positions(b: int, s: int, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def _remat(fn, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are dropped and recomputed in the backward pass.
    The forward draws no random numbers, so no RNG state is stashed."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _maybe_remat(fn, cfg: ArchConfig):
    """``fn`` rematerialized (the JAX package's ``jax.checkpoint``) when
    ``cfg.remat`` is set and autograd is recording; else ``fn`` itself,
    so a forward under ``no_grad`` runs exactly its own ops."""
    if cfg.remat and torch.is_grad_enabled():
        return functools.partial(_remat, fn)
    return fn


def _layer_loop(cfg: ArchConfig, body, x, stacked, n: int,
                allow_group: bool = False):
    """``x = body(x, layer_params(stacked, i))`` for i in 0..n-1: the
    JAX package's ``lax.scan`` over the stacked layer axis.

    ``cfg.remat_group = g > 1`` enables sqrt-L checkpointing under the
    JAX package's condition (``allow_group``, ``cfg.scan_layers``, ``n %
    g == 0``, ``n > g``), when autograd records: each run of g layers is
    rematerialized as one group, ``body``'s own ``_maybe_remat`` nested
    inside, so only the n / g group-boundary activations are kept across
    the forward."""
    def run(xx, lo: int, hi: int):
        for i in range(lo, hi):
            xx = body(xx, layer_params(stacked, i))
        return xx

    g = cfg.remat_group
    if (allow_group and cfg.scan_layers and g > 1 and n % g == 0 and n > g
            and torch.is_grad_enabled()):
        for lo in range(0, n, g):
            x = _remat(run, x, lo, lo + g)
        return x
    return run(x, 0, n)


def forward(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor], *,
            diff: bool = True, mode: str = "logits"):
    """Full-sequence forward of every family.  batch: {"tokens": [B, S]};
    vlm: {"tokens": [B, S - n_patches], "patches": [B, n_patches, d]},
    the projected patches ahead of the text; encdec: {"src": [B, S_src,
    d] frame embeddings, "tokens": [B, S_tgt]}.  mode: "logits" (full
    [B, S, V] float32), "hidden" (the post-``ln_f`` states, for a chunked
    loss) or "last_logits" (only the next-token logits).  Attention is
    ``layers.attention_apply`` over positions 0..S-1 (causal, chunked at
    ``cfg.attn_chunk``); ``diff`` picks its differentiable variant (bf16
    operands, float32 accumulation), else float32 operands.  A dense
    block (the moe family's dense members too) attends within
    ``cfg.window``, the other blocks without one, as in the JAX package;
    the hybrid family's attention layers attend within ``cfg.window``.
    The encoder attends without a causal mask; each decoder block of
    encdec attends across to the normed encoder output.  The ssm family
    runs each Mamba2 block over the sequence (the chunked SSD scan), the
    hybrid family its groups (two RG-LRU layers, each an associative
    scan, and a windowed attention layer, each with its MLP) and then
    its trailing RG-LRU layers, every recurrence from a zero state.
    When autograd records, the blocks are rematerialized by
    ``_maybe_remat`` and ``_layer_loop`` at the JAX package's
    boundaries: a block (a layer group under ``moe_every > 1``, a
    Griffin group, a trailing RG-LRU layer, an encoder or decoder
    block), and groups of ``cfg.remat_group`` of them but for the
    trailing layers.  The values are those of ``remat=False``."""
    if cfg.family == "encdec":
        return _forward_encdec(cfg, params, batch, diff=diff, mode=mode)
    x = _embed(cfg, params, batch["tokens"])
    if cfg.family == "vlm":
        patches = L.dense_apply(params["proj_patches"],
                                batch["patches"].to(cfg.dtype))
        x = torch.cat([patches, x], dim=1)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    if cfg.family == "ssm":
        scfg = _ssm_cfg(cfg)

        def body(xc, bp):
            def blk(xx):
                h, _ = S.ssm_apply(bp["ssm"], scfg,
                                   L.rmsnorm_apply(bp["ln"], xx))
                return xx + h
            return _maybe_remat(blk, cfg)(xc)
        x = _layer_loop(cfg, body, x, params["blocks"], cfg.n_layers,
                        allow_group=True)
    elif cfg.family == "hybrid":
        def body(xc, gp):
            return _maybe_remat(lambda xx: _hybrid_group_apply(
                gp, cfg, xx, positions, diff=diff), cfg)(xc)
        x = _layer_loop(cfg, body, x, params["groups"], cfg.n_layers // 3,
                        allow_group=True)
        if "tail" in params:
            def tbody(xc, tp):
                return _maybe_remat(
                    lambda xx: _rec_layer_apply(tp, cfg, xx)[0], cfg)(xc)
            x = _layer_loop(cfg, tbody, x, params["tail"], cfg.n_layers % 3)
    elif cfg.family in _KV_FAMILIES:
        # one remat unit a layer group: under moe_every > 1 the MoE block
        # and its dense members (``_decoder_layers``' order), as in the
        # JAX package
        me = _moe_every(cfg)

        def body(xc, bps):
            def blk(xx):
                for bp in bps:
                    dense = cfg.family in ("dense", "moe") \
                        and "moe" not in bp
                    xx = _block_apply(cfg, bp, xx, positions, diff=diff,
                                      window=cfg.window if dense else None)
                return xx
            return _maybe_remat(blk, cfg)(xc)
        stacks = [params["blocks"]] + [params[f"blocks_dense{j}"]
                                       for j in range(1, me)]
        x = _layer_loop(cfg, body, x, stacks, cfg.n_layers // me,
                        allow_group=True)
    else:
        raise ValueError(f"forward: unknown family {cfg.family!r}")
    return _finish(cfg, params, x, mode)


def _rec_layer_apply(rp, cfg: ArchConfig, x, *, conv_state=None,
                     rnn_state=None):
    """One RG-LRU layer and its MLP, each a residual, from the given conv
    and RNN states (zero when None).  Returns (x, (conv_state,
    rnn_state))."""
    h, states = R.rglru_apply(rp["rec"], _rg_cfg(cfg),
                              L.rmsnorm_apply(rp["ln_mix"], x),
                              conv_state=conv_state, rnn_state=rnn_state)
    return _mlp_residual(cfg, rp, x + h), states


def _hybrid_group_apply(gp, cfg: ArchConfig, x, positions, *,
                        diff: bool = True):
    """One Griffin group of the full-sequence forward: two RG-LRU layers
    from zero states, then causal attention within ``cfg.window`` and the
    MLP."""
    x, _ = _rec_layer_apply(gp["rec0"], cfg, x)
    x, _ = _rec_layer_apply(gp["rec1"], cfg, x)
    return _block_apply(cfg, gp, x, positions, diff=diff, window=cfg.window)


def _forward_encdec(cfg: ArchConfig, params, batch, *, diff: bool,
                    mode: str):
    """The encoder over ``src`` (cast to the model dtype, no causal
    mask), ``ln_enc``, then the decoder over ``tokens`` attending across
    to the encoder output."""
    enc = batch["src"].to(cfg.dtype)
    pos_src = _positions(enc.shape[0], enc.shape[1], enc.device)

    def enc_body(xc, bp):
        return _maybe_remat(lambda xx: _block_apply(
            cfg, bp, xx, pos_src, diff=diff, causal=False), cfg)(xc)
    enc = _layer_loop(cfg, enc_body, enc, params["enc_blocks"],
                      cfg.n_enc_layers, allow_group=True)
    enc = L.rmsnorm_apply(params["ln_enc"], enc)
    x = _embed(cfg, params, batch["tokens"])
    pos = _positions(x.shape[0], x.shape[1], x.device)

    def dec_body(xc, bp):
        return _maybe_remat(lambda xx: _block_apply(
            cfg, bp, xx, pos, diff=diff, cross_kv=(enc, enc)), cfg)(xc)
    x = _layer_loop(cfg, dec_body, x, params["dec_blocks"],
                    cfg.n_dec_layers, allow_group=True)
    return _finish(cfg, params, x, mode)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch_size: int, s_max: int,
               device="cuda") -> Dict[str, torch.Tensor]:
    """The decode cache, stacked layer axis first, with per-slot
    positions ``index[B]``:

      * dense, moe and vlm: KV [L, B, S_max, KV, hd], int8 with
        per-(position, head) f32 scales ``k_scale``/``v_scale``
        [L, B, S_max, KV] at ``serve_kv_bits == 8``, else in the model
        dtype without scales;
      * encdec: the decoder's self-attention KV ``k``/``v`` [L_dec, B,
        S_max, KV, hd] in the model dtype (bf16: the JAX package
        quantizes only the decoder-only families' caches) and the cross
        cache ``cross_k``/``cross_v`` of the same shape and dtype, zeros
        that no entry point writes (ROADMAP Queue C, reference property
        (g));
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
    if cfg.family in _KV_FAMILIES:
        shape = (cfg.n_layers, b, s_max, cfg.n_kv, cfg.hd)
        if _kv8(cfg):
            cache.update(k=zeros(shape, torch.int8),
                         v=zeros(shape, torch.int8),
                         k_scale=zeros(shape[:-1], torch.float32),
                         v_scale=zeros(shape[:-1], torch.float32))
        else:
            cache.update(k=zeros(shape), v=zeros(shape))
    elif cfg.family == "encdec":
        shape = (cfg.n_dec_layers, b, s_max, cfg.n_kv, cfg.hd)
        cache.update(k=zeros(shape), v=zeros(shape), cross_k=zeros(shape),
                     cross_v=zeros(shape))
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


def param_specs(cfg: ArchConfig, rules: Rules):
    """The ``PartitionSpec`` tree of ``init_params`` under ``rules`` (the
    JAX package's ``specs(init_params(cfg, rules, None))``), built on the
    ``meta`` device: nothing is drawn or allocated."""
    return specs(init_params(cfg, device="meta", rules=rules))


def cache_specs(cfg: ArchConfig, rules: Rules, batch_size: int,
                s_max: int) -> Dict[str, PartitionSpec]:
    """The ``PartitionSpec`` of each leaf of ``init_cache(cfg,
    batch_size, s_max)`` (the JAX package's ``specs(init_cache(cfg,
    rules, b, s, abstract=True))``).  The TP axis lands on whichever KV
    dimension it divides: the KV heads when ``n_kv`` is a multiple of
    the TP degree, else ``head_dim``, else none; likewise the SSM state
    on its heads, else its state dimension."""
    _require_family(cfg, "cache_specs")
    del batch_size, s_max                 # the specs do not depend on them
    tp = max(1, rules.tp_degree)
    hd, kv = cfg.hd, cfg.n_kv
    kv_ax = ("tp", None) if kv and kv % tp == 0 else \
        ((None, "tp") if hd and hd % tp == 0 else (None, None))

    def spec(*axes):
        return rules.resolve(axes)

    kv_spec = spec(None, "batch", None, *kv_ax)
    out = {"index": spec(None)}
    if cfg.family in _KV_FAMILIES:
        out.update(k=kv_spec, v=kv_spec)
        if _kv8(cfg):
            scale = spec(None, "batch", None, kv_ax[0])
            out.update(k_scale=scale, v_scale=scale)
    elif cfg.family == "encdec":
        out.update(k=kv_spec, v=kv_spec, cross_k=kv_spec, cross_v=kv_spec)
    elif cfg.family == "ssm":
        nh = _ssm_cfg(cfg).n_heads
        out["conv"] = spec(None, "batch", None, "tp")
        out["ssm"] = spec(None, "batch", *(("tp", None, None)
                                           if nh % tp == 0
                                           else (None, "tp", None)))
    else:                                       # hybrid
        out.update(k=kv_spec, v=kv_spec)
        for pref, reps in (("g", 2), ("t", 1)):
            for r in range(reps):
                out[f"{pref}_conv{r}"] = spec(None, "batch", None, "tp")
                out[f"{pref}_rnn{r}"] = spec(None, "batch", "tp")
    return out


def _layer_cache(cache, i: int, scaled: bool = True):
    """Layer ``i``'s (k, v, k_scale, v_scale); the scales None where the
    layer writes and reads its K/V unscaled (an int8 cache's unscaled
    layers, or a cache in the model dtype)."""
    k, v = cache["k"][i], cache["v"][i]
    if not scaled:
        return k, v, None, None
    return k, v, cache["k_scale"][i], cache["v_scale"][i]


def _decoder_layers(cfg: ArchConfig, params, cache=None):
    """(cache layer, block params, scaled) of each layer of the dense and
    moe families, in order.  Under ``moe_every = me > 1`` layer
    ``g*me + j`` is member j of group g: member 0 takes ``blocks[g]``
    (its MoE FFN), member j >= 1 ``blocks_dense{j}[g]`` (its MLP); the
    JAX package calls their attention without the int8 cache's scales,
    so they write K/V truncated to int8, read it unscaled and leave the
    scales at zero (ROADMAP Queue C, reference property (e)): ``scaled``
    is False for them.  As in the JAX package, a layer is scaled only
    where the cache has scales (``"k_scale" in cache``): a cache in the
    model dtype (``serve_kv_bits != 8``) is written in that dtype by
    every layer (``forward`` passes no cache)."""
    me = _moe_every(cfg)
    scaled = me == 1 and cache is not None and "k_scale" in cache
    stacks = [params["blocks"]] + [params[f"blocks_dense{j}"]
                                   for j in range(1, me)]
    for g in range(cfg.n_layers // me):
        for j, stack in enumerate(stacks):
            yield g * me + j, layer_params(stack, g), scaled


def _mlp_residual(cfg: ArchConfig, bp, y):
    """y plus the block's FFN of its normed input: the MoE FFN where the
    block has one, else the gated MLP."""
    z = L.rmsnorm_apply(bp["ln_mlp"], y)
    if "moe" in bp:
        return y + L.moe_apply(bp["moe"], _moe_cfg(cfg), z)
    return y + L.mlp_apply(bp["mlp"], z, act=cfg.act)


# ---------------------------------------------------------------------------
# decode / prefill
# ---------------------------------------------------------------------------

@spanned("repro_torch.decode_step")
def decode_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                advance=None):
    """One decode step.  tokens [B, 1] int; returns (logits [B, 1, V]
    f32, cache).

    ``cache["index"]`` is the per-slot position vector [B] int32.
    ``advance`` [B] int (optional, dense, moe and vlm, as in the JAX
    package):
    slots with 0 neither write KV nor move their index — their logits
    are discarded.  Omitted means every slot advances.  The cache's
    tensors are updated in place; the returned dict carries the new
    index tensor.
    """
    _require_family(cfg, "decode_step")
    if advance is not None and cfg.family not in _KV_FAMILIES:
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
    if cfg.family == "encdec":
        x = _decode_encdec(cfg, params, cache, x, index)
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
    for i, bp, scaled in _decoder_layers(cfg, params, cache):
        h = L.decode_attention(
            bp["attn"], acfg, L.rmsnorm_apply(bp["ln_attn"], x),
            cache=_layer_cache(cache, i, scaled), cache_index=index,
            writes=writes)
        x = _mlp_residual(cfg, bp, x + h)
    return _unembed(cfg, params, x), dict(cache, index=index + bump)


def _decode_encdec(cfg: ArchConfig, params, cache, x, index):
    """The decoder layers of one encoder-decoder decode step: self
    attention on the bf16 cache (written in place), cross attention
    against the cross cache as the JAX package reads it (no ``wk``/``wv``:
    ``layers.cross_decode_attention``), then the MLP."""
    acfg = _attn_cfg(cfg)
    writes = L.decode_writes(index, None, cache["k"].shape[2])
    for i in range(cfg.n_dec_layers):
        bp = layer_params(params["dec_blocks"], i)
        x = x + L.decode_attention(
            bp["attn"], acfg, L.rmsnorm_apply(bp["ln_attn"], x),
            cache=_layer_cache(cache, i, scaled=False), cache_index=index,
            writes=writes)
        x = x + L.cross_decode_attention(
            bp["cross"], acfg, L.rmsnorm_apply(bp["ln_cross"], x),
            cross_k=cache["cross_k"][i], cross_v=cache["cross_v"][i])
        x = _mlp_residual(cfg, bp, x)
    return x


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


def _rec_layer_decode(rp, cfg: ArchConfig, x, cache, conv: str, rnn: str,
                      i: int):
    """One RG-LRU layer (+ MLP) of a decode step; its conv and RNN states
    are the cache's ``conv``/``rnn`` entries of layer ``i``, written
    back."""
    x, (c, r) = _rec_layer_apply(rp, cfg, x, conv_state=cache[conv][i],
                                 rnn_state=cache[rnn][i])
    cache[conv][i] = c
    cache[rnn][i] = r
    return x


def _decode_hybrid(cfg: ArchConfig, params, cache, x, index):
    """The Griffin layers of one decode step: each group runs two RG-LRU
    layers and a sliding-window attention layer on the KV ring, then the
    trailing RG-LRU layers run."""
    acfg = _attn_cfg(cfg)
    w = cache["k"].shape[2]
    for i in range(cfg.n_layers // 3):
        gp = layer_params(params["groups"], i)
        x = _rec_layer_decode(gp["rec0"], cfg, x, cache, "g_conv0",
                              "g_rnn0", i)
        x = _rec_layer_decode(gp["rec1"], cfg, x, cache, "g_conv1",
                              "g_rnn1", i)
        h = L.decode_attention_ring(
            gp["attn"], acfg, L.rmsnorm_apply(gp["ln_attn"], x),
            k_cache=cache["k"][i], v_cache=cache["v"][i], cache_index=index,
            window=w)
        x = _mlp_residual(cfg, gp, x + h)
    for i in range(cfg.n_layers % 3):
        x = _rec_layer_decode(layer_params(params["tail"], i), cfg, x,
                              cache, "t_conv0", "t_rnn0", i)
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
    [B, C, d], cache).  ``prefill_step`` drops the hidden states,
    ``verify_step`` unembeds them."""
    if cfg.family not in _KV_FAMILIES:
        # as in the JAX package: the recurrent families and encdec
        # replay prompts one token per decode_step
        raise ValueError(f"prefill_step: unsupported family {cfg.family}")
    _require_family(cfg, "prefill_step")
    index = cache["index"]
    n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                              device=index.device)
    writes = L.prefill_writes(index, n_valid, tokens.shape[1],
                              cache["k"].shape[2])
    acfg = _attn_cfg(cfg)          # same attention config as decode_step
    x = _embed(cfg, params, tokens)
    for i, bp, scaled in _decoder_layers(cfg, params, cache):
        h = L.prefill_attention(
            bp["attn"], acfg, L.rmsnorm_apply(bp["ln_attn"], x),
            cache=_layer_cache(cache, i, scaled), cache_index=index,
            writes=writes)
        x = _mlp_residual(cfg, bp, x + h)
    return x, dict(cache, index=index + n_valid)


@spanned("repro_torch.prefill_step")
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


def _slot_view(cache, slot: int):
    """The slot's row of every cache leaf, as views
    (``leaf[:, slot:slot+1]``, ``index[slot:slot+1]``)."""
    return {name: leaf[slot:slot + 1] if name == "index"
            else leaf[:, slot:slot + 1] for name, leaf in cache.items()}


def _slot_merge(cache, slot: int, new):
    """``cache`` with the slot's new position written into a copy of
    ``index`` (the leaves were written through the views in place)."""
    index = cache["index"].clone()
    index[slot:slot + 1] = new["index"]
    return dict(cache, index=index)


def prefill_slot(cfg: ArchConfig, params, cache, slot: int,
                 tokens: torch.Tensor, n_valid: torch.Tensor):
    """Chunked prefill of a SINGLE batch slot.

    tokens [1, C] int; n_valid [1] int.  The slot's row of every cache
    leaf (a view) is prefilled as a batch of one through
    ``prefill_step``, which writes the K/V rows and scales through the
    views in place; the slot's new position is written back into a copy
    of ``index``, which the returned dict carries (the one passed in is
    left as it was).  As in the reference, a prompt's replay runs the
    same [1, C] program on the same single-row operands whether it
    opens a wave or joins one.
    """
    new = prefill_step(cfg, params, _slot_view(cache, slot), tokens, n_valid)
    return _slot_merge(cache, slot, new)


@spanned("repro_torch.verify_step")
def verify_step(cfg: ArchConfig, params, cache, tokens: torch.Tensor,
                n_valid: torch.Tensor):
    """The speculative verification wave: chunked teacher forcing with
    the logits of every column.

    tokens [B, C] int — per slot, the pending token and the draft's
    proposals; n_valid [B] int in [0, C] (0 freezes a slot, as in
    ``prefill_step``).  Returns (logits [B, C, V] float32, cache):
    column j holds the next-token logits after tokens[:, :j+1].

    It runs the layer stack chunked prefill runs (prefill attention
    writes K/V at ``index + j`` and attends ``kpos <= index + j``: the
    decode step's causal rule per column), so column j's logits and the
    K/V writes are bit for bit those of j+1 sequential ``decode_step``s
    over the same tokens.  The B x C rows of every projection go
    through one packed GEMM (kernel B2 above 8 rows), exact at any row
    count; the float ops (norms, attention products, the bf16 LM head)
    gave the decode step's bits at these shapes on the CPU and on the
    H100 (``scripts/verify_vs_decode.py``).  Columns at or past a slot's
    ``n_valid`` give garbage logits (their K/V is not written); callers
    read only accepted prefixes.  On the moe family the experts'
    capacity counts all B x C tokens of the wave, so the equality with
    sequential decode does not hold there (property (f)).
    """
    x, new_cache = _prefill_forward(cfg, params, cache, tokens, n_valid)
    return _unembed(cfg, params, x), new_cache


def verify_slot(cfg: ArchConfig, params, cache, slot: int,
                tokens: torch.Tensor, n_valid: torch.Tensor):
    """``verify_step`` over a SINGLE batch slot, on views of its rows as
    ``prefill_slot`` does.  tokens [1, C]; n_valid [1].  Returns (logits
    [1, C, V], cache with only ``slot``'s rows and position changed)."""
    logits, new = verify_step(cfg, params, _slot_view(cache, slot), tokens,
                              n_valid)
    return logits, _slot_merge(cache, slot, new)


def rollback_slot(cache, slot, n):
    """Rewind batch slot ``slot`` by ``n`` positions, clamped at 0.

    The whole rejection path of speculative decoding: a copy of the
    position vector ``index`` is decremented and nothing else is
    touched.  K/V entries past the new position hold rejected drafts,
    but attention reads only positions <= index and every position is
    written before it becomes readable again (the argument that makes
    ``reset_slot`` and slot reuse sound).  ``slot`` and ``n`` may be
    Python ints or device scalars.
    """
    index = cache["index"].clone()
    index[slot] = torch.clamp_min(index[slot] - n, 0)
    return dict(cache, index=index)
