"""Architecture configuration schema + the input-shape grid.

Torch port of ``repro.configs.base``: the same frozen ArchConfig, with
``dtype`` a torch dtype.  ``reduced()`` yields the small same-family
config used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


# the four assigned input shapes (LM family)
SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | encdec | hybrid | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    act: str = "swiglu"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    moe_every: int = 1          # llama4: MoE FFN on every 2nd layer
    # --- hybrid (RG-LRU) ---
    window: Optional[int] = None
    d_rnn: int = 0
    # --- ssm (mamba2) ---
    d_inner: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_groups: int = 1
    # --- enc-dec ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- modality frontend stubs ---
    frontend: Optional[str] = None  # "audio" | "vision"
    n_patches: int = 0
    # --- execution ---
    fsdp: bool = False
    remat: bool = True
    attn_chunk: int = 1024
    train_microbatches: int = 4
    scan_layers: bool = True    # False: unroll (flops-exact cost_analysis)
    remat_group: int = 0        # >1: sqrt-L checkpointing over layer groups
    serve_kv_bits: int = 8      # int8-quantized KV cache (decode)
    free_qkv_sharding: bool = False  # let GSPMD factor head/hd tiling
    opt_8bit: bool = False          # 8-bit Adam moments (400B-scale)
    # --- quantized serving (the paper's technique) ---
    serve_weight_bits: int = 4
    serve_act_bits: int = 8
    # --- capability flags ---
    subquadratic: bool = False      # eligible for long_500k
    has_decoder: bool = True

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows padded to a multiple of 128 so both the
        TP axis (16) and the int4 lane packing (8/word) divide evenly
        (standard MaxText-style vocab padding; logits keep the padded
        width, targets never reference the pad)."""
        return ((self.vocab + 127) // 128) * 128

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def dtype(self):
        return torch.bfloat16

    def shape_supported(self, shape: ShapeCell) -> Tuple[bool, str]:
        if shape.name == "long_500k" and not self.subquadratic:
            return False, ("full attention at 524288 context is not "
                           "sub-quadratic; skipped per spec")
        if shape.kind == "decode" and not self.has_decoder:
            return False, "encoder-only architecture has no decode step"
        return True, ""

    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            # hybrid keeps one full (rec, rec, attn) group + 2 tail layers
            n_layers=5 if self.family == "hybrid" else min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            n_dec_layers=min(self.n_dec_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv=min(self.n_kv, 2) if self.n_kv else 0,
            head_dim=32,
            d_ff=256,
            d_rnn=128 if self.d_rnn else 0,
            d_inner=256 if self.d_inner else 0,
            ssm_state=32 if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_heads else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            window=min(self.window, 16) if self.window else None,
            n_patches=8 if self.n_patches else 0,
            fsdp=False,
            attn_chunk=16,
            opt_8bit=self.opt_8bit,
        )


def param_count(cfg: ArchConfig) -> int:
    """Approximate parameter count (embedding + blocks), for roofline
    MODEL_FLOPS = 6 N D and memory budgeting."""
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd = cfg.hd
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d
    if cfg.family == "ssm":
        di = cfg.d_inner
        gn = cfg.ssm_groups * cfg.ssm_state
        blk = d * (2 * di + 2 * gn + cfg.ssm_heads) + di * d \
            + (di + 2 * gn) * 4
        return emb // 2 * (1 if cfg.tie_embeddings else 2) \
            + cfg.n_layers * blk
    if cfg.family == "moe":
        n_moe = cfg.n_layers // cfg.moe_every
        n_dense = cfg.n_layers - n_moe
        ffn = 3 * d * ff * cfg.n_experts
        if cfg.shared_expert:
            ffn += 3 * d * ff
        return emb + cfg.n_layers * attn + n_moe * ffn \
            + n_dense * 3 * d * ff
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // 3
        n_rec = cfg.n_layers - n_attn
        rec = 2 * d * cfg.d_rnn + 2 * cfg.d_rnn * cfg.d_rnn \
            + cfg.d_rnn * d
        ffn = 3 * d * ff
        return emb + n_attn * (attn + ffn) + n_rec * (rec + ffn)
    if cfg.family == "encdec":
        layers = cfg.n_enc_layers + cfg.n_dec_layers
        cross = cfg.n_dec_layers * attn
        return emb + layers * (attn + 3 * d * ff) + cross
    # dense / vlm
    return emb + cfg.n_layers * (attn + 3 * d * ff)


def active_param_count(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: top_k experts only)."""
    if cfg.family != "moe":
        return param_count(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    hd = cfg.hd
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    attn = d * hd * (cfg.n_heads + 2 * cfg.n_kv) + cfg.n_heads * hd * d
    ffn = 3 * d * ff * cfg.top_k
    if cfg.shared_expert:
        ffn += 3 * d * ff
    n_moe = cfg.n_layers // cfg.moe_every
    return emb + cfg.n_layers * attn + n_moe * ffn \
        + (cfg.n_layers - n_moe) * 3 * d * ff
