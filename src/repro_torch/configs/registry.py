"""The 10 assigned architectures (copy of ``repro.configs.registry``).

Each entry matches the assigned config cell verbatim; deviations forced
by published-architecture details are commented inline and recorded in
DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

from .base import ArchConfig

QWEN25_32B = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=8, d_ff=27648,
    vocab=152064, qkv_bias=True, rope_theta=1e6, fsdp=True,
    remat_group=8)

GEMMA_2B = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv=1, d_ff=16384,
    vocab=256000, head_dim=256, act="geglu", tie_embeddings=True,
    fsdp=True, remat_group=6)

GRANITE_8B = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=49152, fsdp=True, remat_group=6)

TINYLLAMA_11B = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv=4, d_ff=5632,
    vocab=32000, fsdp=True, remat_group=11)

PHI35_MOE = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, n_experts=16, top_k=2, fsdp=True, remat_group=8)

LLAMA4_MAVERICK = ArchConfig(
    # MoE 128e top-1 + always-on shared expert, interleaved with dense
    # FFN layers (moe_every=2) exactly like the released Maverick —
    # this is also what makes the 400B total parameter count work out.
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
    vocab=202048, n_experts=128, top_k=1, shared_expert=True,
    moe_every=2, fsdp=True, opt_8bit=True, remat_group=8)

SEAMLESS_M4T = ArchConfig(
    # enc-dec: 24 total layers split 12 encoder + 12 decoder; the
    # audio frontend is a stub (precomputed frame embeddings).
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=12, n_dec_layers=12,
    d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
    vocab=256206, frontend="audio", fsdp=True)

RECURRENTGEMMA_2B = ArchConfig(
    # Griffin pattern: (rec, rec, attn) repeated; 26 layers = 8 groups
    # + 2 trailing recurrent layers.  Local attention window 2048.
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680,
    vocab=256000, head_dim=256, act="geglu", d_rnn=2560, window=2048,
    tie_embeddings=True, subquadratic=True, fsdp=True)

LLAVA_NEXT_MISTRAL = ArchConfig(
    # Mistral-7B backbone; anyres vision tiling is a stub that feeds
    # precomputed patch embeddings (n_patches of them) ahead of text.
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=32000, frontend="vision", n_patches=1152, fsdp=True,
    remat_group=8)

MAMBA2_130M = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280, d_inner=1536, ssm_state=128, ssm_heads=24,
    ssm_groups=1, tie_embeddings=True, subquadratic=True)

ARCHS = {a.name: a for a in [
    QWEN25_32B, GEMMA_2B, GRANITE_8B, TINYLLAMA_11B, PHI35_MOE,
    LLAMA4_MAVERICK, SEAMLESS_M4T, RECURRENTGEMMA_2B, LLAVA_NEXT_MISTRAL,
    MAMBA2_130M,
]}

# short aliases for --arch
ALIASES = {
    "qwen2.5-32b": "qwen2.5-32b",
    "gemma-2b": "gemma-2b",
    "granite-8b": "granite-8b",
    "tinyllama-1.1b": "tinyllama-1.1b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
    "llama4-maverick": "llama4-maverick-400b-a17b",
    "llama4-maverick-400b-a17b": "llama4-maverick-400b-a17b",
    "seamless-m4t-large-v2": "seamless-m4t-large-v2",
    "recurrentgemma-2b": "recurrentgemma-2b",
    "llava-next-mistral-7b": "llava-next-mistral-7b",
    "mamba2-130m": "mamba2-130m",
}


def get_arch(name: str) -> ArchConfig:
    return ARCHS[ALIASES[name]]
