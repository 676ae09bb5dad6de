"""The benchmark's frozen yardstick: the H100's published peaks and the
operations and bytes of the work a cell asks for, counted from the
model's shapes (never from which kernel ran or how often).

Peaks: NVIDIA's data sheet for one H100 SXM, dense rates at its 700 W
limit; a card set below that limit runs slower, so the card's limit is
stated beside every share.

Counts (``arch`` is a configuration's ``port.arch`` group):

  * model FLOPs: 2 x the non-embedding weights a token meets (the MoE
    family's ``top_k`` experts and router), plus the attention products
    QK and PV over the token's causal context, plus the head for each
    row whose logits are asked for;
  * kernel B2 (the packed GEMM) over the real rows of one call of one
    projection [K -> N] (rows of padding, which the kernel is handed
    too, count nothing): 2 rows K N integer operations; bytes, each
    once, of the activations [rows, K] at ``act_bits``, the weights
    [K, N] at ``weight_bits`` and the bfloat16 outputs [rows, N];
  * kernel B7 (the memory-packed bank unpack) of one bank [E, K, N] at
    ``bits``: its int32 words and float32 column scales read, its
    bfloat16 weights written, each once.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

PEAK_BF16_FLOP_S = 989e12
PEAK_INT8_OP_S = 1979e12
HBM_BYTES_S = 3.35e12
#: rows above which the port's packed dispatch takes kernel B2 (B1 at
#: up to 8 rows), as it stood when these counts were frozen
B2_MIN_ROWS = 9


def head_dim(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def attention_shapes(arch: dict) -> List[Tuple[int, int]]:
    """(K, N) of a layer's four attention projections."""
    d, h, kv, hd = arch["d_model"], arch["n_heads"], arch["n_kv"], \
        head_dim(arch)
    return [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]


def mlp_shapes(arch: dict) -> List[Tuple[int, int]]:
    """(K, N) of a dense layer's three MLP projections (none on the moe
    family)."""
    if arch["family"] == "moe":
        return []
    d, f = arch["d_model"], arch["d_ff"]
    return [(d, f), (d, f), (f, d)]


def packed_shapes(arch: dict) -> List[Tuple[int, int]]:
    """(K, N) of every packed (SDV) projection of one layer."""
    return attention_shapes(arch) + mlp_shapes(arch)


def bank_shapes(arch: dict) -> List[Tuple[int, int, int]]:
    """(E, K, N) of one layer's memory-packed expert banks."""
    if arch["family"] != "moe":
        return []
    e, d, f = arch["n_experts"], arch["d_model"], arch["d_ff"]
    return [(e, d, f), (e, d, f), (e, f, d)]


def layer_weights(arch: dict) -> int:
    """Non-embedding weights one token meets in one layer."""
    n = sum(k * m for k, m in attention_shapes(arch))
    if arch["family"] == "moe":
        d, f = arch["d_model"], arch["d_ff"]
        return n + arch["top_k"] * 3 * d * f + d * arch["n_experts"]
    return n + sum(k * m for k, m in mlp_shapes(arch))


def model_flops(arch: dict, *, tokens: int, context_sum: int,
                logit_rows: int) -> float:
    """FLOPs of ``tokens`` tokens whose causal contexts (keys seen,
    itself included) sum to ``context_sum``, with ``logit_rows`` rows
    through the head."""
    layers = arch["n_layers"]
    attn = 4 * arch["n_heads"] * head_dim(arch)        # QK and PV a key
    return (2.0 * tokens * layer_weights(arch) * layers
            + float(attn) * context_sum * layers
            + 2.0 * logit_rows * arch["d_model"] * arch["vocab"])


def b2_call(rows: int, k: int, n: int, weight_bits: int,
            act_bits: int) -> Dict[str, float]:
    return {"ops": 2.0 * rows * k * n,
            "bytes": (rows * k * act_bits + k * n * weight_bits) / 8.0
            + 2.0 * rows * n}


def bound_s(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time: operations at the peak rate or bytes at the
    memory's, the larger."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_S)


def b2_step_bound_s(arch: dict, rows: int, real_rows: int,
                    weight_bits: int, act_bits: int) -> float:
    """B2's bound over one model call at ``rows`` rows, ``real_rows`` of
    them real tokens: every packed projection of every layer (0 where
    the dispatch takes B1)."""
    if rows < B2_MIN_ROWS:
        return 0.0
    per_layer = 0.0
    for k, n in packed_shapes(arch):
        c = b2_call(real_rows, k, n, weight_bits, act_bits)
        per_layer += bound_s(c["ops"], c["bytes"], PEAK_INT8_OP_S)
    return per_layer * arch["n_layers"]


def b7_bank_bytes(e: int, k: int, n: int, bits: int) -> float:
    per = 32 // bits
    nw = -(-n // per)
    return 4.0 * e * k * nw + 4.0 * e * nw * per + 2.0 * e * k * n


def b7_step_bound_s(arch: dict, bits: int) -> float:
    """B7's bound over one model call: every bank of every layer
    unpacked once."""
    nbytes = sum(b7_bank_bytes(e, k, n, bits) for e, k, n in
                 bank_shapes(arch))
    return nbytes * arch["n_layers"] / HBM_BYTES_S


def context_sum(start: int, count: int) -> int:
    """Sum of the causal contexts of ``count`` tokens at positions
    start .. start + count - 1 (position p sees p + 1 keys)."""
    return count * start + count * (count + 1) // 2


def share_pct(bound: float, measured: float):
    """bound / measured in percent; None where nothing was measured."""
    if measured <= 0 or not math.isfinite(measured):
        return None
    return 100.0 * bound / measured
