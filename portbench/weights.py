"""The benchmark's weights: a decoder-only model (dense, vlm or moe
family) drawn from ``--seed`` on the device, one layer at a time.

These are an input of the benchmark, as the prompts are: the program
packs them (``serve_params``) and the plain reference draws the same
numbers again, layer by layer, and quantizes them by its own rule.  Each
layer comes from its own ``torch.Generator`` in one ``randn`` call of
the model dtype (bfloat16), which is then cut into the layer's leaves and
scaled to each leaf's standard deviation.  The tree layout is the port's
(``blocks/attn/wq/kernel``, ``blocks/moe/wi_gate``, ...); the numbers
are not the port's ``init_params`` draws.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPE = torch.bfloat16
#: generator slots: 0 the leaves outside the layers, 1 + i layer i
TOP_SLOT = 0


def vocab_padded(vocab: int) -> int:
    """Embedding and head rows padded to a multiple of 128, as the port
    lays them out."""
    return -(-vocab // 128) * 128


def head_dim(arch: dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


def generator(seed: int, slot: int, device) -> torch.Generator:
    """The generator of one slot of one seed (seeds up to 2**52)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((int(seed) % (1 << 52)) << 10) + slot)
    return gen


def top_leaves(arch: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, std) of the leaves outside the layers.  The head's
    std keeps the logits near unit spread at any width."""
    d, vp = arch["d_model"], vocab_padded(arch["vocab"])
    return [("embed", (vp, d), 0.02),
            ("ln_f/scale", (d,), -1.0),
            ("lm_head", (d, vp), 1.0 / math.sqrt(d))]


def layer_leaves(arch: dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(path, shape, std) of one layer's leaves; a norm scale has std
    -1: it is drawn as 1 + 0.1 N(0, 1)."""
    d, h, kv, hd = arch["d_model"], arch["n_heads"], arch["n_kv"], \
        head_dim(arch)
    out = [("ln_attn/scale", (d,), -1.0),
           ("attn/wq/kernel", (d, h * hd), 1 / math.sqrt(d)),
           ("attn/wk/kernel", (d, kv * hd), 1 / math.sqrt(d)),
           ("attn/wv/kernel", (d, kv * hd), 1 / math.sqrt(d)),
           ("attn/wo/kernel", (h * hd, d), 1 / math.sqrt(h * hd)),
           ("ln_mlp/scale", (d,), -1.0)]
    f = arch["d_ff"]
    if arch["family"] == "moe":
        e = arch["n_experts"]
        out += [("moe/router/kernel", (d, e), 0.01),
                ("moe/wi_gate", (e, d, f), 1 / math.sqrt(d)),
                ("moe/wi_up", (e, d, f), 1 / math.sqrt(d)),
                ("moe/wo", (e, f, d), 1 / math.sqrt(f))]
    else:
        out += [("mlp/wi_gate/kernel", (d, f), 1 / math.sqrt(d)),
                ("mlp/wi_up/kernel", (d, f), 1 / math.sqrt(d)),
                ("mlp/wo/kernel", (f, d), 1 / math.sqrt(f))]
    return out


def _draw(leaves, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One ``randn`` call for all ``leaves``, cut and scaled: a norm
    scale in float32, every other leaf in the model dtype."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    buf = torch.randn(total, generator=gen, dtype=DTYPE, device=device)
    out, o = {}, 0
    for path, shape, std in leaves:
        n = math.prod(shape)
        raw = buf[o:o + n].view(shape)
        o += n
        if std < 0:
            out[path] = 1.0 + 0.1 * raw.to(torch.float32)
        else:
            out[path] = raw * std
    return out


def draw_top(arch: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return _draw(top_leaves(arch), generator(seed, TOP_SLOT, device), device)


def draw_layer(arch: dict, seed: int, layer: int,
               device) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves by path."""
    return _draw(layer_leaves(arch), generator(seed, 1 + layer, device),
                 device)


def nest(flat: Dict[str, torch.Tensor], lead: bool = False) -> dict:
    """A path-keyed dict as the port's nested tree; ``lead`` adds a
    leading layer axis of 1 to every leaf."""
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v[None] if lead else v
    return tree
