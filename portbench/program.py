"""The system under test as the benchmark drives it: the port's
``ArchConfig`` from a configuration file, and its serve tree packed from
the benchmark's own weights one layer at a time (the float tree of a
large model never exists whole on the card).

Only ``repro_torch`` is imported here, and only inside functions.
"""
from __future__ import annotations

import contextlib

import torch

from . import weights as W


def arch_config(config: dict):
    """The port's ``ArchConfig`` of a configuration file's
    ``port.arch`` group."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**config["port"]["arch"])


def serve_tree(config: dict, seed: int, device, *, act_bits=None) -> dict:
    """``serve_params`` of the seed's weights, packed a layer at a time
    and stacked: the leaves outside the layers, then each layer drawn
    with a layer axis of 1, packed, and copied into stacks made after
    the first.  ``act_bits`` overrides the configuration's (the
    control's lower precision)."""
    from repro_torch import tree
    from repro_torch.models import serve_params
    port = config["port"]
    arch = port["arch"]
    kw = dict(bits=port["weight_bits"], compute=port["compute"],
              act_bits=port["act_bits"] if act_bits is None else act_bits)
    n = arch["n_layers"]
    min_size = port.get("min_size", 1 << 16)
    out = serve_params(W.nest(W.draw_top(arch, seed, device)),
                       min_size=min_size, **kw)
    stacks = None
    for i in range(n):
        part = serve_params(
            {"blocks": W.nest(W.draw_layer(arch, seed, i, device),
                              lead=True)},
            min_size=-(-min_size // n), **kw)
        if stacks is None:
            stacks = tree.tree_map(
                lambda a: a.new_empty((n,) + tuple(a.shape[1:])), part)
        for dst, src in zip(tree.leaves(stacks), tree.leaves(part)):
            dst[i] = src[0]
        del part
    out.update(stacks)
    return out


def greedy(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """[B, 1, V_pad] logits -> [B, 1] int32 tokens, the best of the real
    vocabulary."""
    return torch.argmax(logits[:, -1:, :vocab], dim=-1).to(torch.int32)


@contextlib.contextmanager
def expert_choices():
    """Record the expert choices of every MoE call the program makes
    while the block runs: the ``top_e`` [T, k] that
    ``repro_torch.models.layers.moe_route`` returns, kept as returned
    (no copy, no device work), in call order."""
    from repro_torch.models import layers
    orig = layers.moe_route
    calls = []

    def spy(params, cfg, xt):
        out = orig(params, cfg, xt)
        calls.append(out[0])
        return out
    layers.moe_route = spy
    try:
        yield calls
    finally:
        layers.moe_route = orig
