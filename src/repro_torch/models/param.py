"""Parameter sharding metadata — torch port of ``repro.models.param``.

Every init call of the layers names the logical axes of its parameter.
Under ``Rules`` an init builds a tree whose leaves are ``P(value,
spec)``: ``value`` is a tensor (a ``meta`` tensor for the abstract tree
of the dry run: nothing is allocated), ``spec`` the ``PartitionSpec``
on the production mesh.  Without rules the init builds the plain value
tree, the same draws.

Logical axes used by the layers:
  "tp"    tensor-parallel dimension        -> mesh "model"
  "fsdp"  ZeRO-3 parameter shard dimension -> mesh "data" (large archs)
  "ep"    expert-parallel dimension        -> mesh "model"
  "batch" the batch dimension              -> ("data",) or ("pod", "data")
Resolution happens at init time through ``Rules``.  The parameter
factory itself is ``layers.Init``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

from .. import tree


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (not sharded), a mesh
    axis name, or a tuple of names (the dimension sharded over several
    mesh axes, major first).  Trailing dimensions left out are not
    sharded.  A tuple, so ``tree`` walks it as a node: pass
    ``is_leaf=is_spec`` to keep it whole."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass
class P:
    value: Any
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical -> physical axis mapping for one launch configuration."""
    tp: Optional[str] = "model"
    fsdp: Optional[str] = None           # "data" enables ZeRO-3 sharding
    ep: Optional[str] = "model"
    batch: Sequence[str] = ("data",)     # ("pod", "data") on multi-pod
    tp_degree: int = 1                   # mesh size along the tp axis
    batch_degree: int = 1                # product of batch-axis sizes

    def resolve(self, axes: Sequence[Optional[str]]) -> PartitionSpec:
        out = []
        for a in axes:
            if a is None:
                out.append(None)
            elif a == "tp":
                out.append(self.tp)
            elif a == "fsdp":
                out.append(self.fsdp)
            elif a == "ep":
                out.append(self.ep)
            elif a == "batch":
                out.append(tuple(self.batch) if self.batch else None)
            else:
                raise ValueError(f"unknown logical axis {a}")
        return PartitionSpec(*out)

    def batch_spec(self, *trailing: Optional[str]) -> PartitionSpec:
        return PartitionSpec(tuple(self.batch), *trailing)


def is_p(x) -> bool:
    return isinstance(x, P)


def values(t):
    """P tree -> value tree."""
    return tree.tree_map(lambda p: p.value, t, is_leaf=is_p)


def specs(t):
    """P tree -> PartitionSpec tree."""
    return tree.tree_map(lambda p: p.spec, t, is_leaf=is_p)
