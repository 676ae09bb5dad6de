"""Parameter-tree helpers: the leaf order of ``jax.tree_util``, in torch.

The JAX package flattens its trees with ``jax.tree_util``; the port's
optimizer walks its moments in that order and its checkpoints store
``leaves.npz`` in it, so either package restores the other's files.
The order is defined here once:

  * a dict: its values in sorted key order;
  * a list or tuple (a ``NamedTuple`` such as the optimizer's ``Q8``
    too): its items in order;
  * a registered container (``register_container``: the QAT
    ``QATLinear``, the quantizer's ``QuantizedTensor``): its data
    fields in their declared order, the other fields carried as they
    are (``jax.tree_util.register_dataclass``);
  * ``None``: no leaf;
  * anything else is one leaf.

``is_leaf`` stops the walk at a node, as ``jax.tree_util``'s does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

_CONTAINERS: Dict[type, Sequence[str]] = {}


def register_container(cls: type, data_fields: Sequence[str]) -> type:
    """Make the dataclass ``cls`` a tree node whose children are
    ``data_fields``, in that order."""
    _CONTAINERS[cls] = tuple(data_fields)
    return cls


def _children(node) -> Optional[List[Any]]:
    """The children of a tree node in leaf order, or None for a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(node)
    fields = _CONTAINERS.get(type(node))
    if fields is not None:
        return [getattr(node, f) for f in fields]
    return None


def _rebuild(node, children: List[Any]):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (list, tuple)):
        return type(node)(children)
    return dataclasses.replace(
        node, **dict(zip(_CONTAINERS[type(node)], children)))


def leaves(tree, is_leaf: Optional[Callable[[Any], bool]] = None
           ) -> List[Any]:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) \
        else _children(tree)
    if kids is None:
        return [tree]
    out: List[Any] = []
    for kid in kids:
        out += leaves(kid, is_leaf)
    return out


def unflatten(template, new_leaves: Sequence[Any],
              is_leaf: Optional[Callable[[Any], bool]] = None):
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (``jax.tree_util.tree_unflatten``)."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(k) for k in kids])

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree,
             is_leaf: Optional[Callable[[Any], bool]] = None):
    """``fn`` applied to every leaf, the structure kept."""
    return unflatten(tree, [fn(x) for x in leaves(tree, is_leaf)], is_leaf)
