"""Production mesh construction + logical sharding rules — torch port of
``repro.launch.mesh``.

``make_production_mesh`` is a function (not a module constant) so that
importing this module never touches the process group.  Meshes are
``torch.distributed.device_mesh.DeviceMesh``; a sharding is a
``Sharding(mesh, placements)``, the DTensor placements of one leaf (the
JAX package's ``NamedSharding``).  ``rules_for_mesh`` reads only the
mesh's dimension names and sizes, so a stand-in object with
``mesh_dim_names`` and ``shape`` serves too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

from .. import tree
from ..models.param import PartitionSpec, Rules, is_spec, specs, values
from ..models.shard_ctx import placements

PRODUCTION_SHAPE = (16, 16)
MULTI_POD_SHAPE = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) ("pod",
    "data", "model") with ``multi_pod``.  The process group must hold
    256 (512) ranks; the dry run builds it from a fake process group."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = MULTI_POD_SHAPE if multi_pod else PRODUCTION_SHAPE
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{dimension name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def rules_for_mesh(mesh, *, fsdp: bool = False) -> Rules:
    """Logical->physical mapping for the given mesh."""
    sizes = axis_sizes(mesh)
    batch = ("pod", "data") if "pod" in sizes else ("data",)
    bdeg = 1
    for ax in batch:
        bdeg *= sizes[ax]
    return Rules(
        tp="model" if "model" in sizes else None,
        fsdp="data" if fsdp and "data" in sizes else None,
        ep="model" if "model" in sizes else None,
        batch=batch,
        tp_degree=sizes.get("model", 1),
        batch_degree=bdeg,
    )


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The placement of one leaf: its mesh and one DTensor placement per
    mesh dimension (``Shard(d)`` or ``Replicate()``)."""
    mesh: Any
    placements: Tuple[Any, ...]
    spec: PartitionSpec


def sharding(mesh, spec: PartitionSpec) -> Sharding:
    """The ``Sharding`` of ``spec`` on ``mesh``.  A mesh dimension of one
    rank replicates: it shards nothing, and ``DTensor``'s view rules
    cannot squeeze a one-long dimension sharded over it (one KV head on
    a one-rank model axis)."""
    from torch.distributed.tensor import Replicate
    pls = placements(mesh.mesh_dim_names, spec, len(spec))
    return Sharding(mesh, tuple(p if n > 1 else Replicate() for p, n in
                                zip(pls, tuple(mesh.shape))), spec)


def shardings_of(mesh, spec_tree):
    """PartitionSpec tree -> ``Sharding`` tree."""
    return tree.tree_map(lambda s: sharding(mesh, s), spec_tree, is_spec)


def batch_shardings(mesh, rules: Rules, batch_tree) -> Dict:
    """Shard every batch leaf along its leading (batch) axis."""
    def spec_for(x):
        lead = tuple(rules.batch) if rules.batch else None
        return sharding(mesh, PartitionSpec(lead, *([None] * (x.ndim - 1))))
    return tree.tree_map(spec_for, batch_tree)


def distribute(value_tree, sharding_tree):
    """Place every leaf of ``value_tree`` (full tensors, the same on
    every rank) as a ``DTensor`` by its ``Sharding``: each rank keeps
    its own shard, no collective runs."""
    from torch.distributed.tensor import distribute_tensor

    def put(v, s):
        return distribute_tensor(v, s.mesh, list(s.placements),
                                 src_data_rank=None)
    vals = tree.leaves(value_tree)
    shs = tree.leaves(sharding_tree)
    if len(vals) != len(shs):
        raise ValueError(f"{len(vals)} leaves but {len(shs)} shardings: the "
                         "trees differ")
    return tree.unflatten(value_tree, [put(v, s) for v, s in
                                       zip(vals, shs)])


def rules_for_batch(mesh, batch_size: int, *, fsdp: bool = False) -> Rules:
    """``rules_for_mesh`` for a batch of ``batch_size`` rows: a batch the
    batch axes do not divide (long_500k's one row), or batch axes of one
    rank, is replicated instead (a DTensor cannot squeeze a sharded
    batch dimension of one row)."""
    rules = rules_for_mesh(mesh, fsdp=fsdp)
    sizes = axis_sizes(mesh)
    bsize = 1
    for ax in rules.batch:
        bsize *= sizes[ax]
    if batch_size % max(1, bsize) or bsize == 1:
        rules = dataclasses.replace(rules, batch=(), batch_degree=1)
    return rules


def serve_specs(cfg, rules: Rules, min_size: int = 1 << 16):
    """(float shapes, ``PartitionSpec`` tree) of ``serve_params(
    init_params(cfg), bits=cfg.serve_weight_bits, min_size=min_size)``
    under ``rules``: the memory-packed tree's specs, built on ``meta``
    (nothing drawn)."""
    from ..models import init_params, serve_param_specs
    params_p = init_params(cfg, device="meta", rules=rules)
    pvals = values(params_p)
    return pvals, serve_param_specs(pvals, specs(params_p),
                                    cfg.serve_weight_bits, min_size)


def place_decode(mesh, cfg, params, cache, batch, *,
                 min_size: int = 1 << 16):
    """A memory-packed serve tree (``serve_params(..., bits=
    cfg.serve_weight_bits, min_size=min_size)``), a decode cache and a
    batch, full tensors the same on every rank, placed on ``mesh`` as
    ``DTensor``s: the tree by ``serve_param_specs``, the cache by
    ``cache_specs``, the batch along its leading axis.  Returns (rules,
    params, cache, batch); run the model under
    ``shard_ctx.use_rules(rules)``."""
    from ..models import cache_specs
    b = cache["index"].shape[0]
    rules = rules_for_batch(mesh, b, fsdp=cfg.fsdp)
    qspecs = serve_specs(cfg, rules, min_size)[1]
    cspecs = cache_specs(cfg, rules, b, 0)     # specs do not depend on s
    return (rules, distribute(params, shardings_of(mesh, qspecs)),
            distribute(cache, shardings_of(mesh, cspecs)),
            distribute(batch, batch_shardings(mesh, rules, batch)))
