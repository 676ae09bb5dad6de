"""Activation-sharding context — torch port of
``repro.models.shard_ctx``.

Launchers (train, dryrun) install the active ``Rules``; layers call
``constrain(x, ...logical axes...)`` at the standard cut points.  With
no rules installed (unit tests, one device), or on a plain tensor, it
returns ``x`` unchanged, so model code never depends on a mesh being
present and the single-device paths are untouched.  On a ``DTensor``
it redistributes to the placements the rules resolve on the tensor's
own ``DeviceMesh`` (``jax.lax.with_sharding_constraint``).

The rest is the ``DTensor`` plumbing that GSPMD does implicitly:
``placements`` (a spec as DTensor placements), ``replicated_like`` (a
plain tensor the model makes, as a replicated operand), ``batch_local``
(a function run per rank on its batch rows), ``replicate`` and
``gather_to_batch`` (the all-gathers before an op that has no sharding
rule for a sharded operand), ``split_heads`` (a projection's output as
heads), ``follow`` (a tensor put on another's shards), ``einsum``
(an einsum on the local shards),
``split_microbatches`` (each rank's batch rows split into microbatches)
and ``placed_as`` (a gradient reduced into its parameter's placements).
Each but the two splits returns a plain tensor unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from .param import PartitionSpec, Rules

_ACTIVE: list = [None]


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    _ACTIVE.append(rules)
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_rules() -> Optional[Rules]:
    return _ACTIVE[-1]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)



def placements(dim_names: Sequence[str], spec: PartitionSpec, ndim: int):
    """A spec on a tensor of ``ndim`` dimensions -> one DTensor placement
    per mesh dimension (``dim_names``): ``Shard(d)`` on each mesh
    dimension that entry ``d`` names (an entry of several names shards
    that tensor dimension over each of them, major first), else
    ``Replicate()``.  A name the mesh lacks is not sharded over."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(dim_names)
    for d, entry in enumerate(tuple(spec)[:ndim]):
        for name in (entry,) if isinstance(entry, str) else (entry or ()):
            if name in dim_names:
                i = list(dim_names).index(name)
                if out[i] != Replicate():
                    raise ValueError(f"mesh axis {name!r} shards two "
                                     f"dimensions of {spec}")
                out[i] = Shard(d)
    return tuple(out)


def constrain(x, *axes):
    """with_sharding_constraint on logical axes (no-op without rules or
    on a plain tensor)."""
    rules = active_rules()
    if rules is None or not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(mesh.mesh_dim_names, rules.resolve(axes), x.ndim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def replicated_like(t: torch.Tensor, ref):
    """``t`` (a plain tensor the model code makes: positions, masks, the
    streaming softmax's running state) as a replicated ``DTensor`` on
    ``ref``'s mesh when ``ref`` is a ``DTensor``, else ``t`` itself: a
    DTensor op refuses a plain operand that is not a scalar."""
    if not is_dtensor(ref) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _batch_placements(x):
    """``x``'s placements with every mesh dimension replicated but those
    that shard its batch dimension (0)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in x.placements)


def replicate(x):
    """A ``DTensor`` replicated on every mesh dimension (the all-gather
    before an op whose sharding rule a sharded operand breaks: the
    embedding lookup's indices); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    want = (Replicate(),) * x.device_mesh.ndim
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def gather_to_batch(x):
    """A ``DTensor`` sharded on its batch dimension alone (every other
    mesh dimension replicated); a plain tensor as it is.  For the ops
    that have no sharding rule on a sharded inner dimension (the cross
    entropy's gather over a vocab-sharded logits tensor): GSPMD inserts
    the same all-gather."""
    if not is_dtensor(x):
        return x
    want = _batch_placements(x)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def batch_local(fn, *xs):
    """``fn(*xs)`` on the batch rows this rank holds, for a function that
    treats its inputs' batch rows (dimension 0) independently.  Plain
    tensors go straight in.  ``DTensor``s are first replicated on every
    mesh dimension but those that shard the first one's batch dimension
    (GSPMD inserts the same all-gather), then ``fn`` runs on the local
    tensors and its output becomes a ``DTensor`` of those placements —
    a ``shard_map`` over the batch axes.  The streaming attention goes
    through here: its chunk loop (padding, slicing, masks, running
    state) has no sharding rules to propagate."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import DTensor
    mesh = xs[0].device_mesh
    want = _batch_placements(xs[0])
    local = [x.redistribute(mesh, want).to_local() for x in xs]
    return DTensor.from_local(fn(*local), mesh, want, run_check=False)


def follow(x, ref, dims):
    """``x`` redistributed to ``ref``'s shards when both are ``DTensor``s:
    on each mesh dimension where ``ref`` is ``Shard(d)``, ``x`` becomes
    ``Shard(dims[d])`` (``Replicate()`` where ``dims`` has no d, on the
    mesh dimensions ``ref`` replicates, and on a mesh dimension of one
    rank, where a shard of a one-long dimension cannot be squeezed).
    Else ``x`` itself.  The decode attention puts its queries and new
    K/V on the KV cache's batch and head shards, so that its writes and
    products run where the cache lies."""
    if not is_dtensor(x) or not is_dtensor(ref):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh = ref.device_mesh
    want = tuple(Shard(dims[p.dim])
                 if isinstance(p, Shard) and p.dim in dims and mesh.size(i) > 1
                 else Replicate() for i, p in enumerate(ref.placements))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def einsum(eq: str, *xs, like=None):
    """``torch.einsum(eq, *xs)``; where ``like`` = (tensor, its letters)
    is a ``DTensor``, computed on each rank's local tensors (DTensor's
    einsum decomposes into views whose sharding rules differ between
    torch releases).  Every operand is first put on ``like``'s shards: a
    mesh dimension that shards letter L of ``like`` shards L in every
    operand that has it and replicates the others.  The result is a
    ``DTensor`` sharded on its own letters, and ``Partial`` (a sum over
    that mesh dimension) where a contracted letter is sharded."""
    if like is None or not is_dtensor(like[0]):
        return torch.einsum(eq, *xs)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ref, letters = like
    mesh = ref.device_mesh
    cut = [letters[p.dim] if isinstance(p, Shard) and mesh.size(i) > 1
           else None for i, p in enumerate(ref.placements)]
    specs, out = eq.replace(" ", "").split("->")
    sizes, local = {}, []
    for x, spec in zip(xs, specs.split(",")):
        x = replicated_like(x, ref)
        want = tuple(Shard(spec.index(c)) if c is not None and c in spec
                     else Replicate() for c in cut)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        sizes.update(zip(spec, x.shape))
        local.append(x.to_local())
    shape = torch.Size([sizes[c] for c in out])
    pls = [Replicate() if c is None else Shard(out.index(c)) if c in out
           else Partial() for c in cut]
    # contiguous: the global stride given below is the row-major one
    return DTensor.from_local(torch.einsum(eq, *local).contiguous(), mesh,
                              pls, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def split_heads(x, n: int, hd: int):
    """x [..., n * hd] as [..., n, hd].  A ``DTensor`` sharded along its
    last dimension over a mesh dimension that does not divide n is first
    replicated along that mesh dimension: GSPMD shards the heads and the
    head dimension together there, a ``DTensor`` placement names one
    dimension (the all-gather ``batch_local`` makes next)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        mesh, last = x.device_mesh, x.ndim - 1
        want = tuple(Replicate() if p == Shard(last) and n % mesh.size(i)
                     else p for i, p in enumerate(x.placements))
        if want != tuple(x.placements):
            x = x.redistribute(mesh, want)
    return x.reshape(tuple(x.shape[:-1]) + (n, hd))


def split_microbatches(x, n: int):
    """``x`` [B, ...] as [n, B / n, ...], microbatch i in row i.  A plain
    tensor is reshaped: microbatch i holds rows i B / n ... of it.  A
    ``DTensor`` is split on each rank, no collective: microbatch i holds
    rows i b / n ... of the b rows each rank holds, the batch placements
    moved to dimension 1, so every microbatch is sharded along the batch
    axes as the batch was (data-parallel microbatching; on a one-rank
    mesh the plain split)."""
    if not is_dtensor(x):
        b = x.shape[0]
        assert b % n == 0, (b, n)
        return x.reshape((n, b // n) + tuple(x.shape[1:]))
    from torch.distributed.tensor import DTensor, Shard
    local = x.to_local()
    lb = local.shape[0]
    assert lb % n == 0, (tuple(x.shape), lb, n)
    local = local.reshape((n, lb // n) + tuple(local.shape[1:]))
    moved = [Shard(p.dim + 1) if isinstance(p, Shard) else p
             for p in x.placements]
    shape = (n, x.shape[0] // n) + tuple(x.shape[1:])
    return DTensor.from_local(local, x.device_mesh, moved, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def placed_as(g, p):
    """``g`` (a gradient) with the placements of ``p`` (its parameter)
    when both are ``DTensor``s: a gradient comes out of autograd partial
    over the axes its parameter is replicated on, and the optimizer
    keeps every state in the parameter's placements (GSPMD's
    out_shardings do the same reduction).  Else ``g`` itself."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def tp_size() -> int:
    r = active_rules()
    return getattr(r, "tp_degree", 1) if r is not None else 1
