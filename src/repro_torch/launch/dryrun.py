"""Multi-pod dry run — torch port of ``repro.launch.dryrun``.

Builds each (arch x shape) cell for the production meshes — a (16, 16)
("data", "model") mesh of 256 ranks and a (2, 16, 16) ("pod", "data",
"model") mesh of 512 — as ``meta`` tensors (nothing is allocated) with
the ``Sharding`` of every argument, and reckons the JAX package's
fields, which it reads from XLA's partitioned program, from torch's own:

  * ``argument_bytes``: the bytes of the arguments one rank holds,
    reckoned from each leaf's placements (a dimension sharded over mesh
    dimensions of sizes a, b, ... holds ceil(n / (a b ...)) entries);
  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the
    cell's function on the ``meta`` arguments — the matmul-class
    operations (matmuls, batched matmuls, einsums) of the whole global
    batch; elementwise work is not counted.  ``flops_per_device`` is
    that count split evenly over the ranks.  The serve cells hold
    memory-packed trees (``serve_params(bits=cfg.serve_weight_bits)``);
    on ``meta`` tensors the packed dispatch takes the plain route, as on
    the CPU (a shape walk, no card), and its unpack does no matmul;
  * one rank's memory, bytes and collectives (``reckon_rank``): the
    cell's function runs once more on the arguments placed as ``meta``
    ``DTensor``s by their shardings, as the mesh step runs, and
    ``RankReckoner`` sees every op of rank 0's program on its local
    tensors.  ``peak_bytes``: the most bytes of live storage, the
    arguments included, at any op — autograd's saved tensors stay live
    until the backward pass frees them, so rematerialization shows
    here; ``temp_bytes`` = ``peak_bytes - argument_bytes``;
    ``output_bytes``: the storages of the function's outputs;
    ``collectives``: the operand bytes of each collective op, under the
    reference's HLO names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``), summed in
    ``collective_bytes_per_device``; ``bytes_per_device``: every
    op's operands and results, each tensor once an op, views excluded
    — unfused, so an upper bound on XLA's fused "bytes accessed";
  * the skip rules (``cfg.shape_supported``).

The meshes are ``DeviceMesh``es over torch's fake process group
(``torch.testing._internal.distributed.fake_pg``): one process stands in
for every rank (rank 0), and no collective moves data.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      tinyllama-1.1b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import weakref

import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from .. import tree
from ..configs.base import SHAPES, ArchConfig, ShapeCell
from ..configs.registry import ARCHS, get_arch
from ..models import (cache_specs, decode_step, forward, init_cache,
                      init_params, serve_params, shard_ctx)
from ..models.param import PartitionSpec, is_p, specs, values
from ..train import loop, optimizer
from .mesh import (batch_shardings, distribute, make_production_mesh,
                   rules_for_batch, serve_specs, shardings_of)

META = torch.device("meta")

#: the functional collectives DTensor runs, by the reference's HLO names
COLLECTIVE_NAMES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def abstract_batch(cfg: ArchConfig, b: int, s: int, *, kind: str):
    f32, i32 = torch.float32, torch.int32

    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)

    if kind == "decode":
        return {"tokens": t((b, 1), i32)}
    if cfg.family == "encdec":
        s_src = s // 2
        return {"src": t((b, s_src, cfg.d_model), f32),
                "tokens": t((b, s - s_src), i32)}
    if cfg.family == "vlm":
        return {"tokens": t((b, s - cfg.n_patches), i32),
                "patches": t((b, cfg.n_patches, cfg.d_model), f32)}
    return {"tokens": t((b, s), i32)}


def opt_spec_tree(ocfg: optimizer.OptConfig, params_p):
    """The spec tree of ``optimizer.init``'s state: each moment has its
    parameter's spec; an 8-bit moment's ``scale`` drops the last axis."""
    def f(p):
        v, sp = p.value, p.spec
        if ocfg.moments_8bit and v.ndim >= 1 and v.numel() >= 4096:
            full = list(sp) + [None] * (v.ndim - len(sp))
            return optimizer.Q8(q=PartitionSpec(*full),
                                scale=PartitionSpec(*full[:-1], None))
        return sp
    m = tree.tree_map(f, params_p, is_leaf=is_p)
    return {"m": m, "v": m, "step": PartitionSpec()}


def build_cell(cfg: ArchConfig, shape: ShapeCell, mesh):
    """Returns (rules, fn, args, in_shardings, donate) for one cell;
    ``args`` are ``meta`` tensors."""
    # batch=1 cells (long_500k) cannot shard the batch axis; degrade to
    # replicated batch (the O(1)-state archs this shape targets don't
    # need it)
    rules = rules_for_batch(mesh, shape.global_batch, fsdp=cfg.fsdp)
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        params_p = init_params(cfg, device=META, rules=rules)
        pvals, pspecs = values(params_p), specs(params_p)
        ocfg = optimizer.OptConfig(moments_8bit=cfg.opt_8bit,
                                   total_steps=10000)
        opt_abs = optimizer.init(ocfg, pvals)
        opt_specs = opt_spec_tree(ocfg, params_p)
        batch = abstract_batch(cfg, b, s, kind="train")
        fn = loop.make_train_step(cfg, ocfg,
                                  microbatches=cfg.train_microbatches)
        in_sh = (shardings_of(mesh, pspecs), shardings_of(mesh, opt_specs),
                 batch_shardings(mesh, rules, batch))
        return rules, fn, (pvals, opt_abs, batch), in_sh, (0, 1)

    # serving paths run on quantized lane-packed weights (the paper's
    # packing applied to the HBM layout)
    pvals, qspecs = serve_specs(cfg, rules)
    qvals = serve_params(pvals, bits=cfg.serve_weight_bits)

    if shape.kind == "prefill":
        batch = abstract_batch(cfg, b, s, kind="prefill")

        def fn(p, bt):
            return forward(cfg, p, bt, diff=False, mode="last_logits")
        in_sh = (shardings_of(mesh, qspecs),
                 batch_shardings(mesh, rules, batch))
        return rules, fn, (qvals, batch), in_sh, ()

    if shape.kind == "decode":
        cvals = init_cache(cfg, b, s, device=META)
        cspecs = cache_specs(cfg, rules, b, s)
        batch = abstract_batch(cfg, b, s, kind="decode")

        def fn(p, c, t):
            return decode_step(cfg, p, c, t["tokens"])
        in_sh = (shardings_of(mesh, qspecs), shardings_of(mesh, cspecs),
                 batch_shardings(mesh, rules, batch))
        return rules, fn, (qvals, cvals, batch), in_sh, (1,)

    raise ValueError(shape.kind)


def per_device_bytes(args, in_sh) -> int:
    """The bytes of ``args`` one rank holds under ``in_sh``."""
    from torch.distributed.tensor import Shard
    total = 0
    for v, sh in zip(tree.leaves(args), tree.leaves(in_sh)):
        mesh_shape = tuple(sh.mesh.shape)
        local = list(v.shape)
        for i, pl in enumerate(sh.placements):
            if isinstance(pl, Shard):
                local[pl.dim] = -(-local[pl.dim] // mesh_shape[i])
        total += math.prod(local) * v.element_size()
    return total


def count_flops(fn, args) -> int:
    """Matmul-class flops of ``fn(*args)`` on ``meta`` tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


_WAIT = torch.ops._c10d_functional.wait_tensor.default


def _tensors(xs):
    """The tensors among ``xs`` and in its lists and tuples (an op's
    arguments or results)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class RankReckoner(TorchDispatchMode):
    """One rank's memory, bytes and collectives of a function run on
    ``meta`` ``DTensor``s (or plain ``meta`` tensors).  A ``DTensor`` op
    is handed back to ``DTensor`` (``NotImplemented``), whose local ops —
    the rank's own program, the functional collectives included — then
    come here; ops under ``DTensor``'s sharding propagation (a fake mode
    of its own) are not the program's and are skipped.

    ``live`` counts the storages ``hold`` has seen (every op's outputs,
    and what the caller holds before) until each is freed; ``peak`` is
    its largest value.  ``bytes`` sums every op's operands and results,
    each tensor once an op, views and the collectives' waits excluded;
    ``collectives`` the operand bytes of each collective op by its
    reference name, ``operands`` (name, shape, dtype) of each collective
    op's operands in order."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.bytes = 0
        self.collectives = {}
        self.operands = []
        self._held = WeakIdKeyDictionary()

    def hold(self, t):
        """Count the storage of the ``meta`` tensor ``t`` as live until
        it is freed (at its new size where an op resized it)."""
        if t.device != META:
            return
        st = t.untyped_storage()
        size = self._held.get(st)
        if size is None:
            size = self._held[st] = [0]
            weakref.finalize(st, self._free, size)
        n = st.nbytes()
        if n != size[0]:
            self.live += n - size[0]
            size[0] = n
            self.peak = max(self.peak, self.live)

    def _free(self, size):
        self.live -= size[0]

    def __enter__(self):
        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            self.hold(t)
        if func.is_view or func == _WAIT:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        seen = {}
        for t in ins + outs:
            seen.setdefault(id(t), t.numel() * t.element_size())
        self.bytes += sum(seen.values())
        name = COLLECTIVE_NAMES.get(func._overloadpacket.__name__) \
            if func.namespace == "_c10d_functional" else None
        if name is not None:
            self.collectives[name] = self.collectives.get(name, 0) + sum(
                t.numel() * t.element_size() for t in ins)
            self.operands += [(name, tuple(t.shape), t.dtype) for t in ins]
        return out


def reckon_rank(rules, fn, args, in_sh, rk=None) -> dict:
    """One rank's ``peak_bytes``, ``output_bytes``, ``collectives``,
    ``collective_bytes_per_device`` and ``bytes_per_device`` of
    ``fn(*args)``, run on ``args`` placed by ``in_sh`` as ``meta``
    ``DTensor``s under ``rules`` (``rk``, a fresh ``RankReckoner`` by
    default)."""
    dargs = distribute(args, in_sh)
    rk = RankReckoner() if rk is None else rk
    for leaf in tree.leaves(dargs):
        rk.hold(_local(leaf))
    with shard_ctx.use_rules(rules), rk:
        out = fn(*dargs)
    stores = {}
    for leaf in tree.leaves(out):
        if isinstance(leaf, torch.Tensor):
            st = _local(leaf).untyped_storage()
            stores[id(st)] = st.nbytes()
    return {"peak_bytes": rk.peak,
            "output_bytes": sum(stores.values()),
            "collectives": dict(sorted(rk.collectives.items())),
            "collective_bytes_per_device": sum(rk.collectives.values()),
            "bytes_per_device": rk.bytes}


def cache_collectives(rk: RankReckoner, cache, cache_sh) -> list:
    """The collective operands ``rk`` saw that have the shape of one
    layer's local shard of a cache leaf, in any dtype (the dequantized
    K/V too) and with the one-long dimensions dropped (an einsum's
    operands); a shard of fewer than two dimensions longer than one (the
    position vector, one row's state) is left out.  A decode step that
    keeps its cache in place has none."""
    from torch.distributed.tensor import Shard

    def key(shape):
        return tuple(d for d in shape if d != 1)
    leaves = set()
    for v, sh in zip(tree.leaves(cache), tree.leaves(cache_sh)):
        local = list(v.shape)
        for i, pl in enumerate(sh.placements):
            if isinstance(pl, Shard):
                local[pl.dim] = -(-local[pl.dim] // tuple(sh.mesh.shape)[i])
        if len(key(local[1:])) > 1:
            leaves.add(key(local[1:]))
    return [op for op in rk.operands if key(op[1]) in leaves]


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A fake process group of ``n_ranks`` ranks for this process (rank
    0), destroyed on exit: enough to build a ``DeviceMesh`` of that
    size; no collective runs."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def measure_cell(cfg: ArchConfig, shape: ShapeCell, mesh, rk=None) -> dict:
    """Build one cell on ``mesh`` and reckon its numbers (``rk``: the
    ``RankReckoner`` to reckon with, a fresh one by default)."""
    t0 = time.time()
    rules, fn, args, in_sh, donate = build_cell(cfg, shape, mesh)
    train = shape.kind == "train"
    with torch.set_grad_enabled(train):
        with shard_ctx.use_rules(rules):
            flops = count_flops(fn, args)
        rank = reckon_rank(rules, fn, args, in_sh, rk)
    n_dev = math.prod(tuple(mesh.shape))
    arg_bytes = per_device_bytes(args, in_sh)
    return {
        "status": "ok",
        "build_s": round(time.time() - t0, 1),
        "devices": n_dev,
        "donate": list(donate),
        "flops": flops,
        "flops_per_device": flops / n_dev,
        "argument_bytes": arg_bytes,
        **rank,
        "temp_bytes": rank["peak_bytes"] - arg_bytes,
        "notes": ("flops: matmul-class ops of the whole global batch "
                  "(torch.utils.flop_counter), per device an even split; "
                  + ("forward and backward of every microbatch, the "
                     "optimizer update is elementwise (not counted)"
                     if train else
                     "the packed weights are dequantized by the plain "
                     "route on meta tensors, which does no matmul")
                  + ". Memory, bytes and collectives: rank 0's program "
                  "run once on meta DTensors over the fake process "
                  "group; peak_bytes the most live storage at any op, "
                  "the arguments included (the step's arguments stay "
                  "live beside its outputs: nothing is donated), "
                  "temp_bytes the peak less argument_bytes, "
                  "output_bytes the outputs' storages; collectives: "
                  "each collective op's operand bytes on the rank (a "
                  "CPU mesh: DTensor gathers where a card's mesh would "
                  "all-to-all); bytes_per_device: every op's operands "
                  "and results once each, views excluded, unfused, so "
                  "an upper bound on XLA's fused bytes accessed"),
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             verbose: bool = True) -> dict:
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    okay, why = cfg.shape_supported(shape)
    if not okay:
        return {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        res = {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
               **measure_cell(cfg, shape, mesh)}
    if verbose:
        print(f"[{res['arch']} x {shape_name} x {mesh_name}] "
              f"build {res['build_s']}s  flops {res['flops']:.3e} "
              f"(/dev {res['flops_per_device']:.3e})  "
              f"args/dev {res['argument_bytes'] / 2**30:.2f} GiB  "
              f"peak/dev {res['peak_bytes'] / 2**30:.2f} GiB  "
              f"collectives/dev "
              f"{res['collective_bytes_per_device'] / 2**30:.2f} GiB")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry run")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    results = []
    for a in archs:
        for sh in shapes:
            for mp in meshes:
                try:
                    res = run_cell(a, sh, multi_pod=mp)
                except Exception as e:  # noqa: BLE001 — report, go on
                    res = {"arch": a, "shape": sh,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "fail",
                           "error": f"{type(e).__name__}: {e}"}
                    print(f"[{a} x {sh} x {res['mesh']}] FAIL: "
                          f"{res['error']}", file=sys.stderr)
                    n_fail += 1
                results.append(res)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res) + "\n")
    okc = sum(1 for r in results if r["status"] == "ok")
    skc = sum(1 for r in results if r["status"] == "skipped")
    print(f"\ndry-run: {okc} ok, {skc} skipped, {n_fail} failed "
          f"of {len(results)} cells")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
