"""Multi-pod dry run — torch port of ``repro.launch.dryrun``.

Builds each (arch x shape) cell for the production meshes — a (16, 16)
("data", "model") mesh of 256 ranks and a (2, 16, 16) ("pod", "data",
"model") mesh of 512 — as ``meta`` tensors (nothing is allocated) with
the ``Sharding`` of every argument, and reports what maps to torch:

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
  * the skip rules (``cfg.shape_supported``).

The JAX package's other fields come from XLA's partitioned program
(``compiled.cost_analysis()``, the collective ops of the optimized HLO,
``memory_analysis()``); torch has no partitioned program of the cell to
read them from, so they are ``null`` here, with the reason in
``null_reasons``.  The meshes are ``DeviceMesh``es over torch's fake
process group (``torch.testing._internal.distributed.fake_pg``): one
process stands in for every rank, and no collective runs.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      tinyllama-1.1b --shape train_4k --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time

import torch

from .. import tree
from ..configs.base import SHAPES, ArchConfig, ShapeCell
from ..configs.registry import ARCHS, get_arch
from ..models import (cache_specs, decode_step, forward, init_cache,
                      init_params, serve_param_specs, serve_params,
                      shard_ctx)
from ..models.param import PartitionSpec, is_p, specs, values
from ..train import loop, optimizer
from .mesh import (axis_sizes, batch_shardings, make_production_mesh,
                   rules_for_mesh, shardings_of)

META = torch.device("meta")

#: the JAX package's fields that only XLA's partitioned program gives
NULL_REASONS = {
    "bytes_per_device": "XLA cost_analysis 'bytes accessed' of the "
                        "partitioned program; torch has no partitioned "
                        "program of the cell",
    "collective_bytes_per_device": "summed from the collective ops of "
                                   "XLA's optimized HLO; no torch "
                                   "counterpart",
    "collectives": "per-op collective bytes from XLA's optimized HLO; no "
                   "torch counterpart",
    "output_bytes": "XLA memory_analysis of the partitioned program",
    "temp_bytes": "XLA memory_analysis of the partitioned program",
    "peak_bytes": "XLA memory_analysis of the partitioned program",
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
    rules = rules_for_mesh(mesh, fsdp=cfg.fsdp)
    # batch=1 cells (long_500k) cannot shard the batch axis; degrade to
    # replicated batch (the O(1)-state archs this shape targets don't
    # need it).
    sizes = axis_sizes(mesh)
    bsize = math.prod(sizes[ax] for ax in rules.batch)
    if shape.global_batch % max(1, bsize):
        rules = dataclasses.replace(rules, batch=(), batch_degree=1)
    params_p = init_params(cfg, device=META, rules=rules)
    pvals, pspecs = values(params_p), specs(params_p)
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
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
    qvals = serve_params(pvals, bits=cfg.serve_weight_bits)
    qspecs = serve_param_specs(pvals, pspecs, cfg.serve_weight_bits)

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
    """Matmul-class flops of ``fn(*args)`` on ``meta`` tensors.  A decode
    step selects the cache rows it writes with ``nonzero``; on a fresh
    cache every row writes, which is what the meta kernel of
    ``nonzero`` assumes when told to."""
    from torch.fx.experimental import _config as fx_config
    from torch.utils.flop_counter import FlopCounterMode
    with fx_config.patch(meta_nonzero_assume_all_nonzero=True), \
            FlopCounterMode(display=False) as counter:
        fn(*args)
    return int(counter.get_total_flops())


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


def measure_cell(cfg: ArchConfig, shape: ShapeCell, mesh) -> dict:
    """Build one cell on ``mesh`` and reckon its numbers."""
    t0 = time.time()
    rules, fn, args, in_sh, donate = build_cell(cfg, shape, mesh)
    with shard_ctx.use_rules(rules), torch.set_grad_enabled(
            shape.kind == "train"):
        flops = count_flops(fn, args)
    n_dev = math.prod(tuple(mesh.shape))
    return {
        "status": "ok",
        "build_s": round(time.time() - t0, 1),
        "devices": n_dev,
        "donate": list(donate),
        "flops": flops,
        "flops_per_device": flops / n_dev,
        "argument_bytes": per_device_bytes(args, in_sh),
        **{k: None for k in NULL_REASONS},
        "null_reasons": NULL_REASONS,
        "notes": ("flops: matmul-class ops of the whole global batch "
                  "(torch.utils.flop_counter), per device an even split; "
                  + ("forward and backward of every microbatch, the "
                     "optimizer update is elementwise (not counted)"
                     if shape.kind == "train" else
                     "the packed weights are dequantized by the plain "
                     "route on meta tensors, which does no matmul")),
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
              f"args/dev {res['argument_bytes'] / 2**30:.2f} GiB")
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
