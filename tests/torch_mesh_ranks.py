"""Multi-rank jobs for the port's distribution tests, run on the CPU over
``gloo``: ``python tests/torch_mesh_ranks.py JOB WORLD IN OUT`` starts
WORLD ranks (``torch.multiprocessing``, spawn), each running JOB on the
inputs ``torch.load(IN)`` and writing its results to ``OUT/rank<r>.pt``.
The process group's address is ``tcp://localhost`` on a free port.  A
helper of ``test_torch_grad_compress.py``, ``test_torch_mesh_train.py``
and ``test_torch_sharded_decode.py``
(not a test module itself: it imports no JAX)."""
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist


def _grad_compress(rank, inputs, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.grad_compress import compressed_allreduce
    world = dist.get_world_size()
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    g = {"w": torch.from_numpy(inputs["g_local"][rank])}
    zero = {"w": torch.zeros_like(g["w"])}
    gh_p, e_p = compressed_allreduce(g, zero, mesh, pack_words=True)
    gh_u, e_u = compressed_allreduce(g, zero, mesh, pack_words=False)
    acc = np.zeros(g["w"].shape, np.float32)
    errs = zero
    for i in range(inputs["steps"]):
        gh, errs = compressed_allreduce(g, errs, mesh)
        acc += gh["w"].numpy()
        if i + 1 == inputs["ref_steps"]:
            out["acc_ref_steps"] = acc.copy()
    out.update(gh_p=gh_p["w"], e_p=e_p["w"], gh_u=gh_u["w"],
               e_u=e_u["w"], acc=acc)


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _train(mesh, cfg, params, batch, steps):
    """``steps`` train steps of the port on ``mesh`` from the full tree
    ``params`` (every rank holds it); the losses and the final shards."""
    from repro_torch.launch.mesh import (batch_shardings, distribute,
                                         rules_for_mesh, shardings_of)
    from repro_torch.launch.train import scalar
    from repro_torch.models import param_specs, shard_ctx
    from repro_torch.train import loop, optimizer
    rules = rules_for_mesh(mesh, fsdp=cfg.fsdp)
    pv = distribute(params, shardings_of(mesh, param_specs(cfg, rules)))
    ocfg = optimizer.OptConfig(lr=1e-3, warmup=1, total_steps=8)
    opt = optimizer.init(ocfg, pv)
    bt = distribute(batch, batch_shardings(mesh, rules, batch))
    step = loop.make_train_step(cfg, ocfg)
    losses = []
    with shard_ctx.use_rules(rules):
        for _ in range(steps):
            pv, opt, m = step(pv, opt, bt)
            losses.append(scalar(m["loss"]))
    return losses, pv


def _mesh_train(rank, inputs, out):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import rules_for_mesh, shardings_of
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.param import values
    from repro_torch.train import checkpoint
    cfg = get_arch("tinyllama-1.1b").reduced()
    batch = {"tokens": inputs["tokens"]}
    for shape in inputs["meshes"]:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        losses, pv = _train(mesh, cfg, inputs["params"], batch,
                                   inputs["steps"])
        out[f"losses_{shape[0]}x{shape[1]}"] = losses
        if shape == inputs["meshes"][0]:
            # elastic checkpoint: save on this mesh, restore on the next
            checkpoint.save(inputs["ck_dir"], 1, pv)
            saved = [x.full_tensor() for x in tree.leaves(pv)]
            local = [tuple(x.to_local().shape) for x in tree.leaves(pv)]
    mesh2 = init_device_mesh("cpu", inputs["meshes"][1],
                             mesh_dim_names=("data", "model"))
    rules2 = rules_for_mesh(mesh2, fsdp=cfg.fsdp)
    template = values(init_params(cfg, device="meta", rules=rules2))
    restored, _ = checkpoint.restore(
        inputs["ck_dir"], 1, template,
        shardings=shardings_of(mesh2, param_specs(cfg, rules2)))
    got = tree.leaves(restored)
    out["elastic_local_shapes"] = ([tuple(x.to_local().shape) for x in got],
                                   local)
    out["elastic_exact"] = all(
        a.dtype == b.dtype and torch.equal(_bits(a), _bits(b.full_tensor()))
        for a, b in zip(saved, got))
    # the launcher's --mesh path on the whole group, then resumed
    argv = ["--smoke", "--mesh", inputs["launch_mesh"], "--device", "cpu",
            "--global-batch", "4", "--seq", "33", "--microbatches", "1",
            "--ckpt-dir", inputs["launch_dir"]]
    launcher.main(argv + ["--steps", "2"])
    launcher.main(argv + ["--steps", "3", "--resume"])
    out["launch_steps"] = checkpoint.latest_step(inputs["launch_dir"])


def _mesh_decode(rank, inputs, out):
    """Each case's ``decode_step``s on a (2, 2) mesh from its memory-packed
    tree and cache (``place_decode``), the logits gathered; then
    ``materialize`` of ``PackedLinear``s of CPU ``DTensor``s (the per-shard
    route the card takes, each shard's call on the plain version)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import (Sharding, batch_shardings,
                                         distribute, place_decode)
    from repro_torch.models import (PackedLinear, decode_step, materialize,
                                    shard_ctx)
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, case in inputs["cases"].items():
        cfg, tokens = case["cfg"], case["tokens"]
        rules, p, c, _ = place_decode(mesh, cfg, case["params"],
                                      case["cache"], {"tokens": tokens[0]},
                                      min_size=inputs["min_size"])
        sh = batch_shardings(mesh, rules, {"tokens": tokens[0]})
        logits = []
        with shard_ctx.use_rules(rules), torch.no_grad():
            for t in tokens:
                lg, c = decode_step(cfg, p, c,
                                    distribute({"tokens": t}, sh)["tokens"])
                logits.append(lg.full_tensor())
        out[name] = torch.stack(logits)
        out[name + "/index"] = c["index"].full_tensor()
    mats = []
    for pl, placements in inputs["packed"]:
        pls = [Shard(d) if d is not None else Replicate()
               for d in placements]
        dw = distribute({"w": pl.words, "s": pl.scale},
                        {"w": Sharding(mesh, tuple(pls), None),
                         "s": Sharding(mesh, tuple(
                             Replicate() if p == Shard(pl.words.ndim - 2)
                             else p for p in pls), None)})
        got = materialize(
            PackedLinear(words=dw["w"], scale=dw["s"], bits=pl.bits,
                         d_out=pl.d_out, stacked=pl.stacked), torch.bfloat16)
        mats.append((tuple(got.placements) == tuple(pls),
                     got.full_tensor()))
    out["materialize"] = mats


JOBS = {"grad_compress": _grad_compress, "mesh_train": _mesh_train,
        "mesh_decode": _mesh_decode}


def _rank(rank, job, world, port, in_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = {}
        JOBS[job](rank, torch.load(in_path, weights_only=False), out)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main(argv):
    job, world, in_path, out_dir = argv[0], int(argv[1]), argv[2], argv[3]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.multiprocessing.spawn(_rank, args=(job, world, port, in_path,
                                             out_dir), nprocs=world)


if __name__ == "__main__":
    main(sys.argv[1:])
