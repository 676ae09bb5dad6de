"""Training launcher of the torch port — ``repro.launch.train``.

Runs on one torch device (``--device``, default ``cuda``) with the
port's training substrate: deterministic data, AdamW (+8-bit moments),
microbatching, async checkpointing with resume, straggler monitoring,
SIGTERM emergency save.  The step loop itself is
``train/loop.run_training`` — device sync inside the timed region.

  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      tinyllama-1.1b --smoke --steps 50

``--mesh d,m`` trains on a ("data", "model") ``DeviceMesh`` of d x m
ranks: parameters and optimizer state are ``DTensor`` shards by the
sharding rules (``launch/mesh.py``), each batch is sharded along the
batch axes, and the step runs under ``shard_ctx.use_rules``.  It joins
the process group torchrun describes (``nccl`` on ``cuda``, ``gloo`` on
``cpu``), or makes a one-rank group when started plain.

  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --smoke --steps 8 --mesh 2,2 --device cpu

``--qat`` switches to packed QAT (``train/qat``): STE
forward through the packed datapath (kernel B2 on the card), export to
serving-ready params.

  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      tinyllama-1.1b --steps 3 --qat --w-bits 4 --a-bits 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      tinyllama-1.1b --smoke --steps 20 --qat --device cpu \\
      --bitsearch bs.json --plan-cache plans.json --export serve.ck
"""
from __future__ import annotations

import argparse
import os
import tempfile


def run_qat_main(args) -> None:
    """--qat path: single-device packed QAT via ``train/qat/loop``."""
    from ..train import qat

    qcfg = qat.QATRunConfig(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.global_batch, seq=args.seq,
        microbatches=args.microbatches,
        w_bits=args.w_bits, a_bits=args.a_bits,
        min_size=args.qat_min_size,
        packed_forward=not args.float_forward,
        plan_policy="cache" if args.plan_cache else "auto",
        plan_cache=args.plan_cache or None,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, device=args.device)

    precision = None
    if args.bitsearch:
        from ..train.loop import init_run
        cfg, _, params, _, _ = init_run(args.arch, smoke=args.smoke,
                                        device=args.device)
        precision, report = qat.search_bitwidths(
            params, min_size=args.qat_min_size,
            cache_path=args.plan_cache or None)
        qat.write_search_report(report, args.bitsearch,
                                {"arch": cfg.name})
        print(f"bitsearch: {len(report)} layers -> {args.bitsearch}")

    res = qat.run_qat(qcfg, precision=precision)
    print(f"qat: {res['qat_layers']} packed layers, "
          f"eval {res['qat_eval']:.4f} "
          f"(float init {res['float_eval_at_init']:.4f})")
    if args.export:
        from ..train import checkpoint
        served = qat.export_for_serving(qcfg, res["params"])
        checkpoint.save(args.export, qcfg.steps, served)
        print(f"exported serving params -> {args.export}")


def _join_process_group(dev):
    """Join the process group torchrun describes (its environment), or
    make a one-rank group on a free localhost port when started plain.
    Returns (device of this rank, whether this call made the group)."""
    import socket

    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dev, False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ:                      # torchrun
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
    else:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=0, world_size=1)
    return dev, True


def scalar(x) -> float:
    """A 0-dim metric as a float; a ``DTensor`` one (a loss pending its
    sum over the batch axes) is reduced first, on every rank."""
    from torch.distributed.tensor import DTensor
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def run_mesh_main(args) -> dict:
    """--mesh path: float training on a ("data", "model") DeviceMesh.
    Returns each step's loss and wall seconds and the final ``DTensor``
    parameters and optimizer state (``losses``, ``step_s``, ``params``,
    ``opt``)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..configs.registry import get_arch
    from ..data import SyntheticLMData
    from ..device import resolve_device
    from ..models import init_params, shard_ctx
    from ..models.param import specs, values
    from ..train import checkpoint, loop, optimizer
    from .mesh import batch_shardings, distribute, rules_for_mesh, \
        shardings_of

    dev, own_group = _join_process_group(resolve_device(args.device))
    try:
        dd, mm = (int(x) for x in args.mesh.split(","))
        world = dist.get_world_size()
        if dd * mm != world:
            raise ValueError(f"--mesh {args.mesh}: {dd} x {mm} ranks, but "
                             f"the process group holds {world}")
        mesh = init_device_mesh(dev.type, (dd, mm),
                                mesh_dim_names=("data", "model"))
        cfg = get_arch(args.arch)
        if args.smoke:
            cfg = cfg.reduced()
        rules = rules_for_mesh(mesh, fsdp=cfg.fsdp)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"mesh {{'data': {dd}, 'model': {mm}}}  arch {cfg.name}  "
                  f"device {dev}")

        # every rank draws the same full tree and keeps its own shards
        pt = init_params(cfg, seed=0, device=dev, rules=rules)
        params = distribute(values(pt), shardings_of(mesh, specs(pt)))
        del pt
        ocfg = optimizer.OptConfig(lr=3e-4, warmup=10,
                                   total_steps=args.steps,
                                   moments_8bit=cfg.opt_8bit)
        opt = optimizer.init(ocfg, params)     # moments placed as params
        data = SyntheticLMData(
            vocab=cfg.vocab, seq_len=args.seq,
            global_batch=args.global_batch, seed=0,
            n_patches=cfg.n_patches, d_model=cfg.d_model,
            encdec=cfg.family == "encdec")

        start = 0
        if args.resume:
            last = checkpoint.latest_step(args.ckpt_dir)
            if last is not None:
                (params, opt), meta = checkpoint.restore(
                    args.ckpt_dir, last, (params, opt))
                start = meta["step"]
                if rank0:
                    print(f"resumed at step {start}")

        ck = checkpoint.AsyncCheckpointer(args.ckpt_dir)
        state = {"params": params, "opt": opt, "step": start}
        checkpoint.install_sigterm_handler(   # every rank: a collective save
            lambda: (ck.wait(), checkpoint.save(
                args.ckpt_dir, state["step"],
                (state["params"], state["opt"]))))

        def place_batch(host):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
            return distribute(batch, batch_shardings(mesh, rules, batch))

        losses, step_s = [], []

        def on_step(s, p, o, m, dt, mon):
            state.update(params=p, opt=o, step=s + 1)
            losses.append(scalar(m["loss"]))
            step_s.append(dt)
            if mon.should_mitigate and rank0:
                print("[straggler] mitigation trigger")
            if (s + 1) % args.ckpt_every == 0 or s + 1 == args.steps:
                ck.save_async(s + 1, (p, o))
            if ((s + 1) % 10 == 0 or s == start) and rank0:
                print(f"step {s+1:4d} loss {losses[-1]:.4f} "
                      f"lr {scalar(m['lr']):.2e}")

        with shard_ctx.use_rules(rules):
            params, opt, _, _ = loop.run_training(
                cfg, ocfg, params, opt, data, steps=args.steps, start=start,
                microbatches=args.microbatches, place_batch=place_batch,
                on_step=on_step)
        ck.wait()
        dist.barrier()                 # rank 0's last write is on disk
        return {"losses": losses, "step_s": step_s, "params": params,
                "opt": opt}
    finally:
        if own_group:
            dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--mesh", default="",
                    help="data,model: train on a DeviceMesh of data x "
                    "model ranks (default: one device, no mesh)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    # --- QAT mode ---
    ap.add_argument("--qat", action="store_true",
                    help="packed quantization-aware training")
    ap.add_argument("--w-bits", type=int, default=4)
    ap.add_argument("--a-bits", type=int, default=8)
    ap.add_argument("--qat-min-size", type=int, default=1 << 10,
                    help="smallest kernel (elements) to fake-quantize")
    ap.add_argument("--float-forward", action="store_true",
                    help="QAT with the unpacked integer-decode forward")
    ap.add_argument("--plan-cache", default="",
                    help="plan-cache JSON path (warmed by --bitsearch)")
    ap.add_argument("--bitsearch", default="",
                    help="run bitwidth search first; write report here")
    ap.add_argument("--export", default="",
                    help="checkpoint dir for serving-ready params")
    args = ap.parse_args(argv)

    if args.qat:
        run_qat_main(args)
        return
    if args.mesh:
        return run_mesh_main(args)

    from ..configs.registry import get_arch
    from ..data import SyntheticLMData
    from ..device import resolve_device
    from ..models import init_params
    from ..train import checkpoint, loop, optimizer

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    print(f"device {dev}  arch {cfg.name}")

    params = init_params(cfg, seed=0, device=dev)
    ocfg = optimizer.OptConfig(lr=3e-4, warmup=10, total_steps=args.steps,
                               moments_8bit=cfg.opt_8bit)
    opt = optimizer.init(ocfg, params)
    data = SyntheticLMData(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch,
        seed=0, n_patches=cfg.n_patches, d_model=cfg.d_model,
        encdec=cfg.family == "encdec")

    start = 0
    if args.resume:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt), meta = checkpoint.restore(args.ckpt_dir, last,
                                                     (params, opt))
            start = meta["step"]
            print(f"resumed at step {start}")

    ck = checkpoint.AsyncCheckpointer(args.ckpt_dir)
    state = {"params": params, "opt": opt, "step": start}
    checkpoint.install_sigterm_handler(
        lambda: (ck.wait(), checkpoint.save(
            args.ckpt_dir, state["step"], (state["params"], state["opt"]))))

    def on_step(s, p, o, m, dt, mon):
        state.update(params=p, opt=o, step=s + 1)
        if mon.should_mitigate:
            print("[straggler] mitigation trigger")
        if (s + 1) % args.ckpt_every == 0 or s + 1 == args.steps:
            ck.save_async(s + 1, (p, o))
        if (s + 1) % 10 == 0 or s == start:
            print(f"step {s+1:4d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e}")

    loop.run_training(
        cfg, ocfg, params, opt, data, steps=args.steps, start=start,
        microbatches=args.microbatches, on_step=on_step)
    ck.wait()


if __name__ == "__main__":
    main()
