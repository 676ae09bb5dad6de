"""End-to-end training driver on the torch port: train a ~100M-param
llama-family model for a few hundred steps with the full production
substrate — deterministic data, AdamW + cosine, microbatching, async
fault-tolerant checkpointing, straggler monitor, SIGTERM emergency
save, resume.  Runs on the card unless given ``--device cpu``.

Run:   PYTHONPATH=src python examples_torch/train_lm.py --steps 300
Kill/resume:  Ctrl-C (or SIGTERM), then re-run with --resume.
"""
import argparse
import os
import tempfile

import torch

from repro_torch import tree
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.train import checkpoint, loop, optimizer, straggler

# ~100M params: 12L x 768 with a 32k vocab
CFG = ArchConfig(name="demo-100m", family="dense", n_layers=12,
                 d_model=768, n_heads=12, n_kv=4, d_ff=2048,
                 vocab=32000, attn_chunk=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="smoke-size model (CI)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = CFG.reduced() if args.small else CFG
    params = init_params(cfg, seed=0, device=dev)
    n_params = sum(x.numel() for x in tree.leaves(params))
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params")

    ocfg = optimizer.OptConfig(lr=3e-4, warmup=20, total_steps=args.steps)
    opt = optimizer.init(ocfg, params)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch, seed=0)
    step_fn = loop.make_train_step(cfg, ocfg, microbatches=2)

    start = 0
    if args.resume:
        last = checkpoint.latest_step(args.ckpt_dir)
        if last is not None:
            (params, opt), meta = checkpoint.restore(
                args.ckpt_dir, last, (params, opt))
            start = meta["step"]
            print(f"resumed from step {start}")

    ck = checkpoint.AsyncCheckpointer(args.ckpt_dir, keep=3)
    mon = straggler.StepMonitor()
    state = {"params": params, "opt": opt, "step": start}

    def flush():
        ck.wait()
        checkpoint.save(args.ckpt_dir, state["step"],
                        (state["params"], state["opt"]))
        print(f"\nemergency checkpoint at step {state['step']}")

    checkpoint.install_sigterm_handler(flush)

    for s in range(start, args.steps):
        batch = data.device_batch(s, dev)     # pure function of (seed, s)
        mon.start()
        params, opt, m = step_fn(params, opt, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)       # the step's time, not its launch
        dt = mon.stop()
        state.update(params=params, opt=opt, step=s + 1)
        if mon.should_mitigate:
            print(f"[straggler] sustained slow steps "
                  f"(ema {mon.ema:.3f}s) — a fleet driver would "
                  f"checkpoint + rebalance here")
        if (s + 1) % args.ckpt_every == 0 or s + 1 == args.steps:
            ck.save_async(s + 1, (params, opt))
        if (s + 1) % 20 == 0 or s == start:
            print(f"step {s+1:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"|g| {float(m['grad_norm']):.3f}  {dt*1e3:.0f} ms")
    ck.wait()
    print("done; checkpoints in", args.ckpt_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
