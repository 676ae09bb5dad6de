"""Batched serving with lane-packed W4 weights (the paper's packing on
the memory roofline of the card): decode a batch of prompts with the
quantized packed parameter tree; compares tokens/s and weight bytes
vs the bf16 baseline.

Run:  PYTHONPATH=src python examples_torch/serve_packed.py [--device cpu]

On a CUDA card the packed tree's weights are unpacked and dequantized
by the port's fused kernel (B7) at every step; with ``--device cpu`` by
its plain torch version.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.registry import ARCHS
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, init_params, \
    serve_params


def tree_bytes(params):
    return sum(leaf.numel() * leaf.element_size()
               for leaf in tree.leaves(params))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ARCHS[args.arch].reduced()   # CPU-sized backbone of the family
    params = init_params(cfg, seed=0, device=dev)
    qparams = serve_params(params, bits=4, min_size=1024)
    b_bf16 = tree_bytes(params)
    b_q = tree_bytes(qparams)
    print(f"weights: bf16 {b_bf16/2**20:.2f} MiB -> packed W4 "
          f"{b_q/2**20:.2f} MiB ({b_bf16/b_q:.2f}x smaller device "
          "memory residency)")

    rng = np.random.default_rng(0)
    prompts = torch.tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=dev)
    smax = args.prompt_len + args.new_tokens

    def generate(ptree, label):
        cache = init_cache(cfg, args.batch, smax, device=dev)
        # prefill: teacher-force the prompt through decode steps (keeps
        # the example simple; launch/serve.py shows bulk prefill)
        tok = prompts[:, :1]
        t0 = time.perf_counter()
        outs = []
        for i in range(smax - 1):
            logits, cache = decode_step(cfg, ptree, cache, tok)
            if i + 1 < args.prompt_len:
                tok = prompts[:, i + 1:i + 2]
            else:
                tok = torch.argmax(logits[:, -1:, :cfg.vocab], dim=-1
                                   ).to(torch.int32)
                outs.append(tok[:, 0].cpu().numpy())
        dt = time.perf_counter() - t0
        toks = args.batch * (smax - 1)
        print(f"{label}: {toks/dt:8.1f} tok/s  (greedy tail: "
              f"{np.stack(outs, 1)[0][:8]})")
        return np.stack(outs, 1)

    generate(qparams, "packed W4")
    generate(params, "bf16     ")
    # random-init logits are near-uniform, so greedy tokens are not a
    # meaningful agreement metric; compare the logit surfaces instead
    lq, _ = decode_step(cfg, qparams,
                        init_cache(cfg, args.batch, smax, device=dev),
                        prompts[:, :1])
    lf, _ = decode_step(cfg, params,
                        init_cache(cfg, args.batch, smax, device=dev),
                        prompts[:, :1])
    mae = float(torch.mean(torch.abs(lq - lf)))
    rng_sp = float(torch.abs(lf).max())
    print(f"logit MAE packed-vs-bf16: {mae:.4f} (range ±{rng_sp:.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
