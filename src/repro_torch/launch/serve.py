"""Serving launcher of the torch port: the single-batch loop.

``--engine off`` (the default here) teacher-forces one fixed batch of
prompts through ``decode_step`` and greedy-decodes ``--new-tokens``.
Under ``--packed-compute sdv`` (the default) every projection runs on
the SDV datapath (kernels B1/B2 on the card) and, for the ssm
(mamba2-130m) and hybrid (recurrentgemma-2b) archs, every short conv on
the BSEG datapath (kernel B4) unless ``--conv-datapath float``.  Under
``--packed-compute memory`` every projection is stored as W-bit lane
words (packed by kernel B6), unpacked by kernel B7 and dequantized at
every step, and multiplied in bf16; the short convs stay in float.
``--engine on`` — the continuous-batching engine — is not ported yet.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --no-smoke --batch 8 --prompt-len 16 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --no-smoke --packed-compute memory
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --no-smoke --batch 8 --prompt-len 16 --new-tokens 16
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def single_batch_loop(cfg, qparams, cache, prompts, new_tokens):
    """Teacher-force one fixed batch of prompts [B, P], then greedy-decode
    ``new_tokens``.

    Every step synchronizes the card inside the timed loop, so the clock
    stops only after the device finishes.  Returns (generated tokens
    [B, new_tokens] numpy, seconds).
    """
    from repro_torch.models import decode_step
    b, plen = prompts.shape
    smax = plen + new_tokens
    tok = prompts[:, :1]
    gen = []
    t0 = time.perf_counter()
    for i in range(smax - 1):
        logits, cache = decode_step(cfg, qparams, cache, tok)
        if logits.is_cuda:
            torch.cuda.synchronize(logits.device)
        if i + 1 < plen:
            tok = prompts[:, i + 1:i + 2]
        else:
            tok = torch.argmax(logits[:, -1:, :cfg.vocab],
                               dim=-1).to(torch.int32)
            gen.append(tok[:, 0].cpu().numpy())
    dt = time.perf_counter() - t0
    return np.stack(gen, 1), dt


def cache_note(cache) -> str:
    """What ``init_cache`` built, for the banner."""
    if "k_scale" in cache:
        return "int8 KV cache"
    if "k" in cache:
        return (f"{str(cache['k'].dtype).removeprefix('torch.')} KV ring "
                f"cache of {cache['k'].shape[2]} entries")
    return "recurrent-state cache (no KV)"


def run_single_batch(cfg, args, params, device):
    from repro_torch.models import init_cache, serve_params
    from repro_torch.models.quantized import count_packed
    qparams = serve_params(params, bits=args.weight_bits, min_size=1024,
                           compute=args.packed_compute,
                           act_bits=args.act_bits,
                           conv_bseg=(args.packed_compute == "sdv"
                                      and args.conv_datapath == "bseg"))
    smax = args.prompt_len + args.new_tokens
    cache = init_cache(cfg, args.batch, smax, device=device)
    compute_note = (f"SDV W{args.weight_bits}A{args.act_bits} datapath "
                    "(default plans)" if args.packed_compute == "sdv"
                    else f"packed W{args.weight_bits} memory")
    packed = count_packed(qparams)
    n_conv = packed["bseg"]
    if device.type == "cuda":
        # build the kernels this path launches now: nvcc is set-up time,
        # not time of the timed loop's first step
        from repro_torch.kernels import build
        for lib, kind in (("sdv", "sdv"), ("bseg1d", "bseg"),
                          ("packbits", "memory")):
            if packed[kind]:
                build.library(lib)
    conv_note = (f", {n_conv} BSEG-packed W{min(args.weight_bits, 4)}A4 "
                 "short convs" if n_conv else "")
    print(f"{cfg.name}: {compute_note}{conv_note}, {cache_note(cache)}, "
          f"batch {args.batch} (single-batch loop, {device})")
    rng = np.random.default_rng(args.seed)
    prompts = torch.tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.int32, device=device)
    gen, dt = single_batch_loop(cfg, qparams, cache, prompts,
                                args.new_tokens)
    print(f"{args.batch * (smax - 1) / dt:.1f} tok/s, "
          f"{dt / (smax - 1) * 1e3:.1f} ms/step ({device})")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"peak memory {peak:.2f} GiB")
    print("sample:", gen[0][:12])
    return gen, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (--no-smoke runs full size)")
    ap.add_argument("--engine", choices=("on", "off"), default="off",
                    help="on: the continuous-batching engine (not ported "
                         "yet); off: the single-batch loop")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--weight-bits", type=int, default=4)
    ap.add_argument("--packed-compute", choices=("memory", "sdv"),
                    default="sdv",
                    help="sdv: projections on the SDV datapath; memory: "
                         "lane-packed weights (kernels B6/B7), "
                         "dequantized and multiplied in bf16")
    ap.add_argument("--act-bits", type=int, default=8,
                    help="activation width on the SDV datapath")
    ap.add_argument("--conv-datapath", choices=("bseg", "float"),
                    default="bseg",
                    help="short-conv execution under --packed-compute "
                         "sdv: the BSEG packed datapath (kernel B4) or "
                         "float math")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    args = ap.parse_args(argv)
    if args.engine == "on":
        print("the serving engine (--engine on) is not ported yet; use "
              "--engine off", file=sys.stderr)
        return 2

    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=device)
    run_single_batch(cfg, args, params, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
