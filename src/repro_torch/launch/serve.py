"""Serving launcher of the torch port: the continuous-batching engine
and the single-batch loop.

``--engine on`` runs requests through ``repro_torch.serving.Engine``:
the continuous batcher coalesces them into bucketed batch shapes, each
bucket warms up once (building the kernels it launches) and resolves
its lane plans through the planner (``--plan-policy`` defaults to
``cache`` when a plan-cache file exists, else ``auto``), and the
metrics snapshot reports p50/p99 latency, tokens/s and packed-multiply
utilization.  ``--engine off`` (the default here) teacher-forces one
fixed batch of prompts through ``decode_step`` and greedy-decodes
``--new-tokens``.
Under ``--packed-compute sdv`` (the default) every projection runs on
the SDV datapath (kernels B1/B2 on the card) and, for the ssm
(mamba2-130m) and hybrid (recurrentgemma-2b) archs, every short conv on
the BSEG datapath (kernel B4) unless ``--conv-datapath float``.  Under
``--packed-compute memory`` every projection is stored as W-bit lane
words (packed by kernel B6), unpacked by kernel B7 and dequantized at
every step, and multiplied in bf16; the short convs stay in float.
``--speculative`` (engine, dense archs) serves through speculative
decoding: a W``--draft-bits``A``--draft-act-bits`` self-speculation
draft of the same weights proposes ``--spec-k`` tokens a round (kernel
B1) and the target verifies them in one chunked wave (kernel B2 above
8 rows); the tokens equal plain decode's.
A full-width moe arch (``--arch phi3.5-moe --no-smoke``) is drawn and
packed one layer group at a time (``packed_params_layerwise``): its
bf16 tree (84 GB for phi3.5-moe) would not fit the card, its packed one
does.  In both compute modes its expert banks are memory-packed and
unpacked by kernel B7 at every step.  It runs through the single-batch
loop (the engine packs float weights per bucket).
The encoder-decoder arch (``--arch seamless-m4t-large-v2``) replays its
prompts one token per ``decode_step`` (no chunked prefill), with its
decoder's bf16 self-attention cache and the cross cache the JAX package
leaves at zero; the vision-language arch (``--arch
llava-next-mistral-7b``) serves text only, as the dense archs, its patch
projection left in bf16.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --no-smoke --engine on --batch 8 --requests 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --no-smoke --engine on --speculative --batch 8 --requests 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --no-smoke --batch 8 --prompt-len 16 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --no-smoke --packed-compute memory
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --no-smoke --batch 8 --prompt-len 16 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe \\
      --no-smoke --packed-compute memory
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch seamless-m4t-large-v2 --no-smoke --batch 8 --prompt-len 16 \\
      --new-tokens 16 [--packed-compute memory]
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llava-next-mistral-7b --no-smoke --batch 8 --prompt-len 16 \\
      --new-tokens 16 [--packed-compute memory]
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
    if "cross_k" in cache:
        return (f"{str(cache['k'].dtype).removeprefix('torch.')} "
                f"self-attention KV cache and cross cache of "
                f"{cache['k'].shape[2]} entries")
    if "g_rnn0" in cache:
        return (f"{str(cache['k'].dtype).removeprefix('torch.')} KV ring "
                f"cache of {cache['k'].shape[2]} entries")
    if "k" in cache:
        return f"{str(cache['k'].dtype).removeprefix('torch.')} KV cache"
    return "recurrent-state cache (no KV)"


def packed_params_layerwise(cfg, *, seed: int = 0, device="cuda",
                            min_size: int = 1 << 16, **serve_kw):
    """The serve tree of a dense or moe model, drawn and packed one layer
    group at a time: ``serve_params(init_top_params(cfg, seed))`` for the
    leaves outside the layer stacks, then for each group g
    ``serve_params(init_group_params(cfg, g, seed))`` (a layer axis of
    1, so the expert banks stay banks), copied into stacks preallocated
    after the first group.  The result is bit for bit ``serve_params`` of
    the whole tree those draws make (``min_size`` compares a leaf's
    whole stack, as there); the card holds the packed tree and one
    group's float draw, never the float tree.  ``serve_kw`` go to
    ``serve_params``."""
    from repro_torch import tree
    from repro_torch.models import serve_params
    from repro_torch.models.transformer import (init_group_params,
                                                init_top_params, n_groups)
    n = n_groups(cfg)
    out = serve_params(init_top_params(cfg, seed, device),
                       min_size=min_size, **serve_kw)
    stacks = None
    for g in range(n):
        part = serve_params(init_group_params(cfg, g, seed, device),
                            min_size=-(-min_size // n), **serve_kw)
        if stacks is None:
            stacks = tree.tree_map(
                lambda a: a.new_empty((n,) + tuple(a.shape[1:])), part)
        for dst, src in zip(tree.leaves(stacks), tree.leaves(part)):
            dst[g] = src[0]
        del part
    out.update(stacks)
    return out


def serve_kwargs(args) -> dict:
    """The ``serve_params`` arguments of the single-batch loop."""
    return dict(bits=args.weight_bits, min_size=1024,
                compute=args.packed_compute, act_bits=args.act_bits,
                conv_bseg=(args.packed_compute == "sdv"
                           and args.conv_datapath == "bseg"))


def run_single_batch(cfg, args, qparams, device):
    from repro_torch.models import init_cache
    from repro_torch.models.quantized import count_packed
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


def run_engine(cfg, args, params, device):
    """Submit ``--requests`` seeded requests (prompt lengths and decode
    budgets drawn in [n/2, n]) to an engine and drain it; prints the
    metrics summary.  Returns the engine."""
    from repro_torch.serving import Backpressure, BucketShape, Engine, \
        FaultPlan

    s_maxes = ([int(s) for s in args.buckets.split(",") if s]
               if args.buckets else
               [args.prompt_len + args.new_tokens,
                2 * (args.prompt_len + args.new_tokens)])
    faults = FaultPlan.chaos(args.chaos_seed) if args.chaos else None
    engine = Engine(cfg, params, compute=args.packed_compute,
                    weight_bits=args.weight_bits, act_bits=args.act_bits,
                    conv_datapath=args.conv_datapath,
                    plan_policy=args.plan_policy,
                    plan_cache=args.plan_cache,
                    buckets=tuple(BucketShape(args.batch, s)
                                  for s in s_maxes),
                    breaker_threshold=2 if args.chaos else 3,
                    breaker_cooldown_s=0.2 if args.chaos else 2.0,
                    speculative=args.speculative, spec_k=args.spec_k,
                    draft_bits=args.draft_bits,
                    draft_act_bits=args.draft_act_bits,
                    faults=faults, device=device)
    spec_note = (f", speculative k={args.spec_k} "
                 f"(draft W{args.draft_bits}A{args.draft_act_bits})"
                 if args.speculative else "")
    print(f"{cfg.name}: engine, {args.packed_compute} compute, "
          f"plan policy {engine.plan_policy}, buckets "
          f"{[b.key for b in engine.buckets]}{spec_note} ({device})"
          + (f", chaos seed {args.chaos_seed}" if args.chaos else ""))
    # kernel builds are set-up time; under --chaos the buckets stay cold
    # (injected compile failures land in their first warmup) and only
    # the fallback path is built up front, as the reference's chaos
    # sweep does
    if args.chaos:
        engine.prewarm_fallback()
    else:
        for b in engine.buckets:
            engine.warmup(b)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    rng = np.random.default_rng(args.seed)
    n = args.requests or 2 * args.batch
    for _ in range(n):
        pl = int(rng.integers(max(1, args.prompt_len // 2),
                              args.prompt_len + 1))
        nt = int(rng.integers(max(1, args.new_tokens // 2),
                              args.new_tokens + 1))
        deadline = (engine.clock() + args.slo_ms / 1e3
                    if args.slo_ms else None)
        try:
            engine.submit(tuple(rng.integers(0, cfg.vocab, pl)), nt,
                          deadline=deadline)
        except Backpressure:
            pass
    comps = engine.drain()
    snap = engine.metrics.snapshot()
    buckets = snap["buckets"].values()
    decode_ms = 1e3 * sum(b.get("decode_wall_s", 0.0) for b in buckets) \
        / max(sum(b.get("decode_steps", 0) for b in buckets), 1)
    print(f"{snap['requests_completed']} done "
          f"({snap['requests_rejected']} rejected, "
          f"{snap['requests_shed']} shed), "
          f"{snap['tokens_per_s']:.1f} tok/s, "
          f"p50 {snap['latency']['p50_ms']:.1f} ms, "
          f"p99 {snap['latency']['p99_ms']:.1f} ms, "
          f"first token p50 {snap['ttft']['p50_ms']:.1f} ms, "
          f"{snap['waves']['count']} waves, "
          f"{snap['waves']['midwave_joins']} mid-wave joins, "
          f"{decode_ms:.1f} ms per decode iteration ({device})")
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device) / 2**30
        print(f"peak memory {peak:.2f} GiB")
    if args.chaos:
        f = snap["faults"]
        print(f"chaos: {f['wave_failures']} wave failures "
              f"{f['kinds']}, {f['quarantines']} quarantines, "
              f"{f['recoveries']} recoveries, {f['rerouted']} rerouted, "
              f"{f['fallback_waves']} fallback waves; "
              f"health {engine.bucket_health()}")
    for key, util in engine.plan_report().items():
        print(f"bucket {key}: {util['kernel_routed_layers']}/"
              f"{util['packed_layers']} packed layers on kernel routes, "
              f"density {util['density_achieved']:.2f} MACs/multiply")
    if args.speculative:
        sp = snap["speculative"]
        print(f"speculative: {sp['rounds']} rounds, "
              f"mean accepted {sp['mean_accepted']:.2f}, "
              f"tok/target-wave {sp['tokens_per_target_wave']:.2f}, "
              f"acceptance hist {sp['acceptance_hist']}")
        for key, rep in engine.spec_report().items():
            denser = sum(1 for l in rep["layers"] if l["draft_denser"])
            print(f"bucket {key}: spec_on={rep['spec_on']}, "
                  f"{denser}/{len(rep['layers'])} draft layers "
                  f"strictly denser")
    if comps:
        print("sample:", list(comps[0].tokens)[:12])
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced config (--no-smoke runs full size)")
    ap.add_argument("--engine", choices=("on", "off"), default="off",
                    help="on: the continuous-batching serving engine; "
                         "off: the single-batch loop")
    ap.add_argument("--batch", type=int, default=8,
                    help="batch (single-batch loop) / bucket width "
                         "(engine KV slots per wave)")
    ap.add_argument("--requests", type=int, default=None,
                    help="engine: requests to submit (default 2*batch)")
    ap.add_argument("--buckets", default=None,
                    help="engine: comma-separated bucket s_max ladder "
                         "(default: prompt+new and 2x)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="engine: per-request deadline (submit + slo)")
    ap.add_argument("--chaos", action="store_true",
                    help="engine: inject the seeded all-classes fault "
                         "schedule (FaultPlan.chaos) and print the "
                         "health/fault summary")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--speculative", action="store_true",
                    help="engine: self-speculation draft + single-wave "
                         "verification (greedy-exact, DESIGN.md §5.2)")
    ap.add_argument("--spec-k", type=int, default=3,
                    help="drafted tokens per verification wave")
    ap.add_argument("--draft-bits", type=int, default=4,
                    help="draft weight bits")
    ap.add_argument("--draft-act-bits", type=int, default=4,
                    help="draft activation bits (the density knob)")
    ap.add_argument("--plan-policy", choices=("default", "auto", "cache"),
                    default=None,
                    help="engine lane-plan selection (default: cache when "
                         "a plan-cache file exists, else auto); the "
                         "single-batch loop keeps the uniform plans")
    ap.add_argument("--plan-cache", default=None,
                    help="plan-cache JSON path (default "
                         "$REPRO_PLAN_CACHE or .repro_plan_cache.json)")
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

    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params, serve_params

    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    layerwise = cfg.family == "moe" and not args.smoke
    if layerwise and args.engine == "on":
        raise SystemExit(f"{cfg.name}: the engine packs float weights per "
                         "bucket and the float tree does not fit the card; "
                         "serve it with --engine off")
    if args.engine == "on":
        run_engine(cfg, args, init_params(cfg, seed=args.seed,
                                          device=device), device)
    elif layerwise:
        run_single_batch(cfg, args, packed_params_layerwise(
            cfg, seed=args.seed, device=device, **serve_kwargs(args)),
            device)
    else:
        run_single_batch(cfg, args, serve_params(
            init_params(cfg, seed=args.seed, device=device),
            **serve_kwargs(args)), device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
