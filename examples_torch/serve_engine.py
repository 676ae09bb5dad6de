"""The serving engine of the torch port end to end: heterogeneous requests through the
continuous batcher, planner-bucketed packed decode, per-request
latencies and the packed-multiply utilization report — then the same
traffic again with speculative decoding on.

A dozen requests with mixed prompt lengths and decode budgets arrive
at once; the batcher coalesces them into two bucket shapes, the engine
plans + warm-compiles each bucket once, sessions share each wave's KV
cache (slots freed the moment a request finishes), and the metrics
snapshot shows what the datapath actually achieved.

The speculative section (skip with ``--no-speculative``) briefly
trains the checkpoint — acceptance is a *checkpoint* property; a
random-init model's near-tied logits mean the draft never agrees —
then serves the stream plain vs speculative on the same weights: the
outputs are bit-identical (greedy acceptance is exact), the
acceptance-length histogram shows how many tokens each verification
wave landed, and the plan table shows the self-speculation draft
(same checkpoint at W4A4) packing strictly denser than the W4A8
target on the same datapath — the paper's density law exploited
temporally.

On a CUDA card the packed projections run on the port's SDV kernels
(B1 for the decode waves and the draft, B2 for the verification
waves); with ``--device cpu`` on their plain torch versions.

Run:  PYTHONPATH=src python examples_torch/serve_engine.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (Backpressure, BucketShape, Engine,
                                 calibrated_params)


def submit_stream(engine, cfg, n, rng):
    rids = []
    for _ in range(n):
        # short prompts land in the small bucket, long in the large one
        pl = int(rng.integers(4, 32))
        nt = int(rng.integers(4, 13))
        try:
            rids.append(engine.submit(
                tuple(rng.integers(0, cfg.vocab, pl)), nt,
                deadline=engine.clock() + 30.0))
        except Backpressure:
            print("request shed (queue at budget)")
    return rids


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--compute", choices=("sdv", "memory"), default="sdv")
    ap.add_argument("--speculative",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="also run the speculative-decoding section "
                         "(sdv compute only)")
    ap.add_argument("--spec-k", type=int, default=3)
    ap.add_argument("--train-steps", type=int, default=150,
                    help="calibration steps before the speculative "
                         "section (acceptance needs peaked logits)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch(args.arch).reduced()   # CPU-sized family backbone
    params = init_params(cfg, seed=0, device=dev)
    buckets = (BucketShape(4, 24), BucketShape(4, 48))

    engine = Engine(cfg, params, compute=args.compute, buckets=buckets,
                    device=dev)
    print(f"{cfg.name}: {args.compute} compute, plan policy "
          f"{engine.plan_policy}, buckets "
          f"{[b.key for b in engine.buckets]}")

    submit_stream(engine, cfg, args.requests, np.random.default_rng(0))
    completions = engine.drain()
    for c in sorted(completions, key=lambda c: c.rid):
        print(f"  rid {c.rid:2d}  bucket {c.bucket_key}  "
              f"prompt {c.prompt_len:2d} -> {len(c.tokens):2d} tokens  "
              f"{c.latency_s * 1e3:7.1f} ms"
              f"{'' if c.met_deadline else '  MISSED DEADLINE'}")

    snap = engine.metrics.snapshot()
    print(f"{snap['requests_completed']} requests, "
          f"{snap['tokens_per_s']:.1f} tok/s, "
          f"p50 {snap['latency']['p50_ms']:.1f} ms / "
          f"p99 {snap['latency']['p99_ms']:.1f} ms, "
          f"{snap['waves']['count']} waves")
    for key, util in engine.plan_report().items():
        print(f"bucket {key}: {util['kernel_routed_layers']}/"
              f"{util['packed_layers']} packed layers on kernel routes, "
              f"density {util['density_achieved']:.2f} MACs/multiply")

    if not (args.speculative and args.compute == "sdv"):
        return 0

    # -- speculative decoding (DESIGN.md §5.2) ---------------------------
    print(f"\ncalibrating checkpoint ({args.train_steps} steps) so the "
          f"draft has something to agree with ...")
    trained = calibrated_params(cfg, steps=args.train_steps, seed=0,
                                device=dev)

    results = {}
    for speculative in (False, True):
        eng = Engine(cfg, trained, compute="sdv", buckets=buckets,
                     speculative=speculative, spec_k=args.spec_k,
                     device=dev)
        rids = submit_stream(eng, cfg, args.requests,
                             np.random.default_rng(1))
        eng.drain()
        toks = {c.rid: c.tokens for c in eng.completions}
        results[speculative] = ([toks.get(r) for r in rids], eng)

    (plain_toks, plain_eng), (spec_toks, spec_eng) = \
        results[False], results[True]
    sp = spec_eng.metrics.snapshot()["speculative"]
    pp = plain_eng.metrics.snapshot()["speculative"]
    print(f"speculative k={args.spec_k}: outputs bit-identical to "
          f"plain decode: {plain_toks == spec_toks}")
    print(f"  {sp['rounds']} verify rounds, mean accepted "
          f"{sp['mean_accepted']:.2f} tokens/round")
    print(f"  effective tokens per target wave: "
          f"{pp['tokens_per_target_wave']:.2f} plain -> "
          f"{sp['tokens_per_target_wave']:.2f} speculative")
    hist = sp["acceptance_hist"]
    total = sum(hist.values()) or 1
    print("  acceptance-length histogram (tokens landed per slot "
          "per wave):")
    for n in sorted(hist, key=int):
        bar = "#" * round(40 * hist[n] / total)
        print(f"    {n:>2} token(s): {hist[n]:4d} {bar}")
    key, rep = next(iter(spec_eng.spec_report().items()))
    print(f"  draft vs target plans (bucket {key}; same datapath, "
          f"draft strictly denser):")
    print(f"    {'layer':<28} {'datapath':<10} "
          f"{'target':<16} {'draft':<16}")
    for l in rep["layers"]:
        mark = "DENSER" if l["draft_denser"] else "  !!  "
        print(f"    {l['layer'][-28:]:<28} {l['datapath']:<10} "
              f"n={l['target_density']:<2} {l['target_plan'][:12]:<13} "
              f"n={l['draft_density']:<2} {l['draft_plan'][:12]:<13} "
              f"{mark}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
