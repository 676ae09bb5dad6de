#!/usr/bin/env python3
"""Does the speculative verification wave equal sequential decode bit for
bit on one CUDA card, and which op would break it?

Full-width tinyllama-1.1b from a seeded init, SDV W4A8 on the planner's
plans for 8 rows (``serve_params(plan_policy="auto", rows=8)``), a cache
of batch 8 at s_max 64 prefilled with 8 seeded prompt tokens per slot.
Then 4 seeded tokens per slot go through ``models.verify_step`` (the
chunked-prefill layer stack with the logits of every column) and
through 4 sequential ``models.decode_step``s, each on its own copy of
the cache, and the logits, the greedy tokens and every cache leaf are
compared.  Then each float op whose summation order could follow the
row count (a CUDA reduction's block shape, cuBLAS's kernel choice) runs
on seeded inputs of the verification wave's shape, once on all 4
columns and once column by column in the decode step's shape: the
RMSNorm, the attention's score product, its softmax and its value
product (float32), and the bf16 LM-head product; the script prints how
many outputs differ.

  PYTHONPATH=src python scripts/verify_vs_decode.py [--device cuda]
  PYTHONPATH=src python scripts/verify_vs_decode.py --device cpu --smoke
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

BATCH, S_MAX, PROMPT, COLUMNS = 8, 64, 8, 4


def differ(a, b) -> str:
    import torch
    if torch.equal(a, b):
        return "equal"
    n = int((a != b).sum())
    d = float((a.float() - b.float()).abs().max())
    return f"{n} of {a.numel()} differ (max {d:.3g})"


def end_to_end(cfg, qparams, dev):
    import numpy as np
    import torch
    from repro_torch.models import (decode_step, init_cache, prefill_step,
                                    verify_step)

    rng = np.random.default_rng(0)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                          dtype=torch.int32, device=dev)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, COLUMNS)),
                        dtype=torch.int32, device=dev)
    cache0 = prefill_step(cfg, qparams, init_cache(cfg, BATCH, S_MAX,
                                                   device=dev),
                          prompt, torch.full((BATCH,), PROMPT,
                                             dtype=torch.int32, device=dev))
    n = torch.full((BATCH,), COLUMNS, dtype=torch.int32, device=dev)

    def copy():
        return {k: v.clone() for k, v in cache0.items()}

    cache = copy()
    dec = []
    for j in range(COLUMNS):
        logits, cache = decode_step(cfg, qparams, cache, toks[:, j:j + 1])
        dec.append(logits)
    dec = torch.cat(dec, dim=1)
    logits, c = verify_step(cfg, qparams, copy(), toks, n)
    greedy = [t[..., :cfg.vocab].argmax(-1) for t in (logits, dec)]
    print(f"[e2e] verify_step vs {COLUMNS} decode steps: logits "
          f"{differ(logits, dec)}; greedy tokens {differ(*greedy)}; "
          + ", ".join(f"{k} {differ(c[k], cache[k])}" for k in cache))


def by_column(fn, x):
    """``fn`` on each column ``x[:, j:j+1]`` of x [B, C, ...] as a
    contiguous [B, 1, ...] tensor (a decode step's shape), concatenated
    on dim 1."""
    import torch
    return torch.cat([fn(x[:, j:j + 1].contiguous())
                      for j in range(x.shape[1])], dim=1)


def per_op(cfg, qparams, dev):
    import math

    import torch
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, c, d = BATCH, COLUMNS, cfg.d_model
    g, r, hd = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    x = randn(b, c, d, dtype=cfg.dtype)
    ln = {"scale": torch.ones(d, device=dev)}
    print(f"[op] rmsnorm {list(x.shape)} bf16: "
          + differ(L.rmsnorm_apply(ln, x),
                   by_column(lambda xc: L.rmsnorm_apply(ln, xc), x)))
    w = L.mat(qparams["lm_head"], cfg.dtype)
    print(f"[op] LM head {list(x.shape)} x {list(w.shape)} bf16: "
          + differ(x @ w, by_column(lambda xc: xc @ w, x)))
    q = randn(b, c, g, r, hd)
    kc = randn(b, S_MAX, g, hd)
    vc = randn(b, S_MAX, g, hd)
    s_b = torch.einsum("bcgrd,bsgd->bgrcs", q, kc)
    s_c = torch.stack([torch.einsum("bgrd,bkgd->bgrk",
                                    q[:, j].contiguous(), kc)
                       for j in range(c)], dim=3)
    print(f"[op] attention scores {list(s_b.shape)} f32: "
          f"{differ(s_b, s_c)}")
    s = s_c / math.sqrt(hd)
    p_b = torch.softmax(s, dim=-1)
    p_c = torch.stack([torch.softmax(s[:, :, :, j].contiguous(), dim=-1)
                       for j in range(c)], dim=3)
    print(f"[op] softmax over {S_MAX} f32: {differ(p_b, p_c)}")
    o_b = torch.einsum("bgrcs,bsgd->bcgrd", p_b, vc)
    o_c = torch.stack([torch.einsum("bgrk,bkgd->bgrd",
                                    p_b[:, :, :, j].contiguous(), vc)
                       for j in range(c)], dim=1)
    print(f"[op] attention values {list(o_b.shape)} f32: "
          f"{differ(o_b, o_c)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced tinyllama (a rehearsal on the CPU)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params, serve_params

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(f"[card] {smi.stdout.strip()}; torch {torch.__version__}")
    cfg = get_arch("tinyllama-1.1b")
    if args.smoke:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=0, device=dev)
    qparams = serve_params(params, bits=4, min_size=1024, compute="sdv",
                           act_bits=8, plan_policy="auto", rows=BATCH)
    del params
    end_to_end(cfg, qparams, dev)
    per_op(cfg, qparams, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
