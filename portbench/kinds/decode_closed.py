"""Traffic kind ``decode_closed``: one batch of sequences decoded
together, greedy, each token fed back, for the whole window.

Mix parameters (``traffic/<mix>.json``): ``batch`` sequences; each
row's context at the window's start from a set of ``batch`` lengths
spread evenly over [``context_min``, ``context_max``], dealt to the rows
in an order drawn from the seed; ``s_max`` cache positions (the room
left bounds the steps); ``kv_std`` the spread of the context's K/V.

The context is an input, written in set-up: each layer's K and V drawn
from the seed (normal, ``kv_std``), kept as int8 codes with a scale per
(position, head) by the configuration's cache rule, zero past each row's
context; both the program and the reference receive it.  Each step is
one ``decode_step`` at the whole batch; its tokens are read back to the
host, as a server streaming them would, and timed there.  A window
called again goes on where the last one stopped.  The reference
judges every token the program served; on the moe family it takes the
program's expert choices, recorded as the program makes them, and
judges them by themselves (``reference.decoder``).
"""
from __future__ import annotations

import sys
import time

import torch

from portbench import program
from portbench.harness import percentile
from portbench.reference import quant as Q
from portbench.reference.decoder import Reference, served_gaps, widest
from portbench.roofline import context_sum
from portbench.weights import generator, head_dim

_ORDER_SLOT, _FIRST_SLOT, _CACHE_SLOT = 1 << 9, (1 << 9) + 1, 1 << 10


def contexts(traffic: dict, seed: int):
    b, lo, hi = traffic["batch"], traffic["context_min"], \
        traffic["context_max"]
    pool = [lo + (hi - lo) * i // (b - 1) for i in range(b)]
    order = torch.randperm(b, generator=generator(seed, _ORDER_SLOT, "cpu"))
    return [pool[i] for i in order]


def context_kv(arch: dict, traffic: dict, ctx_lens, seed: int, layer: int,
               device):
    """Layer ``layer``'s context: (k codes, k scale, v codes, v scale),
    [B, s_max, KV, hd] int8 and [B, s_max, KV] float32, zero from each
    row's context length on."""
    b, s = traffic["batch"], traffic["s_max"]
    shape = (b, s, arch["n_kv"], head_dim(arch))
    gen = generator(seed, _CACHE_SLOT + layer, device)
    keep = (torch.arange(s, device=device)[None, :]
            < torch.tensor(ctx_lens, device=device)[:, None])
    out = []
    for _ in range(2):
        q, sc = Q.kv_roundtrip(torch.randn(shape, generator=gen,
                                           device=device)
                               * traffic["kv_std"])
        out += [q * keep[..., None, None], sc * keep[..., None]]
    return out


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        t = self.t = ctx.traffic
        dev = ctx.device
        self.arch = ctx.config["port"]["arch"]
        self.cfg = program.arch_config(ctx.config)
        from repro_torch import models
        self.models = models
        self.params = program.serve_tree(ctx.config, ctx.seed, dev,
                                         act_bits=ctx.act_bits)
        b = t["batch"]
        self.ctx_lens = contexts(t, ctx.seed)
        cache = models.init_cache(self.cfg, b, t["s_max"], device=dev)
        for layer in range(self.arch["n_layers"]):
            kq, ks, vq, vs = context_kv(self.arch, t, self.ctx_lens,
                                        ctx.seed, layer, dev)
            cache["k"][layer], cache["k_scale"][layer] = kq, ks
            cache["v"][layer], cache["v_scale"][layer] = vq, vs
        self.start = torch.tensor(self.ctx_lens, dtype=torch.int32,
                                  device=dev)
        self.cache = dict(cache, index=self.start.clone())
        self.first = torch.randint(0, self.arch["vocab"], (b, 1),
                                   generator=generator(ctx.seed, _FIRST_SLOT,
                                                       dev),
                                   device=dev, dtype=torch.int32)
        self.served = []
        self.routes = []            # the program's expert choices, in order
        # warm-up: one step at the cell's shapes, its positions given back
        logits, _ = models.decode_step(self.cfg, self.params, self.cache,
                                       self.first)
        program.greedy(logits, self.arch["vocab"]).cpu()
        self.cache = dict(self.cache, index=self.start.clone())

    def window(self, seconds: float) -> dict:
        """Steps for ``seconds`` (at least two, for one gap between
        tokens), from where the last window stopped, as long as the
        cache has room."""
        t, models = self.t, self.models
        b = t["batch"]
        budget = t["s_max"] - max(self.ctx_lens)
        n0 = len(self.served)
        tok = self.served[-1] if self.served else self.first
        gaps = []
        with program.expert_choices() as routes:
            t0 = time.perf_counter()
            prev = None
            while (time.perf_counter() - t0 < seconds
                   or len(self.served) - n0 < 2) \
                    and len(self.served) < budget:
                with torch.profiler.record_function("portbench.decode_step"):
                    logits, self.cache = models.decode_step(
                        self.cfg, self.params, self.cache, tok)
                tok = program.greedy(logits, self.arch["vocab"])
                with torch.profiler.record_function("portbench.readback"):
                    tok.cpu()
                now = time.perf_counter()
                if prev is not None:
                    gaps.append(now - prev)
                prev = now
                self.served.append(tok)
            elapsed = time.perf_counter() - t0
        self.routes += routes
        steps = len(self.served) - n0
        per_row = sorted(gaps * b)          # every row shares a step's gap
        return {
            "attempted": b, "failed": 0,
            "end_to_end": {"out_tok_s": b * steps / elapsed,
                           "itl_p95_ms": percentile(per_row, 95) * 1e3},
            "work": {
                "seconds": elapsed,
                "steps": steps,
                "tokens": b * steps,
                "context_sum": sum(context_sum(c + n0, steps)
                                   for c in self.ctx_lens),
                "logit_rows": b * steps,
                "calls": [[b, b, steps]],
            },
        }

    def free_program(self):
        del self.params, self.cache

    def _routes(self, steps: int):
        """The program's expert choices as each layer's [steps, B, k], or
        None where the program made a number of MoE calls other than one
        a layer a step (it no longer routes through ``moe_route``)."""
        n = self.arch["n_layers"]
        if len(self.routes) != steps * n:
            print(f"portbench: {len(self.routes)} expert routings recorded, "
                  f"want {steps} steps x {n} layers", file=sys.stderr)
            return None
        return [torch.stack(self.routes[layer::n]) for layer in range(n)]

    def check(self) -> dict:
        """The widest gap, under the reference, of every token the window
        served, all rows decoded together from the same context; on the
        moe family also the widest router-logit deficit of the program's
        expert choices."""
        dev, t = self.ctx.device, self.t
        served = torch.cat(self.served, dim=1)
        fed = torch.cat([self.first, served[:, :-1]], dim=1)
        port = self.ctx.config["port"]
        ref = Reference(self.arch, weight_bits=port["weight_bits"],
                        act_bits=port["act_bits"], seed=self.ctx.seed,
                        device=dev)

        def prefix(layer):
            kq, ks, vq, vs = context_kv(self.arch, t, self.ctx_lens,
                                        self.ctx.seed, layer, dev)
            return (kq.to(torch.float32) * ks[..., None],
                    vq.to(torch.float32) * vs[..., None])
        moe = self.arch["family"] == "moe"
        routes = self._routes(served.shape[1]) if moe else None
        if moe and routes is None:
            return {"route_gap": {"value": float("nan"),
                                  "limit": self.ctx.limits["route_gap"]}}
        logits, deficit = ref.decode_logits(fed, self.start, prefix, routes)
        out = {"max_gap": {"value": widest(served_gaps(logits, served)),
                           "limit": self.ctx.limits["max_gap"]}}
        if moe:
            out["route_gap"] = {"value": deficit,
                                "limit": self.ctx.limits["route_gap"]}
        return out
