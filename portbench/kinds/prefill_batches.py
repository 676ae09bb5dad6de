"""Traffic kind ``prefill_batches``: a closed loop of static batches of
long prompts, one output token each.

Mix parameters (``traffic/<mix>.json``): ``batch`` requests a batch;
prompt lengths from a pool of ``pool`` lengths spread evenly over
[``prompt_min``, ``prompt_max``], each pass over the pool in another
order drawn from the seed (every seed serves the same lengths; a pool of
``batch`` lengths gives every batch the same work); ``chunk``
columns a ``prefill_step``; ``s_max`` cache positions; ``max_batches``
batches whose prompts are drawn in set-up; ``check`` the
requests the reference judges (the longest finished one and others
drawn from the seed).

A batch: its prompts less their last token are prefilled through
``prefill_step`` in chunks of ``chunk`` columns (``n_valid`` per row),
then one ``decode_step`` on the last prompt tokens gives each request
its first token, read back to the host.  The next batch starts then,
on the same cache with its positions set back to 0 (every position a
request reads is written by it first).  The window runs whole batches
until ``seconds`` have passed: its rate counts every prompt token it
served over all its time.  A window called again goes on with the next
batch.
"""
from __future__ import annotations

import collections
import time

import torch

from portbench import program
from portbench.reference.decoder import Reference, served_gaps, widest
from portbench.weights import generator

#: generator slots of the traffic (the weights take 0 .. n_layers)
_ORDER_SLOT, _TOKEN_SLOT, _CHECK_SLOT = 1 << 9, (1 << 9) + 1, (1 << 9) + 2


def pool_lengths(traffic: dict):
    lo, hi, n = traffic["prompt_min"], traffic["prompt_max"], traffic["pool"]
    return [lo + (hi - lo) * i // (n - 1) for i in range(n)]


def lengths(traffic: dict, seed: int, n_requests: int):
    """The prompt length of each of the first ``n_requests`` requests:
    pass after pass over the pool, each in an order drawn from the
    seed."""
    pool = pool_lengths(traffic)
    gen = generator(seed, _ORDER_SLOT, "cpu")
    out = []
    while len(out) < n_requests:
        out += [pool[i] for i in torch.randperm(len(pool), generator=gen)]
    return out[:n_requests]


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
        self.cache = models.init_cache(self.cfg, b, t["s_max"], device=dev)
        # every request's prompt tokens, [batch index, row, position]
        self.tokens = torch.randint(
            0, self.arch["vocab"], (t["max_batches"], b, t["s_max"]),
            generator=generator(ctx.seed, _TOKEN_SLOT, dev), device=dev,
            dtype=torch.int32)
        self.lengths = lengths(t, ctx.seed, b * t["max_batches"])
        self.batches = []           # (batch index, lengths, first tokens)
        # warm-up: one chunk and one decode step at the cell's shapes
        toks = self.tokens[0]
        full = torch.full((b,), t["chunk"], dtype=torch.int32, device=dev)
        cache = models.prefill_step(self.cfg, self.params,
                                    self._reset(), toks[:, :t["chunk"]], full)
        models.decode_step(self.cfg, self.params, cache,
                           toks[:, t["chunk"]:t["chunk"] + 1])
        program.greedy(torch.zeros(b, 1, self.cfg.vocab_padded, device=dev),
                       self.arch["vocab"]).cpu()

    def _reset(self):
        self.cache = dict(self.cache, index=torch.zeros_like(
            self.cache["index"]))
        return self.cache

    def _batch(self, i: int):
        """Batch ``i``: prefill, the first token of each request.
        Returns (the prompt lengths, each chunk's real rows, the first
        tokens)."""
        t, dev, models = self.t, self.ctx.device, self.models
        b, c = t["batch"], t["chunk"]
        lens = self.lengths[i * b:(i + 1) * b]
        toks = self.tokens[i]
        n = max(lens) - 1                       # prefilled columns
        chunks = -(-n // c)
        valid = [[min(c, max(0, ln - 1 - j * c)) for ln in lens]
                 for j in range(chunks)]
        nv = torch.tensor(valid, dtype=torch.int32).to(dev)
        last = torch.tensor(lens, dtype=torch.int64).to(dev) - 1
        cache = self._reset()
        with torch.profiler.record_function("portbench.prefill_step"):
            for j in range(chunks):
                cache = models.prefill_step(self.cfg, self.params, cache,
                                            toks[:, j * c:(j + 1) * c], nv[j])
        with torch.profiler.record_function("portbench.decode_step"):
            logits, cache = models.decode_step(
                self.cfg, self.params, cache,
                toks.gather(1, last[:, None]))
        self.cache = cache
        with torch.profiler.record_function("portbench.readback"):
            first = program.greedy(logits, self.arch["vocab"])[:, 0].cpu()
        return lens, [sum(v) for v in valid], first

    def window(self, seconds: float) -> dict:
        t = self.t
        b = t["batch"]
        calls = collections.Counter()       # (rows, real rows) -> calls
        done = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(self.batches)
            if i >= t["max_batches"]:
                raise RuntimeError(f"more than max_batches={i} batches in "
                                   "the window")
            lens, real, first = self._batch(i)
            self.batches.append((i, lens, first))
            for rows in real:
                calls[b * t["chunk"], rows] += 1
            calls[b, b] += 1
            done += lens
        elapsed = time.perf_counter() - t0
        tokens = sum(done)
        return {
            "attempted": b * len(self.batches), "failed": 0,
            "end_to_end": {"prompt_tok_s": tokens / elapsed},
            "work": {
                "seconds": elapsed,
                "tokens": tokens,
                "context_sum": sum(n * (n + 1) // 2 for n in done),
                "logit_rows": len(done),
                # model calls as [rows, real rows, count]: the chunks at
                # batch x chunk rows, the first-token steps at batch rows
                "calls": [[r, v, n] for (r, v), n in sorted(calls.items())],
            },
        }

    def free_program(self):
        del self.params, self.cache

    def check(self) -> dict:
        """The widest gap, under the reference, of the first tokens of
        ``check`` requests: the longest finished one and others drawn
        from the seed."""
        t, dev = self.t, self.ctx.device
        reqs = [(i, r) for i, lens, _ in self.batches
                for r in range(len(lens))]
        lens = {(i, r): ln for i, ls, _ in self.batches
                for r, ln in enumerate(ls)}
        longest = max(reqs, key=lambda k: lens[k])
        rest = [k for k in reqs if k != longest]
        order = torch.randperm(len(rest),
                               generator=generator(self.ctx.seed,
                                                   _CHECK_SLOT, "cpu"))
        picked = [longest] + [rest[j] for j in order[:t["check"] - 1]]
        first = {i: f for i, _, f in self.batches}
        prompts = [self.tokens[i, r, :lens[(i, r)]]
                   for i, r in picked]
        served = torch.tensor([int(first[i][r]) for i, r in picked],
                              device=dev)
        port = self.ctx.config["port"]
        ref = Reference(self.arch, weight_bits=port["weight_bits"],
                        act_bits=port["act_bits"], seed=self.ctx.seed,
                        device=dev)
        gaps = served_gaps(ref.prompt_logits(prompts), served)
        return {"max_gap": {"value": widest(gaps),
                            "limit": self.ctx.limits["max_gap"]}}
