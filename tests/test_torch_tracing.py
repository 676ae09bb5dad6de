"""The port's profiler spans and expert-choice record
(``repro_torch.tracing``) and the serving engine's first-token time, on
the CPU at reduced size: with no profiler the spans open no range at all
(the range constructors patched to raise); under ``torch.profiler`` the
model steps leave the spans of ``tracing``'s table, nested as the layers
are; a profiler changes no logit and no cache entry; every completion's
first token lies between its start and its finish."""
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.models as tm
from repro_torch import tracing
from repro_torch.configs.registry import get_arch
from repro_torch.serving import BucketShape, Engine

#: (arch, step): a reduced phi3.5-moe decode step (SDV attention and
#: head, memory-packed expert banks) and a reduced dense prefill step
CASES = [("phi3.5-moe", "decode"), ("tinyllama-1.1b", "prefill")]
BATCH, S_MAX, CHUNK = 3, 16, 5
PREFIX = "repro_torch."


@pytest.fixture(scope="module")
def models():
    """Per arch: its config and its SDV serve tree (reduced)."""
    out = {}
    for arch, _ in CASES:
        cfg = get_arch(arch).reduced()
        params = tm.init_params(cfg, seed=1, device="cpu")
        out[arch] = (cfg, tm.serve_params(params, bits=4, min_size=1024,
                                          compute="sdv"))
    return out


def _run(models, arch, step):
    """One step on a fresh cache: (logits or None, the cache)."""
    cfg, q = models[arch]
    rng = np.random.default_rng(3)
    cache = tm.init_cache(cfg, BATCH, S_MAX, device="cpu")
    if step == "prefill":
        toks = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, CHUNK)),
                            dtype=torch.int32)
        n_valid = torch.tensor([CHUNK, 2, 0], dtype=torch.int32)
        return None, tm.prefill_step(cfg, q, cache, toks, n_valid)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, 1)),
                        dtype=torch.int32)
    return tm.decode_step(cfg, q, cache, toks)


def _profiled(models, arch, step):
    """(the step's outputs, its spans as (name, start, end) in start
    order) under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _run(models, arch, step)
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def _parents(spans):
    """Each span with the name of the innermost span around it (None at
    the top)."""
    out, open_ = [], []
    for name, a, b in spans:
        while open_ and open_[-1][2] < b:
            open_.pop()
        out.append((name, open_[-1][0] if open_ else None))
        open_.append((name, a, b))
    return out


def _no_ranges(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)


def test_span_without_a_profiler_is_the_shared_noop(monkeypatch):
    _no_ranges(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    a, b = tracing.span("repro_torch.a"), tracing.span("repro_torch.b")
    assert a is b
    with a:
        pass
    assert tracing.spanned("repro_torch.c")(lambda x: x + 1)(1) == 2


@pytest.mark.parametrize("arch,step", CASES)
def test_steps_open_no_range_without_a_profiler(models, arch, step,
                                                monkeypatch):
    _no_ranges(monkeypatch)
    logits, cache = _run(models, arch, step)
    assert cache["index"].tolist() == ([1] * BATCH if step == "decode"
                                       else [CHUNK, 2, 0])
    assert logits is None or bool(torch.isfinite(logits).all())


#: (span, the span it lies in) that every case's steps show, by step
NESTING = {
    "decode": {("repro_torch.decode_step", None),
               ("repro_torch.attn", "repro_torch.decode_step"),
               ("repro_torch.attn.qkv", "repro_torch.attn"),
               ("repro_torch.attn.kv", "repro_torch.attn"),
               ("repro_torch.attn.core", "repro_torch.attn"),
               ("repro_torch.attn.out", "repro_torch.attn"),
               ("repro_torch.moe", "repro_torch.decode_step"),
               ("repro_torch.moe.route", "repro_torch.moe"),
               ("repro_torch.moe.dispatch", "repro_torch.moe"),
               ("repro_torch.moe.experts", "repro_torch.moe"),
               ("repro_torch.moe.combine", "repro_torch.moe"),
               ("repro_torch.head", "repro_torch.decode_step")},
    "prefill": {("repro_torch.prefill_step", None),
                ("repro_torch.attn", "repro_torch.prefill_step"),
                ("repro_torch.attn.qkv", "repro_torch.attn"),
                ("repro_torch.attn.kv", "repro_torch.attn"),
                ("repro_torch.attn.core", "repro_torch.attn"),
                ("repro_torch.attn.out", "repro_torch.attn"),
                ("repro_torch.mlp", "repro_torch.prefill_step")},
}


@pytest.mark.parametrize("arch,step", CASES)
def test_spans_nest_as_the_layers(models, arch, step):
    """Each span lies in the one the table puts it in, every layer opens
    its attention and FFN spans once, and a profiler changes no logit
    and no cache entry."""
    cfg = models[arch][0]
    (logits, cache), spans = _profiled(models, arch, step)
    pairs = _parents(spans)
    assert set(pairs) == NESTING[step]
    names = [n for n, _ in pairs]
    ffn = "repro_torch.moe" if cfg.family == "moe" else "repro_torch.mlp"
    for name in ("repro_torch.attn", "repro_torch.attn.kv",
                 "repro_torch.attn.core", ffn):
        assert names.count(name) == cfg.n_layers, name
    want_logits, want_cache = _run(models, arch, step)
    assert (logits is None) == (want_logits is None)
    assert logits is None or torch.equal(logits, want_logits)
    assert cache.keys() == want_cache.keys()
    assert all(torch.equal(cache[k], want_cache[k]) for k in cache)


def test_expert_routes_are_moe_route_as_returned(models, monkeypatch):
    """The record holds, in call order, the very tensors ``moe_route``
    returned (no copy); nested records each see every call, and a closed
    record takes no more."""
    from repro_torch.models import layers
    cfg = models["phi3.5-moe"][0]
    orig, returned = layers.moe_route, []

    def spy(*a):
        r = orig(*a)
        returned.append(r)
        return r
    monkeypatch.setattr(layers, "moe_route", spy)
    with tracing.expert_routes() as outer:
        with tracing.expert_routes() as inner:
            _run(models, "phi3.5-moe", "decode")
        _run(models, "phi3.5-moe", "decode")
    _run(models, "phi3.5-moe", "decode")
    assert len(returned) == 3 * cfg.n_layers
    assert len(inner) == cfg.n_layers and len(outer) == 2 * cfg.n_layers
    assert inner == outer[:cfg.n_layers]
    for (top_e, slot, keep), r in zip(outer, returned):
        assert top_e is r[0] and slot is r[2] and keep is r[3]
    assert not tracing._ROUTES


class TickClock:
    """A clock that moves 1 ms at every reading."""
    def __init__(self):
        self.ticks = itertools.count()

    def __call__(self):
        return 100.0 + next(self.ticks) * 1e-3


@pytest.mark.parametrize("speculative", [False, True])
def test_first_token_time(speculative):
    """Every completion's first token comes at or after its start and at
    or before its finish, at the finish for a one-token request; the
    snapshot's time to first token counts every completion."""
    cfg = get_arch("tinyllama-1.1b").reduced()
    eng = Engine(cfg, tm.init_params(cfg, seed=0, device="cpu"),
                 buckets=(BucketShape(2, 16),), speculative=speculative,
                 prefill_chunk=4, spec_k=3, plan_policy="auto",
                 device="cpu", clock=TickClock())
    new = [1, 4, 3]
    rids = [eng.submit([1 + i, 2, 3 + i][:2 + i % 2], new_tokens=n)
            for i, n in enumerate(new)]
    comps = {c.rid: c for c in eng.drain()}
    assert sorted(comps) == sorted(rids)
    for rid, n in zip(rids, new):
        c = comps[rid]
        assert c.submit_t <= c.start_t <= c.first_token_t <= c.finish_t
        if n == 1:
            assert c.first_token_t == c.finish_t
        elif not speculative:               # a token a step
            assert c.first_token_t < c.finish_t
    ttft = eng.metrics.snapshot()["ttft"]
    assert ttft["count"] == len(rids)
    want = sorted(c.first_token_t - c.submit_t for c in comps.values())
    assert ttft["max_ms"] == pytest.approx(want[-1] * 1e3)
