"""Parity of the torch port's serving stack (``repro_torch.serving``) and
slot entry points with the JAX package's, on reduced tinyllama-1.1b
(2 layers, d_model 128, vocab 512) at small shapes.

* ``queue``/``faults``/``metrics`` are the reference's decisions under
  an injected clock: the same random operation scripts give the same
  buckets, flushes, backpressure, sheds, fault schedules, percentiles
  and snapshots.
* ``reset_slot``/``prefill_slot`` leave every cache leaf bit-identical
  to the reference's run op by op (layer loop unrolled, no enclosing
  jit), as ``tests/test_torch_model.py`` holds the decode and prefill.
* The port's ``Engine`` and the JAX ``Engine`` (weights carried across
  with ``models/convert.py``) run one seeded Poisson trace under a fake
  clock and give the same outcomes, the same token stream per request
  and the same metrics.  The JAX engine's three jit seams are swapped
  for the same calls run op by op, on the unrolled config: under jit,
  XLA moves bf16 roundings (ROADMAP Queue C, property (a)), and the
  random-init logits are near-tied, so a greedy token there can flip
  and the stream diverges from then on (the near-tie caveat of
  ``tests/test_torch_model.py``; on such a trace 3 of 10 requests
  diverged at some token against the jitted reference, none against
  the op-by-op one).
* The port's engine keeps the reference's invariants: mixed stream and
  mid-wave joins bit-exact against alone runs, snapshot/restore and
  chaos with none lost, a corrupt plan cache demoting to ``"auto"``,
  and the pristine ``cache0`` of every bucket left untouched by warmup,
  by waves and by a wave lost to an injected fault (the port's caches
  are updated in place, the reference's never change).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.models import Rules, init_params, values
from repro.models import (decode_step as j_decode_step,
                          init_cache as j_init_cache,
                          prefill_slot as j_prefill_slot,
                          prefill_step as j_prefill_step,
                          reset_slot as j_reset_slot,
                          serve_params as j_serve_params)
from repro.serving import faults as j_faults
from repro.serving import loadgen as j_loadgen
from repro.serving import metrics as j_metrics
from repro.serving import queue as j_queue
from repro.serving.engine import Engine as JEngine

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.serving import (BucketShape, Engine, FaultPlan,
                                 corrupt_json_file)
from repro_torch.serving import faults as t_faults
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.serving import metrics as t_metrics
from repro_torch.serving import queue as t_queue
from repro_torch.serving.engine import FALLBACK_KEY

ROWS = 4                     # engine bucket width of the parity runs


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class TickClock(FakeClock):
    """A fake clock that also moves ``tick`` seconds at every reading,
    so waves take (simulated) time and arrivals join them mid-flight —
    the same in both engines, which read the clock in the same order."""

    def __init__(self, tick):
        super().__init__()
        self.tick = tick

    def __call__(self):
        self.t += self.tick
        return self.t


@pytest.fixture(scope="module")
def tiny():
    cfg = get_arch("tinyllama-1.1b").reduced()
    tcfg = t_get_arch("tinyllama-1.1b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = values(init_params(cfg, Rules(tp=None, fsdp=None, ep=None,
                                           batch=()),
                                jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                unrolled=dataclasses.replace(cfg, scan_layers=False))


def _engine(s, **kw):
    kw.setdefault("plan_policy", "auto")
    return Engine(s["tcfg"], s["tparams"], compute="sdv", device="cpu",
                  **kw)


# ---------------------------------------------------------------------------
# queue / faults / metrics: the same decisions under an injected clock
# ---------------------------------------------------------------------------

def _queue_script(mod, seed):
    """A random script of batcher operations; returns its decision log."""
    clock = FakeClock()
    buckets = (mod.BucketShape(2, 8), mod.BucketShape(3, 16),
               mod.BucketShape(2, 32))
    q = mod.ContinuousBatcher(buckets, clock=clock, queue_budget=6,
                              flush_budget=3)
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(80):
        op = int(rng.integers(0, 8))
        b = buckets[int(rng.integers(0, 3))]
        if op <= 2:
            pl, nt = int(rng.integers(1, 30)), int(rng.integers(1, 8))
            deadline = None if rng.random() < 0.5 \
                else clock() + float(rng.uniform(0.0, 0.5))
            req = mod.Request(prompt=tuple(range(pl)), new_tokens=nt,
                              deadline=deadline)
            try:
                r = q.submit(req, est_wave_s=float(rng.uniform(0, 0.2)))
                log.append(("submit", r.rid, r.submit_t))
            except (mod.Backpressure, mod.BucketUnavailable,
                    ValueError) as e:
                log.append(("submit", type(e).__name__, str(e)))
        elif op == 3:
            clock.advance(float(rng.uniform(0.0, 0.2)))
        elif op == 4:
            got = q.ready(est_wave_s=float(rng.uniform(0, 0.2)),
                          force=bool(rng.random() < 0.3))
            log.append(("ready", None if got is None else
                        (got[0].key, [r.rid for r in got[1]])))
        elif op == 5:
            log.append(("shed", [r.rid for r in q.shed_expired()]))
        elif op == 6 and rng.random() < 0.5:
            drained = q.quarantine(b)
            log.append(("quarantine", b.key, [r.rid for r in drained]))
            for r in drained:
                try:
                    log.append(("enqueue", r.rid, q.enqueue(r).key))
                except (mod.BucketUnavailable, ValueError) as e:
                    log.append(("enqueue", r.rid, type(e).__name__))
        elif op == 6:
            q.reinstate(b)
        else:
            n = int(rng.integers(0, 3))
            log.append(("take", b.key, [r.rid for r in q.take(b, n)]))
        log.append(("depth", q.depth(),
                    [q.pending(x) for x in buckets],
                    [x.key for x in q.quarantined()]))
    log.append([r.to_dict() for r in q.snapshot_requests()])
    return log


@pytest.mark.parametrize("seed", range(6))
def test_batcher_decisions_match_reference(seed):
    assert _queue_script(t_queue, seed) == _queue_script(j_queue, seed)


def test_queue_helpers_match_reference():
    for mod in (j_queue, t_queue):
        assert [b.key for b in mod.default_buckets()] \
            == ["b8.s32", "b8.s64", "b8.s128"]
        assert mod.time_remaining(None, 3.0) is None
        assert mod.time_remaining(5.0, 3.5) == 1.5
        r = mod.Request(prompt=[1, 2], new_tokens=3, deadline=9.0, rid=4,
                        submit_t=1.0)
        assert mod.Request.from_dict(r.to_dict()) == r
        for bad in (dict(prompt=(), new_tokens=2),
                    dict(prompt=(1,), new_tokens=0),
                    dict(prompt=("x",), new_tokens=2)):
            with pytest.raises(ValueError):
                mod.Request(**bad)


def _fault_script(mod, seed, classes):
    f = mod.FaultPlan.chaos(seed, classes)
    out = []
    for i in range(40):
        key = f"b{i % 3}"
        try:
            f.maybe_fail_compile(key)
            out.append("compiled")
        except mod.InjectedFault as e:
            out.append((e.kind, e.detail, str(e)))
        wf = f.begin_wave(key, 5 + i % 7)
        out.append((wf.fail_at_step, wf.skew_s, f.draw_malformed()))
        if i % 5 == 0:
            out.append(f.malformed_request(512, too_long=40))
    return out, f.log, f.counts()


@pytest.mark.parametrize("seed,classes", [
    (0, j_faults.FAULT_CLASSES), (1, j_faults.FAULT_CLASSES),
    (2, ("kernel_loss", "malformed")), (3, ("compile_fail", "slow_wave"))])
def test_fault_schedules_match_reference(seed, classes):
    assert t_faults.FAULT_CLASSES == j_faults.FAULT_CLASSES
    assert _fault_script(t_faults, seed, classes) \
        == _fault_script(j_faults, seed, classes)
    with pytest.raises(ValueError, match="unknown fault classes"):
        t_faults.FaultPlan.chaos(seed, ("bogus",))


def test_corrupt_json_file_matches_reference(tmp_path):
    for mod, name in ((j_faults, "j.json"), (t_faults, "t.json")):
        path = tmp_path / name
        path.write_text(json.dumps({"version": 1, "entries": {"a": 1}}))
        mod.corrupt_json_file(str(path), seed=5)
    assert (tmp_path / "j.json").read_bytes() \
        == (tmp_path / "t.json").read_bytes()


def _metrics_script(mod, seed):
    rng = np.random.default_rng(seed)
    clock = FakeClock(10.0)
    m = mod.EngineMetrics(clock=clock)
    for _ in range(60):
        op = int(rng.integers(0, 6))
        key = f"b{int(rng.integers(0, 2))}"
        clock.advance(float(rng.uniform(0, 0.1)))
        if op == 0:
            s = clock() - float(rng.uniform(0, 2))
            m.record_completion(submit_t=s, start_t=s + 0.1,
                                finish_t=clock(),
                                n_tokens=int(rng.integers(1, 9)))
        elif op == 1:
            m.record_wave(key, steps=int(rng.integers(1, 20)),
                          wall_s=float(rng.uniform(0, 1)),
                          requests=int(rng.integers(1, 4)),
                          busy_slot_steps=int(rng.integers(0, 40)),
                          slot_steps=40)
        elif op == 2:
            m.record_wave_failure(key, "kernel_loss")
            m.record_quarantine(key)
            m.record_recovery(key)
        elif op == 3:
            m.record_rejection(infeasible=bool(rng.random() < 0.5))
            m.record_shed()
            m.record_reroute()
        elif op == 4:
            m.record_join()
            m.record_decode_launch(int(rng.integers(0, 4)))
            m.sample_depth(int(rng.integers(0, 9)))
        else:
            m.record_malformed()
            m.record_failed()
            m.record_fallback_wave()
    return m.snapshot()


def _drop_port_only(snap):
    """The port's per-bucket decode/prefill iteration walls and its time
    to first token (absent from the reference's snapshot)."""
    snap.pop("ttft", None)
    for b in snap["buckets"].values():
        for k in ("decode_steps", "decode_wall_s", "prefill_calls",
                  "prefill_wall_s"):
            b.pop(k, None)
    return snap


@pytest.mark.parametrize("seed", range(3))
def test_metrics_snapshot_matches_reference(seed):
    want = _metrics_script(j_metrics, seed)
    got = _drop_port_only(_metrics_script(t_metrics, seed))
    assert got == want
    vals = list(np.random.default_rng(seed).exponential(1.0, 137))
    assert t_metrics.latency_summary(vals) == j_metrics.latency_summary(vals)
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert t_metrics.percentile(sorted(vals), q) \
            == j_metrics.percentile(sorted(vals), q) \
            == float(np.percentile(vals, q, method="inverted_cdf"))


@pytest.fixture(scope="module")
def trees(tiny):
    """(reference, port) serve trees by (arch, compute), from the same
    weights, planned for ``ROWS`` rows; built once per module."""
    memo = {}

    def get(arch, compute):
        if (arch, compute) not in memo:
            if arch == "tinyllama-1.1b":
                params, tparams = tiny["params"], tiny["tparams"]
            else:
                cfg = get_arch(arch).reduced()
                params = values(init_params(
                    cfg, Rules(tp=None, fsdp=None, ep=None, batch=()),
                    jax.random.PRNGKey(0)))
                tparams = tm.params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, params), device="cpu")
            kw = dict(bits=4, min_size=1024, compute=compute, rows=ROWS,
                      plan_policy="auto" if compute == "sdv" else "default")
            memo[arch, compute] = (j_serve_params(params, **kw),
                                   tm.serve_params(tparams, **kw))
        return memo[arch, compute]
    return get


@pytest.mark.parametrize("arch,compute", [
    ("tinyllama-1.1b", "sdv"), ("tinyllama-1.1b", "memory"),
    ("mamba2-130m", "sdv")])
def test_packed_utilization_matches_reference(trees, arch, compute):
    jtree, ttree = trees(arch, compute)
    want = j_metrics.packed_utilization(jtree, ROWS)
    got = t_metrics.packed_utilization(ttree, ROWS)
    assert got == want and got["packed_layers"] > 0


def test_write_snapshot_atomic(tmp_path):
    path = tmp_path / "snap.json"
    t_metrics.write_snapshot(str(path), {"b": [1, 2], "a": 0.5})
    assert json.loads(path.read_text()) == {"a": 0.5, "b": [1, 2]}
    with pytest.raises(TypeError):
        t_metrics.write_snapshot(str(path), {"bad": object()})
    assert json.loads(path.read_text()) == {"a": 0.5, "b": [1, 2]}
    assert [p.name for p in tmp_path.iterdir()] == ["snap.json"]


# ---------------------------------------------------------------------------
# the slot entry points, op by op
# ---------------------------------------------------------------------------

def _np(cache):
    return {k: np.asarray(v) for k, v in cache.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same(jc, tc):
    """Every leaf bit for bit (bf16 leaves as their 16-bit patterns)."""
    assert set(jc) == set(tc)
    for k in jc:
        t = tc[k].view(torch.int16) if tc[k].dtype == torch.bfloat16 \
            else tc[k]
        assert (_bits(jc[k]) == t.numpy()).all(), k


@pytest.mark.parametrize("slot", [0, 2])
def test_prefill_and_reset_slot_bit_identical(tiny, trees, slot):
    """A batch prefill, then ``prefill_slot`` of one slot (twice: the
    second chunk continues at the slot's position), then ``reset_slot``
    of another: every cache leaf equals the reference's run op by op."""
    ucfg, tcfg = tiny["unrolled"], tiny["tcfg"]
    jq, tq = trees("tinyllama-1.1b", "sdv")
    rng = np.random.default_rng(slot)
    first = rng.integers(0, ucfg.vocab, (3, 5))
    chunks = [rng.integers(0, ucfg.vocab, (1, 4)) for _ in range(2)]
    jc = j_init_cache(ucfg, Rules(tp=None, fsdp=None, ep=None, batch=()),
                      3, 16)
    jc = j_prefill_step(ucfg, jq, values(jc), first.astype(np.int32),
                        np.array([5, 3, 2], np.int32))
    tc = tm.init_cache(tcfg, 3, 16, device="cpu")
    tc = tm.prefill_step(tcfg, tq, tc, torch.tensor(first, dtype=torch.int32),
                         torch.tensor([5, 3, 2], dtype=torch.int32))
    _same(jc, tc)
    for chunk, n in zip(chunks, (4, 3)):
        jc = j_prefill_slot(ucfg, jq, jc, slot, chunk.astype(np.int32),
                            np.array([n], np.int32))
        before = tc["index"].clone()
        tc = tm.prefill_slot(tcfg, tq, tc, slot,
                             torch.tensor(chunk, dtype=torch.int32),
                             torch.tensor([n], dtype=torch.int32))
        assert tc["index"] is not before
        _same(jc, tc)
    other = (slot + 1) % 3
    jc = j_reset_slot(jc, other)
    tc = tm.reset_slot(tc, other)
    _same(jc, tc)
    assert int(tc["index"][other]) == 0
    # a decode step after both: the frozen and reset rows stay in step
    tok = rng.integers(0, ucfg.vocab, (3, 1)).astype(np.int32)
    adv = np.array([1, 0, 1], np.int32)
    jl, jc = j_decode_step(ucfg, jq, jc, tok, advance=adv)
    tl, tc = tm.decode_step(tcfg, tq, tc, torch.tensor(tok),
                            advance=torch.tensor(adv))
    _same(jc, tc)


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_reset_slot_recurrent_caches(arch):
    """``reset_slot`` clears one slot of every recurrent-state leaf and
    leaves the others, as the reference does."""
    cfg = get_arch(arch).reduced()
    tcfg = t_get_arch(arch).reduced()
    rules = Rules(tp=None, fsdp=None, ep=None, batch=())
    rng = np.random.default_rng(0)
    jc = values(j_init_cache(cfg, rules, 3, 8))
    filled = {k: (rng.standard_normal(np.shape(v)) * 8).astype(
        np.asarray(v).dtype) if np.asarray(v).dtype != np.int32 else
        np.array([3, 4, 5], np.int32) for k, v in _np(jc).items()}
    tc = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
          if v.dtype.name == "bfloat16" else torch.from_numpy(v.copy())
          for k, v in filled.items()}
    assert set(tc) == set(tm.init_cache(tcfg, 3, 8, device="cpu"))
    want = j_reset_slot({k: jax.numpy.asarray(v)
                         for k, v in filled.items()}, 1)
    _same(want, tm.reset_slot(tc, 1))


# ---------------------------------------------------------------------------
# the engine against the JAX engine, one seeded trace
# ---------------------------------------------------------------------------

TRACE = dict(rate=40.0, duration_s=0.15, prompt_len=10, new_tokens=6)
TRACE_BUCKETS = (16, 32)
TICK_S = 0.002


def _op_by_op(engine, ucfg):
    """The reference engine with its jit seams run op by op."""
    engine.cfg = ucfg
    engine._dec = lambda p, c, t, adv: j_decode_step(ucfg, p, c, t,
                                                     advance=adv)
    engine._pre = lambda p, c, s, t, nv: j_prefill_slot(ucfg, p, c, s, t, nv)
    engine._reset = j_reset_slot
    return engine


def _drive(mod, engine, clock, seed):
    snap = mod.run_poisson(engine, **TRACE, rng=np.random.default_rng(seed),
                           sleep=clock.advance)
    toks = {c.rid: c.tokens for c in engine.completions}
    return snap, toks, dict(engine.outcomes)


@pytest.fixture(scope="module")
def engine_pair(tiny):
    seed = 3
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    arr = j_loadgen.poisson_arrivals(TRACE["rate"], TRACE["duration_s"],
                                     rng_j)
    assert arr == t_loadgen.poisson_arrivals(
        TRACE["rate"], TRACE["duration_s"], rng_t)
    specs = j_loadgen._request_specs(len(arr), 512, 10, 6, rng_j)
    assert specs == t_loadgen._request_specs(len(arr), 512, 10, 6, rng_t)
    out = {}
    jclock = TickClock(TICK_S)
    jeng = _op_by_op(JEngine(
        tiny["cfg"], tiny["params"], compute="sdv", plan_policy="auto",
        clock=jclock, prefill_chunk=4,
        buckets=tuple(j_queue.BucketShape(ROWS, s) for s in TRACE_BUCKETS)),
        tiny["unrolled"])
    out["jax"] = _drive(j_loadgen, jeng, jclock, seed)
    tclock = TickClock(TICK_S)
    teng = _engine(tiny, clock=tclock, prefill_chunk=4,
                   buckets=tuple(BucketShape(ROWS, s) for s in TRACE_BUCKETS))
    out["port"] = _drive(t_loadgen, teng, tclock, seed)
    out["specs"] = specs
    return out


def test_engine_trace_matches_reference(engine_pair):
    (jsnap, jtoks, jout), (tsnap, ttoks, tout) = \
        engine_pair["jax"], engine_pair["port"]
    assert tout == jout and len(tout) == len(engine_pair["specs"]) >= 4
    assert all(o["outcome"] == "ok" for o in tout.values())
    assert ttoks == jtoks
    assert tsnap["waves"]["midwave_joins"] >= 1


def test_engine_metrics_match_reference(engine_pair):
    """Under the ticking fake clock the whole snapshot is deterministic: waves,
    joins, occupancy, latencies and the per-bucket plan utilization
    agree with the reference's."""
    jsnap, tsnap = engine_pair["jax"][0], engine_pair["port"][0]
    assert _drop_port_only(json.loads(json.dumps(tsnap))) \
        == json.loads(json.dumps(jsnap))


# ---------------------------------------------------------------------------
# the reference's engine invariants, on the port's engine
# ---------------------------------------------------------------------------

def _mixed(vocab, n, seed=7):
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(0, vocab,
                                                int(rng.integers(2, 8)))),
             int(rng.integers(2, 5))) for _ in range(n)]


def _alone(eng, prompt, nt):
    rid = eng.submit(prompt, nt)
    return {c.rid: c for c in eng.drain()}[rid].tokens


def test_mixed_stream_bit_exact_vs_alone(tiny):
    eng = _engine(tiny, buckets=(BucketShape(ROWS, 16),))
    specs = _mixed(tiny["tcfg"].vocab, 5)
    rids = [eng.submit(p, nt) for p, nt in specs]
    mixed = {c.rid: c for c in eng.drain()}
    assert sorted(mixed) == sorted(rids)
    st = eng._states["b4.s16"]
    for (prompt, nt), rid in zip(specs, rids):
        assert len(mixed[rid].tokens) == nt
        assert _alone(eng, prompt, nt) == mixed[rid].tokens, rid
    assert eng._states["b4.s16"] is st            # state persists
    assert st.sessions.free_slots() == ROWS


def test_midwave_join_bit_exact_vs_alone(tiny):
    eng = _engine(tiny, buckets=(BucketShape(2, 16),), prefill_chunk=4)
    specs = {"long": ((1, 2, 3, 4, 5), 6), "short": ((6, 7), 2),
             "join": ((8, 9, 10, 11, 12, 13), 3)}
    r_long = eng.submit(*specs["long"])
    r_short = eng.submit(*specs["short"])
    comps = []
    while not any(c.rid == r_short for c in comps):
        comps.extend(eng.step())
    assert eng.busy()
    r_join = eng.submit(*specs["join"])
    comps.extend(eng.drain())
    got = {c.rid: c for c in comps}
    assert sorted(got) == sorted([r_long, r_short, r_join])
    assert got[r_join].midwave_join and not got[r_long].midwave_join
    assert eng.metrics.midwave_joins == 1
    for key, rid in (("long", r_long), ("join", r_join)):
        assert _alone(eng, *specs[key]) == got[rid].tokens, key


def test_snapshot_restore_midwave_none_lost(tiny):
    buckets = (BucketShape(2, 16),)
    a = _engine(tiny, buckets=buckets, clock=FakeClock(100.0))
    specs = [((1, 2, 3), 3), ((4, 5, 6, 7), 2), ((8, 9), 2)]
    rids = [a.submit(p, nt) for p, nt in specs]
    a.step()                               # a wave is in flight
    assert a.busy()
    snap = json.loads(json.dumps(a.snapshot()))
    assert sorted(r["rid"] for r in snap["requests"]) == sorted(rids)
    b = _engine(tiny, buckets=buckets, clock=FakeClock(200.0))
    assert b.restore(snap) == len(specs)
    comps = {c.rid: c for c in b.drain()}
    assert sorted(comps) == sorted(rids)
    assert all(c.submit_t == 100.0 for c in comps.values())
    assert b.submit((1, 2), 2) == len(specs)        # rid watermark kept
    c = _engine(tiny, buckets=buckets)
    c_rids = [c.submit(p, nt) for p, nt in specs]
    c_comps = {r.rid: r for r in c.drain()}
    for rid, crid in zip(rids, c_rids):
        assert comps[rid].tokens == c_comps[crid].tokens
    with pytest.raises(ValueError, match="snapshot version"):
        b.restore({"version": 2})


@pytest.mark.parametrize("state", ["missing", "valid", "corrupt"])
def test_plan_policy_resolution(tiny, tmp_path, state):
    """No cache file: ``"auto"``; a valid one: ``"cache"``; a corrupt one
    demotes ``"cache"`` to ``"auto"`` with a warning, never raising."""
    path = tmp_path / "plans.json"
    if state != "missing":
        path.write_text(json.dumps({"version": 1, "entries": {}}))
    if state == "corrupt":
        corrupt_json_file(str(path), seed=0)
        with pytest.warns(UserWarning, match="plan cache unusable"):
            eng = Engine(tiny["tcfg"], tiny["tparams"], device="cpu",
                         plan_policy="cache", plan_cache=str(path))
        assert eng.plan_policy == "auto"
        return
    eng = Engine(tiny["tcfg"], tiny["tparams"], device="cpu",
                 plan_cache=str(path))
    assert eng.plan_policy == {"missing": "auto", "valid": "cache"}[state]
    assert Engine(tiny["tcfg"], tiny["tparams"], device="cpu",
                  compute="memory").plan_policy == "default"
    with pytest.raises(ValueError, match="plan policy"):
        Engine(tiny["tcfg"], tiny["tparams"], device="cpu",
               plan_policy="bogus")


CHAOS_SEED = 3


def test_chaos_none_lost(tiny):
    """The all-classes chaos schedule on a fake clock with mid-wave
    joins (seeded so that every class fires, a wave is lost mid-flight
    and a request joins one): every admitted request reaches exactly
    one terminal outcome, the faults fire, joins happen, and a
    completion is bit-exact vs a fault-free run in the shape it used
    (the fallback's packs the uniform default plans)."""
    clock = FakeClock()
    faults = FaultPlan.chaos(seed=CHAOS_SEED)
    buckets = (BucketShape(2, 12), BucketShape(2, 16))
    eng = _engine(tiny, clock=clock, faults=faults, breaker_threshold=2,
                  breaker_cooldown_s=0.05, buckets=buckets, prefill_chunk=4)
    admitted = {}
    snap = t_loadgen.run_poisson(eng, rate=60.0, duration_s=0.2,
                                 prompt_len=6, new_tokens=4,
                                 rng=np.random.default_rng(CHAOS_SEED),
                                 slo_s=2.0,
                                 retries=2, backoff_s=0.005, faults=faults,
                                 admitted_out=admitted, sleep=clock.advance)
    assert snap["lost_requests"] == 0
    assert sum(snap["client_outcomes"].values()) == snap["offered_requests"]
    assert set(eng.outcomes) == set(admitted.values())
    assert all(o["outcome"] in ("ok", "shed", "failed")
               for o in eng.outcomes.values())
    fired = faults.counts()
    assert fired.get("compile_fail", 0) >= 2 and fired.get("kernel_loss")
    ok = sorted(r for r, o in eng.outcomes.items() if o["outcome"] == "ok")
    comps = {c.rid: c for c in eng.completions}
    assert ok == sorted(comps) and ok
    assert eng.metrics.midwave_joins > 0
    rng = np.random.default_rng(CHAOS_SEED)
    arrivals = t_loadgen.poisson_arrivals(60.0, 0.2, rng)
    specs = t_loadgen._request_specs(len(arrivals), tiny["tcfg"].vocab, 6,
                                     4, rng)
    idx = {rid: i for i, rid in admitted.items()}
    c = comps[ok[-1]]
    fb = FALLBACK_KEY in eng._states \
        and c.bucket_key == eng._states[FALLBACK_KEY].bucket.key
    shape = eng._states[FALLBACK_KEY if fb else c.bucket_key].bucket
    ref = _engine(tiny, buckets=(shape,),
                  plan_policy="default" if fb else "auto")
    assert _alone(ref, *specs[idx[c.rid]]) == c.tokens


def _pristine(st):
    return all(bool((v == 0).all()) for v in st.cache0.values())


@pytest.mark.parametrize("after", ["warmup", "wave", "kernel_loss"])
def test_cache0_stays_pristine(tiny, after):
    """The model calls update caches in place: warmup, a wave and a
    wave lost mid-flight must leave every bucket's ``cache0`` all zeros
    (a retried wave starts from it), and the retry gives the clean
    tokens."""
    faults = FaultPlan(seed=0, kernel_loss_p=1.0) \
        if after == "kernel_loss" else None
    eng = _engine(tiny, buckets=(BucketShape(2, 16),), faults=faults,
                  prefill_chunk=4)
    st = eng.warmup(BucketShape(2, 16))
    assert _pristine(st)
    assert any(bool((v != 0).any()) for k, v in st.work.items()
               if k != "index")                  # warmup did write
    if after == "warmup":
        return
    specs = [((1, 2, 3, 4, 5, 6), 3), ((7, 8, 9), 4)]
    rids = [eng.submit(p, nt) for p, nt in specs]
    comps = {}
    while eng.depth():
        for c in eng.step(force=True):
            comps[c.rid] = c
        if faults is not None and faults.counts().get("kernel_loss"):
            faults.kernel_loss_p = 0.0          # lose exactly one wave
    assert _pristine(st)
    assert all(eng.outcomes[r]["outcome"] == "ok" for r in rids)
    if after == "kernel_loss":
        assert eng.metrics.failure_kinds == {"kernel_loss": 1}
        clean = _engine(tiny, buckets=(BucketShape(2, 16),),
                        prefill_chunk=4)
        for (p, nt), rid in zip(specs, rids):
            assert _alone(clean, p, nt) == comps[rid].tokens


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_serve_cli_engine_on_cpu(capsys):
    from repro_torch.launch.serve import main
    assert main(["--engine", "on", "--device", "cpu", "--smoke",
                 "--plan-policy", "auto", "--batch", "2", "--prompt-len",
                 "4", "--new-tokens", "3", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert "engine, sdv compute, plan policy auto" in out
    assert "3 done (0 rejected, 0 shed)" in out
    assert "8/8 packed layers on kernel routes" in out


def test_loadgen_cli_on_cpu(tmp_path, capsys):
    path = tmp_path / "serve.json"
    payload = t_loadgen.main([
        "--device", "cpu", "--rates", "60", "--duration", "0.05",
        "--computes", "sdv,memory", "--batch", "2", "--buckets", "12",
        "--prompt-len", "4", "--new-tokens", "3", "--plan-policy", "auto",
        "--json", str(path)])
    assert payload["backend"] == "cpu" and payload["plan_policy"] == "auto"
    assert json.loads(path.read_text())["curves"] == \
        json.loads(json.dumps(payload["curves"]))
    for c in payload["curves"]:
        assert c["lost_requests"] == 0
        assert c["requests_completed"] == c["client_outcomes"]["ok"]
    assert "sdv @   60.0 req/s" in capsys.readouterr().out
