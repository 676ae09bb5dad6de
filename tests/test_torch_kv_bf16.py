"""The bf16 KV cache of the dense, moe and vlm families
(``serve_kv_bits != 8``) against the JAX package, on reduced
tinyllama-1.1b, phi3.5-moe, llava-next-mistral-7b and llama4-maverick
(``moe_every = 2``), each at ``dataclasses.replace(cfg,
serve_kv_bits=16)``.

The reference builds the int8 cache with ``k_scale``/``v_scale`` only at
``serve_kv_bits == 8``; otherwise K and V are in the model dtype and
every entry point follows the cache (``"k_scale" in cache``).  Checked:

* ``init_cache``'s leaf names, dtypes and shapes, and ``cache_specs``,
  equal the reference's (no scale leaves);
* a prefill, 4 decode steps (one row frozen on even steps) and one
  verify wave in SDV and memory modes, the JAX package run op by op
  (ROADMAP Queue C (a)): the bf16 caches bit for bit, the logits within
  one bf16 rounding of their scale.  Under ``moe_every > 1`` the
  reference writes the grouped layers' K/V in bf16 too, so the int8
  truncation of property (e) does not arise;
* on tinyllama: ``prefill_slot``/``reset_slot`` bit for bit against the
  reference, ``verify_step`` == sequential ``decode_step``s, the
  speculative engine's tokens == the plain engine's, and the engine's
  tokens == the reference engine's (one bucket, 4 requests).

Both packages run on the same trees: the reference's seeded weights
carried across, as in the other parity tests, and the port's
``serve_params`` trees carried into the reference's containers
(``_to_reference``; the two packages' packing is held bit for bit in
``tests/test_torch_serving.py``, ``test_torch_moe.py`` and
``test_torch_vlm.py``).  In memory mode the K/V projections are bf16
GEMMs whose float32 sums XLA's CPU backend and torch order differently,
so a sum near a bf16 rounding boundary can round one ulp apart: with the
port's own seeded weights (``init_params(seed=0)``) 81 of reduced
tinyllama's 6144 K entries did, from the first decode step's layer 0 on.
At these weights no sum does, and the caches are held bit for bit.
Most of the time is the reference's eager op compiles, so the shapes
are shared across the tests: batch 3, s_max 16, chunks of 5 and 4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core import datapath as jdp
from repro.models import (Rules, decode_step, init_cache, init_params,
                          prefill_slot, prefill_step, reset_slot, specs,
                          values, verify_step)
from repro.models import quantized as jquant
from repro.models.param import Rules as JRules
from repro.serving import queue as j_queue
from repro.serving.engine import Engine as JEngine

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.serving import BucketShape, Engine
from test_torch_moe import _close
from test_torch_param_specs import _same_specs
from test_torch_serving import TickClock, _op_by_op, _same

ARCHS = ["tinyllama-1.1b", "phi3.5-moe", "llava-next-mistral-7b",
         "llama4-maverick"]
RULES = Rules(tp=None, fsdp=None, ep=None, batch=())
KV_BITS = 16
B, C, S_MAX, STEPS = 3, 5, 16, 4
N_VALID = np.array([5, 3, 0])
#: per-step advance masks: row 2 freezes on even steps
ADVANCE = [np.array([1, 1, s % 2]) for s in range(STEPS)]
VERIFY_N_VALID = np.array([4, 2, 1])
I32 = dict(dtype=torch.int32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors (more only contend
    with the test workers running beside this one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(reference config, unrolled for op-by-op runs; port config), both
    reduced with the bf16 KV cache."""
    cfg = dataclasses.replace(get_arch(arch).reduced(),
                              serve_kv_bits=KV_BITS)
    tcfg = dataclasses.replace(t_get_arch(arch).reduced(),
                               serve_kv_bits=KV_BITS)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    return cfg, dataclasses.replace(cfg, scan_layers=False), tcfg


def _j(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(t.numpy())


def _to_reference(node):
    """A port tree (float or packed) as the reference's: dicts of jax
    arrays, ``PackedLinear``/``SDVLinear`` as the reference's containers
    with the same words, scales and plan."""
    if isinstance(node, dict):
        return {k: _to_reference(v) for k, v in node.items()}
    if isinstance(node, tm.PackedLinear):
        return jquant.PackedLinear(words=_j(node.words),
                                   scale=_j(node.scale), bits=node.bits,
                                   d_out=node.d_out)
    if isinstance(node, tm.SDVLinear):
        p = node.plan
        plan = jdp.SDVPlan(spec=jdp.DATAPATHS[p.spec.name], w_a=p.w_a,
                           w_b=p.w_b, lane=p.lane, n=p.n,
                           signed_a=p.signed_a, signed_b=p.signed_b)
        return jquant.SDVLinear(words=_j(node.words), scale=_j(node.scale),
                                plan=plan, d_out=node.d_out)
    return _j(node)


@pytest.fixture(scope="module")
def models():
    """Per arch: the configs, the reference's seeded weights in both
    packages, and the port's ``serve_params`` trees by compute mode
    (built on first use), each also as the reference's tree."""
    memo = {}

    def get(arch, compute=None):
        if arch not in memo:
            cfg, ucfg, tcfg = _cfgs(arch)
            params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
            memo[arch] = dict(
                cfg=cfg, ucfg=ucfg, tcfg=tcfg, params=params,
                tparams=tm.params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, params),
                    device="cpu"))
        s = memo[arch]
        if compute is not None and ("tq", compute) not in s:
            s["tq", compute] = tm.serve_params(s["tparams"], bits=4,
                                               min_size=1024,
                                               compute=compute)
            s["jq", compute] = _to_reference(s["tq", compute])
        return s
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    cfg, _, tcfg = _cfgs(arch)
    ref = values(init_cache(cfg, RULES, B, S_MAX))
    port = tm.init_cache(tcfg, B, S_MAX, device="cpu")
    assert list(port) == list(ref) == ["index", "k", "v"]
    for k, v in ref.items():
        assert tuple(port[k].shape) == v.shape, k
        assert str(port[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert not port[k].any()
    assert port["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    cfg, _, tcfg = _cfgs(arch)
    trules = tm.Rules(tp_degree=2, batch_degree=16)
    jrules = JRules(**dataclasses.asdict(trules))
    _same_specs(tm.cache_specs(tcfg, trules, 16, 64),
                specs(init_cache(cfg, jrules, 16, 64, abstract=True)))


def _tokens(cfg):
    rng = np.random.default_rng(1)
    return dict(prompt=rng.integers(0, cfg.vocab, (B, C)),
                tokens=rng.integers(0, cfg.vocab, (STEPS, B, 1)),
                verify=rng.integers(0, cfg.vocab, (B, C)))


def _jax_run(s, compute, t):
    """prefill + STEPS decode steps + one verify wave of the reference,
    op by op: (logits of each step and of the wave, cache after the
    decode steps and after the wave)."""
    cfg, q = s["ucfg"], s["jq", compute]
    cache = values(init_cache(cfg, RULES, B, S_MAX))
    cache = prefill_step(cfg, q, cache, jnp.asarray(t["prompt"], jnp.int32),
                         jnp.asarray(N_VALID, jnp.int32))
    logits = []
    for i in range(STEPS):
        out, cache = decode_step(cfg, q, cache,
                                 jnp.asarray(t["tokens"][i], jnp.int32),
                                 advance=jnp.asarray(ADVANCE[i], jnp.int32))
        logits.append(np.asarray(out))
    decoded = dict(cache)
    out, cache = verify_step(cfg, q, cache, jnp.asarray(t["verify"],
                                                        jnp.int32),
                             jnp.asarray(VERIFY_N_VALID, jnp.int32))
    return logits, np.asarray(out), decoded, cache


def _port_run(s, compute, t):
    cfg, q = s["tcfg"], s["tq", compute]
    cache = tm.init_cache(cfg, B, S_MAX, device="cpu")
    cache = tm.prefill_step(cfg, q, cache, torch.tensor(t["prompt"], **I32),
                            torch.tensor(N_VALID, **I32))
    logits = []
    for i in range(STEPS):
        out, cache = tm.decode_step(cfg, q, cache,
                                    torch.tensor(t["tokens"][i], **I32),
                                    advance=torch.tensor(ADVANCE[i], **I32))
        logits.append(out.numpy())
    decoded = {k: v.clone() for k, v in cache.items()}
    out, cache = tm.verify_step(cfg, q, cache,
                                torch.tensor(t["verify"], **I32),
                                torch.tensor(VERIFY_N_VALID, **I32))
    return logits, out.numpy(), decoded, cache


@pytest.mark.parametrize("compute", ["sdv", "memory"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_verify_match_reference(models, arch, compute):
    s = models(arch, compute)
    t = _tokens(s["cfg"])
    (jl, jv, jd, jc), (tl, tv, td, tc) = (_jax_run(s, compute, t),
                                          _port_run(s, compute, t))
    for step, (a, b) in enumerate(zip(jl, tl)):
        assert b.dtype == np.float32 and np.isfinite(b).all()
        _close(b, a, f"{arch} {compute} decode step {step}")
    _close(tv, jv, f"{arch} {compute} verify")
    assert td["k"].dtype == torch.bfloat16 and "k_scale" not in td
    _same(jd, td)
    _same(jc, tc)
    # every layer wrote its K/V in bf16 (no int8 truncation, no zeros)
    for name in ("k", "v"):
        written = td[name][:, 0, :N_VALID[0] + STEPS]
        assert bool((written.abs().amax(dim=(-1, -2)) > 0).all()), name


def test_slots_match_reference(models):
    """A batch prefill, ``prefill_slot`` of slot 2 (two chunks), then
    ``reset_slot`` of slot 0 and one decode step: every leaf of the bf16
    cache equals the reference's run op by op."""
    s = models("tinyllama-1.1b", "sdv")
    ucfg, tcfg, jq, tq = s["ucfg"], s["tcfg"], s["jq", "sdv"], s["tq", "sdv"]
    rng = np.random.default_rng(2)
    first = rng.integers(0, ucfg.vocab, (B, C)).astype(np.int32)
    jc = prefill_step(ucfg, jq, values(init_cache(ucfg, RULES, B, S_MAX)),
                      first, np.array([5, 3, 2], np.int32))
    tc = tm.prefill_step(tcfg, tq, tm.init_cache(tcfg, B, S_MAX,
                                                 device="cpu"),
                         torch.tensor(first), torch.tensor([5, 3, 2], **I32))
    _same(jc, tc)
    for n in (4, 3):
        chunk = rng.integers(0, ucfg.vocab, (1, 4)).astype(np.int32)
        jc = prefill_slot(ucfg, jq, jc, 2, chunk, np.array([n], np.int32))
        tc = tm.prefill_slot(tcfg, tq, tc, 2, torch.tensor(chunk),
                             torch.tensor([n], **I32))
        _same(jc, tc)
    jc, tc = reset_slot(jc, 0), tm.reset_slot(tc, 0)
    _same(jc, tc)
    tok = rng.integers(0, ucfg.vocab, (B, 1)).astype(np.int32)
    _, jc = decode_step(ucfg, jq, jc, tok)
    _, tc = tm.decode_step(tcfg, tq, tc, torch.tensor(tok))
    _same(jc, tc)


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_verify_equals_sequential_decode(models, compute):
    """One ``verify_step`` over 4 columns gives the logits and the bf16
    cache of 4 sequential ``decode_step``s, bit for bit."""
    s = models("tinyllama-1.1b", compute)
    cfg, q = s["tcfg"], s["tq", compute]
    rng = np.random.default_rng(3)
    cache0 = tm.prefill_step(
        cfg, q, tm.init_cache(cfg, B, S_MAX, device="cpu"),
        torch.tensor(rng.integers(0, cfg.vocab, (B, C)), **I32),
        torch.tensor([5, 2, 4], **I32))
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 4)), **I32)
    vl, vc = tm.verify_step(cfg, q, {k: v.clone() for k, v in cache0.items()},
                            toks, torch.full((B,), 4, **I32))
    cache, logits = {k: v.clone() for k, v in cache0.items()}, []
    for j in range(4):
        out, cache = tm.decode_step(cfg, q, cache, toks[:, j:j + 1])
        logits.append(out)
    assert torch.equal(vl, torch.cat(logits, dim=1))
    for k in cache:
        assert torch.equal(vc[k], cache[k]), k


def _submit(eng, vocab, n=4, seed=11):
    rng = np.random.default_rng(seed)
    return [eng.submit([int(x) for x in rng.integers(0, vocab, 2 + i % 4)],
                       new_tokens=3 + i % 3) for i in range(n)]


def _tokens_of(eng, rids):
    toks = {c.rid: c.tokens for c in eng.completions}
    return [toks[r] for r in rids]


def test_engine_spec_equals_plain(models):
    """The speculative engine (k = 3, the W4A4 draft) on the bf16 cache
    gives the plain engine's tokens."""
    s = models("tinyllama-1.1b")
    out = {}
    for speculative in (False, True):
        eng = Engine(s["tcfg"], s["tparams"], buckets=(BucketShape(2, 16),),
                     plan_policy="auto", device="cpu", prefill_chunk=4,
                     speculative=speculative, spec_k=3)
        rids = _submit(eng, s["tcfg"].vocab, n=3)
        eng.drain()
        out[speculative] = (_tokens_of(eng, rids), eng)
    assert out[False][0] == out[True][0]
    st = out[True][1]._states["b2.s16"]
    assert st.work["k"].dtype == torch.bfloat16 and "k_scale" not in st.work
    sp = out[True][1].metrics.snapshot()["speculative"]
    assert sp["rounds"] > 0 and sp["degraded_buckets"] == 0


def test_engine_matches_reference(models):
    """The port's engine and the reference's (its jit seams op by op) on
    the bf16 cache, one bucket, 4 requests at once: the same tokens.  The
    reference engine is handed the tree ``serve_params(plan_policy=
    "default")`` gives, which the port's engine builds itself."""
    s = models("tinyllama-1.1b", "sdv")
    kw = dict(compute="sdv", plan_policy="default", clock=TickClock(0.002),
              prefill_chunk=4)
    jeng = _op_by_op(JEngine(s["cfg"], s["params"],
                             buckets=(j_queue.BucketShape(B, S_MAX),), **kw),
                     s["ucfg"])
    # the default plan's tree is the one the other tests run
    jeng._qparams_by_rows[B] = s["jq", "sdv"]
    teng = Engine(s["tcfg"], s["tparams"], device="cpu",
                  buckets=(BucketShape(B, S_MAX),), **kw)
    jr, tr = _submit(jeng, s["cfg"].vocab), _submit(teng, s["cfg"].vocab)
    jeng.drain()
    teng.drain()
    assert all(o["outcome"] == "ok" for o in teng.outcomes.values())
    assert _tokens_of(teng, tr) == _tokens_of(jeng, jr)
    assert all(len(t) == 3 + i % 3 for i, t in enumerate(_tokens_of(teng,
                                                                    tr)))
