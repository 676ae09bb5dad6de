"""The torch port's speculative ``Engine`` against the JAX package's, on
reduced tinyllama-1.1b (2 layers, d_model 128, vocab 512): weights
carried across with ``models/convert.py``, one seeded Poisson trace
under a ticking fake clock, and the same outcomes, token streams and
speculative counters (rounds, acceptance histogram, walls).  The JAX
engine's seams run op by op on the unrolled config, as
``tests/test_torch_serving.py`` runs them: decode, prefill and reset,
the draft's ``lax.scan`` as a Python loop, the verify program unjitted
(under jit XLA moves bf16 roundings, and random-init logits are
near-tied).  The JAX package's first calls compile every op for each
new shape (most of this file's time), so the trace is short.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_arch
from repro.models import Rules, init_params, values
from repro.models import (decode_step as j_decode_step,
                          prefill_slot as j_prefill_slot,
                          reset_slot as j_reset_slot,
                          serve_params as j_serve_params)
from repro.serving import loadgen as j_loadgen
from repro.serving import queue as j_queue
from repro.serving.engine import Engine as JEngine
from repro.serving.spec import SpecDecoder as JSpecDecoder

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.serving import BucketShape, Engine
from repro_torch.serving import loadgen as t_loadgen

ROWS = 2                     # bucket width
K = 3                        # drafted tokens per round
S_MAX = 16                   # the bucket's cache length


class TickClock:
    """A fake clock that moves ``tick`` seconds at every reading
    (``tests/test_torch_serving.py``), so both engines see the same
    times when they read it in the same order."""

    def __init__(self, tick):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t

    def advance(self, dt):
        self.t += dt


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
    jdec = JSpecDecoder(cfg, params, plan_policy="auto")
    kw = dict(bits=4, min_size=1024, compute="sdv", plan_policy="auto",
              rows=ROWS)
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                unrolled=dataclasses.replace(cfg, scan_layers=False),
                jq=j_serve_params(params, act_bits=8, **kw),
                jdraft=jdec.draft_qparams(ROWS))


def _j_op_by_op_spec(engine, ucfg):
    """The reference's speculative engine with every jit seam run op by
    op: decode, prefill and reset as ``test_torch_serving.py`` swaps
    them, the draft's ``lax.scan`` as a Python loop, the verify program
    unjitted (its ``verify_step`` runs the unrolled layer loop)."""
    engine._dec = lambda p, c, t, adv: j_decode_step(ucfg, p, c, t,
                                                     advance=adv)
    # the tests run JAX with x64 on, where the verify program's fused
    # rollback widens ``index`` to int64 and the reference's
    # ``prefill_slot`` then refuses to merge its int32 slot back; the
    # seam hands it the int32 index (a no-op without x64)
    engine._pre = lambda p, c, s, t, nv: j_prefill_slot(
        ucfg, p, dict(c, index=jnp.asarray(c["index"], jnp.int32)), s, t,
        nv)
    engine._reset = j_reset_slot
    k, vocab = engine.spec.config.k, ucfg.vocab

    def draft(qp, cache, pending, adv):
        cache = dict(cache, index=jnp.asarray(cache["index"], jnp.int32))
        tok = jnp.asarray(pending, jnp.int32)
        out = []
        for _ in range(k):
            logits, cache = j_decode_step(ucfg, qp, cache, tok[:, None],
                                          advance=adv)
            tok = jnp.argmax(logits[:, -1, :vocab], axis=-1).astype(
                jnp.int32)
            out.append(tok)
        return jnp.stack(out, axis=1)

    engine.spec.draft = draft
    engine.spec.verify = engine.spec.verify.__wrapped__
    return engine


def test_engine_spec_trace_matches_reference(tiny):
    """The port's speculative engine and the reference's (op by op) over
    one seeded Poisson trace under a ticking fake clock: the same
    outcomes, token streams, rounds and acceptance histogram."""
    trace = dict(rate=40.0, duration_s=0.05, prompt_len=5, new_tokens=4)
    seed = 3                  # 3 requests: the third joins mid-wave
    buckets = (S_MAX,)
    jclock = TickClock(0.002)
    jeng = _j_op_by_op_spec(JEngine(
        tiny["unrolled"], tiny["params"], compute="sdv", plan_policy="auto",
        clock=jclock, prefill_chunk=4, speculative=True, spec_k=K,
        buckets=tuple(j_queue.BucketShape(ROWS, s) for s in buckets)),
        tiny["unrolled"])
    # the trees the engines would build, already built (same calls)
    jeng._qparams_by_rows[ROWS] = tiny["jq"]
    jeng.spec._draft_by_rows[ROWS] = tiny["jdraft"]
    jsnap = j_loadgen.run_poisson(jeng, **trace,
                                  rng=np.random.default_rng(seed),
                                  sleep=jclock.advance)
    tclock = TickClock(0.002)
    teng = Engine(tiny["tcfg"], tiny["tparams"], compute="sdv",
                  plan_policy="auto", clock=tclock, prefill_chunk=4,
                  speculative=True, spec_k=K, device="cpu",
                  buckets=tuple(BucketShape(ROWS, s) for s in buckets))
    tsnap = t_loadgen.run_poisson(teng, **trace,
                                  rng=np.random.default_rng(seed),
                                  sleep=tclock.advance)
    assert dict(teng.outcomes) == dict(jeng.outcomes)
    assert len(teng.outcomes) >= 3
    assert all(o["outcome"] == "ok" for o in teng.outcomes.values())
    assert {c.rid: c.tokens for c in teng.completions} == \
        {c.rid: c.tokens for c in jeng.completions}
    assert json.loads(json.dumps(tsnap["speculative"])) == \
        json.loads(json.dumps(jsnap["speculative"]))
    assert tsnap["speculative"]["rounds"] > 0
