"""Parity of the torch port's vlm family with the JAX package, on reduced
llava-next-mistral-7b (2 layers, d_model 128, 4 heads, 2 KV heads, 8
patches, vocab 512), with the helpers of ``tests/test_torch_moe.py`` and
``tests/test_torch_encdec.py``.

* The tree: the reference's keys, shapes and dtypes, ``proj_patches``
  among them.
* ``forward`` with patches (the projected patches ahead of the text,
  positions over the whole sequence) against the reference's under
  ``jax.jit``, within ``FORWARD_ATOL``.
* ``prefill_step`` + 6 ``decode_step``s (with the advance mask) + one
  ``verify_step`` in SDV and memory modes against the JAX package run op
  by op (ROADMAP Queue C, property (a)): logits within one bf16 rounding
  of their scale, the int8 caches bit-identical.
* ``serve_params``: both trees equal, words and scales bit for bit, with
  ``proj_patches`` left float in both modes.
* One ``make_train_step`` against the reference's under ``jax.jit``: the
  loss over the text positions only (``loss_fn`` drops the patch
  positions), within ``tests/test_torch_qat.py``'s ``LOSS_ATOL``; and
  one in float32 from a float32 init: every leaf's gradient
  (``proj_patches`` among them) within ``GRAD_RTOL_F32``.
* The serving engine: the port's ``Engine`` and the reference's (seams op
  by op) on one seeded trace give the same outcomes, tokens and metrics
  snapshot; the port's speculative engine gives plain decode's tokens.
* Reference property (h) (ROADMAP Queue C) on the reference alone.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.data import SyntheticLMData as JData
from repro.models import decode_step, forward, init_cache, values
from repro.serving import loadgen as j_loadgen
from repro.serving import queue as j_queue
from repro.serving.engine import Engine as JEngine
from repro.train import loop as jloop
from repro.train import optimizer as jopt

import repro_torch.models as tm
from repro_torch.models import quantized as tquant
from repro_torch.serving import BucketShape, Engine
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.train import loop, optimizer
from test_torch_encdec import (FORWARD_ATOL, GRAD_RTOL_F32, LOSS_ATOL,
                               LOSS_ATOL_F32, float32_step, qat_loss_check,
                               same_serve_tree)
from test_torch_moe import (B, C, RULES, check_runs, jax_run, model_setup,
                            port_run)
from test_torch_serving import TickClock, _drop_port_only, _op_by_op

ARCH = "llava-next-mistral-7b"


@pytest.fixture(scope="module")
def llava():
    s = model_setup(ARCH)
    s["patches"] = np.random.default_rng(2).standard_normal(
        (B, s["cfg"].n_patches, s["cfg"].d_model)).astype(np.float32)
    return s


def test_tree_structure_matches_reference(llava):
    from repro_torch import tree
    ref = jax.tree_util.tree_leaves_with_path(llava["params"])
    port = tree.leaves(tm.init_params(llava["tcfg"], seed=0, device="meta"))
    assert len(ref) == len(port)
    for (path, a), b in zip(ref, port):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    assert set(llava["tparams"]) == {"embed", "ln_f", "lm_head", "blocks",
                                     "proj_patches"}


def test_forward_matches_reference(llava):
    """The patches projected by ``proj_patches`` ahead of the embedded
    text: logits over all n_patches + C positions."""
    s = llava
    jl = np.asarray(jax.jit(lambda p, b: forward(get_arch(ARCH).reduced(),
                                                 p, b))(
        s["params"], {"tokens": jnp.asarray(s["prompt"], jnp.int32),
                      "patches": jnp.asarray(s["patches"])}))
    batch = {"tokens": torch.tensor(s["prompt"], dtype=torch.int32),
             "patches": torch.from_numpy(s["patches"])}
    tl = tm.forward(s["tcfg"], s["tparams"], batch)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape \
        == (B, s["cfg"].n_patches + C, s["cfg"].vocab_padded)
    assert np.abs(tl.detach().numpy() - jl).max() <= FORWARD_ATOL
    last = tm.forward(s["tcfg"], s["tparams"], batch, mode="last_logits")
    assert torch.equal(last, tl[:, -1:])


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_decode_and_verify_match_reference(llava, compute):
    check_runs(jax_run(llava, compute), port_run(llava, compute), compute)


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_serve_params_matches_reference(llava, compute):
    """7 projections a layer and the LM head packed as the reference packs
    them; ``proj_patches`` stays a float kernel in both modes."""
    jq, tq = llava["jq", compute], llava["tq", compute]
    kinds = same_serve_tree(jq, tq)
    assert len(kinds[compute]) == 1 + 7
    kernel = tq["proj_patches"]["kernel"]
    assert isinstance(kernel, torch.Tensor) and kernel.dtype == torch.bfloat16
    want = {"memory": 0, "sdv": 0, "bseg": 0}
    want[compute] = 7 * llava["tcfg"].n_layers + 1
    assert tquant.count_packed(tq) == want


def test_train_step_matches_reference(llava):
    """One ``make_train_step`` on the same patches and tokens: the loss of
    the text positions within ``LOSS_ATOL``."""
    cfg, tcfg = llava["cfg"], llava["tcfg"]
    kw = dict(lr=1e-3, warmup=1, total_steps=2)
    jocfg, tocfg = jopt.OptConfig(**kw), optimizer.OptConfig(**kw)
    host = JData(vocab=cfg.vocab, seq_len=20, global_batch=2, seed=0,
                 n_patches=cfg.n_patches, d_model=cfg.d_model).batch_at(0)
    assert host["tokens"].shape == (2, 20 - cfg.n_patches)
    params = llava["params"]
    _, _, jm = jax.jit(jloop.make_train_step(cfg, jocfg))(
        params, jopt.init(jocfg, params),
        {k: jnp.asarray(v) for k, v in host.items()})
    tparams = llava["tparams"]
    batch = {k: torch.from_numpy(v) for k, v in host.items()}
    _, _, tmetrics = loop.make_train_step(tcfg, tocfg)(
        tparams, optimizer.init(tocfg, tparams), batch)
    assert abs(float(tmetrics["loss"]) - float(jm["loss"])) <= LOSS_ATOL


def test_step_gradients_match_reference_float32(llava, monkeypatch):
    """One float32 train step of reduced llava: the gradients through the
    text positions' loss back into every leaf (``proj_patches`` among
    them, reached through attention from the text), each within
    ``GRAD_RTOL_F32``, and the loss within ``LOSS_ATOL_F32``
    (``tests/test_torch_encdec.py``)."""
    cfg = llava["cfg"]
    host = JData(vocab=cfg.vocab, seq_len=20, global_batch=2, seed=0,
                 n_patches=cfg.n_patches, d_model=cfg.d_model).batch_at(0)
    dloss, dgrad = float32_step(monkeypatch, cfg, llava["tcfg"], host)
    assert dloss <= LOSS_ATOL_F32, dloss
    assert dgrad <= GRAD_RTOL_F32, dgrad


def test_qat_matches_reference(llava):
    """QAT of reduced llava: the decoder's projections and the LM head
    wrapped, ``proj_patches`` left float (``_SKIP_CONTAINERS``), and the
    packed QAT loss of the text positions."""
    cfg = llava["cfg"]
    host = JData(vocab=cfg.vocab, seq_len=20, global_batch=2, seed=0,
                 n_patches=cfg.n_patches, d_model=cfg.d_model).batch_at(0)
    got = qat_loss_check(cfg, llava["tcfg"], llava["params"],
                         llava["tparams"], host)
    assert "lm_head" in got and not any("proj_patches" in p for p in got)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

#: the bucket of the decode tests' cache (B slots of 16), so the
#: reference's decode ops run at shapes it has compiled already
ROWS = B
TRACE = dict(rate=40.0, duration_s=0.1, prompt_len=6, new_tokens=4)
TRACE_BUCKETS = (16,)
TICK_S = 0.002
SEED = 3


def _drive(mod, engine, clock):
    snap = mod.run_poisson(engine, **TRACE, rng=np.random.default_rng(SEED),
                           sleep=clock.advance)
    return snap, {c.rid: c.tokens for c in engine.completions}, \
        dict(engine.outcomes)


def test_engine_trace_matches_reference(llava):
    """Chunked prefill of 4 per slot with the advance mask, the
    reference's seams op by op on the unrolled config."""
    jclock = TickClock(TICK_S)
    jeng = _op_by_op(JEngine(get_arch(ARCH).reduced(), llava["params"],
                             compute="sdv", plan_policy="auto", clock=jclock,
                             prefill_chunk=4, buckets=tuple(
                                 j_queue.BucketShape(ROWS, s)
                                 for s in TRACE_BUCKETS)), llava["cfg"])
    tclock = TickClock(TICK_S)
    teng = Engine(llava["tcfg"], llava["tparams"], compute="sdv",
                  plan_policy="auto", device="cpu", clock=tclock,
                  prefill_chunk=4, buckets=tuple(
                      BucketShape(ROWS, s) for s in TRACE_BUCKETS))
    jsnap, jtoks, jout = _drive(j_loadgen, jeng, jclock)
    tsnap, ttoks, tout = _drive(t_loadgen, teng, tclock)
    assert tout == jout and len(tout) >= 3
    assert all(o["outcome"] == "ok" for o in tout.values())
    assert ttoks == jtoks
    assert _drop_port_only(json.loads(json.dumps(tsnap))) \
        == json.loads(json.dumps(jsnap))


def test_engine_spec_equals_plain(llava):
    """The port's speculative engine (k = 3, the W4A4 draft) gives the
    tokens of its plain engine, as for tinyllama."""
    def serve(speculative):
        eng = Engine(llava["tcfg"], llava["tparams"], plan_policy="auto",
                     device="cpu", buckets=(BucketShape(2, 16),),
                     prefill_chunk=4, speculative=speculative, spec_k=3)
        rng = np.random.default_rng(11)
        rids = [eng.submit([int(x) for x in rng.integers(
            0, llava["tcfg"].vocab, 2 + i)], new_tokens=3 + i)
            for i in range(3)]
        eng.drain()
        toks = {c.rid: c.tokens for c in eng.completions}
        return [toks[r] for r in rids], eng
    plain, _ = serve(False)
    spec, eng = serve(True)
    assert plain == spec
    sp = eng.metrics.snapshot()["speculative"]
    assert sp["rounds"] > 0 and sp["degraded_buckets"] == 0


@pytest.mark.parametrize("args", [["--packed-compute", "memory"],
                                  ["--engine", "on", "--requests", "2"]])
def test_serve_cli_on_cpu(args, capsys):
    """``python -m repro_torch.launch.serve --arch llava-next-mistral-7b``
    on the CPU (reduced): the single-batch loop in memory mode and the
    engine."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "3", "--new-tokens", "3"]
                       + args) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and "sample:" in out


# ---------------------------------------------------------------------------
# reference property (h)
# ---------------------------------------------------------------------------

def test_reference_property_h(llava):
    """The reference alone: ``serve_params`` leaves ``proj_patches`` a
    float kernel in both modes, and a decode step never reads it (the
    same logits with its kernel replaced by NaNs): serving is text
    only."""
    for compute in ("sdv", "memory"):
        kernel = llava["jq", compute]["proj_patches"]["kernel"]
        assert isinstance(kernel, jax.Array) and kernel.dtype == jnp.bfloat16
    cfg, q = llava["cfg"], llava["jq", "sdv"]
    poisoned = dict(q, proj_patches={"kernel": jnp.full_like(
        q["proj_patches"]["kernel"], jnp.nan)})
    tok = jnp.asarray(llava["tokens"][0], jnp.int32)
    outs = [np.asarray(decode_step(cfg, p, values(init_cache(
        cfg, RULES, B, 4)), tok)[0]) for p in (q, poisoned)]
    assert np.isfinite(outs[1]).all()
    assert np.array_equal(outs[0], outs[1])
