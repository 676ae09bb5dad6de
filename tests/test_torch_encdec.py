"""Parity of the torch port's encdec family with the JAX package, on
reduced seamless-m4t-large-v2 (2 encoder and 2 decoder layers, d_model
128, 4 heads, 2 KV heads, vocab 512).

* ``layers.attention_apply`` against the reference's for cross attention
  (``kv=``, the reference's ``use_rope=False``, 37 keys for 20 queries)
  and for the encoder's non-causal self attention, in both streaming
  variants: the
  outputs and the projected K/V within one bf16 rounding of their scale
  (the bf16 GEMMs of the two packages sum in another order).
* ``layers.decode_attention`` on a bf16 cache: the cache bit-identical to
  the reference's (a write past ``s_max`` dropped), the output within one
  bf16 rounding.
* The model: ``forward`` on ``{src, tokens}`` against the reference's
  under ``jax.jit`` within ``FORWARD_ATOL``; against the JAX package run
  op by op (layer loop unrolled, no enclosing jit: ROADMAP Queue C,
  property (a)), 6 ``decode_step``s in float,
  SDV and memory modes, logits within one bf16 rounding of their scale
  and every cache leaf (the bf16 self-attention K/V, the cross cache,
  ``index``) bit for bit; ``cross_k``/``cross_v`` stay zero;
  ``reset_slot`` clears one slot of every leaf as the reference's does.
* ``serve_params``: both trees equal, words and scales bit for bit, in
  SDV and memory modes, ``count_packed`` counting the cross projections
  per layer, and ``packed_from_numpy`` carrying the reference's.
* One ``make_train_step`` against the reference's under ``jax.jit``: the
  loss within ``tests/test_torch_qat.py``'s ``LOSS_ATOL``; and one in
  float32 from a float32 init: every leaf's gradient (the encoder's
  through the cross attention among them) within ``GRAD_RTOL_F32``.
* The serving engine: the port's ``Engine`` and the reference's (chunk 1,
  no advance mask, seams op by op) on one seeded trace under a ticking
  fake clock give the same outcomes, tokens and metrics snapshot; the
  speculative decoder refuses the family.
* Reference property (g) (ROADMAP Queue C) on the reference alone.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.registry import get_arch
from repro.data import SyntheticLMData as JData
from repro.models import (Rules, decode_step, forward, init_cache,
                          init_params, reset_slot, serve_params, values)
from repro.models import layers as jlayers
from repro.models import quantized as jquant
from repro.models.param import Init
from repro.serving import loadgen as j_loadgen
from repro.serving import queue as j_queue
from repro.serving.engine import Engine as JEngine
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.qat import ste as jste

import repro_torch.models as tm
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.data import SyntheticLMData
from repro_torch.models import layers as tlayers
from repro_torch.models import quantized as tquant
from repro_torch.serving import BucketShape, Engine
from repro_torch.serving import loadgen as t_loadgen
from repro_torch.serving.spec import SpecConfig, SpecDecoder
from repro_torch.train import loop, optimizer
from repro_torch.train.qat import ste
from test_torch_qat import _port_plan, _qat_paths, _recording, _worst_leaf_rel
from test_torch_serving import TickClock, _drop_port_only

ARCH = "seamless-m4t-large-v2"
RULES = Rules(tp=None, fsdp=None, ep=None, batch=())
B, S_MAX, STEPS = 3, 12, 6
SRC_LEN, TGT_LEN = 7, 5
#: one bf16 rounding of the outputs' scale: the same bf16 products of the
#: same bf16 weights, summed in float32 in another order (XLA's and
#: torch's CPU GEMMs), then rounded to bf16 (tests/test_torch_moe.py)
BF16_RTOL = 2.0 ** -7
#: ``forward``'s logits against the reference's (tests/test_torch_model.py's
#: LOGIT_ATOL, as tests/test_torch_spec_model.py holds the dense forward;
#: observed 0.0054 on logits of magnitude ~0.93)
FORWARD_ATOL = 0.05
#: one train step's loss (tests/test_torch_qat.py's LOSS_ATOL)
LOSS_ATOL = 5e-3
#: one float32 train step from a float32 init, where no bf16 rounding
#: tie separates the packages: the loss, and each leaf's gradient
#: (relative 2-norm), as tests/test_torch_qat.py's LOSS_ATOL_F32 and
#: GRAD_RTOL_F32 hold the dense step
LOSS_ATOL_F32 = 1e-5
GRAD_RTOL_F32 = 1e-5


def _t(a) -> torch.Tensor:
    """A numpy array (bf16 too) as the torch tensor of the same bits."""
    return tm.params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


def _np(t: torch.Tensor) -> np.ndarray:
    """A torch tensor as numpy, bf16 as ``ml_dtypes.bfloat16``."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def same_bits(a, b) -> bool:
    a = np.asarray(a)
    b = _np(b) if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def close(port, ref, what: str):
    """Within one bf16 rounding of the reference's scale."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, what
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=BF16_RTOL * np.abs(ref).max(),
                               err_msg=what)


def same_serve_tree(jq, tq, path=""):
    """The reference's serve tree and the port's: the same keys, the same
    container at every packed leaf with its words and scales bit for bit,
    every other leaf bit for bit.  Returns the packed containers' paths
    by kind."""
    kinds = {"sdv": [], "memory": []}
    if isinstance(jq, dict):
        assert isinstance(tq, dict) and set(jq) == set(tq), path
        for k in jq:
            sub = same_serve_tree(jq[k], tq[k], f"{path}/{k}")
            for kind in kinds:
                kinds[kind] += sub[kind]
        return kinds
    if isinstance(jq, jquant.SDVLinear):
        assert isinstance(tq, tm.SDVLinear), path
        kinds["sdv"].append(path)
    elif isinstance(jq, jquant.PackedLinear):
        assert isinstance(tq, tm.PackedLinear), path
        assert (tq.bits, tq.d_out) == (jq.bits, jq.d_out), path
        kinds["memory"].append(path)
    else:
        assert same_bits(jq, tq), path
        return kinds
    assert tq.d_out == jq.d_out, path
    assert same_bits(jq.words, tq.words) and same_bits(jq.scale, tq.scale), \
        path
    return kinds


# ---------------------------------------------------------------------------
# layers: cross and non-causal attention, the bf16 decode cache
# ---------------------------------------------------------------------------

def _attn(use_rope: bool):
    kw = dict(n_heads=4, n_kv=2, head_dim=32)
    jcfg = jlayers.AttnConfig(d_model=128, use_rope=use_rope, **kw)
    p = values(jlayers.attention_init(
        Init(jax.random.PRNGKey(5), RULES, jnp.bfloat16), jcfg))
    return jcfg, tlayers.AttnConfig(**kw), p, tm.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def _bf16(rng, *shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("diff", [True, False])
@pytest.mark.parametrize("kind", ["cross", "encoder"])
def test_attention_apply_cross_and_noncausal(kind, diff):
    """Cross attention (queries 20, keys 37 projected from ``kv``, no
    RoPE, no mask) and the encoder's self attention (37 positions, RoPE,
    no causal mask), each over several chunks of 16."""
    rng = np.random.default_rng(2)
    jcfg, tcfg, jp, tp = _attn(use_rope=kind == "encoder")
    sq = 20 if kind == "cross" else 37
    x, src = _bf16(rng, 2, sq, 128), _bf16(rng, 2, 37, 128)
    pos = np.broadcast_to(np.arange(sq, dtype=np.int32), (2, sq))
    kw = dict(causal=False, chunk=16, differentiable=diff)
    jkv = (jnp.asarray(src),) * 2 if kind == "cross" else None
    tkv = (_t(src),) * 2 if kind == "cross" else None
    jy, (jk, jv) = jlayers.attention_apply(
        jp, jcfg, jnp.asarray(x), positions=jnp.asarray(pos), kv=jkv, **kw)
    ty, (tk, tv) = tlayers.attention_apply(
        tp, tcfg, _t(x), positions=_t(pos), kv=tkv, **kw)
    assert ty.dtype == torch.bfloat16
    close(ty.float().numpy(), np.asarray(jy, np.float32), f"{kind} {diff}")
    assert tuple(tk.shape) == (2, 37, 2, 32)
    close(tk.float().numpy(), np.asarray(jk, np.float32), "k")
    close(tv.float().numpy(), np.asarray(jv, np.float32), "v")


def test_decode_attention_bf16_cache():
    """One decode step against a bf16 cache holding earlier entries: k/v
    written cast to the cache dtype and read back as float32; the row at
    ``s_max`` writes nothing (the reference's dropped scatter)."""
    rng = np.random.default_rng(4)
    jcfg, tcfg, jp, tp = _attn(use_rope=True)
    s_max = 6
    kc, vc = _bf16(rng, 3, s_max, 2, 32), _bf16(rng, 3, s_max, 2, 32)
    x = _bf16(rng, 3, 1, 128)
    idx = np.array([0, 3, s_max], np.int32)
    jy, jk, jv = jlayers.decode_attention(
        jp, jcfg, jnp.asarray(x), cache_k=jnp.asarray(kc),
        cache_v=jnp.asarray(vc), cache_index=jnp.asarray(idx))
    tk, tv, tidx = _t(kc), _t(vc), _t(idx)
    ty = tlayers.decode_attention(
        tp, tcfg, _t(x), cache=(tk, tv, None, None), cache_index=tidx,
        writes=tlayers.decode_writes(tidx, None, s_max))
    assert tk.dtype == torch.bfloat16
    assert same_bits(jk, tk) and same_bits(jv, tv)
    assert same_bits(kc[2], tk[2])             # the dropped write
    close(ty.float().numpy(), np.asarray(jy, np.float32), "decode")


# ---------------------------------------------------------------------------
# the model against the reference run op by op
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seamless():
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), scan_layers=False)
    tcfg = t_get_arch(ARCH).reduced()
    assert dataclasses.asdict(cfg) == dict(dataclasses.asdict(tcfg),
                                           scan_layers=False)
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    rng = np.random.default_rng(1)
    s = dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
             src=rng.standard_normal((B, SRC_LEN, cfg.d_model))
             .astype(np.float32),
             tgt=rng.integers(0, cfg.vocab, (B, TGT_LEN)),
             tokens=rng.integers(0, cfg.vocab, (STEPS, B, 1)))
    s["jq", "float"], s["tq", "float"] = params, tparams
    for compute in ("sdv", "memory"):
        s["jq", compute] = serve_params(params, bits=4, min_size=1024,
                                        compute=compute)
        s["tq", compute] = tm.serve_params(tparams, bits=4, min_size=1024,
                                           compute=compute)
    return s


def test_tree_structure_matches_reference(seamless):
    """The port's ``init_params`` has the reference's keys, shapes and
    dtypes: ``enc_blocks``, ``dec_blocks`` with ``ln_cross`` and
    ``cross``, ``ln_enc``."""
    from repro_torch import tree
    ref = jax.tree_util.tree_leaves_with_path(seamless["params"])
    port = tree.leaves(tm.init_params(seamless["tcfg"], seed=0,
                                      device="meta"))
    assert len(ref) == len(port)
    for (path, a), b in zip(ref, port):
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).removeprefix("torch."), path
    assert set(seamless["tparams"]["dec_blocks"]) == {
        "ln_attn", "attn", "ln_mlp", "mlp", "ln_cross", "cross"}


def test_forward_matches_reference(seamless):
    """The encoder over the frame embeddings, the decoder over the target
    tokens with cross attention; ``last_logits`` is the last column."""
    s = seamless
    jl = np.asarray(jax.jit(lambda p, b: forward(get_arch(ARCH).reduced(),
                                                 p, b))(
        s["params"], {"src": jnp.asarray(s["src"]),
                      "tokens": jnp.asarray(s["tgt"], jnp.int32)}))
    batch = {"src": torch.from_numpy(s["src"]),
             "tokens": torch.tensor(s["tgt"], dtype=torch.int32)}
    tl = tm.forward(s["tcfg"], s["tparams"], batch)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    assert np.abs(tl.detach().numpy() - jl).max() <= FORWARD_ATOL
    last = tm.forward(s["tcfg"], s["tparams"], batch, mode="last_logits")
    assert torch.equal(last, tl[:, -1:])


def _runs(s, compute):
    """STEPS decode steps op by op in both packages: (the reference's
    logits, its final cache as numpy), the same for the port."""
    jq, tq = s["jq", compute], s["tq", compute]
    jc = values(init_cache(s["cfg"], RULES, B, S_MAX))
    tc = tm.init_cache(s["tcfg"], B, S_MAX, device="cpu")
    jl, tl = [], []
    for tok in s["tokens"]:
        out, jc = decode_step(s["cfg"], jq, jc, jnp.asarray(tok, jnp.int32))
        jl.append(np.asarray(out))
        out, tc = tm.decode_step(s["tcfg"], tq, tc,
                                 torch.tensor(tok, dtype=torch.int32))
        tl.append(out.numpy())
    return jl, jc, tl, tc


@pytest.mark.parametrize("compute", ["float", "sdv", "memory"])
def test_decode_matches_reference(seamless, compute):
    jl, jc, tl, tc = _runs(seamless, compute)
    for step, (a, b) in enumerate(zip(jl, tl)):
        assert b.dtype == np.float32 and np.isfinite(b).all()
        close(b, a, f"{compute} decode step {step}")
    assert set(jc) == set(tc) == {"index", "k", "v", "cross_k", "cross_v"}
    for name in jc:
        assert same_bits(jc[name], tc[name]), (compute, name)
    assert tc["k"].dtype == torch.bfloat16
    assert tc["index"].tolist() == [STEPS] * B
    assert not tc["cross_k"].any() and not tc["cross_v"].any()
    assert tc["k"][:, :, :STEPS].any() and not tc["k"][:, :, STEPS:].any()
    # reset_slot: slot 1 of every leaf cleared, the others kept, as the
    # reference clears it
    before = {k: v.clone() for k, v in tc.items()}
    jr, tr = reset_slot(jc, 1), tm.reset_slot(tc, 1)
    for name in jr:
        assert same_bits(jr[name], tr[name]), name
        if name == "index":
            continue
        assert not tr[name][:, 1].any(), name
        assert torch.equal(tr[name][:, 0], before[name][:, 0]), name


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_serve_cli_on_cpu(compute, capsys):
    """``python -m repro_torch.launch.serve --arch seamless-m4t-large-v2``
    on the CPU (reduced) through the single-batch loop."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                        "--prompt-len", "3", "--new-tokens", "3",
                        "--packed-compute", compute]) == 0
    out = capsys.readouterr().out
    assert "bfloat16 self-attention KV cache and cross cache" in out
    assert "tok/s" in out


def test_encdec_refuses_prefill_and_advance(seamless):
    """As in the JAX package: prompts replay one token per decode_step."""
    tcfg, tq = seamless["tcfg"], seamless["tq", "sdv"]
    cache = tm.init_cache(tcfg, B, S_MAX, device="cpu")
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported family"):
        tm.prefill_step(tcfg, tq, cache, tok, torch.ones(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="advance mask"):
        tm.decode_step(tcfg, tq, cache, tok,
                       advance=torch.ones(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="KV-cache family"):
        SpecDecoder(tcfg, seamless["tparams"], SpecConfig(), compute="sdv")


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_serve_params_matches_reference(seamless, compute):
    """Every projection of both stacks and the LM head packed as the
    reference packs it; ``count_packed`` counts 7 an encoder layer, 11 a
    decoder layer (the 4 cross projections) and the head."""
    kinds = same_serve_tree(seamless["jq", compute], seamless["tq", compute])
    cfg = seamless["tcfg"]
    n = 7 * cfg.n_enc_layers + 11 * cfg.n_dec_layers + 1
    assert len(kinds[compute]) == 1 + 7 + 11    # the head, the stacks
    assert sum(p.startswith("/dec_blocks/cross/") for p in kinds[compute]) \
        == 4
    want = {"memory": 0, "sdv": 0, "bseg": 0}
    want[compute] = n
    assert tquant.count_packed(seamless["tq", compute]) == want


def test_packed_from_numpy_carries_reference_tree(seamless):
    carried = tm.packed_from_numpy(jax.tree_util.tree_map(
        np.asarray, seamless["jq", "memory"]), device="cpu")
    same_serve_tree(seamless["jq", "memory"], carried)
    assert carried["dec_blocks"]["cross"]["wk"]["kernel"].stacked
    assert tquant.count_packed(carried) == \
        tquant.count_packed(seamless["tq", "memory"])


def test_train_step_matches_reference(seamless):
    """One ``make_train_step`` on the same frames and tokens from the same
    weights: the loss within ``LOSS_ATOL``."""
    cfg, tcfg = seamless["cfg"], seamless["tcfg"]
    kw = dict(lr=1e-3, warmup=1, total_steps=2)
    jocfg, tocfg = jopt.OptConfig(**kw), optimizer.OptConfig(**kw)
    data = dict(vocab=cfg.vocab, seq_len=12, global_batch=2, seed=0,
                d_model=cfg.d_model, encdec=True)
    host = JData(**data).batch_at(0)
    assert all(np.array_equal(host[k], v)
               for k, v in SyntheticLMData(**data).batch_at(0).items())
    params = seamless["params"]
    _, _, jm = jax.jit(jloop.make_train_step(cfg, jocfg))(
        params, jopt.init(jocfg, params),
        {k: jnp.asarray(v) for k, v in host.items()})
    tparams = seamless["tparams"]
    _, _, tmetrics = loop.make_train_step(tcfg, tocfg)(
        tparams, optimizer.init(tocfg, tparams),
        {k: torch.from_numpy(v) for k, v in host.items()})
    assert abs(float(tmetrics["loss"]) - float(jm["loss"])) <= LOSS_ATOL


def float32_step(monkeypatch, cfg, tcfg, host):
    """One train step of both packages in float32 compute from the same
    float32 init on the host batch ``host``: the reference's loss and
    gradients from ``jax.value_and_grad`` of its ``loss_fn`` under
    ``jax.jit``, the port's recorded inside its ``make_train_step`` where
    they reach the optimizer.  Returns (|loss difference|, the worst
    leaf's relative gradient difference)."""
    monkeypatch.setattr(JArchConfig, "dtype",
                        property(lambda self: jnp.float32))
    monkeypatch.setattr(TArchConfig, "dtype",
                        property(lambda self: torch.float32))
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(1)))
    assert {str(p.dtype) for p in jax.tree_util.tree_leaves(params)} \
        == {"float32"}
    tparams = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    jbatch = {k: jnp.asarray(v) for k, v in host.items()}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jloop.loss_fn(cfg, p, jbatch)))(params)
    tg = []
    monkeypatch.setattr(optimizer, "update", _recording(optimizer.update, tg))
    tocfg = optimizer.OptConfig(lr=1e-3, warmup=1, total_steps=2)
    _, _, tmetrics = loop.make_train_step(tcfg, tocfg)(
        tparams, optimizer.init(tocfg, tparams),
        {k: torch.from_numpy(v) for k, v in host.items()})
    return (abs(float(tmetrics["loss"]) - float(jloss)),
            _worst_leaf_rel(jg, tg[0]))


def test_step_gradients_match_reference_float32(seamless, monkeypatch):
    """One float32 train step of reduced seamless: the gradients that flow
    back through the decoder's cross attention and the encoder's
    non-causal attention into every leaf (the encoder's and ``ln_enc``
    among them), each within ``GRAD_RTOL_F32``, and the loss within
    ``LOSS_ATOL_F32``."""
    cfg = seamless["cfg"]
    host = JData(vocab=cfg.vocab, seq_len=12, global_batch=2, seed=0,
                 d_model=cfg.d_model, encdec=True).batch_at(0)
    dloss, dgrad = float32_step(monkeypatch, cfg, seamless["tcfg"], host)
    assert dloss <= LOSS_ATOL_F32, dloss
    assert dgrad <= GRAD_RTOL_F32, dgrad


def qat_loss_check(cfg, tcfg, params, tparams, host):
    """Packed QAT (W4A8, the planner's plans) of both packages from the
    same weights: ``qat_params`` wraps the same leaf paths with the same
    bitwidths and plans, and ``loss_fn`` of the wrapped trees on the host
    batch agrees within ``LOSS_ATOL`` (the reference run op by op:
    ``cfg`` unrolls its layer loop).  Returns the wrapped paths."""
    kw = dict(w_bits=4, a_bits=8, min_size=1 << 10, plan_policy="auto")
    qp = jste.qat_params(params, use_kernel=False, **kw)
    tqp = ste.qat_params(tparams, **kw)
    want = dict(_qat_paths(qp, is_qat=jste.is_qat))
    got = dict(_qat_paths(tqp, is_qat=ste.is_qat))
    assert sorted(got) == sorted(want)
    for path, c in got.items():
        assert (c.w_bits, c.a_bits) == (want[path].w_bits,
                                        want[path].a_bits)
        assert c.plan == _port_plan(want[path].plan), path
    jl = float(jloop.loss_fn(cfg, qp, {k: jnp.asarray(v)
                                       for k, v in host.items()}))
    with torch.no_grad():
        tl = float(loop.loss_fn(tcfg, tqp, {k: torch.from_numpy(v)
                                            for k, v in host.items()}))
    assert np.isfinite(tl) and abs(tl - jl) <= LOSS_ATOL, (tl, jl)
    return got


def test_qat_matches_reference(seamless):
    """QAT of reduced seamless: both stacks' projections wrapped, the
    decoder's cross projections among them, and the packed QAT loss."""
    cfg = seamless["cfg"]
    host = JData(vocab=cfg.vocab, seq_len=12, global_batch=2, seed=0,
                 d_model=cfg.d_model, encdec=True).batch_at(0)
    got = qat_loss_check(cfg, seamless["tcfg"], seamless["params"],
                         seamless["tparams"], host)
    assert {f"dec_blocks/cross/{w}/kernel" for w in ("wq", "wk", "wv",
                                                     "wo")} <= set(got)
    assert any(p.startswith("enc_blocks/") for p in got)


# ---------------------------------------------------------------------------
# the serving engine against the reference's
# ---------------------------------------------------------------------------

#: the bucket of the decode tests' cache, so the reference's decode ops
#: run at shapes it has compiled already
ROWS = B
TRACE = dict(rate=40.0, duration_s=0.1, prompt_len=5, new_tokens=4)
TRACE_BUCKETS = (S_MAX,)
TICK_S = 0.002
SEED = 3


def _drive(mod, engine, clock):
    snap = mod.run_poisson(engine, **TRACE, rng=np.random.default_rng(SEED),
                           sleep=clock.advance)
    return snap, {c.rid: c.tokens for c in engine.completions}, \
        dict(engine.outcomes)


def test_engine_trace_matches_reference(seamless):
    """Chunk 1 (prompts replay through ``decode_step``), no advance mask;
    the reference's jit seams run op by op on the unrolled config."""
    from repro.models import decode_step as j_decode_step
    from repro.models import reset_slot as j_reset_slot
    ucfg = seamless["cfg"]
    jclock = TickClock(TICK_S)
    jeng = JEngine(get_arch(ARCH).reduced(), seamless["params"],
                   compute="sdv", plan_policy="auto", clock=jclock,
                   prefill_chunk=4, buckets=tuple(
                       j_queue.BucketShape(ROWS, s) for s in TRACE_BUCKETS))
    jeng.cfg = ucfg
    jeng._dec = lambda p, c, t, adv: j_decode_step(ucfg, p, c, t)
    jeng._reset = j_reset_slot
    tclock = TickClock(TICK_S)
    teng = Engine(seamless["tcfg"], seamless["tparams"], compute="sdv",
                  plan_policy="auto", device="cpu", clock=tclock,
                  prefill_chunk=4, buckets=tuple(
                      BucketShape(ROWS, s) for s in TRACE_BUCKETS))
    assert teng.prefill_chunk == jeng.prefill_chunk == 1
    jsnap, jtoks, jout = _drive(j_loadgen, jeng, jclock)
    tsnap, ttoks, tout = _drive(t_loadgen, teng, tclock)
    assert tout == jout and len(tout) >= 3
    assert all(o["outcome"] == "ok" for o in tout.values())
    assert ttoks == jtoks
    assert _drop_port_only(json.loads(json.dumps(tsnap))) \
        == json.loads(json.dumps(jsnap))


# ---------------------------------------------------------------------------
# reference property (g)
# ---------------------------------------------------------------------------

def test_reference_property_g(seamless):
    """The reference alone: after a decode step of reduced seamless in
    SDV mode the cross cache is still all zeros (no entry point writes
    it), while the self-attention K/V took the step's entries; the cross
    attention reads the zeros as keys and values, so its output is
    ``wo`` of zeros."""
    cfg = seamless["cfg"]
    cache = values(init_cache(cfg, RULES, B, S_MAX))
    _, cache = decode_step(cfg, seamless["jq", "sdv"], cache,
                           jnp.asarray(seamless["tokens"][0], jnp.int32))
    assert cache["cross_k"].dtype == jnp.bfloat16
    assert not np.asarray(cache["cross_k"], np.float32).any()
    assert not np.asarray(cache["cross_v"], np.float32).any()
    assert np.asarray(cache["k"], np.float32)[:, :, 0].any()
