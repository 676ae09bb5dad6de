"""Parity of the torch port's moe family with the JAX package, on reduced
phi3.5-moe-42b-a6.6b (2 layers, d_model 128, 4 experts, top-2, vocab
512).

* ``layers.moe_route`` / ``moe_apply`` / ``moe_aux_loss`` against the
  reference's ``moe_apply`` (``src/repro/models/layers.py``) on the same
  seeded bf16 activations, at token counts whose capacity drops choices
  and at counts that drop none: the expert ids, slots and kept choices
  are equal exactly, the outputs agree within one bf16 rounding of their
  scale (both packages multiply the same bf16 banks in bf16, with their
  own float32 accumulation order), the auxiliary loss within float32
  rounding.
* The serving entry points, the JAX package run op by op (layer loop
  unrolled, no enclosing jit: ROADMAP Queue C, property (a)):
  ``prefill_step`` + 6 ``decode_step``s + one ``verify_step`` in SDV
  and memory modes.  Logits agree within one bf16
  rounding of their scale; the int8 caches are bit-identical.
* ``serve_params``: the memory-packed expert banks equal the
  reference's, words and scales bit for bit, in both compute modes;
  ``count_packed`` counts a stacked bank once per layer;
  ``launch.serve.packed_params_layerwise`` equals ``serve_params`` of the
  whole tree drawn from the same per-group numbers, bit for bit.

``tests/test_torch_moe_interleaved.py`` runs the same serving checks on
reduced llama4-maverick (``moe_every = 2``, a shared expert) with this
file's helpers, and ``forward`` on both models;
``tests/test_torch_moe_engine.py`` the serving engine.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.models import (Rules, decode_step, forward, init_cache,
                          init_params, prefill_step, serve_params, values,
                          verify_step)
from repro.models import layers as jlayers
from repro.models import quantized as jquant
from repro.models.param import Init

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.launch.serve import packed_params_layerwise
from repro_torch.models import layers as tlayers
from repro_torch.models import quantized as tquant
from repro_torch.models import transformer as ttrans

RULES = Rules(tp=None, fsdp=None, ep=None, batch=())
B, C, S_MAX, STEPS = 3, 5, 16, 6
N_VALID = np.array([5, 3, 0])
#: per-step advance masks: row 2 freezes on even steps
ADVANCE = [np.array([1, 1, s % 2]) for s in range(STEPS)]
VERIFY_N_VALID = np.array([5, 2, 1])
#: one bf16 rounding of the outputs' scale: the same bf16 products of
#: the same bf16 weights, summed in float32 in another order (XLA's and
#: torch's CPU GEMMs), then rounded to bf16 (tests/test_torch_memory.py)
BF16_RTOL = 2.0 ** -7
#: the router's float32 softmax and the renormalized top-k weights: the
#: two packages' float32 exp may differ by an ulp
PROB_RTOL = 1e-6
#: moe_aux_loss: float32 means and sums of [T, E] probabilities
AUX_RTOL = 1e-6


def _t(a) -> torch.Tensor:
    return tm.params_from_numpy({"a": np.asarray(a)}, device="cpu")["a"]


def _close(port: np.ndarray, ref: np.ndarray, what: str):
    """Within one bf16 rounding of the reference's scale."""
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=BF16_RTOL * np.abs(ref).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# layers: routing, dispatch, combine, auxiliary loss
# ---------------------------------------------------------------------------

def _j_route(params, cfg, xt):
    """The reference ``moe_apply``'s routing, line for line
    (``src/repro/models/layers.py:514-531``), which it does not
    return."""
    t = xt.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    cap = max(1, int(math.ceil(t * k * cfg.capacity_factor / e)))
    logits = jlayers.dense_apply(params["router"], xt.astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, e, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - 1
    slot = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    return top_e, top_p, slot, slot < cap, cap


#: (top_k, shared expert) as reduced phi3.5-moe / llama4-maverick route,
#: and the token counts of each with whether their capacity drops a
#: choice (at these seeds)
MOE_CASES = [(2, False, 3, False), (2, False, 8, True),
             (1, True, 3, False), (1, True, 8, True)]


@pytest.fixture(scope="module")
def moe_params():
    out = {}
    for k, shared in {(c[0], c[1]) for c in MOE_CASES}:
        kw = dict(d_model=128, d_ff=256, n_experts=4, top_k=k,
                  shared_expert=shared)
        jcfg, tcfg = jlayers.MoEConfig(**kw), tlayers.MoEConfig(**kw)
        p = values(jlayers.moe_init(Init(jax.random.PRNGKey(3), RULES,
                                         jnp.bfloat16), jcfg))
        out[k, shared] = (jcfg, tcfg, p, tm.params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), device="cpu"))
    return out


@pytest.mark.parametrize("k,shared,t,drops", MOE_CASES)
def test_moe_route_and_apply(moe_params, k, shared, t, drops):
    jcfg, tcfg, jp, tp = moe_params[k, shared]
    x = np.random.default_rng(t).standard_normal((1, t, 128)) \
        .astype(ml_dtypes.bfloat16)
    je, jw, js, jk, jcap = _j_route(jp, jcfg, jnp.asarray(x[0]))
    te, tw, ts, tk, tcap = tlayers.moe_route(tp, tcfg, _t(x[0]))
    assert tcap == jcap
    assert (te.numpy() == np.asarray(je)).all()
    assert (ts.numpy() == np.asarray(js)).all()
    assert (tk.numpy() == np.asarray(jk)).all()
    assert bool((~tk).any()) == drops
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=PROB_RTOL)
    jy = np.asarray(jlayers.moe_apply(jp, jcfg, jnp.asarray(x)))
    ty = tlayers.moe_apply(tp, tcfg, _t(x))
    assert ty.dtype == torch.bfloat16 and ty.shape == jy.shape
    _close(ty.float().numpy(), jy.astype(np.float32), f"moe_apply T={t}")


@pytest.mark.parametrize("k,shared", [(2, False), (1, True)])
def test_moe_aux_loss(moe_params, k, shared):
    jcfg, tcfg, jp, tp = moe_params[k, shared]
    x = np.random.default_rng(11).standard_normal((2, 24, 128)) \
        .astype(ml_dtypes.bfloat16)
    ja = float(jlayers.moe_aux_loss(jp, jcfg, jnp.asarray(x)))
    ta = tlayers.moe_aux_loss(tp, tcfg, _t(x))
    assert ta.dtype == torch.float32
    assert float(ta) == pytest.approx(ja, rel=AUX_RTOL)


# ---------------------------------------------------------------------------
# the model entry points against the reference run op by op
# ---------------------------------------------------------------------------

def model_setup(arch: str, packed: bool = True):
    """Reference and port configs and trees of reduced ``arch``: the
    reference's seeded weights carried across, packed (``packed``) by
    each package's own ``serve_params(min_size=1024)`` in SDV and memory
    modes, and the seeded prompt, decode and verify tokens."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), scan_layers=False)
    tcfg = t_get_arch(arch).reduced()
    assert dataclasses.asdict(cfg) == dict(dataclasses.asdict(tcfg),
                                           scan_layers=False)
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    rng = np.random.default_rng(1)
    s = dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
             prompt=rng.integers(0, cfg.vocab, (B, C)),
             tokens=rng.integers(0, cfg.vocab, (STEPS, B, 1)),
             verify=rng.integers(0, cfg.vocab, (B, C)))
    for compute in ("sdv", "memory") if packed else ():
        s["jq", compute] = serve_params(params, bits=4, min_size=1024,
                                        compute=compute)
        s["tq", compute] = tm.serve_params(tparams, bits=4, min_size=1024,
                                           compute=compute)
    return s


def jax_run(s, compute):
    """prefill + STEPS decode steps + one verify wave, op by op: (the
    decode and verify logits, the cache after each phase)."""
    cfg, q = s["cfg"], s["jq", compute]
    cache = values(init_cache(cfg, RULES, B, S_MAX))
    cache = prefill_step(cfg, q, cache, jnp.asarray(s["prompt"], jnp.int32),
                         jnp.asarray(N_VALID, jnp.int32))
    logits = []
    for i in range(STEPS):
        out, cache = decode_step(cfg, q, cache,
                                 jnp.asarray(s["tokens"][i], jnp.int32),
                                 advance=jnp.asarray(ADVANCE[i], jnp.int32))
        logits.append(np.asarray(out))
    decoded = {k: np.asarray(v) for k, v in cache.items()}
    out, cache = verify_step(cfg, q, cache,
                             jnp.asarray(s["verify"], jnp.int32),
                             jnp.asarray(VERIFY_N_VALID, jnp.int32))
    return (logits, np.asarray(out), decoded,
            {k: np.asarray(v) for k, v in cache.items()})


def port_run(s, compute):
    tcfg, q = s["tcfg"], s["tq", compute]
    i32 = dict(dtype=torch.int32)
    cache = tm.init_cache(tcfg, B, S_MAX, device="cpu")
    cache = tm.prefill_step(tcfg, q, cache, torch.tensor(s["prompt"], **i32),
                            torch.tensor(N_VALID, **i32))
    logits = []
    for i in range(STEPS):
        out, cache = tm.decode_step(tcfg, q, cache,
                                    torch.tensor(s["tokens"][i], **i32),
                                    advance=torch.tensor(ADVANCE[i], **i32))
        logits.append(out.numpy())
    decoded = {k: v.numpy().copy() for k, v in cache.items()}
    out, cache = tm.verify_step(tcfg, q, cache,
                                torch.tensor(s["verify"], **i32),
                                torch.tensor(VERIFY_N_VALID, **i32))
    return logits, out.numpy(), decoded, {k: v.numpy()
                                          for k, v in cache.items()}


def check_runs(j, t, what):
    """Logits within one bf16 rounding of their scale at every decode
    step and verify column; the int8 caches (K/V, scales, index) bit for
    bit after the decode steps and after the verify wave."""
    (jl, jv, jd, jc), (tl, tv, td, tc) = j, t
    for step, (a, b) in enumerate(zip(jl, tl)):
        assert b.dtype == np.float32 and np.isfinite(b).all()
        _close(b, a, f"{what} decode step {step}")
    _close(tv, jv, f"{what} verify")
    for name in jc:
        assert (jd[name] == td[name]).all(), (what, "decode", name)
        assert (jc[name] == tc[name]).all(), (what, "verify", name)


def check_forward(s):
    """The float forward (training's, bf16 weights, differentiable
    attention) over the prompt tokens, within one bf16 rounding of the
    logits' scale."""
    tok = s["prompt"]
    jl = np.asarray(forward(s["cfg"], s["params"],
                            {"tokens": jnp.asarray(tok, jnp.int32)}))
    tl = tm.forward(s["tcfg"], s["tparams"],
                    {"tokens": torch.tensor(tok, dtype=torch.int32)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl.detach().numpy(), jl, "forward")


@pytest.fixture(scope="module")
def phi():
    return model_setup("phi3.5-moe")


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_decode_and_verify_match_reference(phi, compute):
    check_runs(jax_run(phi, compute), port_run(phi, compute), compute)


def _bank_paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _bank_paths(v, f"{path}/{k}" if path else k)
    elif path.split("/")[-1] in ("wi_gate", "wi_up", "wo") \
            and "/moe/" in f"/{path}/":
        yield path, tree


def _at(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_serve_params_expert_banks(phi, compute):
    """Every expert bank is memory-packed in both modes, words and scales
    bit for bit the reference's, stacked on the layer axis; the router
    stays float; one B6 call a bank."""
    jq, tq = phi["jq", compute], phi["tq", compute]
    banks = list(_bank_paths(tq))
    assert len(banks) == 3
    for path, tb in banks:
        jb = _at(jq, path)
        assert isinstance(jb, jquant.PackedLinear), path
        assert isinstance(tb, tm.PackedLinear) and tb.stacked, path
        assert tb.words.shape == jb.words.shape and tb.words.ndim == 4
        assert (tb.words.numpy() == np.asarray(jb.words)).all(), path
        assert (tb.scale.numpy() == np.asarray(jb.scale)).all(), path
        assert (tb.bits, tb.d_out) == (jb.bits, jb.d_out)
    assert isinstance(tq["blocks"]["moe"]["router"]["kernel"], torch.Tensor)
    cfg = phi["tcfg"]
    attn = 4 * cfg.n_layers
    want = {"sdv": {"memory": 3 * cfg.n_layers, "sdv": attn + 1, "bseg": 0},
            "memory": {"memory": 3 * cfg.n_layers + attn + 1, "sdv": 0,
                       "bseg": 0}}[compute]
    assert tquant.count_packed(tq) == want


def test_bank_layer_is_one_b7_call(phi):
    """A layer of a stacked bank materializes in one B7 call ([E * d_in,
    nw] rows, one scale row per expert), bit for bit the reference's
    materialized layer."""
    tb = phi["tq", "memory"]["blocks"]["moe"]["wo"]
    jb = phi["jq", "memory"]["blocks"]["moe"]["wo"]
    from repro_torch.kernels import packbits
    before = packbits.unpack_dequant_plain.calls
    dense = tm.materialize(tb.layer(1))
    assert packbits.unpack_dequant_plain.calls == before + 1
    ref = np.asarray(jquant.materialize(jquant.PackedLinear(
        words=jb.words[1], scale=jb.scale[1], bits=jb.bits, d_out=jb.d_out)))
    assert dense.dtype == torch.bfloat16 and dense.shape == ref.shape
    assert (dense.view(torch.int16).numpy() == ref.view(np.int16)).all()


def test_packed_from_numpy_keeps_banks_stacked(phi):
    carried = tm.packed_from_numpy(jax.tree_util.tree_map(
        np.asarray, phi["jq", "memory"]), device="cpu")
    assert tquant.count_packed(carried) == \
        tquant.count_packed(phi["tq", "memory"])
    assert carried["blocks"]["moe"]["wi_up"].stacked
    assert not carried["lm_head"].stacked


def test_unstacked_bank_is_not_a_layer_stack():
    """A bank outside a layer-stack container ([E, d, f] alone) packs as
    one memory container in both modes, never SDV, counted once."""
    kernel = torch.randn((4, 64, 96)).to(torch.bfloat16)
    for compute in ("sdv", "memory"):
        q = tm.serve_params({"moe": {"wi_gate": kernel}}, min_size=1024,
                            compute=compute)["moe"]["wi_gate"]
        assert isinstance(q, tm.PackedLinear) and not q.stacked
        assert tquant.count_packed(q) == {"memory": 1, "sdv": 0, "bseg": 0}
        with pytest.raises(ValueError):
            q.layer(0)


def _whole_tree(cfg, seed):
    """``init_top_params`` and every group's ``init_group_params``,
    concatenated on the layer axis: the float tree the layer-wise build
    packs."""
    tree = ttrans.init_top_params(cfg, seed, device="cpu")
    groups = [ttrans.init_group_params(cfg, g, seed, device="cpu")
              for g in range(ttrans.n_groups(cfg))]

    def cat(*parts):
        if isinstance(parts[0], dict):
            return {k: cat(*(p[k] for p in parts)) for k in parts[0]}
        return torch.cat(parts)

    tree.update(cat(*groups))
    return tree


def _same_tree(a, b):
    from repro_torch import tree
    la, lb = tree.leaves(a), tree.leaves(b)
    assert len(la) == len(lb)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(la, lb))
    ca = [n for n in tree.leaves(a, is_leaf=tm.is_packed) if tm.is_packed(n)]
    cb = [n for n in tree.leaves(b, is_leaf=tm.is_packed) if tm.is_packed(n)]
    assert [type(n) for n in ca] == [type(n) for n in cb]
    assert all(getattr(x, "stacked", None) == getattr(y, "stacked", None)
               for x, y in zip(ca, cb))


@pytest.mark.parametrize("arch", ["phi3.5-moe", "llama4-maverick"])
@pytest.mark.parametrize("compute", ["sdv", "memory"])
def test_layerwise_build_equals_whole_tree(arch, compute):
    """``packed_params_layerwise`` == ``serve_params`` of the whole tree
    drawn from the same per-group numbers, bit for bit (and the same
    containers, stacked alike); its top leaves are ``init_params``'s."""
    cfg = t_get_arch(arch).reduced()
    kw = dict(bits=4, min_size=1 << 16, compute=compute)
    built = packed_params_layerwise(cfg, seed=5, device="cpu", **kw)
    _same_tree(built, tm.serve_params(_whole_tree(cfg, 5), **kw))
    assert tquant.count_packed(built)["memory"] >= 3 * ttrans.n_groups(cfg)
    top = tm.init_params(cfg, seed=5, device="cpu")
    assert torch.equal(ttrans.init_top_params(cfg, 5, device="cpu")["embed"],
                       top["embed"])
