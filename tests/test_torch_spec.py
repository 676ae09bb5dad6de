"""Parity of the torch port's speculative-decoding entry points
(``models.verify_step``, ``verify_slot``, ``rollback_slot``) and of its
self-speculation draft (``serving.spec.SpecDecoder``) with the JAX
package, on reduced tinyllama-1.1b (2 layers, d_model 128, vocab 512).

The JAX package's seeded weights cross to the port through numpy
(``models/convert.py``), both packages pack them with their own
``serve_params`` and take the same numpy tokens, and the reference runs
op by op (layer loop unrolled, no enclosing jit), as
``tests/test_torch_model.py`` holds the decode and prefill: caches bit
for bit, logits within one bf16 rounding (``rtol 2^-7``, the op-by-op
tolerance of ``test_torch_model.py``).  The W4A4 draft's words and
scales equal the reference's ``draft_qparams`` bit for bit, and its
target-vs-draft plan table the reference's.

The rest of the speculative slice is tested beside this file:
``test_torch_spec_model.py`` (``forward`` and the calibration objective
against the reference; verification equal to sequential decode and the
rollback cases on the port alone), ``test_torch_spec_trace.py`` (the
engine against the reference's engine) and ``test_torch_spec_engine.py``
(the engine's invariants and CLIs).  The JAX package's first calls
compile every op for each new shape, which dominates these runs; split
four ways, each file stays short.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.models import Rules, init_params, values
from repro.models import (decode_step as j_decode_step,
                          init_cache as j_init_cache,
                          prefill_step as j_prefill_step,
                          rollback_slot as j_rollback_slot,
                          serve_params as j_serve_params,
                          verify_slot as j_verify_slot,
                          verify_step as j_verify_step)
from repro.serving.spec import SpecDecoder as JSpecDecoder

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.serving.spec import SpecConfig, SpecDecoder, accept_length

ROWS = 2                     # cache slots
K = 3                        # drafted tokens per round
S_MAX = 16                   # cache length
#: logits against the reference run op by op: one bf16 rounding
#: (``test_torch_model.py::test_op_by_op_reference``)
OP_RTOL = 2.0 ** -7


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
    kw = dict(bits=4, min_size=1024, compute="sdv", plan_policy="auto",
              rows=ROWS)
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                unrolled=dataclasses.replace(cfg, scan_layers=False),
                jq=j_serve_params(params, act_bits=8, **kw),
                tq=tm.serve_params(tparams, act_bits=8, **kw))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _same_cache(jc, tc):
    """Every leaf bit for bit."""
    assert set(jc) == set(tc)
    for k in jc:
        assert (np.asarray(jc[k]) == tc[k].numpy()).all(), k


def _close(jl, tl):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=OP_RTOL,
                               atol=0)


def _prefilled(s, rng):
    """Both packages' caches of ROWS slots at s_max S_MAX, prefilled with
    the same 4 / 3 prompt tokens."""
    ucfg, tcfg = s["unrolled"], s["tcfg"]
    prompt = rng.integers(0, ucfg.vocab, (ROWS, K + 1))
    nv = np.array([K + 1, K], np.int32)
    jc = values(j_init_cache(ucfg, Rules(tp=None, fsdp=None, ep=None,
                                         batch=()), ROWS, S_MAX))
    jc = j_prefill_step(ucfg, s["jq"], jc, jnp.asarray(prompt, jnp.int32),
                        jnp.asarray(nv))
    tc = tm.prefill_step(tcfg, s["tq"], tm.init_cache(tcfg, ROWS, S_MAX,
                                                      device="cpu"),
                         _t(prompt), _t(nv))
    return jc, tc


# ---------------------------------------------------------------------------
# the model entry points against the reference, op by op
# ---------------------------------------------------------------------------

def test_verify_slot_rollback_match_reference(tiny):
    """``verify_step`` (one slot frozen), ``rollback_slot`` (past 0:
    clamped), ``verify_slot`` and a decode step after them: every cache
    leaf equals the reference's run op by op, the logits within one bf16
    rounding."""
    ucfg, tcfg, jq, tq = tiny["unrolled"], tiny["tcfg"], tiny["jq"], \
        tiny["tq"]
    rng = np.random.default_rng(0)
    jc, tc = _prefilled(tiny, rng)
    _same_cache(jc, tc)
    toks = rng.integers(0, ucfg.vocab, (ROWS, K + 1))
    nv = np.array([K + 1, 0], np.int32)
    jl, jc = j_verify_step(ucfg, jq, jc, jnp.asarray(toks, jnp.int32),
                           jnp.asarray(nv))
    tl, tc = tm.verify_step(tcfg, tq, tc, _t(toks), _t(nv))
    assert tl.shape == (ROWS, K + 1, tcfg.vocab_padded)
    _close(jl[0], tl[0])
    _same_cache(jc, tc)
    for slot, n in ((0, 2), (1, 7)):
        jc = j_rollback_slot(jc, slot, n)
        before = dict(tc)
        tc = tm.rollback_slot(tc, slot, n)
        assert tc["index"] is not before["index"]
        assert all(tc[k] is before[k] for k in tc if k != "index")
        _same_cache(jc, tc)
    assert tc["index"].tolist() == [6, 0]
    stoks = rng.integers(0, ucfg.vocab, (1, K + 1))
    jl, jc = j_verify_slot(ucfg, jq, jc, 1, jnp.asarray(stoks, jnp.int32),
                           jnp.asarray([3], jnp.int32))
    tl, tc = tm.verify_slot(tcfg, tq, tc, 1, _t(stoks), _t([3]))
    _close(jl[0, :3], tl[0, :3])
    _same_cache(jc, tc)
    tok = rng.integers(0, ucfg.vocab, (ROWS, 1))
    jl, jc = j_decode_step(ucfg, jq, jc, jnp.asarray(tok, jnp.int32))
    tl, tc = tm.decode_step(tcfg, tq, tc, _t(tok))
    _close(jl, tl)
    _same_cache(jc, tc)


# ---------------------------------------------------------------------------
# SpecConfig / SpecDecoder
# ---------------------------------------------------------------------------

def test_spec_config_validates():
    with pytest.raises(ValueError, match="spec_k"):
        SpecConfig(k=0)


def test_spec_decoder_rejects_recurrent_families(tiny):
    with pytest.raises(ValueError, match="family"):
        SpecDecoder(t_get_arch("mamba2-130m").reduced(), tiny["tparams"])


def test_accept_length():
    assert accept_length(np.array([5, 6, 7]), np.array([5, 6, 7, 9])) == 3
    assert accept_length(np.array([5, 6, 7]), np.array([5, 9, 7, 9])) == 1
    assert accept_length(np.array([5, 6, 7]), np.array([1, 6, 7, 9])) == 0


def test_draft_words_and_plan_table_match_reference(tiny):
    """The W4A4 draft: every container's words, scales and plan equal the
    reference's ``draft_qparams``; ``plan_comparison`` equals the
    reference's table, and every draft layer is strictly denser on the
    target's datapath."""
    jdec = JSpecDecoder(tiny["cfg"], tiny["params"], plan_policy="auto")
    tdec = SpecDecoder(tiny["tcfg"], tiny["tparams"], plan_policy="auto")
    jd = dict(_leaves(jdec.draft_qparams(ROWS)))
    td = dict(_leaves(tdec.draft_qparams(ROWS)))
    packed = [k for k, v in jd.items() if hasattr(v, "words")]
    assert len(packed) == 8 and set(jd) == set(td)
    for k in packed:
        assert (np.asarray(jd[k].words) == td[k].words.numpy()).all(), k
        assert (np.asarray(jd[k].scale) == td[k].scale.numpy()).all(), k
        assert (jd[k].plan.n, jd[k].plan.spec.name, jd[k].plan.w_b) == \
            (td[k].plan.n, td[k].plan.spec.name, td[k].plan.w_b), k
    want = jdec.plan_comparison(tiny["jq"], ROWS)
    got = tdec.plan_comparison(tiny["tq"], ROWS)
    assert got == want and len(got) == 8
    assert all(r["draft_denser"] for r in got)
