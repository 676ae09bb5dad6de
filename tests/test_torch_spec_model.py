"""The torch port's dense entry points of the speculative slice, on
reduced tinyllama-1.1b (2 layers, d_model 128, vocab 512): the
full-sequence forward (``models.forward``, ``models.unembed_hidden``,
``layers.attention_apply`` with the streaming softmax of
``_stream_attend`` / ``_stream_attend_diff``) and the calibration
objective of ``serving.spec.calibrated_params`` against the JAX package,
and ``verify_step`` / ``verify_slot`` / ``rollback_slot`` on the port
alone (their op-by-op parity is in ``tests/test_torch_spec.py``).

The JAX package's seeded weights cross to the port through numpy
(``models/convert.py``); both packages take the same numpy tokens.  The
reference's forward runs its layer loop and attention under
``lax.scan``/``fori_loop``, which XLA fuses (bf16 roundings move), so
logits are held within ``test_torch_model.py``'s stated tolerance; the
loss and its gradients (autograd against ``jax.value_and_grad``) within
the tolerances stated below.  The port-alone properties mirror the
reference's ``tests/test_spec.py``: verification equal to sequential
decode (``torch.equal``, a frozen slot untouched), rollback at position
0, across ``reset_slot`` and mid chunked prefill.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.models import Rules, init_params, values
from repro.models.transformer import forward as j_forward
from repro.models.transformer import unembed_hidden as j_unembed_hidden

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.serving.spec import (calibrated_params, calibration_loss,
                                      calibration_tokens)

ROWS = 2                     # cache slots
K = 3                        # drafted tokens per round
#: forward logits against the reference's: ``test_torch_model.py``'s
#: LOGIT_ATOL; observed below 0.011 on logits of magnitude ~0.94
FORWARD_ATOL = 0.05
#: the calibration loss (float32, ~6.3) and each weight's gradient
#: (bf16 leaves), relative to the loss and to the leaf's largest
#: gradient: the two packages' bf16 roundings differ along the way
LOSS_RTOL = 1e-3
GRAD_RTOL = 0.05


@pytest.fixture(scope="module")
def tiny():
    cfg = get_arch("tinyllama-1.1b").reduced()
    tcfg = t_get_arch("tinyllama-1.1b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = values(init_params(cfg, Rules(tp=None, fsdp=None, ep=None,
                                           batch=()),
                                jax.random.PRNGKey(0)))
    return dict(cfg=cfg, tcfg=tcfg, params=params,
                tparams=tm.params_from_numpy(
                    jax.tree_util.tree_map(np.asarray, params),
                    device="cpu"))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("diff", [True, False])
def test_forward_matches_reference(tiny, diff):
    """``forward`` (differentiable: bf16 operands, float32 accumulation;
    or float32 operands) against the reference's, over 3 query chunks of
    16; ``mode="hidden"`` through ``unembed_hidden`` and
    ``mode="last_logits"`` give the same logits as ``mode="logits"``."""
    cfg, tcfg = tiny["cfg"], tiny["tcfg"]
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (3, 40))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    want = np.asarray(j_forward(cfg, tiny["params"], jbatch, diff=diff))
    batch = {"tokens": _t(toks)}
    got = tm.forward(tcfg, tiny["tparams"], batch, diff=diff)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= FORWARD_ATOL
    h = tm.forward(tcfg, tiny["tparams"], batch, diff=diff, mode="hidden")
    assert torch.equal(tm.unembed_hidden(tcfg, tiny["tparams"], h), got)
    jh = j_forward(cfg, tiny["params"], jbatch, diff=diff, mode="hidden")
    assert np.abs(np.asarray(j_unembed_hidden(cfg, tiny["params"], jh))
                  - got.numpy()).max() <= FORWARD_ATOL
    last = tm.forward(tcfg, tiny["tparams"], batch, diff=diff,
                      mode="last_logits")
    assert torch.equal(last, got[:, -1:])


def test_forward_refuses_other_families():
    """``forward`` runs every family (it refused the ssm and hybrid ones
    before they were ported) and refuses an unknown mode."""
    for arch in ("tinyllama-1.1b", "phi3.5-moe", "llava-next-mistral-7b",
                 "seamless-m4t-large-v2", "mamba2-130m",
                 "recurrentgemma-2b"):
        cfg = t_get_arch(arch).reduced()
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((1, cfg.n_patches, cfg.d_model))
        if cfg.family == "encdec":
            batch["src"] = torch.zeros((1, 3, cfg.d_model))
        with torch.no_grad():
            out = tm.forward(cfg, tm.init_params(cfg, device="cpu"), batch,
                             mode="last_logits")
        assert tuple(out.shape) == (1, 1, cfg.vocab_padded), arch
        assert bool(torch.isfinite(out).all()), arch
    with pytest.raises(ValueError, match="mode"):
        tm.forward(t_get_arch("tinyllama-1.1b").reduced(),
                   tm.init_params(t_get_arch("tinyllama-1.1b").reduced(),
                                  device="cpu"),
                   {"tokens": torch.zeros((1, 4), dtype=torch.int32)},
                   mode="probs")


def test_calibration_loss_and_grads_match_reference(tiny):
    """One step of ``calibrated_params``' objective: the loss and every
    gradient of the same weights on the same numpy token batch (the
    affine-cycle stream), against ``jax.value_and_grad`` of the
    reference's loss."""
    cfg, tcfg = tiny["cfg"], tiny["tcfg"]
    toks = calibration_tokens(np.random.default_rng(0), cfg.vocab, 4, 24,
                              3, 7)

    def j_loss(p, t):
        logits = j_forward(cfg, p, {"tokens": t})
        lp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), -1)
        return -jnp.take_along_axis(lp, t[:, 1:, None], axis=-1).mean()

    jl, jg = jax.value_and_grad(j_loss)(tiny["params"],
                                        jnp.asarray(toks, jnp.int32))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                     tiny["params"]),
                              device="cpu")
    paths, leaves = zip(*_leaves(tp))
    for v in leaves:
        v.requires_grad_(True)
    tl = calibration_loss(tcfg, tp, _t(toks))
    tg = dict(zip(paths, torch.autograd.grad(tl, leaves)))
    assert abs(tl.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    for path, g in _leaves(jax.tree_util.tree_map(np.asarray, jg)):
        want = np.asarray(g, np.float32)
        got = tg[path]
        assert got.dtype == dict(zip(paths, leaves))[path].dtype, path
        got = got.float().numpy()
        assert got.shape == want.shape, path
        assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max(), \
            path


def test_calibration_tokens_match_reference_stream():
    """The reference draws its batches inline; the port's helper draws
    the same numbers from the same generator."""
    rng, ref = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(2):
        col = ref.integers(0, 512, (8, 1))
        cols = [col]
        for _ in range(31):
            cols.append((cols[-1] * 3 + 7) % 512)
        assert (calibration_tokens(rng, 512, 8, 32, 3, 7)
                == np.concatenate(cols, 1)).all()


def test_calibrated_params_learns():
    """The port's own calibration run: the loss is finite and falls, and
    the returned weights carry no autograd state."""
    losses = []
    p = calibrated_params(t_get_arch("tinyllama-1.1b").reduced(), steps=6,
                          lr=1e-2, device="cpu", losses=losses)
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert not p["embed"].requires_grad
    assert p["embed"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the port's own properties (the reference's tests/test_spec.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def packed(tiny):
    """The port's W4A8 SDV tree of the same weights (the planner's plans
    for 2 rows) and an empty cache of 2 slots at s_max 24."""
    tq = tm.serve_params(tiny["tparams"], bits=4, min_size=1024,
                         compute="sdv", act_bits=8, plan_policy="auto",
                         rows=ROWS)
    return tiny["tcfg"], tq, tm.init_cache(tiny["tcfg"], ROWS, 24,
                                           device="cpu")


def _copy(cache):
    return {k: v.clone() for k, v in cache.items()}


def _toks(rng, vocab, *shape):
    return torch.tensor(rng.integers(0, vocab, shape), dtype=torch.int32)


def test_verify_step_equals_sequential_decode(packed):
    """The exactness pillar: k+1 positions in ONE verification wave give
    the logits and K/V of k+1 sequential decode steps, bit for bit; a
    frozen slot (n_valid 0) comes back untouched."""
    cfg, qp, cache0 = packed
    rng = np.random.default_rng(3)
    toks = _toks(rng, cfg.vocab, ROWS, K + 1)
    nv = torch.tensor([K + 1, 0], dtype=torch.int32)
    vlogits, vcache = tm.verify_step(cfg, qp, _copy(cache0), toks, nv)
    cache = _copy(cache0)
    adv = torch.tensor([1, 0], dtype=torch.int32)
    for j in range(K + 1):
        logits, cache = tm.decode_step(cfg, qp, cache, toks[:, j:j + 1],
                                       advance=adv)
        assert torch.equal(vlogits[0, j], logits[0, -1]), j
    assert vcache["index"].tolist() == [K + 1, 0]
    for name, leaf in vcache.items():
        if name != "index":
            assert torch.equal(leaf, cache[name]), name
            assert torch.equal(leaf[:, 1], cache0[name][:, 1]), name


def test_verify_slot_matches_and_isolates(packed):
    cfg, qp, cache0 = packed
    rng = np.random.default_rng(4)
    toks = _toks(rng, cfg.vocab, ROWS, 3)
    nv = torch.full((ROWS,), 3, dtype=torch.int32)
    blogits, _ = tm.verify_step(cfg, qp, _copy(cache0), toks, nv)
    slogits, scache = tm.verify_slot(cfg, qp, _copy(cache0), 0, toks[:1],
                                     nv[:1])
    assert torch.equal(slogits[0], blogits[0])
    assert scache["index"].tolist() == [3, 0]
    for name, leaf in scache.items():
        if name != "index":
            assert torch.equal(leaf[:, 1], cache0[name][:, 1]), name


def test_rollback_clamps_at_zero(packed):
    _, _, cache0 = packed
    c = tm.rollback_slot(cache0, 0, 5)
    assert c["index"].tolist() == [0, 0]
    assert c["k"] is cache0["k"]                 # nothing else touched


def test_rollback_then_redecode_bit_exact(packed):
    """Advance k+1 speculative positions, roll the rejected tail back and
    decode again: logits and index equal a cache that never
    speculated."""
    cfg, qp, cache0 = packed
    rng = np.random.default_rng(5)
    toks = _toks(rng, cfg.vocab, ROWS, 4)
    adv = torch.ones((ROWS,), dtype=torch.int32)
    _, spec = tm.verify_step(cfg, qp, _copy(cache0), toks,
                             torch.full((ROWS,), 4, dtype=torch.int32))
    spec = tm.rollback_slot(tm.rollback_slot(spec, 0, 3), 1, 3)
    _, ctrl = tm.decode_step(cfg, qp, _copy(cache0), toks[:, :1],
                             advance=adv)
    for j in range(1, 4):
        ls, spec = tm.decode_step(cfg, qp, spec, toks[:, j:j + 1],
                                  advance=adv)
        lc, ctrl = tm.decode_step(cfg, qp, ctrl, toks[:, j:j + 1],
                                  advance=adv)
        assert torch.equal(ls, lc), j
    assert torch.equal(spec["index"], ctrl["index"])


def test_rollback_across_reset_slot(packed):
    """Rollback then ``reset_slot`` erases the speculative history: the
    reset slot decodes as a pristine one."""
    cfg, qp, cache0 = packed
    rng = np.random.default_rng(6)
    toks = _toks(rng, cfg.vocab, ROWS, 4)
    _, used = tm.verify_step(cfg, qp, _copy(cache0), toks,
                             torch.full((ROWS,), 4, dtype=torch.int32))
    joined = tm.reset_slot(tm.rollback_slot(used, 0, 2), 0)
    assert int(joined["index"][0]) == 0
    fresh = _toks(rng, cfg.vocab, ROWS, 2)
    adv = torch.tensor([1, 0], dtype=torch.int32)
    a, b = joined, _copy(cache0)
    for j in range(2):
        la, a = tm.decode_step(cfg, qp, a, fresh[:, j:j + 1], advance=adv)
        lb, b = tm.decode_step(cfg, qp, b, fresh[:, j:j + 1], advance=adv)
        assert torch.equal(la[0], lb[0]), j


def test_rollback_mid_chunked_prefill(packed):
    """A slot rolls back while its neighbour is mid chunked prefill: the
    neighbour's replay and the next decode equal a never-speculated
    cache's."""
    cfg, qp, cache0 = packed
    rng = np.random.default_rng(7)
    prompt = _toks(rng, cfg.vocab, 1, 8)
    spec_toks = _toks(rng, cfg.vocab, ROWS, 4)
    four = torch.tensor([4], dtype=torch.int32)

    spec = tm.prefill_slot(cfg, qp, _copy(cache0), 0, prompt[:, :4], four)
    _, spec = tm.verify_step(cfg, qp, spec, spec_toks,
                             torch.tensor([0, 4], dtype=torch.int32))
    spec = tm.rollback_slot(spec, 1, 3)
    ctrl = tm.prefill_slot(cfg, qp, _copy(cache0), 0, prompt[:, :4], four)
    _, ctrl = tm.decode_step(cfg, qp, ctrl, spec_toks[:, :1],
                             advance=torch.tensor([0, 1], dtype=torch.int32))
    spec = tm.prefill_slot(cfg, qp, spec, 0, prompt[:, 4:], four)
    ctrl = tm.prefill_slot(cfg, qp, ctrl, 0, prompt[:, 4:], four)
    step = _toks(rng, cfg.vocab, ROWS, 1)
    ls, spec = tm.decode_step(cfg, qp, spec, step)
    lc, ctrl = tm.decode_step(cfg, qp, ctrl, step)
    assert torch.equal(ls, lc)
    assert torch.equal(spec["index"], ctrl["index"])
