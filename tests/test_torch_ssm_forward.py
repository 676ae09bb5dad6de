"""Parity of the torch port's full-sequence ssm and hybrid paths with the
JAX package: the chunked SSD scan, the RG-LRU's associative scan, the
``forward`` of reduced mamba2-130m and recurrentgemma-2b, one train step
of each.

* ``ssm._ssd_chunked`` against the reference's in float32 over 4 chunks
  (chunk 16, S 64), with and without ``h0``, at ``n_groups`` 1 and 2:
  ``y`` and ``h_final`` within ``SSD_RTOL`` of their scale; and the
  port's ``ssm_apply`` over the sequence against S of its own decode
  steps (the SSD duality), within ``SSD_RTOL``.
* ``rglru.associative_scan`` bit for bit against
  ``jax.lax.associative_scan`` with the reference's ``combine`` on the
  same float32 operands (even and odd lengths); ``_rglru_core`` against
  the reference's at S 64, with and without ``h0``, within
  ``RGLRU_RTOL``.
* ``forward`` at S 64 (past the reduced hybrid's window of 16) against
  the reference's under ``jax.jit`` within ``FORWARD_ATOL``, in float
  and memory mode (bf16) and SDV mode (float32 compute); in bf16 SDV
  mode against the reference run op by op, beside reference property
  (i) (ROADMAP Queue C); ``last_logits`` is the last column of
  ``logits``.
* One float32 train step from a float32 init: every leaf's gradient
  within ``GRAD_RTOL_F32`` and the loss within ``LOSS_ATOL_F32``.

Packed QAT of both families is in ``tests/test_torch_ssm_qat.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.registry import get_arch
from repro.data import SyntheticLMData as JData
from repro.models import Rules, forward, init_params, serve_params, values
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models.param import Init

import repro_torch.models as tm
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models import ssm as tssm
from test_torch_encdec import (FORWARD_ATOL, GRAD_RTOL_F32, LOSS_ATOL_F32,
                               float32_step)

ARCHS = ("mamba2-130m", "recurrentgemma-2b")
RULES = Rules(tp=None, fsdp=None, ep=None, batch=())
#: float32 einsums of the two packages sum in another order: relative to
#: the largest output
SSD_RTOL = 1e-5
#: ``_rglru_core`` against the reference's: the scan is bit for bit, but
#: sigmoid, exp and sqrt on the CPU differ by an ulp between XLA and
#: torch, which the recurrence carries (relative to the largest |h|;
#: observed 1.2e-7 absolute, one float32 ulp, on float32 and bf16 input)
RGLRU_RTOL = 1e-6
S_FWD, B_FWD = 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as ``tests/test_torch_qat.py`` runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    return float(np.abs(port - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# the chunked SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, g, h=4, p=8, n=16, b=2, s=64):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bi = rng.standard_normal((b, s, g, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, a, bi, ci, h0


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(groups, with_h0):
    """4 chunks of 16; with 2 groups each group's B/C serves two heads
    (``repeat_interleave``, the reference's ``jnp.repeat``)."""
    rng = np.random.default_rng(groups)
    x, dt, a, bi, ci, h0 = _ssd_inputs(rng, groups)
    kw = dict(d_model=8, d_inner=32, n_heads=4, d_state=16, n_groups=groups,
              chunk=16)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bi, ci)),
                               jssm.SSMConfig(**kw),
                               h0=jnp.asarray(h0) if with_h0 else None)
    ty, th = tssm._ssd_chunked(*map(torch.from_numpy, (x, dt, a, bi, ci)),
                               tssm.SSMConfig(**kw),
                               h0=torch.from_numpy(h0) if with_h0 else None)
    assert _rel(ty, jy) <= SSD_RTOL
    assert _rel(th, jh) <= SSD_RTOL
    with pytest.raises(AssertionError):
        tssm._ssd_chunked(*map(torch.from_numpy, (x[:, :40], dt[:, :40], a,
                                                  bi[:, :40], ci[:, :40])),
                          tssm.SSMConfig(**kw))


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_scan_equals_decode_recurrence(groups):
    """The SSD duality on the port alone: ``ssm_apply`` over 64 tokens
    (the chunked scan, 4 chunks) == 64 single-token decode steps (the
    recurrence h' = exp(dt a) h + dt B x^T) from the same state, float32
    weights and inputs."""
    cfg = tssm.SSMConfig(d_model=16, d_inner=32, n_heads=4, d_state=8,
                         n_groups=groups, chunk=16)
    gen = torch.Generator().manual_seed(groups)
    params = tssm.ssm_init(tlayers.Init(gen, torch.device("cpu"),
                                        torch.float32), cfg)
    params["a_log"] = torch.randn(cfg.n_heads, generator=gen) * 0.5
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    y_seq, (conv_seq, h_seq) = tssm.ssm_apply(params, cfg, x)
    conv = h = None
    ys = []
    for t in range(x.shape[1]):
        y, (conv, h) = tssm.ssm_apply(params, cfg, x[:, t:t + 1],
                                      conv_state=conv, ssm_state=h,
                                      decode=True)
        ys.append(y)
    assert _rel(y_seq, torch.cat(ys, 1).numpy()) <= SSD_RTOL
    assert _rel(h_seq, h.numpy()) <= SSD_RTOL
    # the projections' float32 GEMMs at 64 rows and at 1 sum in another
    # order, so the conv history is equal to float32 rounding
    assert _rel(conv_seq, conv.numpy()) <= SSD_RTOL


def test_reference_property_j():
    """Reference property (j) (ROADMAP Queue C): the reference's SSD masks
    its segment matrix after the ``exp`` (``where(causal, exp(li), 0)``);
    at a chunk of 256 with dt |a| = 0.7 an upper-triangle segment sum
    passes float32's exp range, its ``exp`` is inf and the backward's 0 x
    inf makes the gradient NaN, so full-size mamba2 training would take
    NaN updates.  The port masks before the ``exp``: the same outputs,
    finite gradients, equal to the reference's where those are finite."""
    rng = np.random.default_rng(0)
    b, s, h, p, n = 1, 256, 2, 4, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.7, np.float32)
    a = np.array([-1.0, -1.0], np.float32)
    bi = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    ci = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    kw = dict(d_model=8, d_inner=8, n_heads=h, d_state=n, chunk=256)

    def jloss(x_, dt_):
        return jnp.sum(jssm._ssd_chunked(x_, dt_, jnp.asarray(a),
                                         jnp.asarray(bi), jnp.asarray(ci),
                                         jssm.SSMConfig(**kw))[0])
    jy = jssm._ssd_chunked(*map(jnp.asarray, (x, dt, a, bi, ci)),
                           jssm.SSMConfig(**kw))[0]
    jgx, jgdt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(dt))
    assert np.isfinite(np.asarray(jy)).all()
    assert np.isfinite(np.asarray(jgx)).all()
    assert np.isnan(np.asarray(jgdt)).any()
    tx = torch.from_numpy(x).requires_grad_(True)
    tdt = torch.from_numpy(dt).requires_grad_(True)
    ty, _ = tssm._ssd_chunked(tx, tdt, *map(torch.from_numpy, (a, bi, ci)),
                              tssm.SSMConfig(**kw))
    ty.sum().backward()
    assert _rel(ty, jy) <= SSD_RTOL
    assert torch.isfinite(tdt.grad).all()
    assert _rel(tx.grad, jgx) <= SSD_RTOL


# ---------------------------------------------------------------------------
# the RG-LRU's associative scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 2, 37, 64])
def test_associative_scan_bit_for_bit(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 24)).astype(np.float32)
    b = rng.standard_normal((2, s, 24)).astype(np.float32)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]
    ja, jh = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, th = trglru.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(ta.numpy(), np.asarray(ja))
    assert np.array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_core_matches_reference(with_h0):
    dr = 32
    p = values(jrglru.rglru_init(Init(jax.random.PRNGKey(3), RULES,
                                      jnp.float32),
                                 jrglru.RGLRUConfig(d_model=16, d_rnn=dr)))
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 64, dr)).astype(np.float32)
    h0 = rng.standard_normal((2, dr)).astype(np.float32) if with_h0 else None
    jy, jh = jrglru._rglru_core(p, jnp.asarray(u),
                                None if h0 is None else jnp.asarray(h0))
    ty, th = trglru._rglru_core(tp, torch.from_numpy(u),
                                None if h0 is None else torch.from_numpy(h0))
    assert _rel(ty, jy) <= RGLRU_RTOL and _rel(th, jh) <= RGLRU_RTOL


def test_rglru_one_token_is_the_decode_step():
    """At S = 1 the scan is ``gated_0 + a_0 h0`` — the arithmetic decode
    has always run (``a h0 + gated``, equal in IEEE arithmetic)."""
    gen = torch.Generator().manual_seed(0)
    cfg = trglru.RGLRUConfig(d_model=16, d_rnn=32)
    p = trglru.rglru_init(tlayers.Init(gen, torch.device("cpu"),
                                       torch.bfloat16), cfg)
    u = torch.randn((3, 1, 32), generator=gen).to(torch.bfloat16)
    h0 = torch.randn((3, 32), generator=gen)
    y, h = trglru._rglru_core(p, u, h0)
    r = torch.sigmoid(tlayers.dense_apply(p["w_a"], u).float())
    i = torch.sigmoid(tlayers.dense_apply(p["w_x"], u).float())
    log_a = -trglru._C * tssm.softplus(p["lam"])[None, None, :] * r
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * i * u.float()
    want = torch.exp(log_a)[:, 0] * h0 + gated[:, 0]
    assert torch.equal(h, want) and torch.equal(y[:, 0], want.to(u.dtype))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = get_arch(request.param).reduced()
    tcfg = t_get_arch(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams)


def _f32(monkeypatch):
    """float32 compute in both packages (the configs' ``dtype``
    patched)."""
    monkeypatch.setattr(JArchConfig, "dtype",
                        property(lambda self: jnp.float32))
    monkeypatch.setattr(TArchConfig, "dtype",
                        property(lambda self: torch.float32))


def _forwards(cfg, tcfg, jp, tp, toks, *, op_by_op=False):
    """(the reference's logits under ``jax.jit``, the port's logits, the
    port's ``last_logits``), and with ``op_by_op`` the reference's logits
    run op by op (layer loop unrolled, no jit)."""
    jtoks = jnp.asarray(toks, jnp.int32)
    out = [np.asarray(jax.jit(lambda p, t: forward(cfg, p, {"tokens": t}))(
        jp, jtoks))]
    batch = {"tokens": torch.tensor(toks, dtype=torch.int32)}
    with torch.no_grad():
        out += [tm.forward(tcfg, tp, batch),
                tm.forward(tcfg, tp, batch, mode="last_logits")]
    if op_by_op:
        out.append(np.asarray(forward(
            dataclasses.replace(cfg, scan_layers=False), jp,
            {"tokens": jtoks})))
    return out


@pytest.mark.parametrize("compute", ["float", "sdv", "memory"])
def test_forward_matches_reference(model, compute, monkeypatch):
    """Logits over S 64 (the hybrid's attention window 16 passed four
    times) against the jitted reference; on a packed tree the SDV
    projections (and the short convs on the BSEG datapath) or the memory
    words run as in serving.  SDV runs in float32 compute: in bf16 the
    jitted reference is itself farther than ``FORWARD_ATOL`` from its
    op-by-op run (property (i), below)."""
    cfg, tcfg = model["cfg"], model["tcfg"]
    jp, tp = model["params"], model["tparams"]
    if compute == "sdv":
        _f32(monkeypatch)
        jp = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
        tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  device="cpu")
    if compute != "float":
        jp = serve_params(jp, bits=4, min_size=1024, compute=compute)
        tp = tm.serve_params(tp, bits=4, min_size=1024, compute=compute)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B_FWD, S_FWD))
    want, got, last = _forwards(cfg, tcfg, jp, tp, toks)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= FORWARD_ATOL
    if compute == "sdv":
        # float32: the head's GEMM of one row sums in another order than
        # of 64 rows
        assert _rel(last, got[:, -1:].numpy()) <= SSD_RTOL
    else:
        assert torch.equal(last, got[:, -1:])


def test_sdv_forward_bf16_and_reference_property_i():
    """Reference property (i) (ROADMAP Queue C): in bf16 the reference's
    SDV forward of reduced mamba2 over 64 tokens moves by more than
    ``FORWARD_ATOL`` between ``jax.jit`` and op by op (observed 0.457 on
    logits of magnitude 0.95; 0.027 with the short convs left float):
    the BSEG conv quantizes its input with one min/max over the whole
    sequence, so a bf16 rounding that XLA moves at the extreme element
    shifts every 4-bit step.  The port's bf16 SDV forward is within
    ``FORWARD_ATOL`` of the op-by-op run (observed 0.001)."""
    cfg = get_arch("mamba2-130m").reduced()
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
    tparams = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    jp = serve_params(params, bits=4, min_size=1024, compute="sdv")
    tp = tm.serve_params(tparams, bits=4, min_size=1024, compute="sdv")
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B_FWD, S_FWD))
    jit, got, _, op = _forwards(cfg, t_get_arch("mamba2-130m").reduced(),
                                jp, tp, toks, op_by_op=True)
    assert np.abs(op - jit).max() > FORWARD_ATOL
    assert np.abs(got.numpy() - op).max() <= FORWARD_ATOL


def test_step_gradients_match_reference_float32(model, monkeypatch):
    """One float32 train step: the gradients through the SSD scan or the
    RG-LRU scan and the windowed attention into every leaf (``a_log``,
    ``dt_bias``, ``lam``, the short convs among them)."""
    cfg = model["cfg"]
    host = JData(vocab=cfg.vocab, seq_len=S_FWD // 2, global_batch=2,
                 seed=0).batch_at(0)
    dloss, dgrad = float32_step(monkeypatch, cfg, model["tcfg"], host)
    assert dloss <= LOSS_ATOL_F32, dloss
    assert dgrad <= GRAD_RTOL_F32, dgrad
