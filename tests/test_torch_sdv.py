"""Parity of the torch port's SDV core, kernels and dispatch with the JAX
package.

Same inputs (numpy, from seeds) go through both packages; the JAX
Pallas kernels run in interpret mode as the JAX package's own tests run
them.  Every integer output — plan fields, storage words, route table,
GEMM lanes — must match bit for bit: every packed route is exact.  On
the CPU the port's kernel routes run their plain versions; the CUDA
kernels themselves are held against them in ``test_torch_kernels_cuda``.
"""
import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datapath as jdp
from repro.core import limbs as jlimbs
from repro.core import signed_split as jsplit
from repro.kernels import ops as jops
from repro.kernels.sdv_matmul import sdv_matmul as j_sdv_matmul
from repro.kernels.sdv_matmul import sdv_num_multiplies as j_num_mults
from repro.kernels.sdv_matvec import sdv_matvec as j_sdv_matvec
from repro.models import quantized as jq
from repro.quant import quantizer as jquant

from repro_torch.core import datapath as tdp
from repro_torch.core import limbs as tlimbs
from repro_torch.core import signed_split as tsplit
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sdv_matmul as tmm
from repro_torch.kernels import sdv_matvec as tmv
from repro_torch.models import quantized as tq
from repro_torch.quant import quantizer as tquant

SPECS = ("int32", "dsp48e2", "dsp58")
BITS = ((4, 4), (4, 8))
_PLAN_KEYS = [(s, wa, wb, sa, sb) for s in SPECS for wa, wb in BITS
              for sa, sb in itertools.product((True, False), repeat=2)]


def _plans(spec, wa, wb, sa, sb):
    """The plan ``plan_sdv`` returns in both packages (as the datapath
    sweep builds them: sign bits parked for signed elements)."""
    kw = dict(signed_a=sa, signed_b=sb, park_sign_bits=sa)
    return (jdp.plan_sdv(jdp.DATAPATHS[spec], wa, wb, **kw),
            tdp.plan_sdv(tdp.DATAPATHS[spec], wa, wb, **kw))


def _operands(plan, m, k, rows, seed):
    rng = np.random.default_rng(seed)
    lo_a, hi_a = ((-(1 << plan.w_a - 1), 1 << plan.w_a - 1)
                  if plan.signed_a else (0, 1 << plan.w_a))
    lo_b, hi_b = ((-(1 << plan.w_b - 1), 1 << plan.w_b - 1)
                  if plan.signed_b else (0, 1 << plan.w_b))
    return (rng.integers(lo_a, hi_a, (m, k)),
            rng.integers(lo_b, hi_b, (rows, k)))


#: the JAX package's integer word packing, jitted: the same integers as
#: op by op (integer arithmetic is exact either way), compiled once per
#: plan instead of once per primitive
_j_prepare = jax.jit(jops.prepare_sdv_weights, static_argnums=1)


def _outcome(fn):
    """(value,) or (exception type name, message) — compares raising
    behaviour as well as results."""
    try:
        return (fn(),)
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("key", _PLAN_KEYS,
                         ids=["-".join(map(str, k)) for k in _PLAN_KEYS])
def test_plan_words_routes_and_packed_matmul(key):
    _check_plan_words_routes_and_packed_matmul(*_plans(*key))


@pytest.mark.parametrize("spec", SPECS)
def test_im2col_plan_words_routes_and_packed_matmul(spec):
    """The SDV plan of the conv im2col route (``_im2col_sdv_plan`` of the
    W4A4 BSEG plan: w_a=4, w_b=5, both signed, L=8, n=3) — the plan
    UltraNet's 1x1 head runs on kernel B2."""
    jbplan = jdp.plan_bseg(jdp.DATAPATHS[spec], 4, 4)
    tbplan = tdp.plan_bseg(tdp.DATAPATHS[spec], 4, 4)
    jplan, tplan = jops._im2col_sdv_plan(jbplan), tops._im2col_sdv_plan(tbplan)
    assert (tplan.w_a, tplan.w_b, tplan.lane, tplan.n, tplan.signed_a,
            tplan.signed_b) == (4, 5, 8, 3, True, True)
    _check_plan_words_routes_and_packed_matmul(jplan, tplan)
    # the head's row count (B * 26 * 26 > 8 rows) takes the GEMM
    assert tops.select_packed_route(5408, plan=tplan, explain=True) == \
        jops.select_packed_route(5408, plan=jplan, explain=True)
    assert tops.select_packed_route(5408, plan=tplan) == "sdv_matmul"


def _check_plan_words_routes_and_packed_matmul(jplan, tplan):
    # plan fields
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    assert jplan.packed_width == tplan.packed_width
    # storage words (M = 13 is not a multiple of n: padded lanes)
    m = 13
    w, x = _operands(jplan, m, 40, 5, seed=7)
    jw = _j_prepare(jnp.asarray(w), jplan)
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    assert tw.dtype == torch.int32 and jw.shape == tuple(tw.shape)
    assert (np.asarray(jw) == tw.numpy()).all()
    # route table with reasons, over rows x modes x kernel switch
    for rows, mode, use_kernel in itertools.product(
            (1, 8, 9, 64), jops._PACKED_MODES, (True, False)):
        kw = dict(use_kernel=use_kernel, mode=mode, explain=True)
        assert _outcome(lambda: jops.select_packed_route(
            rows, plan=jplan, **kw)) == _outcome(
            lambda: tops.select_packed_route(rows, plan=tplan, **kw)), \
            (rows, mode, use_kernel)
    # packed_matmul on every route (one decode-sized row count, so each
    # Pallas kernel compiles once per plan on the JAX side; GEMM row
    # counts are held against the Pallas kernel below)
    want = x @ w.T
    modes = ("auto", "sdv_matmul", "ref") + (
        ("sdv_matvec",) if jplan.signed_a else ())
    for mode in modes:
        jy = np.asarray(jops.packed_matmul(jnp.asarray(x), jw, plan=jplan,
                                           m=m, mode=mode))
        ty = tops.packed_matmul(torch.tensor(x), tw, plan=tplan, m=m,
                                mode=mode)
        assert ty.dtype == torch.int32
        assert (jy == ty.numpy()).all() and (jy == want).all(), mode


@pytest.mark.parametrize("spec,wa,wb,signed_a", [
    ("int32", 4, 8, True), ("dsp48e2", 4, 8, True), ("dsp58", 4, 4, False),
    ("int32", 3, 5, False), ("int32", 4, 5, True), ("dsp48e2", 4, 5, True),
    ("dsp58", 4, 5, True)])
def test_sdv_matmul_plain_matches_pallas_kernel(spec, wa, wb, signed_a):
    """sdv_matmul_plain == JAX sdv_matmul(interpret=True) == x @ w.T,
    with two K blocks on the JAX side and M not a multiple of n."""
    jplan, tplan = _plans(spec, wa, wb, signed_a, True)
    m, k = 3 * jplan.n + 1, 64
    w, x = _operands(jplan, m, k, 11, seed=3)
    jw = jops.prepare_sdv_weights(jnp.asarray(w), jplan)
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    jl = np.asarray(j_sdv_matmul(jnp.asarray(x, jnp.int32), jw, plan=jplan,
                                 br=8, bg=4, bk=32, interpret=True))
    tl = tmm.sdv_matmul_plain(torch.tensor(x, dtype=torch.int32), tw, tplan)
    assert tl.dtype == torch.int32 and tuple(tl.shape) == jl.shape
    assert (jl == tl.numpy()).all()
    assert (tl.numpy().reshape(11, -1)[:, :m] == x @ w.T).all()
    # the wrappers take the plain version on CPU tensors
    assert (tmm.sdv_matmul(torch.tensor(x, dtype=torch.int32), tw,
                           plan=tplan) == tl).all()
    if signed_a:
        xt = np.ascontiguousarray(x[:6].T)
        jv = np.asarray(j_sdv_matvec(jnp.asarray(xt, jnp.int32), jw,
                                     plan=jplan, bg=4, bk=32,
                                     interpret=True))
        tv = tmv.sdv_matvec(torch.tensor(xt, dtype=torch.int32), tw,
                            plan=tplan)
        assert (jv == tv.numpy()).all()


def test_wrappers_validate_operands():
    _, plan = _plans("int32", 4, 8, True, True)
    w = tops.prepare_sdv_weights(torch.ones(4, 16, dtype=torch.int64), plan)
    x = torch.ones(3, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tmm.sdv_matmul(x.to(torch.int64), w, plan=plan)
    with pytest.raises(ValueError, match="K mismatch"):
        tmm.sdv_matmul(x[:, :8].contiguous(), w, plan=plan)
    with pytest.raises(ValueError, match="at most 8 rows"):
        tmv.sdv_matvec(torch.ones(16, 9, dtype=torch.int32), w, plan=plan)
    _, wide = _plans("dsp48e2", 4, 8, True, True)
    with pytest.raises(ValueError, match="3 dims"):
        tmm.sdv_matmul(x, w, plan=wide)


@pytest.mark.parametrize("spec", ["int32", "dsp48e2"])
def test_sdv_matmul_apply_matches(spec):
    """pack_linear_sdv + sdv_matmul_apply: identical words and scales,
    identical int32 GEMM outputs and identical f32 results."""
    jplan, tplan = _plans(spec, 4, 8, True, True)
    rng = np.random.default_rng(5)
    kern = rng.standard_normal((48, 21)).astype(np.float32)
    x = rng.standard_normal((2, 3, 48)).astype(np.float32)
    jl = jq.pack_linear_sdv(jnp.asarray(kern), jplan)
    tl = tq.pack_linear_sdv(torch.tensor(kern), tplan)
    assert (np.asarray(jl.words) == tl.words.numpy()).all()
    assert (np.asarray(jl.scale) == tl.scale.numpy()).all()
    # the integer GEMM on the quantized activations
    xs = jquant.symmetric_scale(
        jnp.max(jnp.abs(jnp.asarray(x)), axis=-1, keepdims=True), 8)
    xq = np.asarray(jquant.symmetric_qvalues(jnp.asarray(x), xs, 8),
                    np.int64)
    jy = np.asarray(jops.packed_matmul(jnp.asarray(xq), jl.words,
                                       plan=jplan, m=21, mode="ref"))
    ty = tops.packed_matmul(torch.tensor(xq), tl.words, plan=tplan, m=21)
    assert (jy == ty.numpy()).all()
    # the dequantized f32 results
    jo = np.asarray(jq.sdv_matmul_apply(jl, jnp.asarray(x)))
    to = tq.sdv_matmul_apply(tl, torch.tensor(x))
    assert to.dtype == torch.float32
    assert (jo == to.numpy()).all()
    # materialize (the LM head's path)
    jm = np.asarray(jq.materialize(jl, jnp.float32))
    assert (jm == tq.materialize(tl, torch.float32).numpy()).all()


def test_quantizer_rule_on_ties():
    """x / scale = k + 0.5 exactly: both packages round half to even."""
    k = np.arange(-9, 9, dtype=np.float32)
    scale = np.float32(0.5)
    x = (k + 0.5) * scale
    for bits in (4, 8):
        jv = np.asarray(jquant.symmetric_qvalues(jnp.asarray(x), scale,
                                                 bits))
        tv = tquant.symmetric_qvalues(torch.tensor(x),
                                      torch.tensor(scale), bits).numpy()
        assert (jv == tv).all()
        assert set(np.abs(tv[np.abs(tv) < (1 << bits - 1) - 1]) % 2) \
            == {0.0}
        lo = np.float32(-4.0)
        ja = np.asarray(jquant.asymmetric_qvalues(jnp.asarray(x), lo,
                                                  scale, bits))
        ta = tquant.asymmetric_qvalues(torch.tensor(x), torch.tensor(lo),
                                       torch.tensor(scale), bits).numpy()
        assert (ja == ta).all()
    amax = np.random.default_rng(2).random(64).astype(np.float32)
    amax[0] = 0.0
    assert (np.asarray(jquant.symmetric_scale(jnp.asarray(amax), 4))
            == tquant.symmetric_scale(torch.tensor(amax), 4).numpy()).all()


def test_quantizer_divisors_are_made_once():
    """``div`` gives JAX's correctly rounded float32 quotient, and its
    divisor tensors are made once per (value, dtype, device) and then
    reused, so a model step adds no device fill per division."""
    from repro_torch.device import constant
    x = np.random.default_rng(3).standard_normal(256).astype(np.float32)
    for d in (7, 15, 127.0, math.sqrt(64)):
        jq = np.asarray(jnp.asarray(x) / d)
        assert (jq == tquant.div(torch.tensor(x), d).numpy()).all()
        assert constant(d, torch.float32, torch.device("cpu")) \
            is constant(d, torch.float32, torch.device("cpu"))
    bf = constant(0.044715, torch.bfloat16, torch.device("cpu"))
    assert bf.dtype == torch.bfloat16 and bf.ndim == 0
    assert float(bf) == float(jnp.asarray(0.044715, jnp.bfloat16))


@pytest.mark.parametrize("spec,signed", [("int32", True), ("dsp48e2", True),
                                         ("dsp58", False)])
def test_pre_adder_packing_and_limb_planes(spec, signed):
    """split_signed / pack: the port's int64 words, carried as planes,
    equal the JAX package's int32-limb words."""
    plan, _ = _plans(spec, 4, 8, signed, True)
    rng = np.random.default_rng(9)
    vals = rng.integers(-8 if signed else 0, 8 if signed else 16,
                        (5, plan.n))
    jr, js = jsplit.split_signed(jnp.asarray(vals, jnp.int32), 4)
    tr, ts = tsplit.split_signed(torch.tensor(vals, dtype=torch.int32), 4)
    assert (np.asarray(jr) == tr.numpy()).all()
    assert (np.asarray(js) == ts.numpy()).all()
    jw = np.asarray(jlimbs.stack_planes(jsplit.pack_limbs(
        jnp.asarray(vals, jnp.int32), 4, plan.lane, signed=signed)))
    tw = tsplit.pack(torch.tensor(vals), 4, plan.lane, signed=signed)
    assert (jw == tlimbs.to_planes(tw).numpy()).all()
    assert (tlimbs.from_planes(tlimbs.to_planes(tw)) == tw).all()
    assert (tw.numpy() == vals @ (1 << (plan.lane * np.arange(plan.n)))).all()


def test_num_multiplies_and_unsupported_routes():
    """``sdv_num_multiplies`` as in the reference; the memory-packed
    route (no plan) without ``scale``/``w_bits`` raises the reference's
    ValueError, on both sides."""
    jplan, tplan = _plans("dsp48e2", 4, 8, True, True)
    assert j_num_mults(7, 37, 64, jplan) == tmm.sdv_num_multiplies(
        7, 37, 64, tplan)
    words = np.zeros((8, 1), np.int32)
    want = _outcome(lambda: jops.packed_matmul(jnp.ones((2, 8)),
                                               jnp.asarray(words)))
    assert want == ("ValueError",
                    "route 'quant_matmul' needs scale and w_bits")
    assert _outcome(lambda: tops.packed_matmul(
        torch.ones(2, 8), torch.tensor(words))) == want
