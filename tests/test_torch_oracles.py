"""The torch port's int64 oracles (``repro_torch.core.sdv``, the rest of
``repro_torch.core.bseg``) and UltraNet's ``mode="bseg_jnp"`` against the
JAX package, which ``tests/conftest.py`` runs under x64 (its DSP48E2 and
DSP58 words are int64 there).

* SDV: ``sdv_pack``, ``sdv_macc`` (the final word and the spill totals)
  and ``sdv_extract``/``sdv_matvec`` bit for bit against the reference
  (values and dtype) and against ``w @ x`` in Python integers, on every
  exact-wrap word (INT32, DSP48E2, DSP58) at W4A4, W4A8 and the widest
  w_a = w_b plan of the word, signed and unsigned; the worst-case values
  of ``tests/test_core_packing.py::test_sdv_worst_case_values`` on each
  word; FP32M refused as the reference refuses it.
* BSEG: ``bseg_pack_inputs``, ``bseg_conv1d_grouped`` and
  ``bseg_conv1d`` bit for bit against the reference on INT32, DSP48E2,
  DSP58 and FP32M, kernels longer than ``n_k`` (several groups) and a
  nonzero ``input_zero_point``, and against ``np.correlate``.
* UltraNet-INT4 ``mode="bseg_jnp"`` at 16x16 against the reference's
  ``bseg_jnp`` and the port's ``bseg`` mode, bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import bseg as jbseg
from repro.core import sdv as jsdv
from repro.models import ultranet as JU

import repro_torch.core as tcore
from repro_torch.core import bseg as tbseg
from repro_torch.core import sdv as tsdv
from repro_torch.models import ultranet as TU

EXACT_WRAP = ("int32", "dsp48e2", "dsp58")
SPECS = EXACT_WRAP + ("fp32m",)


def _same(j, t) -> bool:
    """The same values and dtype."""
    j = np.asarray(j)
    t = t.numpy()
    return j.dtype == t.dtype and j.shape == t.shape and (j == t).all()


def _widest(spec, signed):
    """The widest w_a = w_b SDV plan of ``spec`` (both packages agree on
    the plan: ``core.datapath`` is a copy)."""
    for w in range(32, 1, -1):
        try:
            return jcore.plan_sdv(jcore.DATAPATHS[spec], w, w,
                                  signed_a=signed, signed_b=signed)
        except ValueError:
            continue
    raise AssertionError(spec)


WIDTHS = {"W4A4": (4, 4), "W4A8": (4, 8), "widest": None}


def _plans(spec, signed, widths):
    if WIDTHS[widths] is None:
        jplan = _widest(spec, signed)
    else:
        jplan = jcore.plan_sdv(jcore.DATAPATHS[spec], *WIDTHS[widths],
                               signed_a=signed, signed_b=signed)
    tplan = tcore.plan_sdv(tcore.DATAPATHS[spec], jplan.w_a, jplan.w_b,
                           signed_a=signed, signed_b=signed)
    assert (tplan.n, tplan.lane) == (jplan.n, jplan.lane)
    return jplan, tplan


def _operands(rng, plan, m, k):
    def draw(w, signed, shape):
        lo, hi = (-(1 << (w - 1)), 1 << (w - 1)) if signed else (0, 1 << w)
        return rng.integers(lo, hi, size=shape)
    return (draw(plan.w_a, plan.signed_a, (m, k)),
            draw(plan.w_b, plan.signed_b, (k,)))


@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("spec", EXACT_WRAP)
def test_sdv_oracle_matches_reference(spec, signed, widths):
    jplan, tplan = _plans(spec, signed, widths)
    rng = np.random.default_rng(jplan.w_a * 31 + jplan.w_b)
    # as deep as the lanes hold the exact sums (the widest plans' depth
    # is below 40)
    m, k = 2 * jplan.n + 1, min(40, jcore.sdv_max_accumulation_depth(jplan))
    w_mat, x = _operands(rng, jplan, m, k)
    # the pieces: packed words, the MAC chain's word and spills, the fix-up
    groups = -(-m // jplan.n)
    wp = np.concatenate([w_mat, np.zeros((groups * jplan.n - m, k),
                                         np.int64)]).reshape(
        groups, jplan.n, k)
    steps = np.moveaxis(wp, -1, 0)
    jpacked = jsdv.sdv_pack(jnp.asarray(steps), jplan)
    tpacked = tsdv.sdv_pack(torch.from_numpy(steps), tplan)
    assert _same(jpacked, tpacked)
    bs = np.broadcast_to(x[:, None], (k, groups))
    jword, jspills = jsdv.sdv_macc(jpacked, jnp.asarray(steps & 3),
                                   jnp.asarray(bs), jplan)
    tword, tspills = tsdv.sdv_macc(tpacked, torch.from_numpy(steps & 3),
                                   torch.from_numpy(np.array(bs)), tplan)
    assert _same(jword, tword)
    assert np.array_equal(np.asarray(jspills), tspills.numpy())
    assert _same(jsdv.sdv_extract(jword, jspills, jplan),
                 tsdv.sdv_extract(tword, tspills, tplan))
    # the whole matvec, against the reference and Python integers
    jy = jsdv.sdv_matvec(jnp.asarray(w_mat), jnp.asarray(x), jplan)
    ty = tsdv.sdv_matvec(torch.from_numpy(w_mat), torch.from_numpy(x), tplan)
    assert _same(jy, ty)
    exact = [sum(int(a) * int(b) for a, b in zip(row, x)) for row in w_mat]
    assert ty.tolist() == exact


@pytest.mark.parametrize("spec", EXACT_WRAP)
def test_sdv_worst_case_values(spec):
    """All most-negative values (the pad-MSB case of Sec. III-C), as
    ``tests/test_core_packing.py`` checks it on DSP48E2."""
    jplan = jcore.plan_sdv(jcore.DATAPATHS[spec], 4, 4)
    tplan = tcore.plan_sdv(tcore.DATAPATHS[spec], 4, 4)
    w_mat = np.full((jplan.n, 64), -8)
    x = np.full((64,), -8)
    jy = jsdv.sdv_matvec(jnp.asarray(w_mat), jnp.asarray(x), jplan)
    ty = tsdv.sdv_matvec(torch.from_numpy(w_mat), torch.from_numpy(x), tplan)
    assert _same(jy, ty) and (ty == 64 * 64).all()


def test_sdv_refuses_fp32m():
    plan = tcore.plan_sdv(tcore.FP32M, 4, 4)
    with pytest.raises(ValueError, match="exact-wrap"):
        jsdv.word_dtype(jcore.plan_sdv(jcore.FP32M, 4, 4))
    with pytest.raises(ValueError, match="exact-wrap"):
        tsdv.word_dtype(plan)
    with pytest.raises(ValueError, match="exact-wrap"):
        tsdv.sdv_matvec(torch.ones((3, 4), dtype=torch.int64),
                        torch.ones(4, dtype=torch.int64), plan)


# ---------------------------------------------------------------------------
# BSEG
# ---------------------------------------------------------------------------

def _bseg_plans(spec, wk=4, wi=4):
    return (jcore.plan_bseg(jcore.DATAPATHS[spec], wk, wi),
            tcore.plan_bseg(tcore.DATAPATHS[spec], wk, wi))


@pytest.mark.parametrize("spec", SPECS)
def test_bseg_pack_inputs_and_grouped_match_reference(spec):
    jplan, tplan = _bseg_plans(spec)
    rng = np.random.default_rng(11)
    window = rng.integers(0, 1 << jplan.w_i, size=(3, 5, jplan.n_i))
    assert _same(jbseg.bseg_pack_inputs(jnp.asarray(window), jplan),
                 tbseg.bseg_pack_inputs(torch.from_numpy(window), tplan))
    taps = rng.integers(-8, 8, size=(3, jplan.n_k))
    xs = rng.integers(0, 16, size=(3, 41))
    jy = jbseg.bseg_conv1d_grouped(jnp.asarray(taps), jnp.asarray(xs), jplan)
    ty = tbseg.bseg_conv1d_grouped(torch.from_numpy(taps),
                                   torch.from_numpy(xs), tplan)
    assert _same(jy, ty)
    ref = np.stack([np.correlate(xs[b], taps[b], "valid") for b in range(3)])
    assert np.array_equal(ty.numpy().astype(np.int64), ref)


@pytest.mark.parametrize("zp", [0, 8])
@pytest.mark.parametrize("n_taps", [3, 9])
@pytest.mark.parametrize("spec", SPECS)
def test_bseg_conv1d_matches_reference(spec, n_taps, zp):
    """9 taps exceed every W4A4 plan's n_k: several kernel groups through
    the adder tree; zp 8 runs signed inputs through the zero-point
    correction."""
    jplan, tplan = _bseg_plans(spec)
    assert n_taps < 9 or n_taps > jplan.n_k
    rng = np.random.default_rng(n_taps + zp)
    taps = rng.integers(-8, 8, size=(2, 4, n_taps))
    xs = rng.integers(-zp, 16 - zp, size=(2, 4, 64))
    jy = jbseg.bseg_conv1d(jnp.asarray(taps), jnp.asarray(xs), jplan,
                           input_zero_point=zp)
    ty = tbseg.bseg_conv1d(torch.from_numpy(taps), torch.from_numpy(xs),
                           tplan, input_zero_point=zp)
    assert _same(jy, ty)
    ref = np.stack([[np.correlate(xs[b, c], taps[b, c], "valid")
                     for c in range(4)] for b in range(2)])
    assert np.array_equal(ty.numpy().astype(np.int64), ref)


def test_bseg_float_helpers_match_reference():
    """``shift_down``/``mod_pow2`` on FP32M's float32 words and on
    integer words."""
    w = np.array([0.0, 1.0, 255.0, 4096.0 + 17.0, 2.0 ** 23 + 5.0],
                 np.float32)
    for bits in (0, 3, 8, 12):
        for fn in ("shift_down", "mod_pow2"):
            a = getattr(jbseg, fn)(jnp.asarray(w), bits)
            b = getattr(tbseg, fn)(torch.from_numpy(w), bits)
            assert _same(a, b), (fn, bits)
            a = getattr(jbseg, fn)(jnp.asarray(w.astype(np.int64)), bits)
            b = getattr(tbseg, fn)(torch.from_numpy(w.astype(np.int64)), bits)
            assert _same(a, b), (fn, bits)


# ---------------------------------------------------------------------------
# UltraNet's bseg_jnp mode
# ---------------------------------------------------------------------------

def test_ultranet_bseg_jnp_matches_reference_and_bseg():
    assert TU.ULTRANET_MODES == JU.ULTRANET_MODES == ("ref", "bseg",
                                                      "bseg_jnp")
    jparams = JU.init_ultranet(0)
    tparams = TU.init_ultranet(0, device="cpu")
    img = np.random.default_rng(0).integers(0, 16, (1, 16, 16, 3))
    jy = JU.ultranet_forward(jparams, jnp.asarray(img), mode="bseg_jnp")
    ty = TU.ultranet_forward(tparams, img, mode="bseg_jnp", device="cpu")
    assert _same(jy, ty)
    tb = TU.ultranet_forward(tparams, img, mode="bseg", device="cpu")
    assert np.array_equal(ty.numpy(), tb.numpy().astype(ty.numpy().dtype))
