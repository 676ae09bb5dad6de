"""Parity of the torch port's conv half — BSEG packing, the conv route
table, kernel B3's plain version, ``packed_conv2d`` and UltraNet-INT4 —
with the JAX package.

Same inputs (numpy, from seeds) go through both packages; the JAX
Pallas kernels run in interpret mode as the JAX package's own tests run
them.  Every integer output — kappa words, routes and reasons, conv
outputs, UltraNet head outputs — must be equal, with no tolerance:
every packed route is exact.  On the CPU the port's kernel routes run
their plain versions; the CUDA kernel itself is held against them in
``test_torch_kernels_cuda``.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bseg as jbseg
from repro.core import datapath as jdp
from repro.core import limbs as jlimbs
from repro.finnlite import ultranet_tables as j_tables
from repro.kernels import bseg_common as jbc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bseg_conv2d import bseg_conv2d as j_bseg_conv2d
from repro.kernels.bseg_conv2d import \
    bseg_conv2d_num_multiplies as j_conv_mults
from repro.models import ultranet as JU

from repro_torch.core import bseg as tbseg
from repro_torch.core import datapath as tdp
from repro_torch.core import limbs as tlimbs
from repro_torch.finnlite import ultranet_tables as t_tables
from repro_torch.kernels import bseg_common as tbc
from repro_torch.kernels import bseg_conv2d as tconv
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ultranet as TU
from repro_torch.models.convert import ultranet_params_from_numpy

SPECS = ("int32", "fp32m", "dsp48e2", "dsp58")


def _plans(spec, wk=4, wi=4):
    return (jdp.plan_bseg(jdp.DATAPATHS[spec], wk, wi),
            tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi))


def _same(j, t):
    """A JAX array and a torch tensor hold the same values and dtype
    (an int64 JAX result equals an int32 one: the tests run the JAX
    package with x64 on, under which its int32 sums widen)."""
    j = np.asarray(j)
    t = t.numpy()
    dtype_ok = j.dtype == t.dtype or (j.dtype == np.int64
                                      and t.dtype == np.int32)
    return dtype_ok and j.shape == t.shape and (j == t).all()


def _outcome(fn):
    """(value,) or (exception type name, message)."""
    try:
        return (fn(),)
    except (ValueError, NotImplementedError) as e:
        return (type(e).__name__, str(e))


def _taps(rng, c_out, c_in, kh, kw):
    return rng.integers(-8, 8, (c_out, c_in, kh, kw))


@pytest.mark.parametrize("spec", SPECS)
def test_plans_and_word_specs(spec):
    jplan, tplan = _plans(spec)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tplan)
    jws, tws = jbc.word_spec(jplan), tbc.word_spec(tplan)
    assert (jws.dtype_name, jws.width, jws.exact_wrap, jws.bias_full,
            jws.bias_top, jws.limbs) == (
        str(tws.dtype).removeprefix("torch."), tws.width, tws.exact_wrap,
        tws.bias_full, tws.bias_top, tws.limbs)
    assert jbc.bias_word_full(jplan) == tbc.bias_word_full(tplan)
    assert jbc.bias_word_top(jplan) == tbc.bias_word_top(tplan)
    assert str(np.dtype(jbseg.word_dtype(jplan))) == \
        str(tbseg.word_dtype(tplan)).removeprefix("torch.")
    for n_taps, m in ((3, 418), (1, 26), (5, 30)):
        assert jbseg.bseg_num_multiplies(n_taps, m, jplan) == \
            tbseg.bseg_num_multiplies(n_taps, m, tplan)
    assert j_conv_mults(26, 26, 64, 36, 3, 3, jplan) == \
        tconv.bseg_conv2d_num_multiplies(26, 26, 64, 36, 3, 3, tplan)


@pytest.mark.parametrize("spec", SPECS)
def test_packed_kernel_words(spec):
    """bseg_pack_kernel, prepare_bseg_conv2d (kappa words and tap sums)
    and _unpack_bseg_taps give identical integers: int32 words, float32
    values on FP32M, limb planes on DSP48E2/DSP58."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(11)
    seg = rng.integers(-8, 8, (5, 7, jplan.n_k))
    jw = np.asarray(jbseg.bseg_pack_kernel(jnp.asarray(seg, jnp.int32),
                                           jplan)).astype(np.int64)
    assert (jw == tbseg.bseg_pack_kernel(torch.tensor(seg), tplan)
            .numpy()).all()
    for c_out, c_in, k in ((16, 3, 3), (36, 64, 1), (7, 5, 5)):
        w = _taps(rng, c_out, c_in, k, k)
        jk, jt = jops.prepare_bseg_conv2d(jnp.asarray(w), jplan)
        tk, tt = tops.prepare_bseg_conv2d(torch.tensor(w), tplan)
        assert np.asarray(jk).dtype == tk.numpy().dtype
        assert _same(jk, tk), (c_out, c_in, k)
        assert tt.dtype == torch.int32 and _same(jt, tt)
    # the depthwise factors [G, C] / [2, G, C] decode back to the taps
    taps = rng.integers(-8, 8, (6, 5))
    jk, _ = jops.prepare_bseg_taps(jnp.asarray(taps), jplan)
    tk = torch.tensor(np.asarray(jk))
    ju = np.asarray(jops._unpack_bseg_taps(jk, jplan, 5))
    tu = tops._unpack_bseg_taps(tk, tplan, 5)
    assert _same(ju, tu) and (tu.numpy() == taps).all()


def _to_reference_word(word: torch.Tensor, ws):
    """The port's int64 words in the JAX package's word representation."""
    if ws.limbs == 2:
        return jlimbs.from_planes(jnp.asarray(tlimbs.to_planes(word).numpy()))
    if ws.is_float:
        return jnp.asarray(word.numpy().astype(np.float32))
    return jnp.asarray(tlimbs.lo32(word).numpy())


def _from_reference_word(word, ws) -> np.ndarray:
    if ws.limbs == 2:
        return tlimbs.from_planes(torch.tensor(np.asarray(
            jlimbs.stack_planes(word)))).numpy()
    arr = np.asarray(word)
    return arr.astype(np.int64) & (0xFFFFFFFF if arr.dtype == np.int32
                                   else -1)


@pytest.mark.parametrize("spec", SPECS)
def test_pack_iota_and_split_word(spec):
    """Four Fig. 6/7 steps of a 1-D pipeline: the input factors, the
    lanes and every next carry word are the JAX package's."""
    jplan, tplan = _plans(spec)
    jws = jbc.word_spec(jplan)
    rng = np.random.default_rng(3)
    kappa = tbseg.bseg_pack_kernel(torch.tensor(rng.integers(
        -8, 8, (4, 6, tplan.n_k))), tplan)               # int64 [4, 6]
    carry = torch.full_like(kappa, tbc.bias_word_full(tplan))
    for _ in range(4):
        seg = rng.integers(0, 16, (4, tplan.n_i, 6))
        t_iota = tbc.pack_iota(torch.tensor(seg, dtype=torch.int8), tplan,
                               dim=1)
        j_iota = jbc.pack_iota(jnp.asarray(seg, jnp.int8), jplan, axis=1)
        assert (_from_reference_word(j_iota, jws) == t_iota.numpy()).all()
        word = kappa * t_iota + carry
        j_lanes, j_next = jbc.split_word(_to_reference_word(word, jws),
                                         jplan)
        t_lanes, carry = tbc.split_word(word, tplan)
        assert len(j_lanes) == len(t_lanes) == tplan.n_lanes
        for jl, tl in zip(j_lanes, t_lanes):
            assert _same(jl, tlimbs.lo32(tl))
        mask = (1 << tplan.n_lanes * tplan.lane) - 1
        assert (_from_reference_word(j_next, jws) & mask
                == carry.numpy() & mask).all()


#: a hand-built INT32 plan whose biased word overruns the accumulator
_OVERRUN = dict(spec="int32", w_k=4, w_i=4, lane=12, n_k=2, n_i=2, w_l=0)


def _route_plans():
    out = [_plans(s) for s in SPECS]
    out.append(_plans("dsp58", 4, 8))                    # w_i = 8 > 7
    out.append(tuple(mod.BSEGPlan(**dict(_OVERRUN,
                                         spec=mod.DATAPATHS["int32"]))
                     for mod in (jdp, tdp)))
    return out


#: (x shape, w shape): 3x3, 1x1, even kernels, depthwise, 5x5, and a
#: channel mismatch
_ROUTE_SHAPES = [((1, 26, 26, 64), (64, 64, 3, 3)),
                 ((1, 26, 26, 64), (36, 64, 1, 1)),
                 ((1, 8, 8, 4), (4, 4, 2, 2)), ((1, 8, 8, 4), (4, 4, 4, 3)),
                 ((2, 1, 16, 8), (8, 1, 1, 3)), ((1, 9, 9, 3), (5, 3, 5, 5)),
                 ((1, 9, 9, 3), (5, 4, 3, 3))]


def test_select_conv_route_table():
    """The route table with its reason strings, word for word, over
    plans x shapes x modes x the kernel switch."""
    for (jplan, tplan), (xs, ws), mode, use_kernel in itertools.product(
            _route_plans(), _ROUTE_SHAPES, jops._CONV_MODES, (True, False)):
        kw = dict(use_kernel=use_kernel, mode=mode, explain=True)
        assert _outcome(lambda: jops.select_conv_route(
            xs, ws, plan=jplan, **kw)) == _outcome(
            lambda: tops.select_conv_route(xs, ws, plan=tplan, **kw)), \
            (tplan, xs, ws, mode, use_kernel)
    assert tops._CONV_MODES == jops._CONV_MODES
    for spec in SPECS:
        jplan, tplan = _plans(spec)
        assert jops._conv_word_gate(jplan) == tops._conv_word_gate(tplan)
        assert jops._sdv_words_int32(jplan.spec) == \
            tops._sdv_words_int32(tplan.spec)
    jplan, tplan = _route_plans()[-1]
    assert tops._conv_word_gate(tplan) == jops._conv_word_gate(jplan)
    assert tops._conv_word_gate(tplan) is not None


def _x_pad(rng, plan, b, h, w, c_in, kh, n_groups):
    n_steps = -(-(w + plan.n_k - 1) // plan.n_i)
    need = (n_steps - 1) * plan.n_i + (n_groups - 1) * plan.n_k + plan.n_i
    return rng.integers(0, 1 << plan.w_i,
                        (b, h + kh - 1, max(need, w + kh - 1), c_in))


@pytest.mark.parametrize("spec", SPECS)
def test_bseg_conv2d_plain_matches_pallas_kernel(spec):
    """B3's plain version against the JAX Pallas kernel (interpret mode)
    on the same x_pad and kappa, with two row and channel blocks on the
    JAX side and three tap groups."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(5)
    for c_in, c_out, k, h, w in ((4, 8, 3, 6, 11), (3, 4, 5, 4, 9)):
        taps = _taps(rng, c_out, c_in, k, k)
        jk, _ = jops.prepare_bseg_conv2d(jnp.asarray(taps), jplan)
        tk, _ = tops.prepare_bseg_conv2d(torch.tensor(taps), tplan)
        x_pad = _x_pad(rng, tplan, 2, h, w, c_in, k, tk.shape[-4])
        jy = j_bseg_conv2d(jnp.asarray(x_pad, jnp.int8), jk, plan=jplan,
                           h_out=h, w_out=w, bh=h // 2, bco=c_out // 2,
                           interpret=True)
        xt = torch.tensor(x_pad, dtype=torch.int8)
        ty = tconv.bseg_conv2d_plain(xt, tk, tplan, h_out=h, w_out=w)
        assert _same(jy, ty)
        # the wrapper takes the plain version on CPU tensors
        assert torch.equal(tconv.bseg_conv2d(xt, tk, plan=tplan, h_out=h,
                                             w_out=w), ty)


@pytest.mark.parametrize("spec", SPECS)
def test_packed_conv2d_ultranet_layer_shapes(spec):
    """packed_conv2d at every UltraNet conv shape of a 16x16 frame, and
    one zero-point case (signed activations), bit-exact against the JAX
    package's on the same plan."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(8)
    for s in JU.ultranet_layer_shapes(16, 16):
        x = rng.integers(0, 16, (1, s["h"], s["w"], s["cin"]))
        w = _taps(rng, s["cout"], s["cin"], s["k"], s["k"])
        jy = jops.packed_conv2d(jnp.asarray(x), jnp.asarray(w), plan=jplan)
        ty = tops.packed_conv2d(torch.tensor(x), torch.tensor(w),
                                plan=tplan)
        assert _same(jy, ty), s
        assert _same(jref.conv2d_int_ref(jnp.asarray(x), jnp.asarray(w)),
                     ty)
    x = rng.integers(-5, 11, (2, 7, 9, 5))
    w = _taps(rng, 6, 5, 3, 3)
    jy = jops.packed_conv2d(jnp.asarray(x), jnp.asarray(w), plan=jplan,
                            zero_point=5)
    ty = tops.packed_conv2d(torch.tensor(x), torch.tensor(w), plan=tplan,
                            zero_point=5)
    assert _same(jy, ty)


def test_conv_oracle_and_refusals():
    rng = np.random.default_rng(2)
    for xs, ws in (((2, 7, 6, 5), (4, 5, 3, 3)), ((1, 5, 9, 8), (8, 1, 1, 3)),
                   ((1, 6, 6, 4), (6, 2, 3, 1))):
        x = rng.integers(-8, 16, xs)
        w = rng.integers(-8, 8, ws)
        assert _same(jref.conv2d_int_ref(jnp.asarray(x), jnp.asarray(w)),
                     tref.conv2d_int_ref(torch.tensor(x), torch.tensor(w)))
    jplan, tplan = _plans("int32")
    # the depthwise route (kernel B4), bit-exact against the JAX package
    c = 8
    x = rng.integers(0, 16, (2, 3, 17, c))
    w = np.zeros((c, 1, 1, 3), np.int64)
    w[:, 0, 0, :] = rng.integers(-8, 8, (c, 3))
    for mode in ("auto", "bseg_conv1d", "ref"):
        jy = jops.packed_conv2d(jnp.asarray(x), jnp.asarray(w), plan=jplan,
                                mode=mode)
        ty = tops.packed_conv2d(torch.tensor(x), torch.tensor(w),
                                plan=tplan, mode=mode)
        assert _same(jy, ty), mode
    x2 = rng.integers(-8, 8, (1, 2, 9, c))        # through the zero point
    jy = jops.packed_conv2d(jnp.asarray(x2), jnp.asarray(w), plan=jplan,
                            mode="bseg_conv1d", zero_point=8)
    ty = tops.packed_conv2d(torch.tensor(x2), torch.tensor(w), plan=tplan,
                            mode="bseg_conv1d", zero_point=8)
    assert _same(jy, ty)
    with pytest.raises(ValueError, match="integer activations"):
        tops.packed_conv2d(torch.zeros(1, 4, 4, 3), torch.ones(2, 3, 3, 3),
                           plan=tplan)


# ---------------------------------------------------------------------------
# UltraNet-INT4 end to end
# ---------------------------------------------------------------------------

def _ultranet_case(case):
    """(JAX plans, port plans) for one forward case."""
    if case in ("ref", "default"):
        return None, None
    if case == "sdv_head":
        def plans(mod):
            base = mod.plan_bseg(mod.DATAPATHS["int32"], 4, 4)
            head = mod.plan_sdv(mod.DATAPATHS["dsp48e2"], 4, 5,
                                signed_a=True, signed_b=True,
                                park_sign_bits=True)
            return [base] * 8 + [head]
        return plans(jdp), plans(tdp)
    jplan, tplan = _plans(case)
    return [jplan] * 9, [tplan] * 9


@pytest.fixture(scope="module")
def ultranet_inputs():
    jparams = JU.init_ultranet(0)
    img = np.random.default_rng(1).integers(0, 16, (2, 32, 32, 3))
    want = np.asarray(JU.ultranet_forward(jparams, jnp.asarray(img),
                                          mode="ref"))
    return jparams, img, want


@pytest.mark.parametrize("case", ["ref", "default", *SPECS, "sdv_head"])
def test_ultranet_forward_matches(ultranet_inputs, case):
    """ultranet_forward at 32x32, batch 2, against the JAX package's:
    the oracle, the default plan, a bare plan_bseg(S, 4, 4) on every
    conv for each datapath (the head then runs B3 on the wide and FP32M
    words), and an SDV plan on the head."""
    jparams, img, want = ultranet_inputs
    tparams = TU.init_ultranet(0, device="cpu")
    jplans, tplans = _ultranet_case(case)
    mode = "ref" if case == "ref" else "bseg"
    if case == "ref":
        jy = want
    else:
        jy = JU.ultranet_forward(jparams, jnp.asarray(img), mode=mode,
                                 plans=jplans)
    calls = tconv.bseg_conv2d_plain.calls
    ty = TU.ultranet_forward(tparams, torch.tensor(img), mode=mode,
                             plans=tplans, device="cpu")
    assert tuple(ty.shape) == (2, 2, 2, TU.HEAD_CHANNELS)
    assert _same(jy, ty) and (np.asarray(jy) == want).all()
    if case != "ref":
        head_on_b3 = case in ("fp32m", "dsp48e2", "dsp58")
        assert tconv.bseg_conv2d_plain.calls - calls == 8 + head_on_b3


def test_ultranet_weights_and_accounting():
    jparams = JU.init_ultranet(3)
    tparams = TU.init_ultranet(3, device="cpu")
    conv = ultranet_params_from_numpy(
        [np.asarray(w) for w in jparams.convs], np.asarray(jparams.head),
        device="cpu")
    for p in (tparams, conv):
        assert all(_same(j, t) for j, t in zip(jparams.convs, p.convs))
        assert _same(jparams.head, p.head)
    assert (JU.ULTRANET_LAYERS, JU.HEAD_CHANNELS, JU.W_BITS, JU.A_BITS) == \
        (TU.ULTRANET_LAYERS, TU.HEAD_CHANNELS, TU.W_BITS, TU.A_BITS)
    for size in (32, 416):
        assert JU.ultranet_layer_shapes(size, size) == \
            TU.ultranet_layer_shapes(size, size)
        assert JU.ultranet_conv_routes(size, size) == \
            TU.ultranet_conv_routes(size, size)
        for mode in ("bseg", "naive"):
            assert JU.ultranet_multiplies(size, size, mode=mode) == \
                TU.ultranet_multiplies(size, size, mode=mode)
    assert j_tables() == t_tables()
    with pytest.raises(ValueError, match="unknown ultranet mode"):
        TU.ultranet_forward(tparams, torch.zeros(1, 16, 16, 3), mode="bogus",
                            device="cpu")
    # the benchmark-only seed baseline runs, equal to the exact oracle
    img = torch.from_numpy(np.random.default_rng(2).integers(
        0, 16, (1, 16, 16, 3)))
    assert TU.ULTRANET_MODES == JU.ULTRANET_MODES
    assert torch.equal(
        TU.ultranet_forward(tparams, img, mode="bseg_jnp", device="cpu"),
        TU.ultranet_forward(tparams, img, mode="ref", device="cpu"))
    with pytest.raises(ValueError, match="per-layer plans"):
        TU.ultranet_forward(tparams, torch.zeros(1, 16, 16, 3), mode="ref",
                            plans=[None] * 9, device="cpu")
    with pytest.raises(ValueError, match="parameters on meta"):
        TU.ultranet_forward(TU.init_ultranet(0, device="meta"),
                            torch.zeros(1, 16, 16, 3), device="cpu")


def test_ultranet_cli_on_cpu(capsys):
    from repro_torch.launch import ultranet
    assert ultranet.main(["--size", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "BSEG bit-exact vs integer conv oracle: True" in out
    assert "L0:bseg_conv2d" in out and "L8:im2col" in out
    assert "Tab IV reproduction" in out
