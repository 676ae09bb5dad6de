"""The torch port's packed QAT (``repro_torch.train.qat``) against the
JAX package's ``repro.train.qat``, on the CPU.

  * the shared quantization rule: the three-path identity (QAT weight
    quantizer, the serving containers, the rule) in the port, and
    ``QuantizedTensor`` / ``quantize_symmetric`` / ``fake_quant`` equal
    to the reference's;
  * ``ste_dense``'s forward bit-exact against the reference's on every
    enumerable W4A4/W4A8 plan of the reference's ``_MM_LAYERS`` (the
    port's packed forward on the kernel route and on the plain route ==
    the port's ``plan=None`` == the reference's), and its gradients
    against ``jax.grad``;
  * ``ste_conv2d`` packed == decode on every enumerable W4A4 BSEG plan
    of the reference's conv layer, its output and gradients against the
    reference's;
  * ``qat_params`` wraps the reference's leaf paths with the
    reference's plans; the model's packed QAT loss equals its
    ``plan=None`` loss bitwise;
  * two QAT steps of reduced tinyllama-1.1b from the reference's init
    (``params_from_numpy``), the reference run op by op through its
    ``run_training(step_fn=make_train_step(...))``: each step's loss and
    the final parameters within the tolerances stated below; the export
    serves within 0.1 of the QAT eval;
  * ``search_bitwidths`` gives the reference's choices, and its warm
    plan cache serves ``plan_policy="cache"`` without re-planning.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import planner as jplanner
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.registry import get_arch
from repro.core.datapath import BSEGPlan as JBSEGPlan
from repro.data import SyntheticLMData as JData
from repro.models import Rules, init_params, values
from repro.quant import quantizer as jquant
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro.train.qat import bitsearch as jbitsearch
from repro.train.qat import ste as jste

from repro_torch import planner, tree
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import ops
from repro_torch.models import params_from_numpy, serve_params
from repro_torch.models.quantized import SDVLinear, pack_linear, \
    pack_linear_sdv
from repro_torch.quant import quantizer
from repro_torch.train import loop, optimizer
from repro_torch.train.qat import bitsearch, ste
from repro_torch.train.qat.loop import QATRunConfig, evaluate, \
    export_for_serving

RNG = np.random.default_rng(7)
#: STE gradients on the same float32 inputs: the float32 products sum
#: in another order than XLA's, relative to the largest gradient
STE_GRAD_RTOL = 1e-5
#: two QAT steps of reduced tinyllama (lr 1e-3, warmup 2) against the
#: reference run op by op.  The bf16 roundings of the two packages
#: differ (XLA fuses inside the reference's scans), and a one-ulp bf16
#: change at a quantizer's input moves an integer by one step, so:
#:   * each step's loss within LOSS_ATOL (observed 1.4e-4, 2.3e-3 on
#:     losses ~6.26);
#:   * every parameter within the sign-flip bound 2 * sum(lr) of Adam's
#:     updates (of magnitude lr each step; a gradient near zero can take
#:     the other sign) plus 2 bf16 ulps of the parameter;
#:   * the two packages' parameter updates point the same way: cosine
#:     of (final - init) at least UPDATE_COSINE over all leaves
#:     (observed 0.974) and UPDATE_COSINE_LEAF for each leaf (observed
#:     0.950 at the worst);
#:   * step 1's gradients before the optimizer, each leaf within
#:     GRAD_RTOL_BF16 relative (2-norm; observed 0.082 at the worst).
#:     The reference's compiled QAT forward rounds some quantizer ties
#:     otherwise than its own op-by-op one on bf16-valued data, so a
#:     tight check needs float32:
#:   * in float32 compute from a float32 init, one step's gradients each
#:     leaf within GRAD_RTOL_F32 (observed 8.0e-7) and the loss within
#:     LOSS_ATOL_F32 (observed equal).
LOSS_ATOL = 5e-3
UPDATE_COSINE = 0.95
UPDATE_COSINE_LEAF = 0.9
GRAD_RTOL_BF16 = 0.15
GRAD_RTOL_F32 = 1e-5
LOSS_ATOL_F32 = 1e-5
STEPS, LR = 2, 1e-3
#: the served (SDV-packed) eval against the QAT eval: the reference's
#: ``test_qat_export_serves`` contract
EXPORT_ATOL = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small CPU tensors: more only contend
    with the test workers running beside this one (and are slower here
    even alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan_id(plan):
    d = jplanner.plan_to_dict(plan)
    return "-".join(f"{k}{v}" for k, v in sorted(d.items()))


def _port_plan(jplan):
    """The reference's plan as the port's (the planner's dict form)."""
    return planner.plan_from_dict(jplanner.plan_to_dict(jplan))


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.reshape(-1).view(np.uint8),
                       b.reshape(-1).view(np.uint8))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the shared rule
# ---------------------------------------------------------------------------

def test_three_path_quantization_identity():
    """QAT's weight quantizer, the serving containers and the raw rule
    give the same (q, scale) in the port — and the reference's."""
    kernel_np = RNG.standard_normal((24, 16)).astype(np.float32)
    kernel = _t(kernel_np)
    bits = 4
    amax = kernel.abs().amax(dim=0)
    scale0 = quantizer.symmetric_scale(amax, bits)
    q0 = quantizer.symmetric_qvalues(kernel, scale0, bits)
    q1, scale1 = ste.quantize_weights(kernel, bits)
    assert torch.equal(scale0, scale1) and torch.equal(q0.to(torch.int32),
                                                       q1)
    plan = planner.choose_plan(
        planner.matmul_spec("t", 4, 24, 16, w_bits=bits, a_bits=8)).plan
    sdv = pack_linear_sdv(kernel, plan)
    assert torch.equal(sdv.scale, scale0)
    assert torch.equal(sdv.words, ops.prepare_sdv_weights(
        q0.to(torch.int32).T, plan))
    assert torch.equal(pack_linear(kernel, bits).scale[0], scale0)
    jq, js = jste.quantize_weights(jnp.asarray(kernel_np), bits)
    assert _same_bits(js, scale1.numpy())
    assert np.array_equal(np.asarray(jq), q1.numpy())

    x_np = RNG.standard_normal((3, 24)).astype(np.float32)
    xq, xs = ste.quantize_acts(_t(x_np), 8)
    xs0 = quantizer.symmetric_scale(_t(x_np).abs().amax(-1, keepdim=True), 8)
    assert torch.equal(xs, xs0)
    assert torch.equal(xq, quantizer.symmetric_qvalues(_t(x_np), xs0, 8)
                       .to(torch.int32))
    jxq, jxs = jste.quantize_acts(jnp.asarray(x_np), 8)
    assert _same_bits(jxs, xs.numpy())
    assert np.array_equal(np.asarray(jxq), xq.numpy())


@pytest.mark.parametrize("axis", [-1, 0, None])
def test_quantized_tensor_and_fake_quant_match_reference(axis):
    x_np = (RNG.standard_normal((6, 20)) * 3).astype(np.float32)
    x = _t(x_np)
    qt = quantizer.quantize_symmetric(x, 4, axis=axis)
    jqt = jquant.quantize_symmetric(jnp.asarray(x_np), 4, axis=axis)
    assert qt.values.dtype == torch.int8 and qt.bits == jqt.bits == 4
    assert np.array_equal(qt.values.numpy(), np.asarray(jqt.values))
    assert _same_bits(qt.scale.numpy(), jqt.scale)
    assert _same_bits(quantizer.dequantize(qt).numpy(),
                      jquant.dequantize(jqt))
    assert tree.leaves(qt) == [qt.values, qt.scale]
    xg = x.clone().requires_grad_(True)
    y = quantizer.fake_quant(xg, 4, axis=axis)
    assert _same_bits(y.detach().numpy(),
                      jquant.fake_quant(jnp.asarray(x_np), 4, axis=axis))
    y.sum().backward()
    assert torch.equal(xg.grad, torch.ones_like(x))       # straight through


# ---------------------------------------------------------------------------
# ste_dense: bit-exact on every enumerable plan; gradients
# ---------------------------------------------------------------------------

_MM_LAYERS = [jplanner.matmul_spec(f"m4a{ab}", 3, 24, 10, w_bits=4,
                                   a_bits=ab) for ab in (4, 8)]
_MM_CASES = [(ly, p) for ly in _MM_LAYERS
             for p in jplanner.enumerate_plans(ly)]


@pytest.mark.parametrize(
    "ly,jplan", _MM_CASES,
    ids=[f"w{ly.w_bits}a{ly.a_bits}-{_plan_id(p)}" for ly, p in _MM_CASES])
def test_ste_dense_forward_bit_exact_vs_reference(ly, jplan):
    """On the reference's test data for this plan: the port's packed
    forward through the dispatch table (the kernels' plain versions on
    the CPU) and through the plain route, and its ``plan=None``
    forward, all equal the reference's forward bit for bit (the
    reference's own sweep holds its packed forward to its ``plan=None``
    one)."""
    rng = np.random.default_rng(zlib.crc32(_plan_id(jplan).encode()))
    x_np = rng.standard_normal((ly.rows, ly.k)).astype(np.float32)
    k_np = rng.standard_normal((ly.k, ly.m)).astype(np.float32)
    want = np.asarray(jste.ste_dense(jnp.asarray(x_np), jnp.asarray(k_np),
                                     ly.w_bits, ly.a_bits, None, False))
    plan = _port_plan(jplan)
    for p, use_kernel in ((plan, True), (plan, False), (None, False)):
        got = ste.ste_dense(_t(x_np), _t(k_np), ly.w_bits, ly.a_bits, p,
                            use_kernel)
        assert _same_bits(got.numpy(), want), (p, use_kernel)


@pytest.mark.parametrize("datapath", ["int32", "fp32m", "dsp48e2", "dsp58"])
def test_ste_dense_packed_reference_plans(datapath):
    """The reference's packed forward itself (its dispatch on the plan)
    on the densest W4A8 plan of each datapath, against the port's."""
    ly = _MM_LAYERS[1]
    jplan = max((p for l_, p in _MM_CASES
                 if l_ is ly and p.spec.name == datapath),
                key=lambda p: p.n)
    x_np = RNG.standard_normal((5, ly.k)).astype(np.float32)
    k_np = RNG.standard_normal((ly.k, ly.m)).astype(np.float32)
    want = jste.ste_dense(jnp.asarray(x_np), jnp.asarray(k_np), 4, 8, jplan,
                          False)
    got = ste.ste_dense(_t(x_np), _t(k_np), 4, 8, _port_plan(jplan), True)
    assert _same_bits(got.numpy(), want)


def _st(x, fq):
    return x + jax.lax.stop_gradient(fq - x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ste_dense_gradients_match_reference(dtype):
    """The STE backward (float32 products at the fake-quant point, cast
    to the inputs' dtypes) against ``jax.grad`` of the reference's
    ``ste_dense`` and of its straight-through surrogate; a 3-D input
    sums the kernel's gradient over both leading axes."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x_np = RNG.standard_normal((2, 5, 24)).astype(np.float32)
    k_np = RNG.standard_normal((24, 10)).astype(np.float32)
    g_np = RNG.standard_normal((2, 5, 10)).astype(np.float32)
    jx, jk = jnp.asarray(x_np, jdt), jnp.asarray(k_np, jdt)

    def loss(x_, k_):
        return jnp.sum(jste.ste_dense(x_, k_, 4, 8, None, False)
                       .astype(jnp.float32) * g_np)

    def surrogate(x_, k_):
        xq, xs = jste.quantize_acts(x_, 8)
        qw, sw = jste.quantize_weights(k_, 4)
        x_fq = _st(x_.astype(jnp.float32), xq.astype(jnp.float32) * xs)
        w_fq = _st(k_.astype(jnp.float32),
                   qw.astype(jnp.float32) * sw[None, :])
        return jnp.sum((x_fq @ w_fq) * g_np)

    wx, wk = jax.grad(loss, argnums=(0, 1))(jx, jk)
    sx, sk = jax.grad(surrogate, argnums=(0, 1))(jx, jk)
    x = _t(x_np).to(dtype).requires_grad_(True)
    k = _t(k_np).to(dtype).requires_grad_(True)
    plan = planner.choose_plan(planner.matmul_spec(
        "g", 10, 24, 10, w_bits=4, a_bits=8)).plan
    y = ste.ste_dense(x, k, 4, 8, plan, True)
    assert y.dtype == dtype
    (y.to(torch.float32) * _t(g_np)).sum().backward()
    assert x.grad.dtype == k.grad.dtype == dtype
    for got, want, sur in ((x.grad, wx, sx), (k.grad, wk, sk)):
        want = np.asarray(want).astype(np.float32)
        got = got.to(torch.float32).numpy()
        tol = STE_GRAD_RTOL * np.abs(want).max()
        if dtype == torch.bfloat16:          # one bf16 rounding apart
            tol = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol
        assert np.abs(got - np.asarray(sur, np.float32)).max() <= \
            tol + 2.0 ** -7 * np.abs(want).max() * (dtype != torch.float32)


def test_use_kernel_defaults_to_the_input_device(monkeypatch):
    """Without ``use_kernel``, ``ste_dense``, ``ste_conv2d`` and
    ``QATLinear`` route by the input's device: the plain route on CPU
    tensors (the kernel route is taken on the card); an explicit flag
    wins."""
    from repro_torch.models.quantized import default_bseg_plan
    modes = []
    for name in ("packed_matmul", "packed_conv2d"):
        def rec(*a, _real=getattr(ops, name), **k):
            modes.append(k["mode"])
            return _real(*a, **k)
        monkeypatch.setattr(ops, name, rec)
    plan = planner.choose_plan(
        planner.matmul_spec("t", 4, 32, 16, w_bits=4, a_bits=8)).plan
    x = _t(RNG.standard_normal((4, 32)).astype(np.float32))
    k = _t(RNG.standard_normal((32, 16)).astype(np.float32))
    y = ste.ste_dense(x, k, 4, 8, plan)
    y_lin = ste.QATLinear(kernel=k, w_bits=4, a_bits=8,
                          plan=plan).qat_apply(x)
    y_kernel = ste.ste_dense(x, k, 4, 8, plan, True)
    assert modes == ["ref", "ref", "auto"]
    assert torch.equal(y, y_lin) and torch.equal(y, y_kernel)
    xc = _t(RNG.standard_normal((1, 6, 6, 8)).astype(np.float32))
    wc = _t(RNG.standard_normal((4, 8, 3, 3)).astype(np.float32))
    yc = ste.ste_conv2d(xc, wc, 4, 4, default_bseg_plan(4))
    yc_kernel = ste.ste_conv2d(xc, wc, 4, 4, default_bseg_plan(4), True)
    assert modes[3:] == ["ref", "auto"] and torch.equal(yc, yc_kernel)


# ---------------------------------------------------------------------------
# ste_conv2d
# ---------------------------------------------------------------------------

_CONV_LAYER = jplanner.conv2d_spec("c4a4", 3, 5, 2, 3, 3, 3, w_bits=4,
                                   a_bits=4)
_CONV_PLANS = [p for p in jplanner.enumerate_plans(_CONV_LAYER)
               if isinstance(p, JBSEGPlan)]


@pytest.fixture(scope="module")
def conv_case():
    ly = _CONV_LAYER
    x_np = RNG.standard_normal((2, ly.h, ly.w, ly.c_in)).astype(np.float32)
    w_np = RNG.standard_normal((ly.c_out, ly.c_in, ly.kh, ly.kw)) \
        .astype(np.float32)
    want = np.asarray(jste.ste_conv2d(jnp.asarray(x_np), jnp.asarray(w_np),
                                      4, 4, None, False))
    return x_np, w_np, want


@pytest.mark.parametrize("jplan", _CONV_PLANS,
                         ids=[_plan_id(p) for p in _CONV_PLANS])
def test_ste_conv2d_packed_equals_decode_and_reference(conv_case, jplan):
    """``ste_conv2d`` on the plan (B3's plain version, or the route the
    dispatch picks) == its ``plan=None`` forward == the reference's,
    bitwise, for every enumerable W4A4 BSEG plan."""
    x_np, w_np, want = conv_case
    got = ste.ste_conv2d(_t(x_np), _t(w_np), 4, 4, _port_plan(jplan), True)
    assert _same_bits(got.numpy(), want)


def test_ste_conv2d_decode_and_gradients_match_reference(conv_case):
    x_np, w_np, want = conv_case
    g_np = RNG.standard_normal(want.shape).astype(np.float32)
    x = _t(x_np).requires_grad_(True)
    w = _t(w_np).requires_grad_(True)
    y = ste.ste_conv2d(x, w, 4, 4, None, False)
    assert _same_bits(y.detach().numpy(), want)
    (y * _t(g_np)).sum().backward()

    def loss(x_, w_):
        return jnp.sum(jste.ste_conv2d(x_, w_, 4, 4, None, False) * g_np)
    wx, ww = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x_np),
                                            jnp.asarray(w_np))
    for got, ref in ((x.grad, wx), (w.grad, ww)):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= \
            STE_GRAD_RTOL * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the model: wrapping, packed == decode, two steps against the reference
# ---------------------------------------------------------------------------

def _qat_paths(t, path=(), is_qat=None):
    if is_qat(t):
        yield "/".join(path), t
    elif isinstance(t, dict):
        for k, v in t.items():
            yield from _qat_paths(v, path + (k,), is_qat)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_arch("tinyllama-1.1b").reduced()
    tcfg = t_get_arch("tinyllama-1.1b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    params = values(init_params(cfg, Rules(tp=None, fsdp=None, ep=None,
                                           batch=()),
                                jax.random.PRNGKey(0)))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    kw = dict(w_bits=4, a_bits=8, min_size=1 << 10, plan_policy="auto")
    return dict(cfg=cfg, tcfg=tcfg, params=params, tparams=tparams,
                qp=jste.qat_params(params, use_kernel=False, **kw),
                tqp=ste.qat_params(tparams, use_kernel=True, **kw))


def test_qat_params_wraps_the_reference_leaves(tiny):
    """The same leaf paths, bitwidths and plans as the reference's
    ``qat_params``; the serving rewrite packs that layer set; the
    default ``use_kernel`` follows the kernel's device."""
    want = {p: c for p, c in _qat_paths(tiny["qp"], is_qat=jste.is_qat)}
    got = {p: c for p, c in _qat_paths(tiny["tqp"], is_qat=ste.is_qat)}
    assert sorted(got) == sorted(want) and "lm_head" in got
    assert len(got) == ste.count_qat_layers(tiny["tqp"]) == 8
    for p, c in got.items():
        assert (c.w_bits, c.a_bits) == (want[p].w_bits, want[p].a_bits)
        assert c.plan == _port_plan(want[p].plan), p
        assert c.use_kernel
    served = serve_params(ste.float_params(tiny["tqp"]), bits=4,
                          min_size=1 << 10, compute="sdv", act_bits=8)
    n_sdv = sum(1 for _ in _qat_paths(served, is_qat=lambda t: isinstance(
        t, SDVLinear)))
    assert n_sdv == len(got)
    assert not ste.qat_params(tiny["tparams"], min_size=1 << 10)[
        "lm_head"].use_kernel                           # CPU tensors
    assert ste.float_params(tiny["tqp"])["lm_head"] is \
        tiny["tparams"]["lm_head"]


def test_qat_loss_packed_equals_decode(tiny):
    """The whole model's QAT loss on the packed plans == on ``plan=None``
    bitwise: the plan changes the route, never the arithmetic."""
    toks = torch.from_numpy(RNG.integers(0, 512, (2, 24)).astype(np.int32))
    decode = ste.qat_params(tiny["tparams"], min_size=1 << 10)
    with torch.no_grad():
        a = loop.loss_fn(tiny["tcfg"], tiny["tqp"], {"tokens": toks})
        b = loop.loss_fn(tiny["tcfg"], decode, {"tokens": toks})
    assert torch.isfinite(a) and torch.equal(a, b)


def _recording(update, grads_out):
    """``update`` that first keeps the gradients it is given: a step's
    microbatch-accumulated float32 gradients, before the optimizer."""
    def wrapped(ocfg, grads, *a, **k):
        grads_out.append(grads)
        return update(ocfg, grads, *a, **k)
    return wrapped


def _worst_leaf_rel(jgrads, tgrads):
    """max over leaves of |port - reference| / |reference| (2-norms)."""
    a_leaves = jax.tree_util.tree_leaves(jgrads)
    b_leaves = tree.leaves(tgrads)
    assert len(a_leaves) == len(b_leaves)
    worst = 0.0
    for a, b in zip(a_leaves, b_leaves):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        worst = max(worst, float(np.linalg.norm(a - b) / np.linalg.norm(a)))
    return worst


@pytest.fixture(scope="module")
def two_steps(tiny):
    cfg, tcfg = tiny["cfg"], tiny["tcfg"]
    kw = dict(lr=LR, warmup=2, total_steps=STEPS)
    jocfg, tocfg = jopt.OptConfig(**kw), optimizer.OptConfig(**kw)
    data = dict(vocab=cfg.vocab, seq_len=32, global_batch=2, seed=0)
    jl, tl, jg, tg = [], [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jopt, "update", _recording(jopt.update, jg))
        mp.setattr(optimizer, "update", _recording(optimizer.update, tg))
        jp, _, _, _ = jloop.run_training(
            cfg, jocfg, tiny["qp"], jopt.init(jocfg, tiny["qp"]),
            JData(**data), steps=STEPS,
            step_fn=jloop.make_train_step(cfg, jocfg, microbatches=2),
            on_step=lambda s, p, o, m, dt, mon: jl.append(float(m["loss"])))
        tdata = SyntheticLMData(**data)
        tp, _, _, _ = loop.run_training(
            tcfg, tocfg, tiny["tqp"], optimizer.init(tocfg, tiny["tqp"]),
            tdata, steps=STEPS, microbatches=2,
            on_step=lambda s, p, o, m, dt, mon: tl.append(float(m["loss"])))
    return dict(jp=jp, tp=tp, jl=jl, tl=tl, jg=jg, tg=tg, tdata=tdata)


def test_two_qat_steps_match_reference(tiny, two_steps):
    jl, tl = two_steps["jl"], two_steps["tl"]
    assert len(tl) == len(jl) == STEPS
    assert np.all(np.isfinite(tl))
    assert np.abs(np.array(tl) - np.array(jl)).max() <= LOSS_ATOL
    lr_sum = sum(float(optimizer.schedule(optimizer.OptConfig(
        lr=LR, warmup=2, total_steps=STEPS), torch.tensor(s)))
        for s in range(1, STEPS + 1))
    init = [p.to(torch.float32).numpy()
            for p in tree.leaves(tiny["tqp"])]
    d_port, d_ref = [], []
    for p0, a, b in zip(init, jax.tree_util.tree_leaves(two_steps["jp"]),
                        tree.leaves(two_steps["tp"])):
        a = np.asarray(a).astype(np.float32)
        b = b.to(torch.float32).numpy()
        assert a.shape == b.shape
        ulp = np.abs(a) * 2.0 ** -7
        assert (np.abs(a - b) <= 2 * lr_sum + 2 * ulp).all()
        d_ref.append((a - p0).ravel())
        d_port.append((b - p0).ravel())
    for a, b in zip(d_ref, d_port):
        cos = a @ b / np.linalg.norm(a) / np.linalg.norm(b)
        assert cos >= UPDATE_COSINE_LEAF, (a.shape, cos)
    d_ref, d_port = np.concatenate(d_ref), np.concatenate(d_port)
    cos = d_ref @ d_port / np.linalg.norm(d_ref) / np.linalg.norm(d_port)
    assert cos >= UPDATE_COSINE, cos


def test_step_gradients_match_reference(two_steps):
    """Step 1's gradients as each package hands them to the optimizer
    (float32, accumulated over 2 microbatches, from the same init and
    batch), leaf by leaf, in bf16 compute."""
    assert len(two_steps["tg"]) == len(two_steps["jg"]) == STEPS
    worst = _worst_leaf_rel(two_steps["jg"][0], two_steps["tg"][0])
    assert worst <= GRAD_RTOL_BF16, worst


def test_step_gradients_match_reference_float32(tiny, monkeypatch):
    """The same in float32 compute from a float32 init, where no
    rounding tie reaches a quantizer: one train step's accumulated
    gradients (2 microbatches) of the port's ``make_train_step`` against
    the reference's, each leaf within ``GRAD_RTOL_F32``, and the loss."""
    monkeypatch.setattr(JArchConfig, "dtype",
                        property(lambda self: jnp.float32))
    monkeypatch.setattr(TArchConfig, "dtype",
                        property(lambda self: torch.float32))
    cfg, tcfg = tiny["cfg"], tiny["tcfg"]
    params = values(init_params(cfg, Rules(tp=None, fsdp=None, ep=None,
                                           batch=()),
                                jax.random.PRNGKey(1)))
    assert {str(p.dtype) for p in jax.tree_util.tree_leaves(params)} \
        == {"float32"}
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    kw = dict(w_bits=4, a_bits=8, min_size=1 << 10)
    qp = jste.qat_params(params, use_kernel=False, **kw)
    tqp = ste.qat_params(tparams, **kw)
    host = JData(vocab=cfg.vocab, seq_len=32, global_batch=2,
                 seed=0).batch_at(0)
    ocfg = dict(lr=LR, warmup=2, total_steps=STEPS)
    jg, tg = [], []
    monkeypatch.setattr(jopt, "update", _recording(jopt.update, jg))
    monkeypatch.setattr(optimizer, "update", _recording(optimizer.update,
                                                        tg))
    jocfg, tocfg = jopt.OptConfig(**ocfg), optimizer.OptConfig(**ocfg)
    _, _, jm = jloop.make_train_step(cfg, jocfg, microbatches=2)(
        qp, jopt.init(jocfg, qp), {k: jnp.asarray(v) for k, v in
                                   host.items()})
    _, _, tm = loop.make_train_step(tcfg, tocfg, microbatches=2)(
        tqp, optimizer.init(tocfg, tqp), {k: torch.from_numpy(v) for k, v
                                          in host.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_ATOL_F32
    worst = _worst_leaf_rel(jg[0], tg[0])
    assert worst <= GRAD_RTOL_F32, worst


def test_export_serves_within_tolerance(tiny, two_steps):
    """The trained QAT tree exported to SDV serving (the planner's
    plans) evaluates within ``EXPORT_ATOL`` of the QAT eval."""
    qcfg = QATRunConfig(w_bits=4, a_bits=8, min_size=1 << 10)
    tp, data = two_steps["tp"], two_steps["tdata"]
    served = export_for_serving(qcfg, tp, plan_policy="auto")
    assert ste.count_qat_layers(served) == 0
    qat_eval = evaluate(tiny["tcfg"], tp, data, batches=1,
                        offset=qcfg.eval_offset)
    served_eval = evaluate(tiny["tcfg"], served, data, batches=1,
                           offset=qcfg.eval_offset)
    assert np.isfinite(qat_eval)
    assert abs(served_eval - qat_eval) < EXPORT_ATOL, (served_eval,
                                                       qat_eval)


# ---------------------------------------------------------------------------
# bitsearch
# ---------------------------------------------------------------------------

def test_bitsearch_matches_reference(tiny, tmp_path):
    jprec, jrep = jbitsearch.search_bitwidths(tiny["params"],
                                              min_size=1 << 10)
    prec, rep = bitsearch.search_bitwidths(tiny["tparams"], min_size=1 << 10)
    assert prec == jprec and len(rep) == len(jrep) == 8
    for a, b in zip(rep, jrep):
        for f in ("path", "kind", "w_bits", "a_bits", "datapath", "plan",
                  "route", "cost_per_mac"):
            assert getattr(a, f) == getattr(b, f), f
        assert a.sensitivity == pytest.approx(b.sensitivity, rel=1e-5)
    payload = bitsearch.write_search_report(rep, str(tmp_path / "r.json"),
                                            {"arch": "tiny"})
    assert payload["precision"]["lm_head"] == list(prec["lm_head"])
    k = _t(RNG.standard_normal((128, 64)).astype(np.float32))
    assert 0 < bitsearch.sensitivity_proxy(k, 8) \
        < bitsearch.sensitivity_proxy(k, 4) < 1


def test_bitsearch_warm_cache_serves_without_replanning(tmp_path):
    cache = str(tmp_path / "plans.json")
    params = {"layer": {"kernel": _t(
        RNG.standard_normal((64, 1024)).astype(np.float32))}}
    precision, report = bitsearch.search_bitwidths(
        params, candidates=((4, 8),), rows_list=(1, 8), cache_path=cache)
    assert precision == {"layer/kernel": (4, 8)}
    assert report[0].route != "ref"
    before = open(cache).read()
    assert "bitsearch" in before
    serve_params(params, bits=4, act_bits=8, compute="sdv",
                 plan_policy="cache", plan_cache=cache, rows=8)
    assert open(cache).read() == before       # pure cache hits
    wrapped = ste.qat_params(params, w_bits=4, a_bits=8,
                             plan_policy="cache", plan_cache=cache, rows=8)
    assert wrapped["layer"]["kernel"].plan is not None
    assert open(cache).read() == before
