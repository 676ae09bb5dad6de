"""Parity of the torch port's recurrent families with the JAX package:
the conv1d half of ``kernels/ops`` (kernel B4's plain version), the
``BSEGConv`` short conv, and packed decoding of reduced mamba2-130m (ssm)
and recurrentgemma-2b (hybrid).

Same inputs (numpy, from seeds) go through both packages; the JAX
Pallas kernel runs in interpret mode as the JAX package's own tests run
it.  Integer outputs — kappa words, tap sums, routes and reasons, conv
outputs — must be equal, with no tolerance.  The float decode is held
against the JAX package run op by op (layer loop unrolled, no enclosing
jit), which is the port's execution model, and against the JAX package
as it runs (``jit``), whose XLA fusion moves bf16 roundings.  On the CPU
the port's kernels run their plain versions; the CUDA kernel itself is
held against them in ``test_torch_kernels_cuda``.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core import datapath as jdp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.bseg_conv1d import bseg_conv1d as j_bseg_conv1d
from repro.models import (BSEGConv, Rules, SDVLinear, decode_step,
                          init_cache, init_params, serve_params, values)
from repro.models import quantized as jquant
from repro.models import ssm as jssm

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.core import datapath as tdp
from repro_torch.kernels import bseg_conv1d as tconv1d
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import quantized as tquant
from repro_torch.models import ssm as tssm

SPECS = ("int32", "fp32m", "dsp48e2", "dsp58")
ARCHS = ("mamba2-130m", "recurrentgemma-2b")
#: decode batch, cache length and teacher-forced steps: 20 steps pass the
#: reduced hybrid's 16-entry attention window, so its KV ring wraps
B, S_MAX, STEPS = 3, 20, 20
#: Against the JAX package run op by op: every integer (SDV lanes, the
#: BSEG conv) is exact and the float ops are the same ops in the same
#: dtypes, so the logits may differ by one bf16 rounding of the final
#: product — 2^-7 of the logits' scale (the largest |logit| of the step:
#: the rounding is relative to the summed terms, not to a logit that
#: cancels to near zero) — and the float32 states by float32 rounding.
LOGIT_RTOL = 2.0 ** -7
STATE_ATOL = 1e-5


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


def _bf16(rng, shape, scale=1.0):
    """Seeded bf16 values as (numpy float32 of the bf16 values, torch)."""
    t = torch.tensor(rng.standard_normal(shape) * scale,
                     dtype=torch.float32).to(torch.bfloat16)
    return t.to(torch.float32).numpy(), t


# ---------------------------------------------------------------------------
# the conv1d half of kernels/ops and kernel B4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n_taps", [3, 4, 5])
def test_prepare_bseg_taps(spec, n_taps):
    """[G, C] words (int32, float32 on FP32M) or [2, G, C] limb planes,
    and the tap sums, bit for bit; the factors decode back to the taps."""
    jplan, tplan = _plans(spec)
    taps = np.random.default_rng(n_taps).integers(-8, 8, (11, n_taps))
    jk, js = jops.prepare_bseg_taps(jnp.asarray(taps), jplan)
    tk, ts = tops.prepare_bseg_taps(torch.tensor(taps), tplan)
    assert _same(jk, tk) and _same(js, ts)
    assert ts.dtype == torch.int32
    assert (tops._unpack_bseg_taps(tk, tplan, n_taps).numpy() == taps).all()


def _x_pad(rng, plan, b, s_out, c, n_groups):
    n_steps = -(-(s_out + plan.n_k - 1) // plan.n_i)
    need = (n_steps - 1) * plan.n_i + (n_groups - 1) * plan.n_k + plan.n_i
    return rng.integers(0, 1 << plan.w_i, (b, need + 2, c))


@pytest.mark.parametrize("spec", SPECS)
def test_bseg_conv1d_plain_matches_pallas_kernel(spec):
    """B4's plain version against the JAX Pallas kernel (interpret mode)
    on the same x_pad and kappa: the decode shape S = 4 and a ragged
    S = 37, one and two channel blocks on the JAX side."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(7)
    for s_out, c, bc in ((4, 10, 128), (37, 256, 128)):
        taps = rng.integers(-8, 8, (c, 4))
        jk, _ = jops.prepare_bseg_taps(jnp.asarray(taps), jplan)
        tk, _ = tops.prepare_bseg_taps(torch.tensor(taps), tplan)
        x_pad = _x_pad(rng, tplan, 2, s_out, c, tk.shape[-2])
        jy = j_bseg_conv1d(jnp.asarray(x_pad, jnp.int8), jk, plan=jplan,
                           s_out=s_out, bc=bc, interpret=True)
        xt = torch.tensor(x_pad, dtype=torch.int8)
        ty = tconv1d.bseg_conv1d_plain(xt, tk, tplan, s_out=s_out)
        assert _same(jy, ty), (s_out, c)
        # the wrapper takes the plain version on CPU tensors
        assert torch.equal(tconv1d.bseg_conv1d(xt, tk, plan=tplan,
                                               s_out=s_out), ty)


@pytest.mark.parametrize("spec", SPECS)
def test_ops_bseg_conv1d_and_depthwise_conv2d(spec):
    """ops.bseg_conv1d, causal and 'same', with and without a zero point,
    against the JAX package's (Pallas kernel in interpret mode) and the
    exact conv; the depthwise route of packed_conv2d likewise."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(13)
    c, n, b, s = 6, 4, 2, 15
    taps = rng.integers(-8, 8, (c, n))
    jk, js = jops.prepare_bseg_taps(jnp.asarray(taps), jplan)
    tk, ts = tops.prepare_bseg_taps(torch.tensor(taps), tplan)
    xq = rng.integers(-8, 8, (b, s, c))
    for padding, zp in itertools.product(("causal", "same"), (0, 8)):
        x = xq if zp else xq + 8
        left = n - 1 if padding == "causal" else (n - 1) // 2
        jy = jops.bseg_conv1d(jnp.asarray(x, jnp.int8), jk, js, plan=jplan,
                              n_taps=n, zero_point=zp, padding=padding)
        ty = tops.bseg_conv1d(torch.tensor(x), tk, ts, plan=tplan,
                              n_taps=n, zero_point=zp, padding=padding)
        assert _same(jy, ty), (padding, zp)
        assert _same(jref.conv1d_ref(jnp.asarray(x), jnp.asarray(taps),
                                     left), ty)
        assert torch.equal(tref.conv1d_ref(torch.tensor(x),
                                           torch.tensor(taps), left), ty)
    assert torch.equal(
        tref.conv1d_causal_ref(torch.tensor(xq), torch.tensor(taps)),
        tref.conv1d_ref(torch.tensor(xq), torch.tensor(taps), n - 1))
    for f in (lambda: jops.bseg_conv1d(jnp.asarray(xq, jnp.int8), jk, js,
                                       plan=jplan, n_taps=n,
                                       padding="full"),
              lambda: tops.bseg_conv1d(torch.tensor(xq), tk, ts, plan=tplan,
                                       n_taps=n, padding="full")):
        with pytest.raises(ValueError):
            f()
    # depthwise conv2d: C_in == 1, kh == 1, 'same' pad along W
    wt = np.zeros((c, 1, 1, 3), np.int64)
    wt[:, 0, 0, :] = rng.integers(-8, 8, (c, 3))
    for x, zp in ((rng.integers(0, 16, (2, 3, 17, c)), 0),
                  (rng.integers(-8, 8, (1, 2, 9, c)), 8)):
        want = jref.conv2d_int_ref(jnp.asarray(x), jnp.asarray(wt))
        for mode in ("auto", "bseg_conv1d"):
            jy = jops.packed_conv2d(jnp.asarray(x), jnp.asarray(wt),
                                    plan=jplan, mode=mode, zero_point=zp)
            ty = tops.packed_conv2d(torch.tensor(x), torch.tensor(wt),
                                    plan=tplan, mode=mode, zero_point=zp)
            assert _same(jy, ty) and _same(want, ty), (mode, zp)


#: a hand-built INT32 plan whose biased word overruns the accumulator
_OVERRUN = dict(spec="int32", w_k=4, w_i=4, lane=12, n_k=2, n_i=2, w_l=0)


def test_select_conv1d_route_table():
    """The causal conv1d route with its reason strings, word for word,
    on the four W4A4 plans, a w_i = 8 plan and an overrunning one."""
    plans = [_plans(s) for s in SPECS] + [_plans("dsp58", 4, 8)]
    plans.append(tuple(mod.BSEGPlan(**dict(_OVERRUN,
                                           spec=mod.DATAPATHS["int32"]))
                       for mod in (jdp, tdp)))
    routes = set()
    for (jplan, tplan), use_kernel in itertools.product(plans,
                                                        (True, False)):
        kw = dict(use_kernel=use_kernel, explain=True)
        want = _outcome(lambda: jops.select_conv1d_route(jplan, **kw))
        assert _outcome(lambda: tops.select_conv1d_route(tplan, **kw)) \
            == want, (tplan, use_kernel)
        assert tops.select_conv1d_route(tplan, use_kernel=use_kernel) \
            == want[0][0]
        routes.add(want[0][0])
    assert routes == {"bseg_conv1d", "ref"}


# ---------------------------------------------------------------------------
# BSEGConv: packing and the packed short conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_pack_conv_bseg_stacked_and_unstacked(spec):
    """A stacked [L, C, taps] conv keeps the JAX package's [L, G, C] /
    [L, 2, G, C] layout, and its per-layer slice is the per-layer
    container, contiguous."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(17)
    wf, wt = _bf16(rng, (3, 20, 4), 0.5)
    bf, bt = _bf16(rng, (3, 20), 0.1)
    jw = {"w": jnp.asarray(wf).astype(jnp.bfloat16),
          "b": jnp.asarray(bf).astype(jnp.bfloat16)}
    jc = jquant.pack_conv_bseg(jw, jplan)
    tc = tm.pack_conv_bseg({"w": wt, "b": bt}, tplan)
    assert tc.stacked and tc.taps == jc.taps == 4
    for name in ("kappa", "tap_sum", "scale", "bias"):
        assert _same(getattr(jc, name), getattr(tc, name)), name
    for i in range(3):
        one = tm.pack_conv_bseg({"w": wt[i], "b": bt[i]}, tplan)
        sl = tc.layer(i)
        assert not one.stacked and sl.kappa.is_contiguous()
        for name in ("kappa", "tap_sum", "scale", "bias"):
            assert torch.equal(getattr(sl, name), getattr(one, name)), name


@pytest.mark.parametrize("spec", ["int32", "dsp48e2"])
def test_bseg_conv_apply_outputs_and_state(spec):
    """The packed short conv (one global min/max over history and new
    samples) against the JAX package's: a decode step with history and a
    5-sample call without; outputs to one bf16 rounding, new_state
    exact.  The float conv of an unpacked container likewise."""
    jplan, tplan = _plans(spec)
    rng = np.random.default_rng(19)
    wf, wt = _bf16(rng, (24, 4), 0.5)
    bf, bt = _bf16(rng, (24,), 0.1)
    jw = {"w": jnp.asarray(wf).astype(jnp.bfloat16),
          "b": jnp.asarray(bf).astype(jnp.bfloat16)}
    tw = {"w": wt, "b": bt}
    jc = jquant.pack_conv_bseg(jw, jplan)
    tc = tm.pack_conv_bseg(tw, tplan)
    for s, with_state in ((1, True), (5, False)):
        xf, xt = _bf16(rng, (2, s, 24))
        sf, st = _bf16(rng, (2, 3, 24))
        jstate = jnp.asarray(sf).astype(jnp.bfloat16) if with_state else None
        tstate = st if with_state else None
        jx = jnp.asarray(xf).astype(jnp.bfloat16)
        for jparams, tparams in ((jc, tc), (jw, tw)):
            jy, jn = jssm.short_conv_apply(jparams, jx, state=jstate)
            ty, tn = tssm.short_conv_apply(tparams, xt, state=tstate)
            assert ty.dtype == torch.bfloat16 and tn.dtype == torch.bfloat16
            jy = np.asarray(jy.astype(jnp.float32))
            np.testing.assert_allclose(ty.float().numpy(), jy, rtol=0,
                                       atol=LOGIT_RTOL * np.abs(jy).max())
            assert (np.asarray(jn.astype(jnp.float32))
                    == tn.float().numpy()).all()


# ---------------------------------------------------------------------------
# reduced mamba2-130m and recurrentgemma-2b
# ---------------------------------------------------------------------------

def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    cfg = get_arch(request.param).reduced()
    tcfg = t_get_arch(request.param).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    rules = Rules(tp=None, fsdp=None, ep=None, batch=())
    params = values(init_params(cfg, rules, jax.random.PRNGKey(0)))
    jq = serve_params(params, bits=4, min_size=1024, compute="sdv")
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    tq = tm.serve_params(tp, bits=4, min_size=1024, compute="sdv")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (STEPS, B, 1))
    return dict(cfg=cfg, tcfg=tcfg, rules=rules, params=params, tp=tp,
                jq=jq, tq=tq, tokens=tokens)


def _jax_run(s, cfg, jit):
    cache = values(init_cache(cfg, s["rules"], B, S_MAX))
    dec = (lambda p, c, t: decode_step(cfg, p, c, t))
    dec = jax.jit(dec) if jit else dec
    logits = []
    for t in s["tokens"]:
        out, cache = dec(s["jq"], cache, jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(out))
    return np.stack(logits), {k: np.asarray(v.astype(jnp.float32)
                                            if v.dtype == jnp.bfloat16
                                            else v)
                              for k, v in cache.items()}


def _port_run(s):
    tcfg = s["tcfg"]
    cache = tm.init_cache(tcfg, B, S_MAX, device="cpu")
    logits = []
    for t in s["tokens"]:
        out, cache = tm.decode_step(tcfg, s["tq"], cache,
                                    torch.tensor(t, dtype=torch.int32))
        assert out.dtype == torch.float32
        logits.append(out.numpy())
    return np.stack(logits), {
        k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        for k, v in cache.items()}


@pytest.fixture(scope="module")
def runs(setup):
    # scan_layers=False unrolls the layer loop in Python: the JAX package
    # then runs op by op (no enclosing jit), as the port does
    unrolled = dataclasses.replace(setup["cfg"], scan_layers=False)
    return {"jax": _jax_run(setup, setup["cfg"], jit=True),
            "jax_op_by_op": _jax_run(setup, unrolled, jit=False),
            "port": _port_run(setup)}


def test_serve_params_containers(setup):
    """The same leaves become SDVLinear and BSEGConv on both sides, with
    identical words, kappas, tap sums and scales; conv_bseg=False keeps
    the float conv dict."""
    jl, tl = dict(_leaves(setup["jq"])), dict(_leaves(setup["tq"]))
    assert jl.keys() == tl.keys()
    sdv = [k for k, v in jl.items() if isinstance(v, SDVLinear)]
    convs = [k for k, v in jl.items() if isinstance(v, BSEGConv)]
    assert sdv and convs
    for k in sdv:
        assert isinstance(tl[k], tm.SDVLinear), k
        assert _same(jl[k].words, tl[k].words), k
        assert _same(jl[k].scale, tl[k].scale), k
    for k in convs:
        assert isinstance(tl[k], tm.BSEGConv) and tl[k].stacked, k
        assert jl[k].plan == jquant.default_bseg_plan(4)
        for name in ("kappa", "tap_sum", "scale", "bias"):
            assert _same(getattr(jl[k], name), getattr(tl[k], name)), \
                (k, name)
    n_layers = {"mamba2-130m-smoke": 2, "recurrentgemma-2b-smoke": 4}
    assert tquant.count_packed(setup["tq"])["bseg"] == \
        n_layers[setup["cfg"].name]
    floats = tm.serve_params(setup["tp"], bits=4, min_size=1024,
                             compute="sdv", conv_bseg=False)
    jfloats = serve_params(setup["params"], bits=4, min_size=1024,
                           compute="sdv", conv_bseg=False)
    fl = dict(_leaves(floats))
    assert fl.keys() == dict(_leaves(jfloats)).keys()
    assert tquant.count_packed(floats)["bseg"] == 0
    assert all(not isinstance(v, tm.BSEGConv) for v in fl.values())


def test_decode_matches_op_by_op_reference(runs, setup):
    """20 teacher-forced decode steps against the JAX package run op by
    op: every step's logits to one bf16 rounding, the bf16 caches (conv
    histories, KV ring) bit for bit and the float32 states within
    float32 rounding; the hybrid's ring has wrapped."""
    (jl, jc), (tl, tc) = runs["jax_op_by_op"], runs["port"]
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    for step in range(STEPS):
        np.testing.assert_allclose(
            tl[step], jl[step], rtol=0,
            atol=LOGIT_RTOL * np.abs(jl[step]).max(), err_msg=f"step {step}")
    assert jc.keys() == tc.keys()
    for k in jc:
        if k in ("ssm", "g_rnn0", "g_rnn1", "t_rnn0"):
            np.testing.assert_allclose(tc[k], jc[k], rtol=0,
                                       atol=STATE_ATOL, err_msg=k)
        else:
            assert (tc[k] == jc[k]).all(), k
    assert (tc["index"] == STEPS).all()
    if setup["cfg"].family == "hybrid":
        assert tc["k"].shape[2] == setup["cfg"].window < STEPS


def test_decode_against_jitted_reference(runs):
    """The JAX package as it runs (decode_step under jit) moves bf16
    roundings (XLA fusion), and the W4A4 short-conv quantizer — one
    scale for the whole tensor, 15 levels — turns a moved rounding into
    a whole quantization step; so the port is held to the reference's
    own spread: per step, no farther from the jitted reference than the
    op-by-op reference is, plus one bf16 rounding."""
    jit, op, port = (runs[k][0] for k in ("jax", "jax_op_by_op", "port"))
    assert np.isfinite(jit).all()
    for step in range(STEPS):
        spread = np.abs(op[step] - jit[step]).max()
        slack = LOGIT_RTOL * np.abs(jit[step]).max()
        assert np.abs(port[step] - jit[step]).max() <= spread + slack, step


def test_greedy_tokens_where_margin_exceeds_tolerance(runs, setup):
    """Random-init logits are near-tied (DESIGN.md §5.2), so the greedy
    token is compared where the op-by-op reference's top-2 margin
    exceeds twice the logit tolerance."""
    vocab = setup["cfg"].vocab
    a = runs["jax_op_by_op"][0][:, :, 0, :vocab]
    b = runs["port"][0][:, :, 0, :vocab]
    top2 = np.sort(a, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * LOGIT_RTOL * np.abs(a).max()
    assert sure.sum() > 0
    assert (a.argmax(-1)[sure] == b.argmax(-1)[sure]).all()


def test_recurrent_families_refuse_prefill_and_advance(setup):
    """As in the JAX package: prompts are replayed one token per
    decode_step, so prefill_step and the advance mask raise; the
    full-sequence path (``ssm_apply(decode=False)``, the chunked SSD scan)
    runs, and equals the decode recurrence step by step (float32)."""
    tcfg, tq = setup["tcfg"], setup["tq"]
    cache = tm.init_cache(tcfg, B, S_MAX, device="cpu")
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported family"):
        tm.prefill_step(tcfg, tq, cache, tokens,
                        torch.ones(B, dtype=torch.int32))
    with pytest.raises(ValueError, match="advance mask"):
        tm.decode_step(tcfg, tq, cache, tokens,
                       advance=torch.ones(B, dtype=torch.int32))
    scfg = tssm.SSMConfig(d_model=8, d_inner=16, n_heads=2, d_state=4)
    gen = torch.Generator().manual_seed(0)
    p = tssm.ssm_init(tm.layers.Init(gen, torch.device("cpu"),
                                     torch.float32), scfg)
    x = torch.randn((1, 4, 8), generator=gen)
    y, (_, h) = tssm.ssm_apply(p, scfg, x, decode=False)
    conv = h1 = None
    for t in range(4):
        y1, (conv, h1) = tssm.ssm_apply(p, scfg, x[:, t:t + 1],
                                        conv_state=conv, ssm_state=h1,
                                        decode=True)
        assert torch.allclose(y[:, t:t + 1], y1, rtol=0, atol=1e-5)
    assert torch.allclose(h, h1, rtol=0, atol=1e-5)


def test_serve_cli_recurrent_on_cpu(capsys):
    """The serve CLI runs reduced mamba2 on the CPU with the short convs
    on the BSEG datapath, and with them in float."""
    args = ["--arch", "mamba2-130m", "--device", "cpu", "--batch", "2",
            "--prompt-len", "3", "--new-tokens", "3"]
    assert tserve.main(args) == 0
    out = capsys.readouterr().out
    assert "2 BSEG-packed W4A4 short convs" in out
    assert "recurrent-state cache (no KV)" in out and "tok/s" in out
    assert tserve.main(args + ["--conv-datapath", "float"]) == 0
    assert "BSEG-packed" not in capsys.readouterr().out
