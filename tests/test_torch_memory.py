"""Parity of the torch port's memory-side packing with the JAX package:
the lane pack/unpack (kernels B6/B7's plain versions), the quantized
matmul (kernel B5's plain version) and the memory-packed route of
``packed_matmul``, ``PackedLinear`` packing and materializing, and
memory-mode serving of reduced tinyllama-1.1b, mamba2-130m and
recurrentgemma-2b.

Same inputs (numpy, from seeds) go through both packages; the JAX
Pallas kernels run in interpret mode as the JAX package's own tests run
them.  Lane words, scales and materialized bf16 weights must be equal
bit for bit; the quantized matmul sums float32 products, in another
order than XLA, so it is held to ``tests/test_kernels.py``'s tolerance.
The decode is held against the JAX package run op by op (layer loop
unrolled, no enclosing jit), the port's execution model, and against
the JAX package as it runs (``jit``).  On the CPU the port's kernels run
their plain versions; the CUDA kernels themselves are held against them
in ``test_torch_kernels_cuda``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import (PackedLinear, Rules, decode_step, init_cache,
                          init_params, prefill_step, serve_params, values)
from repro.models import quantized as jquant

import repro_torch.models as tm
from repro_torch.configs.registry import get_arch as t_get_arch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packbits as tpack
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import quantized as tquant

#: tests/test_kernels.py::test_quant_matmul's tolerance: both sides sum
#: float32 products, in different orders
QMM_RTOL, QMM_ATOL = 1e-5, 1e-4
#: against the JAX package run op by op the projections are the same
#: bf16 products of the same bf16 weights, so the logits may differ by
#: one bf16 rounding of their scale (the f32 accumulation order inside
#: torch's and XLA's bf16 GEMMs differs) and the float32 states by
#: float32 rounding — tests/test_torch_recurrent.py's tolerances
LOGIT_RTOL = 2.0 ** -7
STATE_ATOL = 1e-5
#: against the JAX package as it runs (lax.scan under XLA, which fuses
#: and moves bf16 roundings) — tests/test_torch_model.py's tolerance
LOGIT_ATOL = 0.05
WIDTHS = (2, 3, 4, 8)


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(j, t) -> bool:
    """Bit-identical arrays (bf16 compared by bit pattern)."""
    a, b = np.asarray(j), _np(t)
    if a.dtype.name == "bfloat16":
        a, b = a.view(np.int16), b.view(np.int16)
    return a.shape == b.shape and a.dtype == b.dtype and (a == b).all()


def _launches():
    return (tpack.pack_words.launches, tpack.unpack_words.launches,
            tqmm.quant_matmul.launches)


# ---------------------------------------------------------------------------
# B6 / B7: lane pack and unpack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("shape", [(8, 64), (16, 256), (3, 64)])
def test_pack_unpack_words(w, shape):
    """B6/B7's plain versions against the Pallas kernels and the
    reference's oracles, bit for bit, and the round trip.  For w = 3 (10
    fields per word) the column count is cut to a multiple of 10."""
    per = 32 // w
    m, n = shape[0], shape[1] // per * per
    rng = np.random.default_rng(w * 1000 + n + m)
    vals = rng.integers(-(1 << w - 1), 1 << w - 1, (m, n)).astype(np.int8)
    jk = np.asarray(jops.pack_weights(jnp.asarray(vals), w=w,
                                      use_kernel=True))
    jr = np.asarray(jref.pack_words_ref(jnp.asarray(vals), w=w))
    tw = tops.pack_weights(torch.tensor(vals), w=w)
    assert tw.dtype == torch.int32 and tw.shape == (m, n // per)
    assert (jk == tw.numpy()).all() and (jr == tw.numpy()).all()
    assert (tref.pack_words_ref(torch.tensor(vals), w=w) == tw).all()
    ju = np.asarray(jops.unpack_weights(jnp.asarray(jk), w=w,
                                        use_kernel=True))
    tu = tops.unpack_weights(tw, w=w)
    assert tu.dtype == torch.int8
    assert (ju == tu.numpy()).all() and (tu.numpy() == vals).all()


def test_pack_masks_fields_and_wraps_into_the_sign_bit():
    """Values outside w bits keep their w low bits, as in the reference;
    for w = 8 the fourth field fills the sign bit (negative words)."""
    vals = np.random.default_rng(3).integers(-128, 128, (4, 32)) \
        .astype(np.int8)
    for w in WIDTHS:
        n = 32 // (32 // w) * (32 // w)
        jw = np.asarray(jref.pack_words_ref(jnp.asarray(vals[:, :n]), w=w))
        tw = tops.pack_weights(torch.tensor(vals[:, :n]), w=w)
        assert (jw == tw.numpy()).all(), w
    w8 = tops.pack_weights(torch.tensor(vals), w=8)
    assert (w8 < 0).any()
    assert (tops.unpack_weights(w8, w=8).numpy() == vals).all()


def test_packbits_refusals():
    with pytest.raises(ValueError, match="multiple"):
        tpack.pack_words(torch.zeros((2, 12), dtype=torch.int8), w=3)
    with pytest.raises(ValueError, match="2..8"):
        tpack.unpack_words(torch.zeros((2, 2), dtype=torch.int32), w=9)
    with pytest.raises(ValueError, match="int32"):
        tpack.unpack_words(torch.zeros((2, 2), dtype=torch.int64), w=4)


# ---------------------------------------------------------------------------
# B5: quantized matmul and the memory-packed route of packed_matmul
# ---------------------------------------------------------------------------

def _qmm_operands(w, m, n, k, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wint = rng.integers(-(1 << w - 1), (1 << w - 1) - 1, size=(k, n))
    scale = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, wint, scale


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("mnk", [(8, 64, 128), (16, 128, 64), (4, 32, 256)])
def test_quant_matmul(w, mnk):
    """B5's plain version and ``packed_matmul(plan=None)`` against the
    Pallas kernel (tests/test_kernels.py's blocks) and the oracle."""
    m, n, k = mnk
    x, wint, scale = _qmm_operands(w, m, n, k)
    wp = jref.pack_words_ref(jnp.asarray(wint), w=w)
    jy = np.asarray(jops.quant_matmul(
        jnp.asarray(x), wp, jnp.asarray(scale), w=w, use_kernel=True,
        block_m=8, block_n=32, block_k=32))
    yr = np.asarray(jref.quant_matmul_ref(jnp.asarray(x), jnp.asarray(wint),
                                          jnp.asarray(scale)))
    tw = torch.tensor(np.asarray(wp))
    ty = tops.quant_matmul(torch.tensor(x), tw, torch.tensor(scale), w=w)
    assert ty.dtype == torch.float32 and ty.shape == (m, n)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=QMM_RTOL, atol=QMM_ATOL)
    np.testing.assert_allclose(ty.numpy(), yr, rtol=QMM_RTOL, atol=QMM_ATOL)
    tp = tops.packed_matmul(torch.tensor(x), tw, scale=torch.tensor(scale),
                            w_bits=w)
    assert torch.equal(tp, ty)


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("mnk", [(8, 256, 2048), (16, 64, 5632)])
def test_quant_matmul_rounding_check(w, mnk):
    """B5's plain version lies within ``ROUNDING_LIMIT`` rounding scales of
    the float64 product; x rounded to TF32's 10 mantissa bits, or to
    bf16, lies outside at the same K (the check sees lower precision)."""
    m, n, k = mnk
    x, wint, scale = _qmm_operands(w, m, n, k, seed=3)
    tx, ts = torch.tensor(x), torch.tensor(scale)
    tw = torch.tensor(wint, dtype=torch.int8)
    exact = (tx.double() @ tw.double()) * ts.double()
    limit = tqmm.ROUNDING_LIMIT * tqmm.rounding_scale(tx, tw, ts)
    y = tqmm.quant_matmul(tx, tpack.pack_words(tw, w=w), ts, w=w)
    assert ((y.double() - exact).abs() <= limit).all()
    bits = tx.view(torch.int32)
    x_tf32 = ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(
        torch.float32)
    for low in (x_tf32, tx.bfloat16().float()):
        got = (low.double() @ tw.double()) * ts.double()
        assert not ((got - exact).abs() <= limit).all()


def test_packed_matmul_memory_route_batch_dims_and_trim():
    """Batch dims restored, ``m`` trims the padded columns, bf16
    activations widen to float32; the ref route agrees."""
    w, n, k = 4, 40, 96
    x, wint, scale = _qmm_operands(w, 6, n, k, seed=11)
    x3 = x.reshape(2, 3, k)
    xb = jnp.asarray(x3).astype(jnp.bfloat16)
    wp = jref.pack_words_ref(jnp.asarray(wint), w=w)
    tw = torch.tensor(np.asarray(wp))
    for mode in ("auto", "quant_matmul", "ref"):
        jy = np.asarray(jops.packed_matmul(
            xb, wp, scale=jnp.asarray(scale), w_bits=w, m=37, mode=mode))
        ty = tops.packed_matmul(
            torch.tensor(np.asarray(xb.astype(jnp.float32))).to(
                torch.bfloat16), tw, scale=torch.tensor(scale), w_bits=w,
            m=37, mode=mode)
        assert ty.shape == (2, 3, 37) and ty.dtype == torch.float32, mode
        np.testing.assert_allclose(ty.numpy(), jy, rtol=QMM_RTOL,
                                   atol=QMM_ATOL, err_msg=mode)


def test_memory_route_table_and_refusals():
    """``plan=None`` routes and reasons are the reference's; no scale or
    w_bits, or an SDV plan on the quant_matmul row, raises as there."""
    for rows in (1, 8, 9, 256):
        for use_kernel in (True, False):
            assert tops.select_packed_route(
                rows, use_kernel=use_kernel, explain=True) == \
                jops.select_packed_route(rows, use_kernel=use_kernel,
                                         explain=True)
    assert tops.select_packed_route(8, explain=True) == (
        "quant_matmul", "no SDV plan: memory-packed lane words")
    words = torch.zeros((8, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs scale and w_bits"):
        tops.packed_matmul(torch.ones(2, 8), words)
    with pytest.raises(ValueError, match="needs scale and w_bits"):
        tops.packed_matmul(torch.ones(2, 8), words, scale=torch.ones(8))
    plan = tquant.default_sdv_plan(4, 8)
    with pytest.raises(ValueError, match="not an SDV plan"):
        tops.packed_matmul(torch.ones(2, 8, dtype=torch.int32), words,
                           plan=plan, mode="quant_matmul")
    with pytest.raises(ValueError, match="float32"):
        tqmm.quant_matmul(torch.ones(2, 8), words, torch.ones(4), w=4)


# ---------------------------------------------------------------------------
# PackedLinear: pack_linear and materialize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("shape", [(64, 96), (3, 64, 96), (48, 37)])
def test_pack_linear_and_materialize(bits, shape):
    """Words and scales bit-identical to the reference's (2-D, stacked,
    and a d_out that is not a multiple of 32/bits), and the materialized
    bf16 kernel too; the whole stack packs and unpacks in one call."""
    rng = np.random.default_rng(bits + len(shape))
    kernel = (rng.standard_normal(shape) * 0.05).astype(ml_dtypes.bfloat16)
    jp = jquant.pack_linear(jnp.asarray(kernel), bits)
    tk = tm.params_from_numpy({"k": kernel}, device="cpu")["k"]
    before = tpack.pack_words_plain.calls
    tp = tm.pack_linear(tk, bits)
    assert tpack.pack_words_plain.calls == before + 1
    assert (tp.bits, tp.d_out) == (jp.bits, jp.d_out)
    assert _same(jp.words, tp.words) and _same(jp.scale, tp.scale)
    assert tp.stacked == (len(shape) == 3)
    before = tpack.unpack_words_plain.calls
    dense = tm.materialize(tp)
    assert tpack.unpack_words_plain.calls == before + 1
    assert dense.shape == shape and dense.dtype == torch.bfloat16
    assert _same(jquant.materialize(jp), dense)
    assert _same(jquant.materialize(jp, jnp.float32),
                 tm.materialize(tp, torch.float32))
    if tp.stacked:
        assert torch.equal(tm.materialize(tp.layer(1)), dense[1])


# ---------------------------------------------------------------------------
# serve_params(compute="memory") and memory-mode decoding
# ---------------------------------------------------------------------------

ARCHS = ("tinyllama-1.1b", "mamba2-130m", "recurrentgemma-2b")
RULES = Rules(tp=None, fsdp=None, ep=None, batch=())
#: tinyllama: the prompt chunk, valid columns and advance masks of
#: tests/test_torch_model.py; the recurrent models: 20 decode steps, past
#: the reduced hybrid's 16-entry attention window
B, C, N_VALID = 3, 5, np.array([5, 3, 0])
DENSE_STEPS, DENSE_S_MAX = 6, 16
ADVANCE = [np.array([1, 1, s % 2]) for s in range(DENSE_STEPS)]
REC_STEPS = 20


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
    params = values(init_params(cfg, RULES, jax.random.PRNGKey(0)))
    jq = serve_params(params, bits=4, min_size=1024, compute="memory")
    tp = tm.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    tq = tm.serve_params(tp, bits=4, min_size=1024, compute="memory")
    rng = np.random.default_rng(1)
    if cfg.family == "dense":
        prompt = rng.integers(0, cfg.vocab, (B, C))
        tokens = rng.integers(0, cfg.vocab, (DENSE_STEPS, B, 1))
    else:
        prompt, tokens = None, rng.integers(0, cfg.vocab, (REC_STEPS, B, 1))
    return dict(cfg=cfg, tcfg=tcfg, jq=jq, tq=tq, prompt=prompt,
                tokens=tokens)


def _jax_run(s, cfg, jit):
    dense = cfg.family == "dense"
    cache = values(init_cache(cfg, RULES, B,
                              DENSE_S_MAX if dense else REC_STEPS))
    if dense:
        cache = prefill_step(cfg, s["jq"], cache,
                             jnp.asarray(s["prompt"], jnp.int32),
                             jnp.asarray(N_VALID, jnp.int32))

    def dec(p, c, t, adv):
        return decode_step(cfg, p, c, t, advance=adv) if dense \
            else decode_step(cfg, p, c, t)
    dec = jax.jit(dec) if jit else dec
    logits = []
    for i, t in enumerate(s["tokens"]):
        adv = jnp.asarray(ADVANCE[i], jnp.int32) if dense else None
        out, cache = dec(s["jq"], cache, jnp.asarray(t, jnp.int32), adv)
        logits.append(np.asarray(out))
    return np.stack(logits), {k: np.asarray(v.astype(jnp.float32)
                                            if v.dtype == jnp.bfloat16
                                            else v)
                              for k, v in cache.items()}


def _port_run(s, tq):
    tcfg = s["tcfg"]
    dense = tcfg.family == "dense"
    cache = tm.init_cache(tcfg, B, DENSE_S_MAX if dense else REC_STEPS,
                          device="cpu")
    if dense:
        cache = tm.prefill_step(tcfg, tq, cache,
                                torch.tensor(s["prompt"], dtype=torch.int32),
                                torch.tensor(N_VALID, dtype=torch.int32))
    logits = []
    for i, t in enumerate(s["tokens"]):
        kw = dict(advance=torch.tensor(ADVANCE[i], dtype=torch.int32)) \
            if dense else {}
        out, cache = tm.decode_step(tcfg, tq, cache,
                                    torch.tensor(t, dtype=torch.int32), **kw)
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
            "port": _port_run(setup, setup["tq"])}


def test_serve_params_memory_containers(setup):
    """The same leaves become PackedLinear on both sides, with the same
    bits, d_out, words and scales; the short convs stay float (conv_bseg
    follows compute), and the per-layer count is one B7 call each."""
    jl, tl = dict(_leaves(setup["jq"])), dict(_leaves(setup["tq"]))
    assert jl.keys() == tl.keys()
    packed = [k for k, v in jl.items() if isinstance(v, PackedLinear)]
    assert packed and all(isinstance(tl[k], tm.PackedLinear)
                          for k in packed)
    assert not any(isinstance(v, (tm.SDVLinear, tm.BSEGConv))
                   for v in tl.values())
    for k in packed:
        assert (tl[k].bits, tl[k].d_out) == (jl[k].bits, jl[k].d_out), k
        assert _same(jl[k].words, tl[k].words), k
        assert _same(jl[k].scale, tl[k].scale), k
    counts = tquant.count_packed(setup["tq"])
    cfg = setup["cfg"]
    want = {"tinyllama-1.1b-smoke": 7 * cfg.n_layers + 1}.get(cfg.name)
    assert counts["sdv"] == counts["bseg"] == 0
    assert counts["memory"] == (want or sum(
        tl[k].words.shape[0] if tl[k].stacked else 1 for k in packed))


def test_decode_matches_op_by_op_reference(runs, setup):
    """Against the JAX package run op by op: every step's logits to one
    bf16 rounding of their scale, the caches (int8 KV and scales; bf16
    conv histories and KV ring) bit for bit, float32 states within
    float32 rounding."""
    (jl, jc), (tl, tc) = runs["jax_op_by_op"], runs["port"]
    assert tl.shape == jl.shape and np.isfinite(tl).all()
    for step in range(len(jl)):
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
    if setup["cfg"].family == "hybrid":
        assert tc["k"].shape[2] == setup["cfg"].window < REC_STEPS


def test_decode_against_jitted_reference(runs, setup):
    """The JAX package as it runs (jit; XLA moves bf16 roundings):
    tinyllama within ``LOGIT_ATOL``; the recurrent models no farther
    than the op-by-op reference is from it, plus one bf16 rounding."""
    jit, op, port = (runs[k][0] for k in ("jax", "jax_op_by_op", "port"))
    assert np.isfinite(jit).all()
    for step in range(len(jit)):
        err = np.abs(port[step] - jit[step]).max()
        if setup["cfg"].family == "dense":
            assert err <= LOGIT_ATOL, step
        else:
            spread = np.abs(op[step] - jit[step]).max()
            assert err <= spread + LOGIT_RTOL * np.abs(jit[step]).max(), step


def test_reference_words_through_packed_from_numpy(runs, setup):
    """The reference's own packed tree, carried over by
    ``packed_from_numpy``, gives the port's run: the same words run."""
    carried = tm.packed_from_numpy(
        jax.tree_util.tree_map(np.asarray, setup["jq"]), device="cpu")
    assert tquant.count_packed(carried) == tquant.count_packed(setup["tq"])
    logits, cache = _port_run(setup, carried)
    want_logits, want_cache = runs["port"]
    assert (logits == want_logits).all()
    for k in want_cache:
        assert (cache[k] == want_cache[k]).all(), k


def test_sdv_mode_keeps_memory_packing_for_unstacked_banks():
    """Under compute="sdv" an unstacked 3-D kernel (an MoE expert bank)
    falls to PackedLinear, as in the reference, and counts as one
    container (it has no layer axis: its leading axis is the experts');
    a stacked one under ``blocks`` packs as SDVLinear, one per layer."""
    rng = np.random.default_rng(5)
    bank = (rng.standard_normal((4, 32, 48)) * 0.1).astype(np.float32)
    tree = {"moe": {"wi_gate": bank}, "blocks": {"mlp": {"wo": bank}}}
    jt = serve_params(jax.tree_util.tree_map(jnp.asarray, tree), bits=4,
                      min_size=1024, compute="sdv")
    tt = tm.serve_params(tm.params_from_numpy(tree, device="cpu"), bits=4,
                         min_size=1024, compute="sdv")
    assert isinstance(jt["moe"]["wi_gate"], PackedLinear)
    assert isinstance(tt["moe"]["wi_gate"], tm.PackedLinear)
    assert _same(jt["moe"]["wi_gate"].words, tt["moe"]["wi_gate"].words)
    assert isinstance(tt["blocks"]["mlp"]["wo"], tm.SDVLinear)
    assert not tt["moe"]["wi_gate"].stacked
    assert tquant.count_packed(tt) == {"memory": 1, "sdv": 4, "bseg": 0}


def test_serve_cli_memory_on_cpu(capsys):
    """The serve CLI decodes reduced tinyllama in memory mode on the CPU
    (the kernels' plain versions: no kernel launches) and prints the
    reference's banner."""
    before = _launches()
    plain = tpack.unpack_words_plain.calls
    args = ["--arch", "tinyllama-1.1b", "--device", "cpu", "--batch", "2",
            "--prompt-len", "3", "--new-tokens", "3", "--packed-compute",
            "memory"]
    assert tserve.main(args) == 0
    out = capsys.readouterr().out
    assert "packed W4 memory" in out and "int8 KV cache" in out
    assert "SDV" not in out and "tok/s" in out
    assert _launches() == before
    # 5 steps x (7 x 2 layers + the LM head)
    assert tpack.unpack_words_plain.calls - plain == 5 * 15
