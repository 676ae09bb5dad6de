"""The port's CUDA kernels (B1 GEMV, B2 GEMM, B3 BSEG conv2d, B4 BSEG
depthwise conv1d, B5 quantized matmul, B6/B7 lane pack/unpack and the
fused unpack-and-dequantize B7 runs as on the serving path) against
their plain torch version and the exact result (integer, or the float64
product within the float32 summation bound and within
``ROUNDING_LIMIT`` typical float32 roundings for B5).

Imports only the port, so it runs on a machine with a card and no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Without a card every test skips: a CUDA kernel has no CPU mode.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.datapath import DATAPATHS, plan_bseg, plan_sdv
from repro_torch.kernels import (bseg_common, bseg_conv1d, bseg_conv2d, build,
                                 ops, packbits, quant_matmul, ref, sdv_matmul,
                                 sdv_matvec)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _case(spec, wa, wb, signed_a, m, k, rows, seed, signed_b=True, n=None):
    kw = {} if n is None else dict(n=n)
    plan = plan_sdv(DATAPATHS[spec], wa, wb, signed_a=signed_a,
                    signed_b=signed_b, park_sign_bits=signed_a, **kw)
    rng = np.random.default_rng(seed)
    lo, hi = (-(1 << wa - 1), 1 << wa - 1) if signed_a else (0, 1 << wa)
    w = rng.integers(lo, hi, (m, k))
    lo, hi = (-(1 << wb - 1), 1 << wb - 1) if signed_b else (0, 1 << wb)
    x = rng.integers(lo, hi, (rows, k))
    words = ops.prepare_sdv_weights(torch.tensor(w), plan)
    return plan, w, x, words


def _lo32(a):
    """The low 32 bits of int64 values, as int32 (an int64 product that
    wraps keeps them)."""
    return (np.asarray(a, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)


def _check_both_kernels(cuda, plan, w, x, words):
    """B2 (and B1 up to 8 rows) on the card == the plain version on the
    CPU == the exact product (mod 2^32), bit for bit."""
    rows, m = x.shape[0], w.shape[0]
    xt = torch.tensor(x, dtype=torch.int32)
    want = sdv_matmul.sdv_matmul_plain(xt, words, plan)
    assert (want.reshape(rows, -1)[:, :m].numpy() == _lo32(x @ w.T)).all()
    got = sdv_matmul.sdv_matmul(xt.to(cuda), words.to(cuda), plan=plan)
    torch.cuda.synchronize()
    assert (got.cpu() == want).all()
    if rows <= 8:
        got = sdv_matvec.sdv_matvec(xt.T.contiguous().to(cuda),
                                    words.to(cuda), plan=plan)
        torch.cuda.synchronize()
        assert (got.cpu() == want).all()


#: (spec, w_a, w_b, signed_a, signed_b, n): the serve plans (W4A8 on the
#: INT32 and DSP48E2 words), W4A4 on DSP58, the im2col plans (4, 5),
#: unsigned activations at w_b = 8 (.u8 B), unsigned storage at w_a = 8
#: (.u8 A), both unsigned, n = 1, and the most lanes plan_sdv yields
#: (n = 10 on INT32 2x2 unsigned; n = 9 on DSP58 2x2)
_SDV_PLANS = [("int32", 4, 8, True, True, None),
              ("dsp48e2", 4, 8, True, True, None),
              ("dsp58", 4, 4, True, True, None),
              ("int32", 2, 2, True, True, None),
              ("int32", 4, 5, True, True, None),
              ("dsp48e2", 4, 5, True, True, None),
              ("dsp58", 4, 5, True, True, None),
              ("int32", 4, 8, True, False, None),
              ("dsp48e2", 4, 8, True, False, None),
              ("int32", 8, 8, False, True, None),
              ("dsp58", 8, 8, False, False, None),
              ("int32", 8, 8, True, True, 1),
              ("dsp48e2", 4, 8, True, True, 1),
              ("int32", 2, 2, False, True, None),
              ("dsp58", 2, 2, True, True, None)]


@pytest.mark.parametrize("spec,wa,wb,signed_a,signed_b,n", _SDV_PLANS)
@pytest.mark.parametrize("rows", [1, 3, 8, 9, 64, 77, 128])
def test_kernels_match_plain_and_exact(cuda, spec, wa, wb, signed_a,
                                       signed_b, n, rows):
    """(4, 5) is the im2col plan of the W4A4 BSEG plans: the 1x1 head.
    M = 301 is no multiple of 16 and K = 700 of 64."""
    _check_both_kernels(cuda, *_case(spec, wa, wb, signed_a, 301, 700,
                                     rows, rows, signed_b=signed_b, n=n))


#: operands wider than 8 bits, in byte slices: the nine plans of the
#: planner's w_b = a_bits + 1 and W4A16 on every exact-wrap word, the
#: widest w_a = w_b plan of each word (15, 23, 26), the widest w_a (30 on
#: INT32, 26 on DSP58), the planner's W16A16, and unsigned wide operands
_WIDE_SDV_PLANS = [(s, wa, wb, True, True, None)
                   for s in ("int32", "dsp48e2", "dsp58")
                   for wa, wb in ((4, 9), (8, 9), (4, 16))] + [
    ("int32", 15, 15, True, True, None), ("dsp48e2", 23, 23, True, True, None),
    ("dsp58", 26, 26, True, True, None), ("int32", 30, 1, True, True, None),
    ("dsp58", 26, 31, True, True, None), ("dsp48e2", 16, 16, True, True, None),
    ("dsp58", 12, 20, False, False, None), ("int32", 9, 3, False, True, None)]


@pytest.mark.parametrize("spec,wa,wb,signed_a,signed_b,n", _WIDE_SDV_PLANS)
@pytest.mark.parametrize("rows", [3, 8, 77])
def test_wide_operands_match_plain_and_exact(cuda, spec, wa, wb, signed_a,
                                             signed_b, n, rows):
    """B1/B2 on byte-sliced operands: bit-exact against the plain version
    and the exact product mod 2^32 (M = 45, K = 700)."""
    _check_both_kernels(cuda, *_case(spec, wa, wb, signed_a, 45, 700, rows,
                                     wa * 100 + wb + rows,
                                     signed_b=signed_b, n=n))


def test_wide_operands_through_packed_matmul(cuda):
    """``ops.packed_matmul(plan=...)`` routes a W8A9 plan to B1 (8 rows)
    and B2 (12 rows) on the card, launching each once."""
    plan, w, x, words = _case("dsp48e2", 8, 9, True, 64, 128, 12, 2)
    xd, wd = torch.tensor(x).to(cuda), words.to(cuda)
    b1, b2 = sdv_matvec.sdv_matvec.launches, sdv_matmul.sdv_matmul.launches
    y8 = ops.packed_matmul(xd[:8], wd, plan=plan, m=64)
    y12 = ops.packed_matmul(xd, wd, plan=plan, m=64)
    torch.cuda.synchronize()
    assert sdv_matvec.sdv_matvec.launches == b1 + 1
    assert sdv_matmul.sdv_matmul.launches == b2 + 1
    assert (y12.cpu().numpy() == x @ w.T).all()
    assert (y8.cpu().numpy() == x[:8] @ w.T).all()


@pytest.mark.parametrize("spec,wa,wb,signed_a,signed_b,n",
                         [_SDV_PLANS[i] for i in (0, 1, 7, 9, 11, 13)])
@pytest.mark.parametrize("k", [17, 33])
@pytest.mark.parametrize("rows,m", [(5, 45), (130, 77)])
def test_kernels_short_ragged_k(cuda, spec, wa, wb, signed_a, signed_b, n,
                                k, rows, m):
    """K below one 32-deep tensor-core step and between two; M no
    multiple of 16."""
    _check_both_kernels(cuda, *_case(spec, wa, wb, signed_a, m, k, rows,
                                     k + rows, signed_b=signed_b, n=n))


def test_kernels_at_the_im2col_head_shape(cuda):
    """B2 at the UltraNet head's im2col product: 5408 rows (8 x 26 x 26),
    K = 64, M = 36, on the head's plan (w_a = 4, w_b = 5, n = 3)."""
    from repro_torch.kernels.ops import _im2col_sdv_plan
    plan = _im2col_sdv_plan(plan_bseg(DATAPATHS["int32"], 4, 4))
    rng = np.random.default_rng(5408)
    w = rng.integers(-8, 8, (36, 64))
    x = rng.integers(0, 16, (5408, 64))
    words = ops.prepare_sdv_weights(torch.tensor(w), plan)
    _check_both_kernels(cuda, plan, w, x, words)


#: B2's wgmma kernel (``sdv_matmul.takes_wgmma``): every signedness of
#: lanes and activations, the UltraNet head's im2col plan (w_a = 4, w_b =
#: 5, n = 3), n = 1 (64 word columns a warpgroup, a 4-stage ring) and the
#: most lanes (n = 10 on INT32 2x2 unsigned)
_WGMMA_PLANS = [("int32", 4, 8, True, True, None),
                ("int32", 4, 8, True, False, None),
                ("int32", 8, 8, False, True, None),
                ("int32", 8, 8, False, False, None),
                ("int32", 4, 5, True, True, None),
                ("int32", 8, 8, True, True, 1),
                ("int32", 2, 2, False, True, None)]


@pytest.mark.parametrize("spec,wa,wb,signed_a,signed_b,n", _WGMMA_PLANS)
@pytest.mark.parametrize("rows", [sdv_matmul.WGMMA_MIN_ROWS, 4096, 5408,
                                  8192, 4096 + 77])
def test_wgmma_kernel_matches_plain_and_exact(cuda, spec, wa, wb, signed_a,
                                              signed_b, n, rows):
    """B2 at many rows on the wgmma kernel == its plain version (on the
    card: thousands of rows) == the exact product, bit for bit.  K = 700
    is no multiple of the 64-deep stage (nor of 16: the activations are
    padded), G = 296 columns no multiple of a block's; 4096 + 77 rows end
    in a partial row tile.  On the byte container both launch counters
    move by one; int32 activations take the mma.sync kernel, which
    agrees."""
    m = 8 * 37 * (n or plan_sdv(DATAPATHS[spec], wa, wb, signed_a=signed_a,
                                signed_b=signed_b,
                                park_sign_bits=signed_a).n)
    plan, w, x, words = _case(spec, wa, wb, signed_a, m, 700, rows,
                              rows + wa, signed_b=signed_b, n=n)
    assert sdv_matmul.takes_wgmma(rows, words.shape[-1], plan)
    xd = torch.tensor(x, dtype=torch.int32, device=cuda)
    x8 = xd.to(sdv_matmul.byte_dtype(plan))
    wd = words.to(cuda)
    b2, wg = sdv_matmul.sdv_matmul.launches, sdv_matmul.sdv_matmul.wgmma_launches
    got = sdv_matmul.sdv_matmul(x8, wd, plan=plan)
    torch.cuda.synchronize()
    assert sdv_matmul.sdv_matmul.launches == b2 + 1
    assert sdv_matmul.sdv_matmul.wgmma_launches == wg + 1
    assert torch.equal(got, sdv_matmul.sdv_matmul_plain(xd, wd, plan))
    exact = (xd.double() @ torch.tensor(w, device=cuda).double().T).long()
    assert torch.equal(got.reshape(rows, -1)[:, :m].long(), exact)
    assert torch.equal(sdv_matmul.sdv_matmul(xd, wd, plan=plan), got)
    assert sdv_matmul.sdv_matmul.launches == b2 + 2
    assert sdv_matmul.sdv_matmul.wgmma_launches == wg + 1


def test_wgmma_kernel_through_the_serving_path(cuda, monkeypatch):
    """``sdv_matmul_apply`` at a prefill chunk's 4096 rows on the serve
    plan quantizes straight to int8 and runs the wgmma kernel once; its
    output equals the same apply with B2 held below the crossover (the
    mma.sync kernel on int32 activations) bit for bit.  The Python mirror
    of the kernel's shared memory is the kernel's own."""
    from repro_torch.models import quantized
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    qw = quantized.pack_linear_sdv(
        torch.randn(512, 1024, generator=gen, device=cuda),
        quantized.default_sdv_plan(4, 8))
    x = torch.randn(8, 512, 512, generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    wg = sdv_matmul.sdv_matmul.wgmma_launches
    got = quantized.sdv_matmul_apply(qw, x)
    torch.cuda.synchronize()
    assert sdv_matmul.sdv_matmul.wgmma_launches == wg + 1
    monkeypatch.setattr(sdv_matmul, "WGMMA_MIN_ROWS", 1 << 30)
    want = quantized.sdv_matmul_apply(qw, x)
    torch.cuda.synchronize()
    assert sdv_matmul.sdv_matmul.wgmma_launches == wg + 1
    assert torch.equal(got, want)
    # the geometry's shared-memory mirror is the kernel's
    lib = build.library("sdv_wgmma")
    for n in (1, 2, 3, 10):
        geo = sdv_matmul.wgmma_geometry(4096, 4096, 7168, n, sms=132)
        assert lib.sdv_wgmma_smem_bytes(geo.bgw, geo.stages) \
            == sdv_matmul.wgmma_smem_bytes(geo.bgw, geo.stages)


def test_unsigned_elements_on_gemm(cuda):
    plan, w, x, words = _case("dsp48e2", 3, 5, False, 40, 333, 20, 0)
    got = sdv_matmul.sdv_matmul(torch.tensor(x, dtype=torch.int32).to(cuda),
                                words.to(cuda), plan=plan)
    torch.cuda.synchronize()
    assert (got.cpu().reshape(20, -1)[:, :40].numpy() == x @ w.T).all()


#: tinyllama-1.1b's projection shapes (K, M): q/o, k/v, gate/up, down
_TINYLLAMA_SHAPES = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]


@pytest.mark.parametrize("k,m", _TINYLLAMA_SHAPES)
@pytest.mark.parametrize("path,wb,rows", [("verify", 8, 32), ("draft", 4, 8)])
def test_speculative_path_shapes(cuda, k, m, path, wb, rows):
    """The speculative path's kernels at full width: B2 at the verify
    wave's 32 rows (8 slots x 4 columns) on the target's dsp48e2 W4A8
    n=3 plan, and B1 at 8 rows on the W4A4 draft's dsp48e2 n=4 plan,
    against the plain version (on the card) and the exact product."""
    plan, w, x, words = _case("dsp48e2", 4, wb, True, m, k, rows, k + m)
    assert plan.n == (3 if path == "verify" else 4)
    xd, wd = torch.tensor(x, dtype=torch.int32).to(cuda), words.to(cuda)
    if path == "verify":
        got = sdv_matmul.sdv_matmul(xd, wd, plan=plan)
    else:
        got = sdv_matvec.sdv_matvec(xd.T.contiguous(), wd, plan=plan)
    want = sdv_matmul.sdv_matmul_plain(xd, wd, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got.reshape(rows, -1)[:, :m].cpu().numpy() == x @ w.T).all()


def test_verify_wave_launches_only_b2_and_equals_decode(cuda):
    """Reduced tinyllama on the card: one ``verify_step`` over 4 columns
    of 8 slots is one B2 launch per projection and no plain call, and
    gives the logits and caches of 4 ``decode_step``s (8 rows: B1)."""
    import repro_torch.models as tm
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("tinyllama-1.1b").reduced()
    qp = tm.serve_params(tm.init_params(cfg, seed=0, device=cuda), bits=4,
                         min_size=1024, compute="sdv", act_bits=8,
                         plan_policy="auto", rows=8)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (8, 4)),
                        dtype=torch.int32, device=cuda)
    cache0 = tm.init_cache(cfg, 8, 16, device=cuda)
    b1, b2 = sdv_matvec.sdv_matvec.launches, sdv_matmul.sdv_matmul.launches
    plain = sdv_matmul.sdv_matmul_plain.calls
    vl, vc = tm.verify_step(cfg, qp, {k: v.clone() for k, v in
                                      cache0.items()}, toks,
                            torch.full((8,), 4, dtype=torch.int32,
                                       device=cuda))
    torch.cuda.synchronize()
    assert sdv_matmul.sdv_matmul.launches == b2 + 7 * cfg.n_layers
    assert sdv_matvec.sdv_matvec.launches == b1
    assert sdv_matmul.sdv_matmul_plain.calls == plain
    cache, logits = cache0, []
    for j in range(4):
        out, cache = tm.decode_step(cfg, qp, cache, toks[:, j:j + 1])
        logits.append(out)
    assert torch.equal(vl, torch.cat(logits, dim=1))
    assert all(torch.equal(vc[k], cache[k]) for k in cache)


def test_launch_counters_and_dispatch(cuda):
    plan, w, x, words = _case("int32", 4, 8, True, 64, 128, 12, 1)
    xd, wd = torch.tensor(x).to(cuda), words.to(cuda)
    b1, b2 = sdv_matvec.sdv_matvec.launches, sdv_matmul.sdv_matmul.launches
    plain = sdv_matmul.sdv_matmul_plain.calls
    y8 = ops.packed_matmul(xd[:8], wd, plan=plan, m=64)
    y12 = ops.packed_matmul(xd, wd, plan=plan, m=64)
    torch.cuda.synchronize()
    assert sdv_matvec.sdv_matvec.launches == b1 + 1
    assert sdv_matmul.sdv_matmul.launches == b2 + 1
    assert sdv_matmul.sdv_matmul_plain.calls == plain
    assert (y12.cpu().numpy() == x @ w.T).all()
    assert (y8.cpu().numpy() == x[:8] @ w.T).all()


def _conv_case(spec, wk, wi, c_in, c_out, k, h, w, b, seed):
    plan = plan_bseg(DATAPATHS[spec], wk, wi)
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.integers(0, 1 << wi, (b, h, w, c_in)))
    taps = torch.tensor(rng.integers(-(1 << wk - 1), 1 << wk - 1,
                                     (c_out, c_in, k, k)))
    return plan, x, taps


#: (spec, w_k, w_i): the four W4A4 plans of UltraNet, plans with more
#: lanes and other n_i, and taps wider than 8 bits (byte-sliced): W12A4 on
#: DSP58, W16A2 on INT32, W9A7 on DSP48E2, and the widest w_k that
#: plan_bseg admits on each word (test_torch_bseg_tc checks they are)
_B3_PLANS = [("int32", 4, 4), ("fp32m", 4, 4), ("dsp48e2", 4, 4),
             ("dsp58", 4, 4), ("int32", 2, 2), ("dsp48e2", 2, 2),
             ("fp32m", 3, 3), ("dsp58", 4, 7), ("dsp58", 12, 4),
             ("int32", 16, 2), ("dsp48e2", 9, 7), ("int32", 29, 1),
             ("fp32m", 21, 1), ("dsp48e2", 26, 1), ("dsp58", 26, 1)]


@pytest.mark.parametrize("spec,wk,wi", _B3_PLANS)
@pytest.mark.parametrize("c_in,c_out,k,h,w", [(3, 16, 3, 13, 40),
                                              (16, 37, 3, 9, 21),
                                              (64, 36, 1, 7, 26),
                                              (5, 8, 5, 6, 11)])
def test_bseg_conv2d_matches_plain_and_exact(cuda, spec, wk, wi, c_in, c_out,
                                             k, h, w):
    """B3 on the card against its plain version on the CPU, bit for bit,
    and ``packed_conv2d`` against the exact conv (C_out = 37: a ragged
    channel tile; 1x1 on every word)."""
    plan, x, taps = _conv_case(spec, wk, wi, c_in, c_out, k, h, w, 2, c_out)
    exact = ref.conv2d_int_ref(x, taps)
    x_pad, kappa, _ = ops.bseg_conv2d_operands(x, taps, plan)
    want = bseg_conv2d.bseg_conv2d_plain(x_pad, kappa, plan, h_out=h,
                                         w_out=w)
    assert (want == exact).all()
    launches = bseg_conv2d.bseg_conv2d.launches
    got = bseg_conv2d.bseg_conv2d(x_pad.to(cuda), kappa.to(cuda), plan=plan,
                                  h_out=h, w_out=w)
    torch.cuda.synchronize()
    assert bseg_conv2d.bseg_conv2d.launches == launches + 1
    assert got.dtype == torch.int32 and (got.cpu() == want).all()
    y = ops.packed_conv2d(x.to(cuda), taps.to(cuda), plan=plan,
                          mode="bseg_conv2d")
    torch.cuda.synchronize()
    assert (y.cpu() == exact).all()


@pytest.mark.parametrize("spec,wk,wi", [("int32", 4, 4), ("dsp58", 12, 4)])
def test_bseg_conv2d_is_deterministic(cuda, spec, wk, wi):
    """Two launches on the same operands give the same bits (every output
    is written once, by one block, without atomics)."""
    plan, x, taps = _conv_case(spec, wk, wi, 64, 64, 3, 26, 26, 8, 9)
    x_pad, kappa, _ = ops.bseg_conv2d_operands(x, taps, plan)
    xd, kd = x_pad.to(cuda), kappa.to(cuda)
    a = bseg_conv2d.bseg_conv2d(xd, kd, plan=plan, h_out=26, w_out=26)
    b = bseg_conv2d.bseg_conv2d(xd, kd, plan=plan, h_out=26, w_out=26)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(a.cpu(), ref.conv2d_int_ref(x, taps))


def test_bseg_conv2d_many_channel_chunks(cuda):
    """C_in = 160 runs in three channel chunks of 64 (the B tile decoded
    again for each), and C_in = 40 (no multiple of 16) by byte loads."""
    for c_in, c_out in ((160, 24), (40, 70)):
        plan, x, taps = _conv_case("dsp48e2", 4, 4, c_in, c_out, 3, 5, 19, 2,
                                   c_in)
        x_pad, kappa, _ = ops.bseg_conv2d_operands(x, taps, plan)
        got = bseg_conv2d.bseg_conv2d(x_pad.to(cuda), kappa.to(cuda),
                                      plan=plan, h_out=5, w_out=19)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), ref.conv2d_int_ref(x, taps))


def test_bseg_conv2d_zero_point_and_wide_rows(cuda):
    """A signed activation domain through the zero point, and a 416-wide
    row (UltraNet's first layer) with pipelines split across blocks."""
    plan, x, taps = _conv_case("int32", 4, 4, 3, 16, 3, 4, 416, 1, 0)
    xs = x - 5
    y = ops.packed_conv2d(xs.to(cuda), taps.to(cuda), plan=plan,
                          zero_point=5)
    torch.cuda.synchronize()
    assert (y.cpu() == ref.conv2d_int_ref(xs, taps)).all()
    plan, x, taps = _conv_case("dsp48e2", 4, 4, 64, 64, 3, 3, 26, 1, 1)
    y = ops.packed_conv2d(x.to(cuda), taps.to(cuda), plan=plan)
    torch.cuda.synchronize()
    assert (y.cpu() == ref.conv2d_int_ref(x, taps)).all()


def test_bseg_conv2d_rejects_operands(cuda):
    plan, x, taps = _conv_case("int32", 4, 4, 4, 8, 3, 5, 9, 1, 0)
    kappa, _ = ops.prepare_bseg_conv2d(taps, plan)
    x_pad = torch.zeros((1, 7, 16, 4), dtype=torch.int8, device=cuda)
    kd = kappa.to(cuda)
    with pytest.raises(ValueError, match="int8"):
        bseg_conv2d.bseg_conv2d(x_pad.to(torch.int32), kd, plan=plan,
                                h_out=5, w_out=9)
    with pytest.raises(ValueError, match="columns"):
        bseg_conv2d.bseg_conv2d(x_pad[:, :, :8].contiguous(), kd, plan=plan,
                                h_out=5, w_out=9)
    with pytest.raises(ValueError, match="rows"):
        bseg_conv2d.bseg_conv2d(x_pad, kd, plan=plan, h_out=6, w_out=9)
    with pytest.raises(ValueError, match="channels"):
        bseg_conv2d.bseg_conv2d(x_pad[..., :3].contiguous(), kd, plan=plan,
                                h_out=5, w_out=9)
    with pytest.raises(ValueError, match="operands on"):
        bseg_conv2d.bseg_conv2d(x_pad, kappa, plan=plan, h_out=5, w_out=9)
    wide = plan_bseg(DATAPATHS["dsp48e2"], 4, 4)
    with pytest.raises(ValueError, match="5 dims"):
        bseg_conv2d.bseg_conv2d(x_pad, kd, plan=wide, h_out=5, w_out=9)
    fp = plan_bseg(DATAPATHS["fp32m"], 4, 4)
    with pytest.raises(ValueError, match="float32"):
        bseg_conv2d.bseg_conv2d(x_pad, kd, plan=fp, h_out=5, w_out=9)


def _conv1d_case(spec, c, s, n_taps, seed):
    plan = plan_bseg(DATAPATHS[spec], 4, 4)
    rng = np.random.default_rng(seed)
    taps = torch.tensor(rng.integers(-8, 8, (c, n_taps)))
    xq = torch.tensor(rng.integers(-8, 8, (3, s, c)))
    kappa, tap_sum = ops.prepare_bseg_taps(taps, plan)
    return plan, taps, xq, kappa, tap_sum


@pytest.mark.parametrize("spec", ["int32", "fp32m", "dsp48e2", "dsp58"])
@pytest.mark.parametrize("c,s,n_taps", [(1792, 4, 4), (37, 4, 4),
                                        (300, 37, 3), (37, 301, 4),
                                        (65, 1000, 5)])
def test_bseg_conv1d_matches_plain_and_exact(cuda, spec, c, s, n_taps):
    """B4 on the card against its plain version on the CPU, bit for bit,
    and ``ops.bseg_conv1d`` against the exact causal conv.  Ragged C;
    at S = 301 and 1000 the few chains split into chunks whose
    boundaries do not align with n_i."""
    plan, taps, xq, kappa, tap_sum = _conv1d_case(spec, c, s, n_taps, c + s)
    x_pad = ops.bseg_conv1d_x_pad(xq, plan, n_groups=kappa.shape[-2],
                                  n_taps=n_taps, zero_point=8)
    want = bseg_conv1d.bseg_conv1d_plain(x_pad, kappa, plan, s_out=s)
    launches = bseg_conv1d.bseg_conv1d.launches
    got = bseg_conv1d.bseg_conv1d(x_pad.to(cuda), kappa.to(cuda), plan=plan,
                                  s_out=s)
    torch.cuda.synchronize()
    assert bseg_conv1d.bseg_conv1d.launches == launches + 1
    assert got.dtype == torch.int32 and (got.cpu() == want).all()
    y = ops.bseg_conv1d(xq.to(cuda), kappa.to(cuda), tap_sum.to(cuda),
                        plan=plan, n_taps=n_taps, zero_point=8)
    torch.cuda.synchronize()
    assert (y.cpu() == ref.conv1d_causal_ref(xq, taps)).all()


@pytest.mark.parametrize("spec", ["int32", "dsp58"])
def test_bseg_conv1d_same_padding_and_depthwise_conv2d(cuda, spec):
    plan, taps, xq, kappa, tap_sum = _conv1d_case(spec, 96, 50, 5, 3)
    y = ops.bseg_conv1d(xq.to(cuda), kappa.to(cuda), tap_sum.to(cuda),
                        plan=plan, n_taps=5, zero_point=8, padding="same")
    torch.cuda.synchronize()
    assert (y.cpu() == ref.conv1d_ref(xq, taps, 2)).all()
    x = xq.reshape(1, 3, 50, 96)
    w = taps[:, None, None, :3].contiguous()
    y = ops.packed_conv2d(x.to(cuda), w.to(cuda), plan=plan, zero_point=8)
    torch.cuda.synchronize()
    assert (y.cpu() == ref.conv2d_int_ref(x, w)).all()


@pytest.mark.parametrize("spec", ["int32", "fp32m", "dsp48e2", "dsp58"])
@pytest.mark.parametrize("c", [37, 1792])
def test_bseg_conv1d_every_short_row_and_a_long_one(cuda, spec, c):
    """B4 at S_out = 1..8 (the decode shapes, one strip a row) and 2048
    (strips of the long rows), at C = 1792 and C = 37 (C % 4 != 0: byte
    loads), against its plain version bit for bit; x_pad random in every
    position, the schedule's unused right end too."""
    plan = plan_bseg(DATAPATHS[spec], 4, 4)
    rng = np.random.default_rng(c)
    taps = torch.tensor(rng.integers(-8, 8, (c, 4)))
    kappa, _ = ops.prepare_bseg_taps(taps, plan)
    for s in list(range(1, 9)) + [2048]:
        _, need = bseg_common.schedule(plan, s, kappa.shape[-2])
        x_pad = torch.tensor(rng.integers(0, 16, (2, need + 1, c)),
                             dtype=torch.int8)
        want = bseg_conv1d.bseg_conv1d_plain(x_pad, kappa, plan, s_out=s)
        got = bseg_conv1d.bseg_conv1d(x_pad.to(cuda), kappa.to(cuda),
                                      plan=plan, s_out=s)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), s


@pytest.mark.parametrize("spec,wk,wi,n_taps", [
    ("int32", 29, 1, 4), ("fp32m", 21, 1, 4), ("dsp48e2", 26, 1, 4),
    ("dsp58", 26, 1, 4), ("dsp48e2", 4, 4, 17), ("int32", 8, 4, 8)])
def test_bseg_conv1d_wide_taps_and_many_taps(cuda, spec, wk, wi, n_taps):
    """B4 on the widest taps of each word (the decode's 64-bit words and
    lanes) and on 17 taps in 6 groups of 3 (18 taps: two passes of 16
    over the outputs), at an odd C, against its plain version."""
    plan = plan_bseg(DATAPATHS[spec], wk, wi)
    rng = np.random.default_rng(wk + n_taps)
    c, s = 37, 50
    taps = torch.tensor(rng.integers(-(1 << wk - 1), 1 << wk - 1,
                                     (c, n_taps)))
    kappa, _ = ops.prepare_bseg_taps(taps, plan)
    _, need = bseg_common.schedule(plan, s, kappa.shape[-2])
    x_pad = torch.tensor(rng.integers(0, 1 << wi, (3, need + 2, c)),
                         dtype=torch.int8)
    want = bseg_conv1d.bseg_conv1d_plain(x_pad, kappa, plan, s_out=s)
    got = bseg_conv1d.bseg_conv1d(x_pad.to(cuda), kappa.to(cuda), plan=plan,
                                  s_out=s)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("s", [4, 2048])
def test_bseg_conv1d_is_deterministic(cuda, s):
    """Two launches of B4 on the same operands are bit-identical."""
    plan, taps, xq, kappa, tap_sum = _conv1d_case("int32", 1792, s, 4, s)
    x_pad = ops.bseg_conv1d_x_pad(xq, plan, n_groups=kappa.shape[-2],
                                  n_taps=4, zero_point=8).to(cuda)
    kd = kappa.to(cuda)
    first = bseg_conv1d.bseg_conv1d(x_pad, kd, plan=plan, s_out=s)
    second = bseg_conv1d.bseg_conv1d(x_pad, kd, plan=plan, s_out=s)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_bseg_conv1d_rejects_operands(cuda):
    plan, taps, xq, kappa, _ = _conv1d_case("int32", 8, 6, 4, 0)
    kd = kappa.to(cuda)
    x_pad = torch.zeros((2, 10, 8), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="int8"):
        bseg_conv1d.bseg_conv1d(x_pad.to(torch.int32), kd, plan=plan,
                                s_out=6)
    with pytest.raises(ValueError, match="samples"):
        bseg_conv1d.bseg_conv1d(x_pad[:, :5].contiguous(), kd, plan=plan,
                                s_out=6)
    with pytest.raises(ValueError, match="channels"):
        bseg_conv1d.bseg_conv1d(x_pad[..., :7].contiguous(), kd, plan=plan,
                                s_out=6)
    with pytest.raises(ValueError, match="operands on"):
        bseg_conv1d.bseg_conv1d(x_pad, kappa, plan=plan, s_out=6)
    with pytest.raises(ValueError, match="contiguous"):
        bseg_conv1d.bseg_conv1d(x_pad.transpose(0, 1).contiguous()
                                .transpose(0, 1), kd, plan=plan, s_out=6)
    wide = plan_bseg(DATAPATHS["dsp48e2"], 4, 4)
    with pytest.raises(ValueError, match="3 dims"):
        bseg_conv1d.bseg_conv1d(x_pad, kd, plan=wide, s_out=6)
    fp = plan_bseg(DATAPATHS["fp32m"], 4, 4)
    with pytest.raises(ValueError, match="float32"):
        bseg_conv1d.bseg_conv1d(x_pad, kd, plan=fp, s_out=6)
    w8 = plan_bseg(DATAPATHS["dsp58"], 4, 8)
    with pytest.raises(ValueError, match="w_i"):
        bseg_conv1d.bseg_conv1d(x_pad, kd, plan=w8, s_out=6)


# ---------------------------------------------------------------------------
# B6 / B7 (lane pack / unpack) and B5 (quantized matmul)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,nw", [(1, 1), (3, 37), (37, 301), (256, 1000)])
def test_pack_unpack_words_match_plain(cuda, w, m, nw):
    """B6 and B7 against their plain versions, bit for bit, at ragged
    row and word counts; values over the whole int8 range (masked to w
    bits by the pack, as in the reference)."""
    per = 32 // w
    rng = np.random.default_rng(w * 100 + m)
    vals = torch.tensor(rng.integers(-128, 128, (m, nw * per)),
                        dtype=torch.int8)
    want = packbits.pack_words_plain(vals, w=w)
    got = packbits.pack_words(vals.to(cuda), w=w)
    torch.cuda.synchronize()
    assert (got.cpu() == want).all()
    want_u = packbits.unpack_words_plain(want, w=w)
    got_u = packbits.unpack_words(want.to(cuda), w=w)
    torch.cuda.synchronize()
    assert (got_u.cpu() == want_u).all()
    # the round trip keeps each value's w low bits, sign-extended
    low = ((vals.to(torch.int32) + (1 << w - 1)) & ((1 << w) - 1)) \
        - (1 << w - 1)
    assert (got_u.cpu() == low.to(torch.int8)).all()


def test_packbits_counters_and_refusals(cuda):
    vals = torch.zeros((4, 64), dtype=torch.int8, device=cuda)
    b6, b7 = packbits.pack_words.launches, packbits.unpack_words.launches
    plain = packbits.pack_words_plain.calls + packbits.unpack_words_plain.calls
    words = ops.pack_weights(vals, w=4)
    ops.unpack_weights(words, w=4)
    torch.cuda.synchronize()
    assert packbits.pack_words.launches == b6 + 1
    assert packbits.unpack_words.launches == b7 + 1
    assert packbits.pack_words_plain.calls \
        + packbits.unpack_words_plain.calls == plain
    with pytest.raises(ValueError, match="aligned"):
        packbits.pack_words(vals.reshape(-1)[8:8 + 3 * 64].reshape(3, 64),
                            w=4)
    with pytest.raises(ValueError, match="int8"):
        packbits.pack_words(vals.to(torch.int32), w=4)
    with pytest.raises(ValueError, match="contiguous"):
        packbits.unpack_words(words.t(), w=4)



def _dequant_operands(m, nw, w, rows_per_scale, seed):
    """Random words (every field value) and scales with a subnormal
    column, two on bf16 rounding ties and one that overflows."""
    per = 32 // w
    rng = np.random.default_rng(seed)
    words = torch.tensor(rng.integers(-2**31, 2**31, (m, nw)),
                         dtype=torch.int32)
    scale = torch.tensor(rng.uniform(0.001, 0.1,
                                     (m // rows_per_scale, nw * per)),
                         dtype=torch.float32)
    for col, v in enumerate((9e-41, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
                             3e38)[:nw * per]):
        scale[:, col] = v
    return words, scale


def _same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(view), b.contiguous().view(view))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("w", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("m,nw", [(1, 1), (3, 37), (37, 301), (256, 1000)])
def test_unpack_dequant_matches_plain(cuda, m, nw, w, dtype):
    """The fused B7 against its plain version (on the CPU), bit for bit, at
    ragged row and word counts, a d_out that trims the last word, and
    (256 rows) four groups of 64 rows with their own scales."""
    per = 32 // w
    d_out = max(1, nw * per - 3)
    rps = 64 if m == 256 else m
    words, scale = _dequant_operands(m, nw, w, rps, seed=w * 100 + m)
    kw = dict(w=w, d_out=d_out, rows_per_scale=rps, dtype=dtype)
    want = packbits.unpack_dequant_plain(words, scale, **kw)
    got = packbits.unpack_dequant(words.to(cuda), scale.to(cuda), **kw)
    torch.cuda.synchronize()
    assert _same_bits(got.cpu(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d_out", [2048, 2047, 2044, 2040, 2033])
@pytest.mark.parametrize("offset", [0, 1])
def test_unpack_dequant_misaligned(cuda, d_out, offset, dtype):
    """W4 rows of 256 words: 16-byte word loads on an aligned base, 4-byte
    loads on a base one word off; vector stores where d_out keeps every
    row 16 bytes aligned (2048, 2040 trimming a whole word; 2044 for
    float32), scalar stores otherwise — all bit for bit the plain
    version."""
    words, scale = _dequant_operands(96, 256, 4, 32, seed=d_out + offset)
    buf = torch.empty(words.numel() + offset, dtype=torch.int32, device=cuda)
    dev_words = buf[offset:].view(words.shape)
    dev_words.copy_(words)
    kw = dict(w=4, d_out=d_out, rows_per_scale=32, dtype=dtype)
    got = packbits.unpack_dequant(dev_words, scale.to(cuda), **kw)
    torch.cuda.synchronize()
    assert _same_bits(got.cpu(), packbits.unpack_dequant_plain(words, scale,
                                                               **kw))


def test_unpack_dequant_counters_and_refusals(cuda):
    words, scale = _dequant_operands(8, 4, 4, 4, seed=0)
    words, scale = words.to(cuda), scale.to(cuda)
    fused, b7 = packbits.unpack_dequant.launches, packbits.unpack_words.launches
    plain = packbits.unpack_dequant_plain.calls \
        + packbits.unpack_words_plain.calls
    out = ops.unpack_dequant(words, scale, w=4, d_out=30, rows_per_scale=4)
    torch.cuda.synchronize()
    assert out.shape == (8, 30) and out.dtype == torch.bfloat16
    assert packbits.unpack_dequant.launches == fused + 1
    assert packbits.unpack_words.launches == b7
    assert packbits.unpack_dequant_plain.calls \
        + packbits.unpack_words_plain.calls == plain
    kw = dict(w=4, d_out=30, rows_per_scale=4)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        packbits.unpack_dequant(words, scale, dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        packbits.unpack_dequant(words.t().contiguous().t(), scale, **kw)
    with pytest.raises(ValueError, match="scale must be float32"):
        packbits.unpack_dequant(words, scale[:1], **kw)
    with pytest.raises(ValueError, match="scale on"):
        packbits.unpack_dequant(words, scale.cpu(), **kw)
    shifted = torch.empty(scale.numel() + 1, device=cuda)[1:].view(
        scale.shape)
    with pytest.raises(ValueError, match="aligned"):
        packbits.unpack_dequant(words, shifted, **kw)
    assert packbits.unpack_dequant.launches == fused + 1

def _qmm_case(m, k, n, w, dtype, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32) \
        .to(dtype)
    w_int = torch.tensor(rng.integers(-(1 << w - 1), 1 << w - 1, (k, n)))
    scale = torch.tensor(rng.uniform(0.001, 0.1, n), dtype=torch.float32)
    words = packbits.pack_words_plain(w_int.to(torch.int8), w=w)
    return x, w_int, words, scale


@pytest.mark.parametrize("w", [4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 2048), (8, 2048, 256),
                                   (8, 5632, 2048), (128, 2048, 5632),
                                   (3, 77, 40), (37, 300, 136)])
def test_quant_matmul_matches_plain(cuda, w, dtype, m, k, n):
    """B5 against its plain version and the float64 product, at the
    tinyllama projection shapes (8 decode rows, 128 prefill rows) and
    ragged ones, within the float32 summation bound
    (``quant_matmul.error_bound``) and within ``ROUNDING_LIMIT`` typical
    float32 roundings (``quant_matmul.rounding_scale``), which float32 x
    rounded to TF32's 10 mantissa bits exceeds."""
    x, w_int, words, scale = _qmm_case(m, k, n, w, dtype, m + k + n)
    bound = quant_matmul.error_bound(x, w_int, scale)
    limit = quant_matmul.ROUNDING_LIMIT \
        * quant_matmul.rounding_scale(x, w_int, scale)
    exact = (x.to(torch.float64) @ w_int.to(torch.float64)) \
        * scale.to(torch.float64)
    want = quant_matmul.quant_matmul_plain(x, words, scale, w=w)
    got = quant_matmul.quant_matmul(x.to(cuda), words.to(cuda),
                                    scale.to(cuda), w=w)
    torch.cuda.synchronize()
    got = got.cpu().to(torch.float64)
    assert ((got - exact).abs() <= bound).all()
    assert ((got - want.to(torch.float64)).abs() <= 2 * bound).all()
    assert ((got - exact).abs() <= limit).all()
    if dtype == torch.float32:
        bits = x.view(torch.int32)
        x_tf32 = ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF) \
            .view(torch.float32)
        low = (x_tf32.double() @ w_int.double()) * scale.double()
        assert not ((low - exact).abs() <= limit).all()


def _qmm_checks(got, x, w_int, scale, want=None):
    """B5's output against the float64 product (within ``error_bound``
    and ``ROUNDING_LIMIT`` rounding scales) and, given, its plain
    version (within twice the bound)."""
    bound = quant_matmul.error_bound(x, w_int, scale)
    limit = quant_matmul.ROUNDING_LIMIT \
        * quant_matmul.rounding_scale(x, w_int, scale)
    exact = (x.double() @ w_int.double()) * scale.double()
    got = got.cpu().double()
    assert ((got - exact).abs() <= bound).all()
    assert ((got - exact).abs() <= limit).all()
    if want is not None:
        assert ((got - want.double()).abs() <= 2 * bound).all()


@pytest.mark.parametrize("w", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n_words", [(3, 77, 7), (8, 1000, 37),
                                         (37, 300, 41), (130, 2100, 25)])
def test_quant_matmul_every_width(cuda, w, dtype, m, k, n_words):
    """B5 at w = 2..8 (120-column tiles at w = 3, 5, 6), ragged m, k and
    word counts (unaligned rows: 4-byte copies and plain loads), with and
    without a K split, against its plain version and the float64
    product."""
    per = 32 // w
    x, w_int, words, scale = _qmm_case(m, k, n_words * per, w, dtype,
                                       w * 1000 + m)
    got = quant_matmul.quant_matmul(x.to(cuda), words.to(cuda),
                                    scale.to(cuda), w=w)
    torch.cuda.synchronize()
    want = quant_matmul.quant_matmul_plain(x, words, scale, w=w)
    _qmm_checks(got, x, w_int, scale, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 5632, 256), (8, 2048, 2048),
                                   (128, 2048, 256), (64, 5632, 512)])
def test_quant_matmul_split_k_is_deterministic(cuda, dtype, m, k, n):
    """At shapes whose grid splits K (8 and 128 rows), two launches give
    bit-identical output (the partials are added in split order by the
    last block of each tile, whose ticket resets itself), within the
    checks."""
    geo = quant_matmul.launch_geometry(
        m, n, k, 4, torch.cuda.get_device_properties(cuda)
        .multi_processor_count)
    assert geo.grid[2] > 1
    x, w_int, words, scale = _qmm_case(m, k, n, 4, dtype, 17)
    xd, wd, sd = x.to(cuda), words.to(cuda), scale.to(cuda)
    first = quant_matmul.quant_matmul(xd, wd, sd, w=4)
    second = quant_matmul.quant_matmul(xd, wd, sd, w=4)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _qmm_checks(first, x, w_int, scale)


@pytest.mark.parametrize("m,k,n", [(8, 5632, 2048), (128, 2048, 256)])
def test_quant_matmul_controls_fail(cuda, m, k, n):
    """On float32 x the checks refuse the lower precisions: x rounded to
    TF32 (exact product after) and B5 itself on bf16-rounded x."""
    x, w_int, words, scale = _qmm_case(m, k, n, 4, torch.float32, 5)
    limit = quant_matmul.ROUNDING_LIMIT \
        * quant_matmul.rounding_scale(x, w_int, scale)
    exact = (x.double() @ w_int.double()) * scale.double()
    bits = x.view(torch.int32)
    x_tf32 = ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF) \
        .view(torch.float32)
    low = (x_tf32.double() @ w_int.double()) * scale.double()
    assert not ((low - exact).abs() <= limit).all()
    y16 = quant_matmul.quant_matmul(x.bfloat16().to(cuda), words.to(cuda),
                                    scale.to(cuda), w=4)
    torch.cuda.synchronize()
    assert not ((y16.cpu().double() - exact).abs() <= limit).all()


def test_quant_matmul_float32_edge_values(cuda):
    """float32 x split into its three bf16 parts loses nothing: rows with
    one nonzero term (weight 1) equal the plain version bit for bit, at
    edge values of the split: signed zeros, the largest and smallest
    normal float32, long runs of significand ones, and values whose last
    part is a bf16 subnormal (|x| >= 2^-110); and a random mix of them
    stays within the checks."""
    f32 = np.finfo(np.float32)
    vals = np.array([0.0, -0.0, f32.max, -f32.max, f32.tiny, -f32.tiny,
                     1.9999999, -1.9999999, 1.0 + 2.0 ** -23,
                     1.9999999 * 2.0 ** -100, 1.9999999 * 2.0 ** -110,
                     2.0 ** -105 * (1 + 2.0 ** -23), 2.0 ** -108 * 1.5],
                    dtype=np.float32)
    m, k, n = len(vals), 64, 8
    x = torch.zeros((m, k), dtype=torch.float32)
    x[torch.arange(m), torch.arange(m) * 3] = torch.tensor(vals)
    w_int = torch.ones((k, n), dtype=torch.int64)
    scale = torch.full((n,), 0.5, dtype=torch.float32)
    words = packbits.pack_words_plain(w_int.to(torch.int8), w=4)
    got = quant_matmul.quant_matmul(x.to(cuda), words.to(cuda),
                                    scale.to(cuda), w=4)
    torch.cuda.synchronize()
    want = quant_matmul.quant_matmul_plain(x, words, scale, w=4)
    assert torch.equal(got.cpu(), want)
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.choice(vals[[0, 1, 6, 7, 8, 9, 11]], (8, 640)))
    w_int = torch.tensor(rng.integers(-8, 8, (640, 64)))
    scale = torch.tensor(rng.uniform(0.001, 0.1, 64), dtype=torch.float32)
    words = packbits.pack_words_plain(w_int.to(torch.int8), w=4)
    got = quant_matmul.quant_matmul(x.to(cuda), words.to(cuda),
                                    scale.to(cuda), w=4)
    torch.cuda.synchronize()
    _qmm_checks(got, x, w_int, scale)


def test_quant_matmul_dispatch_and_refusals(cuda):
    x, w_int, words, scale = _qmm_case(6, 64, 48, 4, torch.float32, 1)
    xd, wd, sd = x.to(cuda), words.to(cuda), scale.to(cuda)
    b5, plain = quant_matmul.quant_matmul.launches, \
        quant_matmul.quant_matmul_plain.calls
    y = ops.packed_matmul(xd.reshape(2, 3, 64), wd, scale=sd, w_bits=4,
                          m=45)
    torch.cuda.synchronize()
    assert quant_matmul.quant_matmul.launches == b5 + 1
    assert quant_matmul.quant_matmul_plain.calls == plain
    assert y.shape == (2, 3, 45)
    exact = (x.double() @ w_int.double()) * scale.double()
    bound = quant_matmul.error_bound(x, w_int, scale)
    assert ((y.cpu().reshape(6, 45).double() - exact[:, :45]).abs()
            <= bound[:, :45]).all()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        quant_matmul.quant_matmul(xd.half(), wd, sd, w=4)
    with pytest.raises(ValueError, match="scale"):
        quant_matmul.quant_matmul(xd, wd, sd[:5], w=4)
    with pytest.raises(ValueError, match="operands on"):
        quant_matmul.quant_matmul(xd, words, sd, w=4)


def test_qat_ste_defaults_launch_on_card(cuda):
    """Without ``use_kernel`` the STE layers and ``QATLinear`` resolve
    it from the input's device: on the card each call launches its
    kernel (B2 for the dense layer, B3 for the conv); an explicit False
    takes the plain route and launches none."""
    from repro_torch.models.quantized import default_bseg_plan
    from repro_torch.train.qat import ste
    plan = plan_sdv(DATAPATHS["dsp48e2"], 4, 8, signed_a=True,
                    signed_b=True, park_sign_bits=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    x = torch.randn((64, 256), generator=gen, device=cuda)
    w = torch.randn((256, 96), generator=gen, device=cuda)
    before = sdv_matmul.sdv_matmul.launches
    y = ste.ste_dense(x, w, 4, 8, plan)
    assert sdv_matmul.sdv_matmul.launches == before + 1
    y_lin = ste.QATLinear(kernel=w, w_bits=4, a_bits=8,
                          plan=plan).qat_apply(x)
    assert sdv_matmul.sdv_matmul.launches == before + 2
    y_plain = ste.ste_dense(x, w, 4, 8, plan, False)
    assert sdv_matmul.sdv_matmul.launches == before + 2
    assert torch.equal(y, y_lin) and torch.equal(y, y_plain)
    xc = torch.randn((2, 12, 12, 16), generator=gen, device=cuda)
    wc = torch.randn((8, 16, 3, 3), generator=gen, device=cuda)
    before = bseg_conv2d.bseg_conv2d.launches
    yc = ste.ste_conv2d(xc, wc, 4, 4, default_bseg_plan(4))
    assert bseg_conv2d.bseg_conv2d.launches == before + 1
    assert torch.equal(yc, ste.ste_conv2d(xc, wc, 4, 4, default_bseg_plan(4),
                                          False))
    assert bseg_conv2d.bseg_conv2d.launches == before + 1


def test_qat_ste_layers_on_card(cuda):
    """Packed QAT on the card: ``ste_dense`` on a dsp48e2 W4A8 plan (B2)
    == ``plan=None`` bitwise, ``ste_conv2d`` on the W4A4 BSEG plan (B3)
    == ``plan=None``, and two steps of reduced tinyllama QAT through
    ``run_qat`` with 15 B2 launches per microbatch (2 layers x 7 + the
    LM head) and finite losses."""
    from repro_torch.models.quantized import default_bseg_plan
    from repro_torch.train.qat import QATRunConfig, run_qat, ste
    plan = plan_sdv(DATAPATHS["dsp48e2"], 4, 8, signed_a=True,
                    signed_b=True, park_sign_bits=True)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    x = torch.randn((64, 256), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    w = torch.randn((256, 96), generator=gen, device=cuda) \
        .to(torch.bfloat16)
    before = sdv_matmul.sdv_matmul.launches
    y = ste.ste_dense(x, w, 4, 8, plan, True)
    assert sdv_matmul.sdv_matmul.launches == before + 1
    assert torch.equal(y.view(torch.int16), ste.ste_dense(
        x, w, 4, 8, None, True).view(torch.int16))
    xc = torch.randn((2, 12, 12, 16), generator=gen, device=cuda)
    wc = torch.randn((8, 16, 3, 3), generator=gen, device=cuda)
    before = bseg_conv2d.bseg_conv2d.launches
    yc = ste.ste_conv2d(xc, wc, 4, 4, default_bseg_plan(4), True)
    assert bseg_conv2d.bseg_conv2d.launches == before + 1
    assert torch.equal(yc.view(torch.int32), ste.ste_conv2d(
        xc, wc, 4, 4, None, True).view(torch.int32))
    before = sdv_matmul.sdv_matmul.launches
    res = run_qat(QATRunConfig(steps=2, global_batch=4, seq=32,
                               microbatches=2, eval_batches=1,
                               device="cuda"), log=lambda *_: None)
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 2
    assert sdv_matmul.sdv_matmul.launches - before == 2 * 2 * 15 + 15
