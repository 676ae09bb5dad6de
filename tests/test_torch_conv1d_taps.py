"""The premise and the host side of the decoded-tap depthwise conv1d (B4
``bseg_conv1d``, ``csrc/bseg1d.cu``), on the CPU.

The kernel decodes each channel's packed tap-group factors into taps and
sums tap x sample over a strip of outputs, with no carry word.  What
lets that equal the paper's BSEG arithmetic bit for bit is checked here
without a card:

- the decode (``decode_conv1d_taps_plain``, and the kernel's biased
  64-bit decode repeated in Python integers) gives back the taps that
  both packages' ``prepare_bseg_taps`` packed, on every word form and tap
  width up to the widest ``plan_bseg`` admits;
- the identity: the BSEG word arithmetic (``bseg_conv1d_plain``, and the
  JAX Pallas kernel in interpret mode) equals the plain correlation of
  ``x_pad`` with the decoded taps (``correlate1d_plain``), whatever the
  pad positions that no output uses hold, and ``ops.bseg_conv1d`` is
  the exact causal and 'same' conv;
- the launch shape covers every output exactly once at the short conv's
  channel counts and an odd one, at 1..8 and 2048 outputs.

The kernel itself is held against ``bseg_conv1d_plain`` and the exact
conv on the card in ``test_torch_kernels_cuda``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datapath as jdp
from repro.kernels import ops as jops
from repro.kernels.bseg_conv1d import bseg_conv1d as j_bseg_conv1d

from repro_torch.core import datapath as tdp
from repro_torch.kernels import bseg_common
from repro_torch.kernels import bseg_conv1d as tconv1d
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

SPECS = ("int32", "fp32m", "dsp48e2", "dsp58")
#: the widest w_k plan_bseg admits on each word at some w_i <= 7, and
#: that w_i (tests/test_torch_bseg_tc.py)
WIDEST = {"int32": (29, 1), "fp32m": (21, 1), "dsp48e2": (26, 1),
          "dsp58": (26, 1)}
WIDTHS = [2, 3, 4, 5, 6, 7, 8, "widest"]


def _admits(spec, wk, wi):
    try:
        tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi)
    except ValueError:
        return False
    return True


def _plans(spec, wk, wi):
    return (jdp.plan_bseg(jdp.DATAPATHS[spec], wk, wi),
            tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi))


def _plan_widths(spec, wk):
    """(w_k, w_i): the widest w_i <= 4 that the word admits beside w_k."""
    if wk == "widest":
        return WIDEST[spec]
    return wk, max(w for w in range(1, 5) if _admits(spec, wk, w))


def _taps(rng, wk, c, n):
    taps = rng.integers(-(1 << wk - 1), 1 << wk - 1, (c, n))
    taps[0, 0] = -(1 << wk - 1)                       # the extremes
    taps[1, -1] = (1 << wk - 1) - 1
    return taps


def _kernel_decode(words: torch.Tensor, plan) -> torch.Tensor:
    """csrc/bseg1d.cu's decode in Python integers: W + H (H = 2^(L-1) in
    each of the n_k lanes) mod 2^64, lane i = (W + H) >> iL & (2^L - 1)
    minus 2^(L-1), kept mod 2^32 as the kernel's uint32 taps; tap j of
    the [C, G n_k] result is lane n_k - 1 - j % n_k of group j // n_k."""
    lane, n_k = plan.lane, plan.n_k
    bias = sum(1 << (i * lane + lane - 1) for i in range(n_k))
    g, c = words.shape
    out = torch.zeros((c, g * n_k), dtype=torch.int64)
    for gi in range(g):
        for ch in range(c):
            wd = (int(words[gi, ch]) + bias) % 2 ** 64
            for j in range(n_k):
                i = n_k - 1 - j
                v = ((wd >> i * lane) & ((1 << lane) - 1)) - (1 << lane - 1)
                out[ch, gi * n_k + j] = v % 2 ** 32
    return out


@pytest.mark.parametrize("wk", WIDTHS)
@pytest.mark.parametrize("spec", SPECS)
def test_decode_conv1d_taps_gives_back_the_taps(spec, wk):
    """``decode_conv1d_taps_plain`` == the taps packed by both packages'
    ``prepare_bseg_taps`` (which agree), with zero taps past the conv's
    own; 5 taps leave the last group partial whenever n_k does not divide
    5; the kernel's biased decode gives the same taps mod 2^32."""
    wk, wi = _plan_widths(spec, wk)
    jplan, tplan = _plans(spec, wk, wi)
    rng = np.random.default_rng(wk * 10 + wi)
    n = 5
    taps = _taps(rng, wk, 9, n)
    tk, ts = tops.prepare_bseg_taps(torch.tensor(taps), tplan)
    jk, js = jops.prepare_bseg_taps(jnp.asarray(taps), jplan)
    assert (np.asarray(jk) == tk.numpy()).all()
    assert (np.asarray(js) == ts.numpy()).all()
    dec = tconv1d.decode_conv1d_taps_plain(tk, tplan)
    groups = tk.shape[-2]
    assert dec.dtype == torch.int64 and dec.shape == (9, groups * tplan.n_k)
    want = np.zeros((9, groups * tplan.n_k), dtype=np.int64)
    want[:, :n] = taps
    assert (dec.numpy() == want).all()
    words = bseg_common.kappa_words(tk, tplan)
    assert torch.equal(_kernel_decode(words, tplan), dec % 2 ** 32)


def _x_pad(rng, plan, b, s_out, c, n_groups, extra=3):
    """x_pad of the kernel's operands, every position random: the step
    schedule's right end (and ``extra`` more) feeds no output."""
    _, need = bseg_common.schedule(plan, s_out, n_groups)
    return rng.integers(0, 1 << plan.w_i, (b, need + extra, c))


@pytest.mark.parametrize("wk", [4, 2, 8, "widest"])
@pytest.mark.parametrize("spec", SPECS)
def test_bseg_arithmetic_is_the_plain_correlation(spec, wk):
    """The identity B4's redesign rests on: the BSEG word arithmetic
    (``bseg_conv1d_plain``) == the plain correlation of x_pad with the
    decoded taps (``correlate1d_plain``), bit for bit, at the decode
    shape (4 outputs, 4 taps) and ragged ones (1, 7 and 37 outputs; 3 and
    5 taps), every x_pad position random; the JAX Pallas kernel
    (interpret mode) agrees at W4A4."""
    wk, wi = _plan_widths(spec, wk) if wk != 4 else (4, 4)
    jplan, tplan = _plans(spec, wk, wi)
    rng = np.random.default_rng(wk * 100 + wi)
    for s_out, n, c in ((4, 4, 12), (1, 3, 5), (7, 5, 9), (37, 4, 16)):
        taps = _taps(rng, wk, c, n)
        tk, _ = tops.prepare_bseg_taps(torch.tensor(taps), tplan)
        x_pad = _x_pad(rng, tplan, 2, s_out, c, tk.shape[-2])
        xt = torch.tensor(x_pad, dtype=torch.int8)
        got = tconv1d.bseg_conv1d_plain(xt, tk, tplan, s_out=s_out)
        dec = tconv1d.decode_conv1d_taps_plain(tk, tplan)
        want = tconv1d.correlate1d_plain(xt, dec, s_out=s_out)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want), (s_out, n)
        if wk == 4 and s_out in (4, 37):
            jk, _ = jops.prepare_bseg_taps(jnp.asarray(taps), jplan)
            jy = j_bseg_conv1d(jnp.asarray(x_pad, jnp.int8), jk, plan=jplan,
                               s_out=s_out, bc=c, interpret=True)
            assert (np.asarray(jy) == want.numpy()).all()


@pytest.mark.parametrize("padding", ["causal", "same"])
@pytest.mark.parametrize("spec", SPECS)
def test_conv1d_route_is_the_exact_conv(spec, padding):
    """``ops.bseg_conv1d`` (x_pad with the zero point in its pads, B4's
    plain version, the tap-sum correction) == the exact signed conv, and
    the decoded-tap correlation of the same x_pad gives B4's result, for
    causal and 'same' padding at 4 taps (decode) and 5 (a partial
    group)."""
    _, tplan = _plans(spec, 4, 4)
    rng = np.random.default_rng(len(spec))
    for s, n, c in ((4, 4, 13), (29, 5, 8)):
        taps = torch.tensor(rng.integers(-8, 8, (c, n)))
        xq = torch.tensor(rng.integers(-8, 8, (3, s, c)))
        kappa, tap_sum = tops.prepare_bseg_taps(taps, tplan)
        y = tops.bseg_conv1d(xq, kappa, tap_sum, plan=tplan, n_taps=n,
                             zero_point=8, padding=padding)
        left = n - 1 if padding == "causal" else (n - 1) // 2
        assert torch.equal(y, tref.conv1d_ref(xq, taps, left))
        x_pad = tops.bseg_conv1d_x_pad(xq, tplan, n_groups=kappa.shape[-2],
                                       n_taps=n, zero_point=8,
                                       padding=padding)
        dec = tconv1d.decode_conv1d_taps_plain(kappa, tplan)
        assert torch.equal(
            tconv1d.correlate1d_plain(x_pad, dec, s_out=s),
            tconv1d.bseg_conv1d_plain(x_pad, kappa, tplan, s_out=s))


@pytest.mark.parametrize("spec", SPECS)
def test_every_plan_fits_the_kernel(spec):
    """Every plan ``check_operands`` can take (n_lanes <= MAX_LANES, w_i
    <= 7, the biased word inside the datapath word) passes the kernel's
    own limits: n_k <= 12 lanes of L bits with n_k L <= 64 (the decode's
    uint64), and G n_k <= 96 taps (the launch's tap table) for G <=
    MAX_GROUPS."""
    for wk in range(1, 30):
        for wi in range(1, 8):
            if not _admits(spec, wk, wi):
                continue
            plan = tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi)
            if plan.n_lanes > tconv1d.MAX_LANES:
                continue
            assert 1 <= plan.n_k <= 12 and plan.n_k * plan.lane <= 64
            assert 1 <= plan.lane
            assert tconv1d.MAX_GROUPS * plan.n_k <= 96


_SHAPES = ([(8, c, s) for c in (1792, 2560, 37) for s in range(1, 9)]
           + [(8, c, 2048) for c in (1792, 2560, 37)]
           + [(3, 301, 1000), (1, 5, 2048), (2, 4096, 64)])


@pytest.mark.parametrize("b,c,s_out", _SHAPES)
def test_launch_shape_covers_every_output_once(b, c, s_out):
    """Replays the kernel's thread indexing: thread (quad, strip, row)
    owns channels 4 quad .. + 3 (fewer past C) and outputs [strip s,
    + s) (fewer past S_out), and every (b, s, c) is owned exactly once;
    the block and grid fit the launcher's limits; a decode call is one
    strip a row, and long rows fill the card ``WAVES`` times (2048
    threads an SM)."""
    sms = 132
    threads, strip = tconv1d.launch_shape(b, c, s_out, sms=sms)
    assert threads % 32 == 0 and 32 <= threads <= tconv1d.BLOCK_THREADS
    quads = -(-c // 4)
    gx, gy = -(-quads // threads), -(-s_out // strip)
    assert gy <= 65535 and strip >= 1
    if strip > 8:
        assert strip % 8 == 0
    cover = torch.zeros((s_out, c), dtype=torch.int32)
    for x in range(gx):
        for t in range(threads):
            c0 = 4 * (x * threads + t)
            if c0 >= c:
                continue
            for y in range(gy):
                cover[y * strip:min(s_out, (y + 1) * strip),
                      c0:min(c, c0 + 4)] += 1
    assert (cover == 1).all()
    if s_out <= 8:
        assert gy == 1
    if s_out >= 2048:
        assert b * quads * gy >= min(
            tconv1d.WAVES * sms * tconv1d.SM_THREADS,
            b * quads * -(-s_out // (tconv1d.MIN_STRIP + 8)))
