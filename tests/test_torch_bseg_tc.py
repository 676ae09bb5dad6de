"""The premise and the host side of the tensor-core BSEG conv2d (B3
``bseg_conv2d``, ``csrc/bseg.cu``), on the CPU.

The kernel decodes the packed kernel-row factors once into int8 taps (in
byte slices when they are wider than 8 bits) and runs the conv as an
implicit GEMM on the int8 tensor cores.  What lets that equal the
paper's BSEG arithmetic bit for bit is checked here without a card:

- the decode (``decode_taps_plain``, the kernel's decode and slices)
  gives back the taps that ``prepare_bseg_conv2d`` packed, on every
  datapath and tap width up to the widest ``plan_bseg`` admits;
- the identity: the BSEG word arithmetic (``bseg_conv2d_plain``, and
  the JAX Pallas kernel in interpret mode) equals the plain correlation
  of ``x_pad`` with the decoded taps (``correlate_plain``), whatever the
  right pad columns hold;
- the launch geometry covers every output exactly once, at every
  UltraNet shape and at the card tests' shapes, within the kernel's
  shared memory.

The kernel itself is held against ``bseg_conv2d_plain`` and the exact
conv on the card in ``test_torch_kernels_cuda``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datapath as jdp
from repro.kernels import ops as jops
from repro.kernels.bseg_conv2d import bseg_conv2d as j_bseg_conv2d
from repro.models import ultranet as JU

from repro_torch.core import datapath as tdp
from repro_torch.kernels import bseg_conv2d as tconv
from repro_torch.kernels import ops as tops

SPECS = ("int32", "fp32m", "dsp48e2", "dsp58")
#: the widest w_k plan_bseg admits on each word at some w_i <= 7 (the
#: kernel stages activations in int8), and that w_i
WIDEST = {"int32": (29, 1), "fp32m": (21, 1), "dsp48e2": (26, 1),
          "dsp58": (26, 1)}
#: tap widths of the decode and identity tests: every width to 8 bits
#: (one slice), 12 and 16 (two), and the widest (three or four)
WIDTHS = [2, 3, 4, 5, 6, 7, 8, 12, 16, "widest"]


def _admits(spec, wk, wi):
    try:
        tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi)
    except ValueError:
        return False
    return True


def _plan_widths(spec, wk):
    """(w_k, w_i) of a test plan: the widest w_i <= 4 that the word
    admits beside w_k."""
    if wk == "widest":
        return WIDEST[spec]
    wi = max(w for w in range(1, 5) if _admits(spec, wk, w))
    return wk, wi


def _plans(spec, wk, wi):
    return (jdp.plan_bseg(jdp.DATAPATHS[spec], wk, wi),
            tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi))


def _taps(rng, wk, c_out, c_in, kh, kw):
    return rng.integers(-(1 << wk - 1), 1 << wk - 1, (c_out, c_in, kh, kw))


def _x_pad(rng, plan, b, h, w, c_in, kh, n_groups):
    """x_pad of the kernel's operands, every column random: the right pad
    columns only meet zero taps."""
    n_steps = -(-(w + plan.n_k - 1) // plan.n_i)
    need = (n_steps - 1) * plan.n_i + (n_groups - 1) * plan.n_k + plan.n_i
    return rng.integers(0, 1 << plan.w_i,
                        (b, h + kh - 1, max(need, w + kh - 1), c_in))


@pytest.mark.parametrize("spec", SPECS)
def test_widest_tap_widths(spec):
    """``WIDEST`` is the widest w_k that plan_bseg admits on the word at
    any w_i <= 7, and the kernel's four byte slices cover it."""
    wk, wi = WIDEST[spec]
    assert _admits(spec, wk, wi)
    assert not any(_admits(spec, wk + 1, w) for w in range(1, 8))
    plan = tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi)
    assert tconv.tap_slices(plan) == -(-wk // 8) <= tconv.MAX_SLICES


@pytest.mark.parametrize("wk", WIDTHS)
@pytest.mark.parametrize("spec", SPECS)
def test_decode_taps_gives_back_the_packed_taps(spec, wk):
    """``decode_taps_plain`` (the kernel's decode: low lanes first, with
    borrow; byte slices, the top one int8) joined again == the taps
    packed by both packages' ``prepare_bseg_conv2d``, with zero taps
    past kw; kw = 5 leaves the last tap group partial whenever n_k
    does not divide it."""
    wk, wi = _plan_widths(spec, wk)
    jplan, tplan = _plans(spec, wk, wi)
    rng = np.random.default_rng(wk * 10 + wi)
    c_out, c_in, kh, kw = 6, 5, 3, 5
    taps = _taps(rng, wk, c_out, c_in, kh, kw)
    taps[0, 0, 0, 0] = -(1 << wk - 1)                 # the extremes
    taps[1, 0, 0, 0] = (1 << wk - 1) - 1
    tk, _ = tops.prepare_bseg_conv2d(torch.tensor(taps), tplan)
    jk, _ = jops.prepare_bseg_conv2d(jnp.asarray(taps), jplan)
    assert (np.asarray(jk) == tk.numpy()).all()
    slices = tconv.decode_taps_plain(tk, tplan)
    n = tconv.tap_slices(tplan)
    assert len(slices) == n
    assert [s.dtype for s in slices] == [torch.uint8] * (n - 1) + [torch.int8]
    s_taps = tk.shape[-4] * tplan.n_k
    assert all(s.shape == (c_out, kh, s_taps, c_in) for s in slices)
    want = np.zeros((c_out, kh, s_taps, c_in), dtype=np.int64)
    want[:, :, :kw] = taps.transpose(0, 2, 3, 1)
    assert (tconv.join_slices(slices).numpy() == want).all()


@pytest.mark.parametrize("wk", WIDTHS)
@pytest.mark.parametrize("spec", SPECS)
def test_bseg_arithmetic_is_the_plain_correlation(spec, wk):
    """The identity B3's redesign rests on: the BSEG word arithmetic
    (``bseg_conv2d_plain``) == the plain correlation of x_pad with the
    decoded taps (mod 2^32), bit for bit, for 1x1, 3x3 and 5x5 kernels
    (5 taps: a partial tap group when n_k does not divide 5), every
    x_pad column random; and the JAX Pallas kernel (interpret mode)
    agrees at the 3x3 shape."""
    wk, wi = _plan_widths(spec, wk)
    jplan, tplan = _plans(spec, wk, wi)
    rng = np.random.default_rng(wk * 100 + wi)
    for c_in, c_out, k, h, w in ((3, 4, 3, 4, 9), (16, 3, 1, 3, 5),
                                 (5, 4, 5, 3, 7)):
        taps = _taps(rng, wk, c_out, c_in, k, k)
        tk, _ = tops.prepare_bseg_conv2d(torch.tensor(taps), tplan)
        x_pad = _x_pad(rng, tplan, 2, h, w, c_in, k, tk.shape[-4])
        xt = torch.tensor(x_pad, dtype=torch.int8)
        got = tconv.bseg_conv2d_plain(xt, tk, tplan, h_out=h, w_out=w)
        dec = tconv.join_slices(tconv.decode_taps_plain(tk, tplan))
        want = tconv.correlate_plain(xt, dec, h_out=h, w_out=w)
        assert got.dtype == want.dtype == torch.int32
        assert torch.equal(got, want), (c_in, k)
        if k == 3:
            jk, _ = jops.prepare_bseg_conv2d(jnp.asarray(taps), jplan)
            jy = j_bseg_conv2d(jnp.asarray(x_pad, jnp.int8), jk, plan=jplan,
                               h_out=h, w_out=w, interpret=True)
            assert (np.asarray(jy) == want.numpy()).all()


def _geometry_cases():
    """(b, h_out, w_out, c_in, c_out, kh, spec, w_k, w_i): every UltraNet
    conv shape at 416x416, batch 8, and at 32x32, batch 2, on the four
    W4A4 plans, the 416x416 ones also on the widest taps of DSP58 (four
    slices); the card tests' shapes."""
    cases = []
    for size, b in ((416, 8), (32, 2)):
        for s in JU.ultranet_layer_shapes(size, size):
            for spec in SPECS:
                cases.append((b, s["h"], s["w"], s["cin"], s["cout"], s["k"],
                              spec, 4, 4))
            if size == 416:
                cases.append((b, s["h"], s["w"], s["cin"], s["cout"], s["k"],
                              "dsp58", 26, 1))
    for c_in, c_out, k, h, w in ((3, 16, 3, 13, 40), (16, 37, 3, 9, 21),
                                 (64, 36, 1, 7, 26), (5, 8, 5, 6, 11),
                                 (160, 24, 3, 5, 19), (40, 70, 3, 5, 19),
                                 (64, 64, 3, 26, 26)):
        cases.append((2, h, w, c_in, c_out, k, "int32", 4, 4))
        cases.append((2, h, w, c_in, c_out, k, "dsp58", 12, 4))
    return cases


@pytest.mark.parametrize("b,h,w,c_in,c_out,kh,spec,wk,wi", _geometry_cases())
def test_launch_geometry_covers_every_output_once(b, h, w, c_in, c_out, kh,
                                                  spec, wk, wi):
    """Replays the kernel's walk: block (x, y) owns channels x N .. x N + N
    and the pixel tiles y, y + grid_y, ...; tile t's pixel m (in m16
    tile m // 16 of warp m // 16 % 8) is output (t's row + m // tc, t's
    column + m % tc) when inside the frame.  Every
    (pixel, channel) is written exactly once; the tiles fit the kernel's
    limits and shared memory; on 132 SMs the work covers the card where
    the shape allows it."""
    sms = 132
    plan = tdp.plan_bseg(tdp.DATAPATHS[spec], wk, wi)
    taps = -(-kh // plan.n_k) * plan.n_k
    geo = tconv.launch_shape(b, h, w, c_in, c_out, kh, taps,
                             tconv.tap_slices(plan), sms=sms)
    assert geo.n_tile in (8, 16, 32, 64) and geo.mt in (1, 2, 4)
    assert geo.mt * geo.n_tile <= tconv.MAX_N_TILE
    assert 16 * tconv.WARPS * geo.mt // 2 < geo.tr * geo.tc \
        <= 16 * tconv.WARPS * geo.mt or geo.mt == 1
    assert geo.cc in (16, 32, 64) and geo.cc <= tconv.MAX_CHANNEL_CHUNK
    assert geo.smem <= tconv.MAX_SHARED_BYTES
    assert geo.smem == tconv.smem_bytes(geo.n_tile, geo.tr, geo.tc, geo.cc,
                                        kh, taps, tconv.tap_slices(plan))
    tiles_x, tiles_y, n_tiles = geo.tiles
    assert tiles_x * geo.tc >= w > (tiles_x - 1) * geo.tc
    assert tiles_y * geo.tr >= h > (tiles_y - 1) * geo.tr
    assert n_tiles == b * tiles_x * tiles_y
    co_tiles, grid_y = geo.grid
    assert co_tiles * geo.n_tile >= c_out > (co_tiles - 1) * geo.n_tile
    assert 1 <= grid_y <= n_tiles
    # pixel tiles walked by the blocks of one channel tile
    walked = torch.cat([torch.arange(y, n_tiles, grid_y)
                        for y in range(grid_y)])
    assert torch.equal(walked.sort().values, torch.arange(n_tiles))
    # pixels of each tile
    t = walked[:, None]
    m = torch.arange(geo.tr * geo.tc)[None, :]
    bb = t // (tiles_x * tiles_y)
    yy = (t // tiles_x) % tiles_y * geo.tr + m // geo.tc
    xx = t % tiles_x * geo.tc + m % geo.tc
    inside = (yy < h) & (xx < w)
    cover = torch.zeros(b * h * w, dtype=torch.int64)
    cover.index_add_(0, ((bb * h + yy) * w + xx)[inside],
                     torch.ones(int(inside.sum()), dtype=torch.int64))
    assert (cover == 1).all()
    # channels: the channel tiles partition [0, C_out)
    chans = torch.arange(co_tiles * geo.n_tile)
    assert ((chans < c_out).sum() == c_out)
    if n_tiles * co_tiles < 2 * sms:        # too few items for the card:
        assert geo.tr == 1 and geo.n_tile <= 16     # the tiles went small


def test_launch_geometry_refuses_what_does_not_fit():
    """A kernel row of taps too long for shared memory at every tile
    raises (the wrapper's only refusal beyond ``check_operands``)."""
    with pytest.raises(ValueError, match="shared memory"):
        tconv.launch_shape(1, 4, 4, 64, 8, 64, 64, 4, sms=132)


def test_wide_taps_on_the_cpu_path():
    """``bseg_conv2d`` takes taps wider than 8 bits (the CPU tensor runs
    the plain version) and ``packed_conv2d`` stays exact on them."""
    from repro_torch.kernels import ref as tref
    plan = tdp.plan_bseg(tdp.DATAPATHS["dsp58"], 12, 4)
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.integers(0, 16, (2, 5, 7, 6)))
    taps = torch.tensor(_taps(rng, 12, 5, 6, 3, 3))
    y = tops.packed_conv2d(x, taps, plan=plan, mode="bseg_conv2d")
    assert torch.equal(y, tref.conv2d_int_ref(x, taps))
