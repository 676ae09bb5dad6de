"""The premise and the host side of the SDV tensor-core kernels (B1
``sdv_matvec``, B2 ``sdv_matmul``, ``csrc/sdv.cu``), on the CPU.

The kernels decode each storage word once into its n lanes as int8 and
multiply them on the int8 tensor cores.  What lets that equal the
paper's packed arithmetic bit for bit is checked here without a card:

- the decode (``sdv_matmul.decode_lanes_plain``, the kernels' decode and
  A-tile layout) equals the reference's ``sdv_unpack_words_ref`` in both
  packages, on every word form and width;
- the JAX ``sdv_matmul`` kernel (interpret mode) equals ``x @ w.T`` on
  every signedness of weights and activations, so an exact int8 product
  of the decoded lanes is the same function;
- the launch geometry covers every output once, at every projection
  shape of the main paths;
- the int8 operand gate and the operand types.

The kernels themselves are held against ``sdv_matmul_plain`` and the
exact product on the card in ``test_torch_kernels_cuda``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import datapath as jdp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.sdv_matmul import sdv_matmul as j_sdv_matmul

from repro_torch.core import datapath as tdp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sdv_matmul as tmm
from repro_torch.kernels import sdv_matvec as tmv

SPECS = ("int32", "dsp48e2", "dsp58")


def _plans(spec, wa, wb, sa, sb, **kw):
    """The same plan from both packages (sign bits parked for signed
    storage, as the serve and conv paths build them)."""
    kw.update(signed_a=sa, signed_b=sb, park_sign_bits=sa)
    return (jdp.plan_sdv(jdp.DATAPATHS[spec], wa, wb, **kw),
            tdp.plan_sdv(tdp.DATAPATHS[spec], wa, wb, **kw))


def _ints(lo_hi_signed, bits, shape, rng):
    if lo_hi_signed:
        return rng.integers(-(1 << bits - 1), 1 << bits - 1, shape)
    return rng.integers(0, 1 << bits, shape)


def _check_decode(jplan, tplan, m, k, seed):
    rng = np.random.default_rng(seed)
    w = _ints(tplan.signed_a, tplan.w_a, (m, k), rng)
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    jw = np.asarray(jops.prepare_sdv_weights(jnp.asarray(w), jplan))
    assert (jw == tw.numpy()).all()
    g = tw.shape[-1]
    want = tref.sdv_unpack_words_ref(tw, plan=tplan)            # [K, G n]
    assert (np.asarray(jref.sdv_unpack_words_ref(jnp.asarray(jw),
                                                 plan=jplan))
            == want.numpy()).all()
    assert (want[:, :m].numpy() == w.T).all()
    a = tmm.decode_lanes_plain(tw, tplan)
    assert a.dtype == (torch.int8 if tplan.signed_a else torch.uint8)
    chan = tmm.slot_channels(g, tplan.n)
    assert a.shape == (chan.numel(), k)
    used = chan >= 0
    assert (a[used].to(torch.int32) == want.T[chan[used]]).all()
    assert (a[~used] == 0).all()
    # every channel of every group has exactly one slot
    assert sorted(chan[used].tolist()) == list(range(g * tplan.n))


@pytest.mark.parametrize("signed_a", [True, False])
@pytest.mark.parametrize("wb", [2, 8])
@pytest.mark.parametrize("wa", range(2, 9))
@pytest.mark.parametrize("spec", SPECS)
def test_decode_lanes_matches_unpack_ref(spec, wa, wb, signed_a):
    """The kernels' decode == ``sdv_unpack_words_ref`` (port and JAX) at
    every w_a on every word form, signed and unsigned storage; w_b = 2
    gives each word its most lanes (n = 10 on the INT32 word at w_a = 2,
    unsigned: the largest n ``plan_sdv`` yields for w_a, w_b <= 8), w_b
    = 8 its fewest.  M spans several blocks and ends in a partial group;
    K is ragged."""
    jplan, tplan = _plans(spec, wa, wb, signed_a, True)
    _check_decode(jplan, tplan, 2 * tmm.TILE_M + 3 * tplan.n + 1, 37,
                  seed=wa * 10 + wb)


@pytest.mark.parametrize("signed_a", [True, False])
@pytest.mark.parametrize("spec", SPECS)
def test_decode_lanes_one_lane(spec, signed_a):
    """n = 1, the smallest n (``plan_sdv(..., n=1)``): one lane per word,
    64 word columns per block."""
    jplan, tplan = _plans(spec, 8, 8, signed_a, True, n=1)
    assert tplan.n == 1 and tmm.block_groups(1) == tmm.MAX_GROUPS
    _check_decode(jplan, tplan, 150, 70, seed=1)


def test_largest_lane_count_is_within_the_kernels():
    """No plan ``plan_sdv`` yields for w_a, w_b <= 8 has more lanes than
    the kernels take (n = 15 is never reached; 10 is the largest)."""
    ns = [tdp.plan_sdv(tdp.DATAPATHS[s], wa, wb, signed_a=sa, signed_b=sb,
                       park_sign_bits=sa).n
          for s in SPECS for wa in range(2, 9) for wb in range(2, 9)
          for sa in (True, False) for sb in (True, False)]
    assert max(ns) == 10 <= tmm.MAX_LANES
    assert tmm.block_groups(max(ns)) * max(ns) <= tmm.TILE_M


@pytest.mark.parametrize("signed_b", [True, False])
@pytest.mark.parametrize("signed_a", [True, False])
def test_operand_types(signed_a, signed_b):
    """``.s8`` for signed, ``.u8`` for unsigned decoded lanes and
    activations; the kernel flags carry the same choice."""
    for spec in SPECS:
        _, plan = _plans(spec, 8, 8, signed_a, signed_b)
        a, b = tmm.mma_types(plan)
        assert a == ("s8" if signed_a else "u8")
        assert b == ("s8" if signed_b else "u8")
        flags = tmm.plan_flags(plan)
        assert bool(flags & tmm._SIGNED_A) == signed_a
        assert bool(flags & tmm._SIGNED_B) == signed_b
        assert bool(flags & tmm._TWO_LIMB) == (spec != "int32")


#: (spec, w_a, w_b, n or None): w = 2 and w = 8 on each word, the
#: largest n (INT32 2x2: 10 unsigned, 8 signed; DSP 2x2: 9) and n = 1;
#: each runs with every signedness of weights and activations
_PREMISE = [("int32", 2, 2, None), ("int32", 8, 8, None),
            ("int32", 2, 8, None), ("dsp48e2", 2, 2, None),
            ("dsp48e2", 8, 8, None), ("dsp58", 8, 2, None),
            ("dsp58", 2, 8, None)]
_PREMISE_KEYS = [(s, wa, wb, n, sa, sb) for s, wa, wb, n in _PREMISE
                 for sa in (True, False) for sb in (True, False)] \
    + [("int32", 8, 8, 1, True, True), ("dsp48e2", 8, 8, 1, False, False)]


@pytest.mark.parametrize("spec,wa,wb,n,signed_a,signed_b", _PREMISE_KEYS)
def test_packed_arithmetic_is_the_exact_product(spec, wa, wb, n, signed_a,
                                                signed_b):
    """The reference's SDV kernel (interpret mode) == x @ w.T at 11 rows,
    K = 64, M = 3n + 1, and so does the int8 product of the decoded lanes
    in the kernels' slot order: the tensor-core kernels compute what the
    TPU kernel computes."""
    kw = {} if n is None else dict(n=n)
    jplan, tplan = _plans(spec, wa, wb, signed_a, signed_b, **kw)
    m, k, rows = 3 * tplan.n + 1, 64, 11
    rng = np.random.default_rng(wa * 100 + wb * 10 + tplan.n)
    w = _ints(signed_a, wa, (m, k), rng)
    x = _ints(signed_b, wb, (rows, k), rng)
    want = x @ w.T
    jw = jops.prepare_sdv_weights(jnp.asarray(w), jplan)
    jl = np.asarray(j_sdv_matmul(jnp.asarray(x, jnp.int32), jw, plan=jplan,
                                 br=8, bg=4, bk=32, interpret=True))
    assert (jl.reshape(rows, -1)[:, :m] == want).all()
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    a = tmm.decode_lanes_plain(tw, tplan).to(torch.int64)
    chan = tmm.slot_channels(tw.shape[-1], tplan.n)
    y = torch.tensor(x) @ a.T                       # [rows, slots]
    got = torch.zeros((rows, tw.shape[-1] * tplan.n), dtype=torch.int64)
    got[:, chan[chan >= 0]] = y[:, chan >= 0]
    assert (got[:, :m].numpy() == want).all()
    assert (jl.reshape(rows, -1) == got.numpy()).all()


#: the main paths' projection shapes (K, M): tinyllama-1.1b's q/o, k/v,
#: gate/up and down; the packed mamba2-130m and recurrentgemma-2b trees'
#: (as ``serve_params(compute="sdv", min_size=1024)`` packs them)
_TINYLLAMA = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048)]
_MAMBA2 = [(768, 24), (768, 256), (768, 1536), (1536, 768)]
_RGEMMA = [(2560, 256), (2560, 2560), (2560, 7680), (7680, 2560)]
#: the UltraNet-INT4 1x1 head on its im2col plan: 8 x 26 x 26 rows,
#: K = 64, M = 36
_HEAD = (5408, 64, 36)
_GEOMETRY_CASES = (
    [("B1", 8, k, m, 2) for k, m in _TINYLLAMA + _MAMBA2 + _RGEMMA]
    + [("B1", 1, k, m, 3) for k, m in _TINYLLAMA]
    + [("B2", r, k, m, n) for k, m in _TINYLLAMA for r, n in ((128, 2),
                                                               (128, 3),
                                                               (9, 2))]
    + [("B2", _HEAD[0], _HEAD[1], _HEAD[2], 3),
       ("B2", 77, 17, 40, 5), ("B2", 300, 33, 301, 10),
       ("B1", 3, 33, 301, 1)])


@pytest.mark.parametrize("kname,rows,k,m,n", _GEOMETRY_CASES)
def test_launch_geometry_covers_every_output_once(kname, rows, k, m, n):
    """Replays the kernel's epilogue indexing block by block: each (row,
    channel) of [rows, G, n] is written by exactly one block of each K
    split, the splits tile [0, K) in whole stages, and the tiles fit the
    kernel's limits; on 132 SMs the grid fills the card where the shape
    allows it."""
    sms = 132
    g = -(-m // n)
    gemv = kname == "B1"
    geo = tmm.launch_geometry(rows, k, g, n, gemv=gemv, sms=sms)
    bg = geo.bg
    assert bg % 4 == 0 and 4 <= bg <= tmm.MAX_GROUPS
    assert n * bg <= tmm.TILE_M
    assert geo.row_tile == (tmm.GEMV_MAX_ROWS if gemv else tmm.GEMM_ROWS)
    assert geo.chunk % tmm.TILE_K == 0
    gx, gy, gz = geo.grid
    # K: the splits start at z * chunk, end at min(K, (z + 1) chunk)
    starts = [z * geo.chunk for z in range(gz)]
    assert starts[0] == 0 and all(s < k for s in starts)
    assert gz * geo.chunk >= k > (gz - 1) * geo.chunk
    # outputs: slot i * bg + gl of block x is lane i of group x bg + gl
    cover = torch.zeros((rows, g * n), dtype=torch.int32)
    slot = torch.arange(tmm.TILE_M)
    i, gl = slot // bg, slot % bg
    for bx in range(gx):
        grp = bx * bg + gl
        ok = (slot < n * bg) & (grp < g)
        chans = (grp * n + i)[ok]
        for by in range(gy):
            r0 = by * geo.row_tile
            r1 = min(rows, r0 + geo.row_tile)
            cover[r0:r1, chans] += 1
    assert (cover == 1).all()
    blocks = gx * gy * gz
    per_sm = tmm.GEMV_BLOCKS_PER_SM if gemv else tmm.GEMM_BLOCKS_PER_SM
    if gx * gy < sms * per_sm and k >= 2 * tmm.TILE_K:
        assert gz > 1                      # split-K where the grid is small
    assert blocks <= max(gx * gy, 2 * sms * per_sm)


@pytest.mark.parametrize("wa,wb", [(9, 4), (4, 9), (12, 3)])
def test_operands_wider_than_int8_are_refused(wa, wb):
    """``check_operands``: the kernels' int8 operands need w_a, w_b <= 8,
    on the CPU path too."""
    plan = tdp.plan_sdv(tdp.DATAPATHS["dsp58"], wa, wb, signed_a=True,
                        signed_b=True, park_sign_bits=True)
    w = tops.prepare_sdv_weights(torch.ones(2 * plan.n, 16,
                                            dtype=torch.int64), plan)
    with pytest.raises(ValueError, match="int8"):
        tmm.sdv_matmul(torch.ones(3, 16, dtype=torch.int32), w, plan=plan)
    with pytest.raises(ValueError, match="int8"):
        tmv.sdv_matvec(torch.ones(16, 3, dtype=torch.int32), w, plan=plan)
