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
- operands wider than 8 bits (fault C1): the byte slices of the decoded
  lanes and of the activations, shifted together mod 2^32, give the
  exact product, and ``sdv_matmul``, ``sdv_matvec`` and
  ``ops.packed_matmul(plan=...)`` equal the reference's on such plans;
- the operand types and flags;
- B2's wgmma kernel at many rows: its persistent launch and tile layout
  (``wgmma_slot_channels``) cover every output once at the main paths'
  shapes, and ``takes_wgmma`` gives it exactly the single-limb calls
  within 8 bits at or above ``WGMMA_MIN_ROWS`` rows.

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


def _lo32(a):
    """The low 32 bits of int64 values, as int32 (an int64 product that
    wraps keeps them)."""
    return (np.asarray(a, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32) \
        .view(np.int32)


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


#: the wgmma kernel's launches on the main paths at many rows (rows, K,
#: M, n): llava-next-mistral-7b's projections (q/o, k/v, gate/up, down)
#: at a prefill chunk's 4096 rows, recurrentgemma-2b's and mamba2-130m's
#: at their SDV ``forward``'s 2 x 2048, the UltraNet head's im2col GEMM,
#: and ragged rows and word columns
_LLAVA = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
_WGMMA_CASES = (
    [(4096, k, m, 2) for k, m in _LLAVA + _RGEMMA + _MAMBA2]
    + [_HEAD + (3,), (1100, 700, 296, 2), (8192, 64, 40, 10),
       (1300, 136, 200, 1), (tmm.WGMMA_MIN_ROWS, 4096, 4096, 2)])


@pytest.mark.parametrize("rows,k,m,n", _WGMMA_CASES)
def test_wgmma_geometry_covers_every_output_once(rows, k, m, n):
    """Replays the wgmma kernel's persistent tile walk and its epilogue
    indexing: the blocks walk every tile once, the tiles are the product
    of the row tiles (each row once) and the column tiles, whose
    warpgroups store each channel once in ``wgmma_slot_channels``'
    order, so each (row, channel) of [rows, G, n] is stored exactly once;
    the stages tile [0, K); the ring fits shared memory."""
    sms = 132
    g = -(-m // n)
    assert tmm.takes_wgmma(rows, g, tdp.plan_sdv(tdp.DATAPATHS["int32"], 4,
                                                  8, signed_a=True,
                                                  signed_b=True,
                                                  park_sign_bits=True))
    geo = tmm.wgmma_geometry(rows, k, g, n, sms=sms)
    bgw = geo.bgw
    assert bgw % 4 == 0 and n * bgw <= tmm.WGMMA_SLOTS
    assert 2 <= geo.stages <= tmm.WGMMA_MAX_STAGES
    assert tmm.wgmma_smem_bytes(bgw, geo.stages) <= tmm.SMEM_LIMIT
    assert geo.k_stages * tmm.WGMMA_TILE_K >= k \
        > (geo.k_stages - 1) * tmm.WGMMA_TILE_K
    tiles = geo.row_tiles * geo.col_tiles
    assert geo.grid == min(tiles, sms)
    walked = sorted(t for b in range(geo.grid)
                    for t in range(b, tiles, geo.grid))
    assert walked == list(range(tiles))
    pairs = {(t % geo.row_tiles, t // geo.row_tiles) for t in walked}
    assert len(pairs) == tiles and max(ct for _, ct in pairs) \
        == geo.col_tiles - 1
    cover_r = torch.zeros(rows, dtype=torch.int32)
    for rt in range(geo.row_tiles):
        cover_r[rt * tmm.WGMMA_ROWS:(rt + 1) * tmm.WGMMA_ROWS] += 1
    assert (cover_r == 1).all()
    slots = tmm.wgmma_slot_channels(g, n).reshape(-1, tmm.WGMMA_SLOTS)
    cover_c = torch.zeros(g * n, dtype=torch.int32)
    slot = torch.arange(tmm.WGMMA_SLOTS)
    for ct in range(geo.col_tiles):
        for c in range(tmm.WGMMA_CONSUMERS):
            ch = (ct * tmm.WGMMA_CONSUMERS * bgw + c * bgw) * n + slot
            ok = (slot < n * bgw) & (ch < g * n)
            wg = ct * tmm.WGMMA_CONSUMERS + c
            assert torch.equal(slots[wg], torch.where(ok, ch, -1))
            cover_c[ch[ok]] += 1
    assert (cover_c == 1).all()


#: (spec, w_a, w_b, signed_a, signed_b, n, rows, g): whether B2 takes the
#: wgmma kernel: the serve plan at the crossover and one row below it,
#: every signedness, n = 1 and the most lanes, the im2col head; never
#: the two-limb words (the verify and QAT plan dsp48e2 n=3 at 512 and
#: 4096 rows, DSP58), byte-sliced lanes or activations, word columns
#: that are no 16-byte row, or the rounding FP32M datapath
_KERNEL_CHOICE = [
    ("int32", 4, 8, True, True, None, tmm.WGMMA_MIN_ROWS, 2048, True),
    ("int32", 4, 8, True, True, None, tmm.WGMMA_MIN_ROWS - 1, 2048, False),
    ("int32", 4, 8, True, True, None, 4096, 7168, True),
    ("int32", 4, 8, True, True, None, 32, 7168, False),
    ("int32", 4, 8, True, False, None, 4096, 512, True),
    ("int32", 8, 8, False, True, None, 4096, 512, True),
    ("int32", 8, 8, False, False, None, 4096, 512, True),
    ("int32", 8, 8, True, True, 1, 4096, 512, True),
    ("int32", 2, 2, False, True, None, 4096, 512, True),
    ("int32", 4, 5, True, True, None, 5408, 12, True),
    ("int32", 4, 8, True, True, None, 4096, 7170, False),
    ("dsp48e2", 4, 8, True, True, None, 512, 2048, False),
    ("dsp48e2", 4, 8, True, True, None, 4096, 2048, False),
    ("dsp58", 4, 4, True, True, None, 4096, 2048, False),
    ("int32", 4, 9, True, True, None, 4096, 2048, False),
    ("int32", 9, 3, False, True, None, 4096, 2048, False),
    ("fp32m", 4, 4, True, True, None, 4096, 2048, False),
]


@pytest.mark.parametrize("spec,wa,wb,signed_a,signed_b,n,rows,g,wgmma",
                         _KERNEL_CHOICE)
def test_b2_kernel_choice(spec, wa, wb, signed_a, signed_b, n, rows, g,
                          wgmma):
    """``takes_wgmma`` gives B2's wgmma kernel exactly the single-limb,
    unsliced calls at or above ``WGMMA_MIN_ROWS`` rows; the activation
    container a quantizer casts to follows it (``ops.sdv_operand_dtype``:
    one byte there, int32 elsewhere), and the dispatch table's route
    stays the reference's ``sdv_matmul`` (the planner reads it)."""
    kw = {} if n is None else dict(n=n)
    tplan = tdp.plan_sdv(tdp.DATAPATHS[spec], wa, wb, signed_a=signed_a,
                         signed_b=signed_b, park_sign_bits=signed_a, **kw)
    assert tmm.takes_wgmma(rows, g, tplan) == wgmma
    byte = torch.int8 if signed_b else torch.uint8
    words = torch.zeros((64, g), dtype=torch.int32)
    assert tops.sdv_operand_dtype(rows, words, tplan) == (byte if wgmma
                                                          else torch.int32)
    if spec != "fp32m":
        jplan, _ = _plans(spec, wa, wb, signed_a, signed_b, **kw)
        assert tops.select_packed_route(rows, plan=tplan, explain=True) \
            == jops.select_packed_route(rows, plan=jplan, explain=True)


@pytest.mark.parametrize("signed_b", [True, False])
@pytest.mark.parametrize("k", [64, 37])
def test_wgmma_operand_and_byte_activations(k, signed_b):
    """The wgmma kernel's activations: the plan's byte container, K padded
    with zeros to 16-byte rows; ``sdv_matmul`` and ``packed_matmul`` on
    the CPU take that container as they take int32 (the exact product),
    and refuse it on a plan whose activations need byte slices."""
    _, tplan = _plans("int32", 4, 8, True, signed_b)
    rng = np.random.default_rng(k)
    rows, m = tmm.WGMMA_MIN_ROWS, 8
    w = _ints(True, 4, (m, k), rng)
    x = _ints(signed_b, 8, (rows, k), rng)
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    x8 = tmm.wgmma_operand(torch.tensor(x, dtype=torch.int32), tplan)
    assert x8.dtype == tmm.byte_dtype(tplan)
    assert x8.shape == (rows, -(-k // 16) * 16)
    assert (x8[:, :k].to(torch.int64).numpy() == x).all()
    assert (x8[:, k:] == 0).all()
    want = x @ w.T
    y = tmm.sdv_matmul(torch.tensor(x).to(x8.dtype), tw, plan=tplan)
    assert (y.reshape(rows, -1)[:, :m].numpy() == want).all()
    y = tops.packed_matmul(torch.tensor(x), tw, plan=tplan, m=m)
    assert (y.numpy() == want).all()
    _, wide = _plans("int32", 4, 9, True, True)
    with pytest.raises(ValueError, match="activations must be"):
        tmm.check_operands(x8, tops.prepare_sdv_weights(torch.tensor(w),
                                                        wide), wide,
                           k_axis=1)


#: plans wider than int8 (fault C1), all signed, sign bits parked: the
#: planner's w_b = a_bits + 1 (W4A9, W8A9) and W4A16 on every exact-wrap
#: word, and the widest w_a = w_b plan_sdv admits on each (15, 23, 26)
_C1_PLANS = [(s, wa, wb) for s in SPECS
             for wa, wb in ((4, 9), (8, 9), (4, 16))]
_WIDEST_SDV = [("int32", 15, 15), ("dsp48e2", 23, 23), ("dsp58", 26, 26)]


@pytest.mark.parametrize("spec,wa,wb", _WIDEST_SDV)
def test_widest_square_plans(spec, wa, wb):
    """``_WIDEST_SDV`` is the widest w_a = w_b plan each word admits."""
    word = tdp.DATAPATHS[spec].w_word

    def fits(w):
        try:
            plan = tdp.plan_sdv(tdp.DATAPATHS[spec], w, w, signed_a=True,
                                signed_b=True, park_sign_bits=True)
        except ValueError:
            return False
        return plan.packed_width + plan.n <= word
    assert wa == wb and fits(wa) and not fits(wa + 1)


@pytest.mark.parametrize("spec,wa,wb", _C1_PLANS + _WIDEST_SDV)
def test_wide_operands_match_the_reference(spec, wa, wb):
    """Fault C1, repaired: ``sdv_matmul`` and ``sdv_matvec`` (their plain
    versions on the CPU) and ``ops.packed_matmul(plan=...)`` give the
    reference's ``packed_matmul`` and ``x @ w.T`` (mod 2^32) at 3 rows, K
    = 33, M = 2n + 1, numpy seed 0, operands at their full widths; the
    route is the reference's."""
    jplan, tplan = _plans(spec, wa, wb, True, True)
    rng = np.random.default_rng(0)
    m, k, rows = 2 * tplan.n + 1, 33, 3
    w = _ints(True, wa, (m, k), rng)
    x = _ints(True, wb, (rows, k), rng)
    want = _lo32(x @ w.T)
    jw = jops.prepare_sdv_weights(jnp.asarray(w), jplan)
    assert jops.select_packed_route(rows, plan=jplan) \
        == tops.select_packed_route(rows, plan=tplan)
    jy = np.asarray(jops.packed_matmul(jnp.asarray(x), jw, plan=jplan, m=m))
    assert (jy == want).all()
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    assert (np.asarray(jw) == tw.numpy()).all()
    xt = torch.tensor(x, dtype=torch.int32)
    ty = tops.packed_matmul(torch.tensor(x), tw, plan=tplan, m=m)
    assert (ty.numpy() == jy).all()
    for y in (tmm.sdv_matmul(xt, tw, plan=tplan),
              tmv.sdv_matvec(xt.T.contiguous(), tw, plan=tplan)):
        assert (y.reshape(rows, -1)[:, :m].numpy() == want).all()


def _wide_sliced_keys():
    keys = [(s, wa, wb, True, True) for s, wa, wb in _C1_PLANS + _WIDEST_SDV]
    keys += [("dsp58", 12, 20, False, False), ("int32", 9, 3, False, True),
             ("int32", 30, 1, True, True), ("dsp58", 26, 31, True, False)]
    return keys


@pytest.mark.parametrize("spec,wa,wb,signed_a,signed_b", _wide_sliced_keys())
def test_byte_slices_give_the_exact_product(spec, wa, wb, signed_a,
                                            signed_b):
    """The kernels' sliced premise: every slice pair (ia, ib), ia + ib <=
    3, the int8 product of lane byte ia (``decode_lanes_plain``) and
    activation byte ib (``activation_slice_plain``), shifted left 8 (ia +
    ib) bits and summed mod 2^32, == x @ w.T mod 2^32, in the kernels'
    slot order; the top slice of a signed operand is int8, every other
    uint8; the slice counts and pairs reach the kernels through the
    flags."""
    jplan, tplan = _plans(spec, wa, wb, signed_a, signed_b)
    rng = np.random.default_rng(wa * 100 + wb)
    m, k, rows = 3 * tplan.n + 1, 70, 5
    w = _ints(signed_a, wa, (m, k), rng)
    x = _ints(signed_b, wb, (rows, k), rng)
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    sa, sb = tmm.slice_counts(tplan)
    assert (sa, sb) == (min(4, -(-wa // 8)), min(4, -(-wb // 8)))
    pairs = tmm.slice_pairs(tplan)
    assert pairs == [(i, j) for i in range(sa) for j in range(sb)
                     if i + j <= 3]
    flags = tmm.plan_flags(tplan)
    assert (flags >> tmm._SLICES_A & 3, flags >> tmm._SLICES_B & 3) \
        == (sa - 1, sb - 1)
    chan = tmm.slot_channels(tw.shape[-1], tplan.n)
    total = torch.zeros((rows, chan.numel()), dtype=torch.int64)
    for ia, ib in pairs:
        a = tmm.decode_lanes_plain(tw, tplan, ia)
        b = tmm.activation_slice_plain(torch.tensor(x), tplan, ib)
        assert a.dtype == (torch.int8 if signed_a and ia == sa - 1
                           else torch.uint8)
        assert b.dtype == (torch.int8 if signed_b and ib == sb - 1
                           else torch.uint8)
        total += (b.to(torch.int64) @ a.to(torch.int64).T) << 8 * (ia + ib)
    got = torch.zeros((rows, tw.shape[-1] * tplan.n), dtype=torch.int64)
    got[:, chan[chan >= 0]] = total[:, chan >= 0]
    assert (_lo32(got[:, :m].numpy()) == _lo32(x @ w.T)).all()


@pytest.mark.parametrize("signed_a", [True, False])
@pytest.mark.parametrize("wa", [9, 12, 16, 23])
def test_decode_lanes_slices_match_unpack_ref(wa, signed_a):
    """Each byte slice of ``decode_lanes_plain`` holds byte j of the
    lanes ``sdv_unpack_words_ref`` decodes (both packages), on the wide
    DSP58 word, its padding slots 0."""
    jplan, tplan = _plans("dsp58", wa, 4, signed_a, True)
    rng = np.random.default_rng(wa)
    m, k = 2 * tmm.TILE_M + tplan.n + 1, 21
    w = _ints(signed_a, wa, (m, k), rng)
    tw = tops.prepare_sdv_weights(torch.tensor(w), tplan)
    jw = jops.prepare_sdv_weights(jnp.asarray(w), jplan)
    want = tref.sdv_unpack_words_ref(tw, plan=tplan).to(torch.int64)
    assert (np.asarray(jref.sdv_unpack_words_ref(jw, plan=jplan))
            == want.numpy()).all()
    chan = tmm.slot_channels(tw.shape[-1], tplan.n)
    used = chan >= 0
    sa = tmm.slice_counts(tplan)[0]
    for j in range(sa):
        a = tmm.decode_lanes_plain(tw, tplan, j)
        assert ((a[used].to(torch.int64) & 0xFF)
                == (want.T[chan[used]] >> 8 * j) & 0xFF).all()
        assert (a[~used] == 0).all()


def test_wide_launch_geometry():
    """A sliced launch: the grid's z axis runs over K splits x slice
    pairs, and the K split aims at the same blocks per SM."""
    plan = tdp.plan_sdv(tdp.DATAPATHS["dsp58"], 26, 26, signed_a=True,
                        signed_b=True, park_sign_bits=True)
    pairs = len(tmm.slice_pairs(plan))
    assert pairs == 10
    one = tmm.launch_geometry(8, 2048, 256, plan.n, gemv=True, sms=132)
    geo = tmm.launch_geometry(8, 2048, 256, plan.n, gemv=True, sms=132,
                              pairs=pairs)
    splits = -(-2048 // geo.chunk)
    assert geo.grid == (one.grid[0], one.grid[1], splits * pairs)
    assert splits <= -(-2048 // one.chunk)
    assert geo.grid[0] * geo.grid[1] * geo.grid[2] >= 132 * \
        tmm.GEMV_BLOCKS_PER_SM
