"""The fused unpack-and-dequantize (kernel B7 as memory-mode serving runs
it, ``packbits.unpack_dequant``) against the JAX package's
``repro.models.quantized.materialize``, which unpacks, scales, trims and
casts in jnp.

Same inputs (numpy, from seeds) go through both packages.  On the CPU the
wrapper runs its plain version, ``unpack_dequant_plain``; its output and
``materialize``'s must equal the reference's bit for bit at every lane
width, for 2-D and stacked containers, a ``d_out`` that is not a
multiple of ``32 // w``, bfloat16 and float32, and on edge scales
(a subnormal, products on a bf16 rounding tie, products that overflow)
with the largest fields of both signs.  The kernel's launch shape is
replayed here (every output written once); the kernel itself is held
against the plain version in ``test_torch_kernels_cuda``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import quantized as jquant

import repro_torch.models as tm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import packbits as tpack

WIDTHS = (2, 3, 4, 5, 6, 7, 8)
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "f32": (torch.float32, jnp.float32)}
#: 2-D and stacked kernels, d_out a multiple of 32 // w for some w (96)
#: and for none (37)
SHAPES = [(64, 96), (3, 64, 96), (48, 37), (2, 40, 37)]
#: (K, N) of tinyllama-1.1b's memory-packed projections and LM head
TINYLLAMA = [(2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
             (2048, 32000)]


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy()
    return t.contiguous().view(torch.int32).numpy()


def _same(j, t: torch.Tensor) -> bool:
    """Bit-identical (bf16 and float32 compared by bit pattern)."""
    a = np.asarray(j)
    a = a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a.view(
        np.int32)
    return a.shape == tuple(t.shape) and (a == _bits(t)).all()


def _torch_container(jp) -> tm.PackedLinear:
    return tm.PackedLinear(words=torch.tensor(np.asarray(jp.words)),
                           scale=torch.tensor(np.asarray(jp.scale)),
                           bits=jp.bits, d_out=jp.d_out)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("w", WIDTHS)
def test_materialize_matches_reference(w, shape, dt):
    """``materialize`` (one ``unpack_dequant`` call for the whole stack)
    and ``unpack_dequant_plain`` on the same words and scales give the
    reference's ``materialize`` bit for bit."""
    tdt, jdt = DTYPES[dt]
    rng = np.random.default_rng(w * 10 + len(shape))
    kernel = (rng.standard_normal(shape) * 0.05).astype(ml_dtypes.bfloat16)
    jp = jquant.pack_linear(jnp.asarray(kernel), w)
    want = jquant.materialize(jp, jdt)
    tp = _torch_container(jp)
    calls = tpack.unpack_dequant_plain.calls
    dense = tm.materialize(tp, tdt)
    assert tpack.unpack_dequant_plain.calls == calls + 1
    assert dense.dtype == tdt and _same(want, dense)
    nw = tp.words.shape[-1]
    flat = tpack.unpack_dequant_plain(
        tp.words.reshape(-1, nw), tp.scale.reshape(-1, tp.scale.shape[-1]),
        w=w, d_out=tp.d_out, rows_per_scale=shape[-2], dtype=tdt)
    assert _same(np.asarray(want).reshape(-1, shape[-1]), flat)
    # the port's own packing gives the same words, so the same weights
    tk = tm.params_from_numpy({"k": kernel}, device="cpu")["k"]
    assert torch.equal(tm.materialize(tm.pack_linear(tk, w), tdt), dense)


def _edge_container(w: int, d_in: int, d_out: int, layers: int):
    """Words whose fields run over every w-bit value, the largest of both
    signs in every row, and scales with a subnormal column, two columns
    whose products with +-1, +-2, +-4 fall on a bf16 rounding tie (one
    rounds down to even, one up), and one whose products overflow."""
    per = 32 // w
    n_pad = -(-d_out // per) * per
    rng = np.random.default_rng(w)
    half = 1 << (w - 1)
    q = rng.integers(-half, half, (layers, d_in, n_pad))
    q[:, 0::2, :4] = [-half, half - 1, 1, -2]
    q[:, 1::2, :4] = [half - 1, -half, -4, -1]
    scale = rng.uniform(0.001, 0.1, (layers, 1, n_pad)).astype(np.float32)
    scale[..., 0] = 9e-41                      # subnormal, as q x it
    scale[..., 1] = 1 + 2.0 ** -8              # 1 x: tie, to even (down)
    scale[..., 2] = 1 + 3 * 2.0 ** -8          # 1 x: tie, to even (up)
    scale[..., 3] = 3e38                       # |q| >= 2: overflow to inf
    words = tpack.pack_words_plain(
        torch.tensor(q.reshape(-1, n_pad), dtype=torch.int8), w=w)
    fields = tpack.unpack_words_plain(words, w=w).numpy()   # q mod 2^w
    words = words.numpy().reshape(layers, d_in, -1)
    jp = jquant.PackedLinear(words=jnp.asarray(words),
                             scale=jnp.asarray(scale), bits=w, d_out=d_out)
    return jp, fields.reshape(q.shape), scale


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("w", WIDTHS)
def test_materialize_edge_scales(w, dt):
    """Bit for bit the IEEE chain (numpy: float32 products, one
    round-to-nearest-even cast), and the reference wherever its CPU
    backend computes IEEE products: XLA's CPU backend flushes subnormal
    float32 results to zero, so on the subnormal column the reference
    reads +-0 where the port (like the chain it replaces, and the card)
    keeps the subnormal product."""
    tdt, jdt = DTYPES[dt]
    d_out = 4 * (32 // w) - 1
    jp, q, scale = _edge_container(w, d_in=6, d_out=d_out, layers=2)
    with np.errstate(over="ignore"):
        prod = q.astype(np.float32) * scale
    # the products of columns 1 and 2 in rows that hold +-1, +-2, +-4 lie
    # exactly halfway between two bf16 values
    assert ((prod[..., 1:3].view(np.uint32) & 0xFFFF) == 0x8000).sum() >= 4
    ieee = prod[..., :d_out].astype(ml_dtypes.bfloat16 if dt == "bf16"
                                    else np.float32)
    got = tm.materialize(_torch_container(jp), tdt)
    assert _same(ieee, got)
    want = np.asarray(jquant.materialize(jp, jdt)).copy()
    sub = (prod[..., :d_out] != 0) & (np.abs(prod[..., :d_out])
                                      < np.finfo(np.float32).tiny)
    assert sub[..., 0].all() and not sub[..., 1:].any()
    assert (want[sub].astype(np.float32) == 0).all()     # flushed
    want[sub] = ieee[sub]
    assert _same(want, got)
    assert (got[..., 0] != 0).all() and np.isinf(
        got[..., 3].float().numpy()).any()


def _replay(m: int, nw: int, rps: int, sms: int):
    """The rows and words each launch of ``unpack_dequant_kernel`` writes,
    from its indexing: block (x, y) takes slab y % s of group y // s (s
    slabs of ``rows`` rows a group of ``rps``); its warp v walks the
    slab's rows from v in steps of 8, and lane (quad, qi), after the
    quad transpose, stores words x * 128 + 16 quad + 4 k + qi (k = 0..3)
    that are below nw — the words lane 4 quad + k loaded (4 a lane,
    from x * 128 + 4 lane)."""
    spans, slabs, rows = tpack.launch_shape(m, nw, rps, sms=sms)
    warps = tpack.DEQUANT_WARPS
    per_group = -(-rps // rows)
    assert slabs == (m // rps) * per_group
    row_hits = np.zeros(m, dtype=np.int64)
    for y in range(slabs):
        g, j = divmod(y, per_group)
        start = g * rps + j * rows
        end = min((g + 1) * rps, start + rows)
        for v in range(warps):
            row_hits[start + v:end:warps] += 1
    lane = np.arange(32)
    quad, qi = lane // 4, lane % 4
    word_hits = np.zeros(nw, dtype=np.int64)
    for x in range(spans):
        loaded = x * tpack.SPAN_WORDS + 4 * lane[:, None] + np.arange(4)
        for k in range(4):
            stored = x * tpack.SPAN_WORDS + 16 * quad + 4 * k + qi
            assert (stored == loaded[4 * quad + k, qi]).all()
            np.add.at(word_hits, stored[stored < nw], 1)
    return (spans, slabs, rows), row_hits, word_hits


@pytest.mark.parametrize("m,nw,rps", [(k, n // 8, k) for k, n in TINYLLAMA]
                         + [(22 * 2048, 256, 2048), (22 * 5632, 704, 5632),
                            (1, 1, 1), (37, 301, 37), (74, 126, 37),
                            (9, 129, 9), (200000, 3, 200000),
                            (4000, 3, 2), (64, 4000, 8)])
def test_launch_shape_covers_every_output_once(m, nw, rps):
    """Every (row, word), hence every output column, is written by exactly
    one lane of one launch, each slab inside one scale group; the grid
    fits, and where the groups leave room it is one wave of
    ``DEQUANT_BLOCKS_PER_SM`` blocks an SM whose warps walk no more rows
    than one wave needs."""
    sms = 132
    (spans, slabs, rows), row_hits, word_hits = _replay(m, nw, rps, sms)
    assert (row_hits == 1).all() and (word_hits == 1).all()
    assert slabs <= tpack.MAX_GRID_Y and rows % tpack.DEQUANT_WARPS == 0
    assert spans == -(-nw // tpack.SPAN_WORDS)
    warps, wave = tpack.DEQUANT_WARPS, tpack.DEQUANT_BLOCKS_PER_SM * sms
    groups = m // rps
    if spans * groups <= wave:
        assert spans * slabs <= wave
        per_group = wave // (spans * groups)
        assert rows // warps == -(-rps // (warps * per_group))


@pytest.mark.parametrize("k,n", TINYLLAMA)
def test_serving_shapes_take_the_vector_path(k, n):
    """At W4, every tinyllama matrix loads 16-byte word vectors (its rows
    hold a multiple of 4 words) and stores 16-byte bf16 vectors, with no
    trim; a d_out off the 16-byte grid takes the scalar stores."""
    nw = n // 8
    assert nw % 4 == 0
    assert tpack.store_unit(4, torch.bfloat16) == 16
    assert tpack.vector_store(4, torch.bfloat16, n)
    assert tpack.vector_store(4, torch.float32, n)
    assert not tpack.vector_store(4, torch.bfloat16, n - 1)
    assert not tpack.vector_store(6, torch.bfloat16, n)       # 10 bytes
    assert tpack.store_unit(3, torch.bfloat16) == 4           # 20 bytes


def test_materialize_costs_one_plain_call_and_no_launch():
    """On the CPU a stacked container is one plain fused call (one plain
    unpack inside it); no kernel counter moves."""
    jp, _, _ = _edge_container(4, d_in=8, d_out=30, layers=3)
    tp = _torch_container(jp)
    counters = (tpack.unpack_dequant.launches, tpack.unpack_words.launches)
    calls = (tpack.unpack_dequant_plain.calls, tpack.unpack_words_plain.calls)
    out = tm.materialize(tp)
    assert out.shape == (3, 8, 30) and out.is_contiguous()
    assert (tpack.unpack_dequant_plain.calls,
            tpack.unpack_words_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert (tpack.unpack_dequant.launches,
            tpack.unpack_words.launches) == counters
    # ops.unpack_dequant takes the container's [L, 1, n] scales as they are
    flat = tops.unpack_dequant(tp.words.reshape(-1, tp.words.shape[-1]),
                               tp.scale, w=4, d_out=30, rows_per_scale=8)
    assert torch.equal(flat.reshape(3, 8, 30), out)


def test_unpack_dequant_refusals():
    words = torch.zeros((8, 4), dtype=torch.int32)
    scale = torch.ones((2, 32))
    kw = dict(w=4, d_out=30, rows_per_scale=4)
    assert tpack.unpack_dequant(words, scale, **kw).shape == (8, 30)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tpack.unpack_dequant(words, scale, dtype=torch.float16, **kw)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tpack.unpack_dequant(words, scale, dtype=torch.int8, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tpack.unpack_dequant(torch.zeros((4, 8), dtype=torch.int32).t(),
                             scale, **kw)
    with pytest.raises(ValueError, match="scale must be float32"):
        tpack.unpack_dequant(words, torch.ones((1, 32)), **kw)
    with pytest.raises(ValueError, match="scale must be float32"):
        tpack.unpack_dequant(words, torch.ones((2, 30)), **kw)
    with pytest.raises(ValueError, match="scale must be float32"):
        tpack.unpack_dequant(words, scale.double(), **kw)
    with pytest.raises(ValueError, match="groups"):
        tpack.unpack_dequant(words, scale, w=4, d_out=30, rows_per_scale=3)
    with pytest.raises(ValueError, match="d_out"):
        tpack.unpack_dequant(words, scale, w=4, d_out=33, rows_per_scale=4)
    with pytest.raises(ValueError, match="int32"):
        tpack.unpack_dequant(words.long(), scale, **kw)
    with pytest.raises(ValueError, match="rows_per_scale"):
        tpack.unpack_dequant(words, scale, w=4, d_out=30, rows_per_scale=0)
    with pytest.raises(ValueError, match="field width"):
        tpack.unpack_dequant(words, scale, w=9, d_out=3, rows_per_scale=4)
