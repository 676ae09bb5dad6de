"""The premise and the host side of the tensor-core quantized matmul (B5
``quant_matmul``, ``csrc/quant_matmul.cu``), on the CPU.

The kernel decodes each lane word once into bf16 fields and multiplies
them on the bf16 tensor cores with float32 accumulation; float32 x is
split exactly into three bf16 parts.  What lets that compute B5's
function is checked here without a card:

- the decode (``decode_fields_plain``, and the kernel's float
  magic-number arithmetic repeated in numpy) gives both packages'
  unpacked fields, exactly in bf16, at w = 2..8;
- the split of float32 x (``split_x_plain``, the kernel's truncation)
  gives back x exactly on edge values and random values;
- a plain model of the kernel's summation order (truncating MMA steps,
  accumulator restarts, K splits in order, then the scale) stays within
  ``ROUNDING_LIMIT`` typical float32 roundings of the float64 product at
  the tinyllama shapes, where x rounded to TF32 or bf16 does not;
- the launch geometry covers every output exactly once with every K
  split counted.

The kernel itself is held against its plain version and the float64
product on the card in ``test_torch_kernels_cuda``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.packbits import unpack_words as j_unpack_words

from repro_torch.kernels import packbits as tpack
from repro_torch.kernels import quant_matmul as tqmm
from repro_torch.kernels import ref as tref

WIDTHS = (2, 3, 4, 5, 6, 7, 8)
#: tinyllama-1.1b's memory-packed (K, N): q/o, k/v, gate/up, down, head
TINYLLAMA = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048),
             (2048, 32000))
SMS = 132


def _words(rng, k, nw):
    """Random int32 words, all 32 bits (the bits above the last field of
    w = 3, 5, 6, 7 too: the decode must ignore them)."""
    return torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (k, nw)),
                        dtype=torch.int32)


def _magic_decode(words: np.ndarray, w: int) -> np.ndarray:
    """The kernel's decode in numpy float32: the biased field u = f +
    2^(w-1) is the field with its sign bit flipped, and (2^23 + u) -
    (2^23 + 2^(w-1)) is the field, exact; its bf16 is the float's high
    half.  Returns [k, nw * per] float32 from those bf16 bits."""
    per, mask, half = 32 // w, (1 << w) - 1, 1 << (w - 1)
    u32 = words.view(np.uint32)
    magic = np.float32(8388608.0 + half)
    out = []
    for i in range(per):
        u = ((u32 >> np.uint32(i * w)) & np.uint32(mask)) ^ np.uint32(half)
        f = (np.uint32(0x4B000000) | u).view(np.float32) - magic
        out.append((f.view(np.uint32) & np.uint32(0xFFFF0000))
                   .view(np.float32))
    return np.stack(out, axis=-1).reshape(words.shape[0], -1)


@pytest.mark.parametrize("w", WIDTHS)
def test_decode_fields_match_both_unpacks(w):
    """``decode_fields_plain`` (the kernel's A tiles, [n, k] in slot
    order) == the port's and the JAX package's reference unpack and the
    JAX Pallas unpack kernel (interpret), transposed; every field is an
    exact bf16, and the kernel's magic-number decode gives the same
    values."""
    rng = np.random.default_rng(w)
    words = _words(rng, 19, 13)
    want = tref.unpack_words_ref(words, w=w)                  # [k, n] int8
    assert (np.asarray(jref.unpack_words_ref(jnp.asarray(words.numpy()),
                                             w=w)) == want.numpy()).all()
    assert (np.asarray(j_unpack_words(jnp.asarray(words.numpy()), w=w,
                                      interpret=True)) == want.numpy()).all()
    got = tqmm.decode_fields_plain(words, w=w)
    assert got.dtype == torch.bfloat16 and got.shape == (13 * (32 // w), 19)
    assert torch.equal(got.to(torch.int32), want.T.to(torch.int32))
    magic = _magic_decode(words.numpy(), w)
    assert (magic == want.numpy().astype(np.float32)).all()


@pytest.mark.parametrize("w", WIDTHS)
def test_words_per_tile(w):
    """A block's words: a multiple of 4 (16-byte copies), their fields at
    most the tile's 128 columns and more than 128 - 2 per - 4 of them."""
    words, per = tqmm.words_per_tile(w), 32 // w
    assert words % 4 == 0
    assert tqmm.TILE_COLS - 4 * per < words * per <= tqmm.TILE_COLS


def _edge_values():
    f32 = np.finfo(np.float32)
    ones = np.float32(1.9999999)                  # 24 ones in the significand
    vals = [0.0, -0.0, f32.max, -f32.max, f32.tiny, -f32.tiny, ones, -ones,
            ones * 2.0 ** 100, ones * 2.0 ** -100, ones * 2.0 ** -110,
            np.float32(1.0) + np.float32(2.0 ** -23),
            # lo (the last 8 bits) lands among bf16's subnormals
            np.float32(2.0 ** -105) * (1 + np.float32(2.0 ** -23)),
            np.float32(2.0 ** -108) * np.float32(1.5),
            (np.float32(2.0 ** -104) * (1 + np.float32(2.0 ** -16))
             + np.float32(2.0 ** -127))]
    return np.array(vals, dtype=np.float32)


def test_split_x_is_exact():
    """hi + mid + lo == x exactly (float64 sum), each part exact in bf16
    (its float32 value survives the cast), on the edge values (signed
    zeros, the largest and smallest normal float32, long runs of
    significand ones, remainders that are bf16 subnormals) and on random
    values over the exponents >= -110; the largest float32 stays finite
    (truncation, where rounding to nearest gives a bf16 infinity)."""
    rng = np.random.default_rng(0)
    rand = (rng.choice([-1.0, 1.0], 4000) * rng.uniform(1.0, 2.0, 4000)
            * 2.0 ** rng.integers(-110, 127, 4000)).astype(np.float32)
    x = torch.tensor(np.concatenate([_edge_values(), rand]))
    parts = tqmm.split_x_plain(x)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    assert all(torch.isfinite(p).all() for p in parts)
    total = sum(p.to(torch.float64) for p in parts)
    assert torch.equal(total, x.to(torch.float64))
    assert torch.equal(parts[0].to(torch.float32).view(torch.int32)
                       & 0xFFFF, torch.zeros_like(x, dtype=torch.int32))
    assert torch.equal(torch.signbit(parts[0][:2]),
                       torch.tensor([False, True]))
    # the domain's edge: bits below 2^-133 are lost, nothing more
    tiny = torch.tensor([2.0 ** -120 * (1 + 2.0 ** -23), 1e-40],
                        dtype=torch.float32)
    err = (sum(p.to(torch.float64) for p in tqmm.split_x_plain(tiny))
           - tiny.to(torch.float64)).abs()
    assert (err < 2.0 ** -133).all()


def _tf32(x):
    bits = x.view(torch.int32)
    return ((bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _reading(y, x, w_int, scale):
    exact = (x.to(torch.float64) @ w_int.to(torch.float64)) \
        * scale.to(torch.float64)
    rs = tqmm.rounding_scale(x, w_int, scale)
    return float(((y.to(torch.float64) - exact).abs() / rs).max())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(8, 5632, 2048), (8, 2048, 5632),
                                   (8, 2048, 32000), (128, 5632, 2048),
                                   (128, 2048, 256), (3, 77, 40)])
def test_summation_model_within_rounding_limit(dtype, m, k, n):
    """The kernel's summation order, modelled in float32 with MMA steps
    truncated toward zero (``summation_model_plain``) on the geometry the
    kernel takes at the shape (48 of the n columns computed), reads at
    most ``ROUNDING_LIMIT`` rounding scales from the float64 product; on
    float32 x, x rounded to TF32's 10 significand bits and bf16-rounded x
    read far above it (at K >= 2048)."""
    rng = np.random.default_rng(m + k)
    x = torch.tensor(rng.standard_normal((m, k)), dtype=torch.float32) \
        .to(dtype)
    cols = min(n, 48)
    w_int = torch.tensor(rng.integers(-8, 8, (k, cols)))
    scale = torch.tensor(rng.uniform(0.001, 0.1, cols), dtype=torch.float32)
    geo = tqmm.launch_geometry(m, n, k, 4, SMS)
    y = tqmm.summation_model_plain(x, w_int, scale, geo)
    assert _reading(y, x, w_int, scale) <= tqmm.ROUNDING_LIMIT
    if k >= 2048 and dtype == torch.float32:
        low = (_tf32(x).double() @ w_int.double()) * scale.double()
        assert _reading(low, x, w_int, scale) > tqmm.ROUNDING_LIMIT
        y16 = tqmm.summation_model_plain(x.bfloat16(), w_int, scale, geo)
        assert _reading(y16, x, w_int, scale) > tqmm.ROUNDING_LIMIT


def test_accumulator_restarts_matter_for_one_long_chain():
    """Why the kernel restarts its accumulator: one truncating MMA chain
    over all of K = 5632 on float32 x (no split, no restart) drifts past
    ``ROUNDING_LIMIT`` in the pessimistic model, and restarting every
    stage brings the same chain back within it."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((8, 5632)), dtype=torch.float32)
    w_int = torch.tensor(rng.integers(-8, 8, (5632, 32)))
    scale = torch.tensor(rng.uniform(0.001, 0.1, 32), dtype=torch.float32)
    geo = tqmm.launch_geometry(8, 2048, 5632, 4, SMS)
    one = geo._replace(kchunk=5632 + 64, grid=geo.grid[:2] + (1,))
    chain = tqmm.summation_model_plain(x, w_int, scale, one, acc_stages=0)
    restarted = tqmm.summation_model_plain(x, w_int, scale, one,
                                           acc_stages=1)
    assert _reading(chain, x, w_int, scale) > tqmm.ROUNDING_LIMIT
    assert _reading(restarted, x, w_int, scale) <= tqmm.ROUNDING_LIMIT


_GEOMETRY_CASES = (
    [(m, k, n, 4) for k, n in TINYLLAMA for m in (8, 128)]
    + [(3, 77, 40, w) for w in WIDTHS]
    + [(37, 300, 136, w) for w in (4, 8)]
    + [(37, 300, 130, 5), (1, 64, 120, 6), (200, 5000, 9990, 3)])


@pytest.mark.parametrize("m,k,n,w", _GEOMETRY_CASES)
def test_launch_geometry_covers_every_output_once(m, k, n, w):
    """Replays the kernel's block indexing: each (row, column) of [m, n]
    is in exactly one (column tile, row tile) block, whose columns are
    the fields of its words in slot order; the splits tile [0, k) in
    whole stages, so every output gets one partial from each split; the
    workspace holds every split's [m, n] partial and the tickets one int
    per tile; where the shape allows it the grid fills the card."""
    per = 32 // w
    geo = tqmm.launch_geometry(m, n, k, w, SMS)
    gx, gy, gz = geo.grid
    assert geo.rows == (8 if m <= 8 else 64)
    assert geo.words == tqmm.words_per_tile(w)
    cover = torch.zeros((m, n), dtype=torch.int32)
    for bx in range(gx):
        c0 = bx * geo.words * per
        cols = torch.arange(c0, min(n, c0 + geo.words * per))
        assert (cols // per - bx * geo.words < geo.words).all()
        for by in range(gy):
            r0 = by * geo.rows
            cover[r0:min(m, r0 + geo.rows), cols] += 1
    assert (cover == 1).all()
    assert geo.kchunk % tqmm.TILE_K == 0
    assert (gz - 1) * geo.kchunk < k <= gz * geo.kchunk
    assert geo.workspace == (gz * m * n if gz > 1 else 0)
    assert geo.tickets == (gx * gy if gz > 1 else 0)
    stages = -(-k // tqmm.TILE_K)
    if gx * gy < SMS and stages >= 2 * tqmm.MIN_SPLIT_STAGES[geo.rows]:
        assert gz > 1                        # split-K where the grid is small
    if gz > 1:                               # no split below its minimum
        assert geo.kchunk // tqmm.TILE_K >= tqmm.MIN_SPLIT_STAGES[geo.rows]


def test_kernel_entry_refuses_cpu_tensors():
    """``quant_matmul_cuda`` launches or raises: a CPU tensor is refused,
    never sent to the plain version."""
    words = tpack.pack_words_plain(torch.zeros((64, 16), dtype=torch.int8),
                                   w=4)
    calls = tqmm.quant_matmul_plain.calls
    with pytest.raises(ValueError, match="CUDA tensors"):
        tqmm.quant_matmul_cuda(torch.ones((2, 64)), words, torch.ones(16),
                               w=4)
    assert tqmm.quant_matmul_plain.calls == calls
