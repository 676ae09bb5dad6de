// Cross-channel BSEG packed conv2d (B3) for Hopper (sm_90a), on the int8
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/bseg_conv2d.py::bseg_conv2d (its
// body _body): the dense stride-1 'same' conv2d of the paper's UltraNet
// through Binary Segmentation (Sec. III-D, Figs. 6/7).
//
// What is computed.  x_pad [B, H_pad, W_pad, C_in] int8 holds unsigned
// activations in [0, 2^w_i), w_i <= 7; kappa holds one packed factor per
// (tap group g, kernel row r, input channel ci, output channel co): the
// n_k taps of the group, reversed, summed into one word through the
// pre-adder (int32, FP32M converted to int32 exactly by the wrapper, or
// the wide DSP48E2/DSP58 words as hi:lo int32 limb planes).  The
// reference runs a carry word per (row, r, ci, g, co) through the DSP's
// wide multiplies, Fig. 7 slicing and the adder tree; with its guard bits
// every lane is exact, so what comes out is the plain correlation
//   out[b, y, c, co] = sum_{r < kh, s < S, ci}
//                      x_pad[b, y + r, c + s, ci] * T[co, r, s, ci]
// (mod 2^32, the reference's int32 total) of x_pad with the decoded taps
// T, S = G n_k (taps past kw decode to 0).  bseg_conv2d_plain repeats the
// DSP's word arithmetic step by step; decode_taps_plain mirrors the decode
// below, and the CPU tests hold the identity between the two.
//
// Bound: bytes.  At UltraNet's 416x416 frame, batch 8, the 8 3x3 stages
// read ~0.012 GB of x_pad and kappa and write ~0.166 GB of int32 output
// (88.6 MB for the first layer): ~55 us at 3.35 TB/s, against ~5 us for
// their 10.8 G operations at the int8 tensor-core rate.
//
// What the design does about it.  It does not carry the DSP's word through
// the card (~25-40 integer instructions per wide multiply, 0.6% of the
// bound): it is an implicit GEMM, pixels x output channels x K, K in the
// order (r, s, ci), on mma.sync m16n8k32 with s32 accumulators.
//   - Taps.  A block owns a tile of N <= 64 output channels for its whole
//     life (a persistent grid).  It decodes the kappa words of its tile
//     once (low lanes first, with borrow; 32-bit arithmetic on the narrow
//     words, no division in the loop, eight loads in flight a thread, four
//     input channels a 32-bit store) into an int8 B tile [N][K] in shared
//     memory; taps wider than 8 bits are cut into byte slices, the top
//     slice .s8 and the lower ones .u8, each slice its own K pass, summed
//     with shifts in 32-bit integers (the integer MMA wraps, so the total
//     is the exact sum mod 2^32).
//   - Activations.  The block then walks its pixel tiles (tr output rows x
//     tc columns of one image, up to 128 MT pixels: MT m16 tiles a warp,
//     MT = 4 at 16 output channels, so the fixed costs of a tile - its
//     barriers and index arithmetic - spread over more pixels).  For each
//     it stages the strip of x_pad it reads - tr + kh - 1 rows, tc + S - 1
//     columns, a chunk of cc = 16, 32 or 64 channels, zeros past C_in:
//     by cp.async of 16 bytes a thread, double-buffered so the
//     next tile's strip lands while this one is multiplied, where C_in %
//     16 == 0; by byte loads otherwise (layer 0's 3 channels).  The A
//     fragments come straight from the strip by ldmatrix: each (r, s, 16
//     channels) is one 16-byte run, so im2col happens only in the
//     addresses, never in memory.  A K step's B fragments serve all MT
//     m-tiles of the warp.
//   - Output.  Each warp stages its sums through shared memory, eight
//     pixels at a time, and writes them with 16-byte coalesced stores.
//     Every output is written once: no split-K, no zeroing pass, no
//     atomics; the result is deterministic.
// Channels past C_in and the odd 16-byte K chunk of a K step carry zero
// taps; pixels past the frame are computed on zero-filled strip bytes and
// dropped.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlices = 4;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kDecodeQuads = 2;        // 8 kappa loads in flight a thread

struct Conv {
  int h_pad, w_pad, c_in, kh, groups, c_out, h_out, w_out;
  int n_k, lane, slices;
  bool wide;            // [2, ...] limb-plane kappa
  bool narrow;          // the packed taps fit 32 bits (n_k L <= 32)
  int tr, tc, cc;       // pixel tile rows x columns; channels per chunk
  int taps;             // S = groups * n_k
  int n_chunks;         // ceil(C_in / cc)
  int sh, sw, pp;       // strip rows, columns, bytes per strip pixel
  int cpc_log;          // log2(cc / 16)
  int nq;               // 16-byte K chunks of one channel chunk
  int bp;               // B tile bytes per output channel per slice
  int strip_bytes;
  float inv_sw, inv_tc;  // 1 / sw, 1 / tc (quotients of small integers)
  int tiles_x, tiles_y, n_tiles;
  bool vec_x, vec_out;  // C_in % 16 == 0; C_out % 4 == 0
};

// Shared memory of one block (bytes), region by region; bseg_conv2d.py's
// smem_bytes mirrors it
struct Layout {
  int b_tile, q_table, strips, stage, total;
};

__host__ __device__ inline Layout layout(const Conv& c, int n_tile) {
  Layout l;
  l.b_tile = c.slices * n_tile * c.bp;
  l.q_table = ((c.nq + 1) * 4 + 15) / 16 * 16;
  l.strips = 2 * c.strip_bytes;
  l.stage = kWarps * 8 * (n_tile + 4) * 4;
  l.total = l.b_tile + l.q_table + l.strips + l.stage;
  return l;
}

// a / d for 0 <= a < 2^20 and 1 <= d <= 1024, by the float reciprocal:
// (a + 0.5) / d is at least 0.5 / d from an integer, far beyond the
// rounding of the product
__device__ __forceinline__ int quot(int a, float inv_d) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * inv_d);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: an invalid copy reads nothing (src-size 0) and
// writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// D += A (16 x 32, row: unsigned activations) * B (32 x 8, col: taps,
// .s8 for the top slice, .u8 below), int32 accumulate (wrapping)
template <bool kTapU8>
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  if constexpr (kTapU8)
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Pixel tile t -> its image and the x_pad row / column of its corner
// (tiles run along a row, then down the image, then over the batch)
struct Tile {
  int b, y0, x0;
};

__device__ __forceinline__ Tile tile_of(const Conv& c, int t) {
  Tile tl;
  tl.x0 = t % c.tiles_x * c.tc;
  t /= c.tiles_x;
  tl.y0 = t % c.tiles_y * c.tr;
  tl.b = t / c.tiles_y;
  return tl;
}

// Decode four packed words (input channels ci .. ci + 3 of one output
// channel, kernel row and tap group; their lanes, low to high, are taps
// s0, s0 - 1, ...) and write each tap's four bytes with one 32-bit store:
// byte slice j of tap s0 - i at dst - i cc + j slice_stride
template <typename Word>
__device__ __forceinline__ void decode_quad(const Conv& c, Word (&rem)[4],
                                            uint8_t* dst, int slice_stride) {
  const Word mask = (Word(1) << c.lane) - 1, half = Word(1) << (c.lane - 1);
  for (int i = 0; i < c.n_k; ++i) {
    const int sh = i * c.lane;
    Word v[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const Word f = (rem[w] >> sh) & mask;
      v[w] = f >= half ? f - mask - 1 : f;   // two's complement
      rem[w] -= v[w] << sh;
    }
    uint8_t* d = dst - i * c.cc;
    for (int j = 0; j < c.slices; ++j) {
      uint32_t b = 0;
#pragma unroll
      for (int w = 0; w < 4; ++w)
        b |= (static_cast<uint32_t>(v[w] >> (8 * j)) & 0xFFu) << (8 * w);
      *reinterpret_cast<uint32_t*>(d + j * slice_stride) = b;
    }
  }
}

// Decode the kappa words of channel chunk ch for output channels co0 ..
// co0 + N into the B tile [slices][N][bp]: row co, byte (r S + s) cc + ci
// holds byte j of tap T[co, r, s, ch cc + ci] (0 past C_out / C_in).  A
// word's lanes hold the arithmetic sum of the reversed taps: decoded low
// to high, each lane sign-extended from L bits and taken off the rest.
// Thread (row, co) takes the quads (g, r, four ci) = row, row + kThreads /
// N, ... in that order, ci fastest, stepping its indices without
// division, and loads kDecodeQuads quads before it decodes any.
template <int N>
__device__ void decode_taps(const Conv& c, const int32_t* __restrict__ kappa,
                            uint8_t* btile, int co0, int ch) {
  constexpr int kStep = kThreads / N;   // quad rows a pass
  const int cq = c.cc / 4;              // quads a channel chunk
  const int rows = c.groups * c.kh * cq;
  const int nl = threadIdx.x % N, co = co0 + nl;
  const int64_t plane =
      static_cast<int64_t>(c.groups) * c.kh * c.c_in * c.c_out;
  int q = threadIdx.x / N;
  int qi = q % cq, r = q / cq % c.kh, g = q / cq / c.kh;
  while (q < rows) {
    uint32_t lo[kDecodeQuads][4], hi[kDecodeQuads][4];
    int dst[kDecodeQuads];   // B tile offset of the quad's first tap
#pragma unroll
    for (int u = 0; u < kDecodeQuads; ++u) {
      const int64_t k0 =
          (static_cast<int64_t>(g * c.kh + r) * c.c_in + ch * c.cc +
           4 * qi) * c.c_out + co;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const bool ok = q < rows && co < c.c_out &&
                        ch * c.cc + 4 * qi + w < c.c_in;
        const int64_t k = k0 + static_cast<int64_t>(w) * c.c_out;
        lo[u][w] = ok ? static_cast<uint32_t>(__ldg(kappa + k)) : 0u;
        hi[u][w] = ok && c.wide
                       ? static_cast<uint32_t>(__ldg(kappa + plane + k))
                       : 0u;
      }
      dst[u] = q < rows ? nl * c.bp +
                              (r * c.taps + g * c.n_k + c.n_k - 1) * c.cc +
                              4 * qi
                        : -1;
      q += kStep;
      qi += kStep;
      while (qi >= cq) {
        qi -= cq;
        if (++r == c.kh) {
          r = 0;
          ++g;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kDecodeQuads; ++u) {
      if (dst[u] < 0) break;
      if (c.narrow) {
        uint32_t rem[4] = {lo[u][0], lo[u][1], lo[u][2], lo[u][3]};
        decode_quad<uint32_t>(c, rem, btile + dst[u], N * c.bp);
      } else {
        uint64_t rem[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          rem[w] = c.wide ? static_cast<uint64_t>(hi[u][w]) << 32 | lo[u][w]
                          : static_cast<uint64_t>(static_cast<int64_t>(
                                static_cast<int32_t>(lo[u][w])));
        decode_quad<uint64_t>(c, rem, btile + dst[u], N * c.bp);
      }
    }
  }
  if (c.nq % 2) {   // the odd K chunk of the last K step: zero taps
    for (int idx = threadIdx.x; idx < c.slices * N; idx += kThreads)
      *reinterpret_cast<uint4*>(btile + idx * c.bp + c.nq * 16) =
          make_uint4(0, 0, 0, 0);
  }
}

// Stage tile t's strip, channel chunk ch, into dst [sh][sw][pp]: zeros
// past the frame and past C_in.  cp.async (completes later) where C_in %
// 16 == 0, else byte loads
__device__ void load_strip(const Conv& c, const int8_t* __restrict__ x,
                           uint8_t* dst, int t, int ch) {
  const Tile tl = tile_of(c, t);
  const int cpc = 1 << c.cpc_log, ci0 = ch * c.cc;
  const int units = c.sh * c.sw * cpc;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int q = u & (cpc - 1), pix = u >> c.cpc_log;
    const int row = quot(pix, c.inv_sw), col = pix - row * c.sw;
    const int yy = tl.y0 + row, xx = tl.x0 + col;
    const int ci = ci0 + q * 16;
    const bool ok = yy < c.h_pad && xx < c.w_pad && ci < c.c_in;
    const int8_t* src =
        ok ? x + ((static_cast<int64_t>(tl.b) * c.h_pad + yy) * c.w_pad +
                  xx) * c.c_in + ci
           : x;
    uint8_t* d = dst + pix * c.pp + q * 16;
    if (c.vec_x) {
      cp_async16(d, src, ok);
    } else {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (ok && ci + e < c.c_in)
          w[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(
                          __ldg(src + e)))
                      << (8 * (e % 4));
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// acc += strip (the MT A rows of this lane) x B tile of one slice, over
// the channel chunk's K; each K step's B fragments serve every m-tile
template <int NT, int MT, bool kTapU8>
__device__ __forceinline__ void k_loop(const Conv& c, const uint8_t* strip,
                                       const int (&pix_off)[MT],
                                       const bool (&live)[MT],
                                       const int32_t* qoff,
                                       const uint8_t* bt,
                                       int (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x % 32;
  const int a_half = lane / 16;
  const uint8_t* b_row = bt + (lane % 8) * c.bp + ((lane / 8) % 2) * 16;
  const int steps = (c.nq + 1) / 2;
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      ldmatrix_x2(b[nt], b_row + nt * 8 * c.bp + ks * 32);
    const int off = qoff[2 * ks + a_half];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if (!live[mt]) continue;
      uint32_t a[4];
      ldmatrix_x4(a, strip + pix_off[mt] + off);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma<kTapU8>(acc[mt][nt], a, b[nt]);
    }
  }
}

// Write the warp's MT m-tiles x N channels of tile t, eight pixels at a
// time through its stage [8][N + 4], as 16-byte stores: lane (row0, c4)
// takes channels 4 c4 .. 4 c4 + 3 of rows row0, row0 + 32 / C4, ...
template <int NT, int MT>
__device__ __forceinline__ void store_tile(const Conv& c,
                                           int32_t* __restrict__ out,
                                           int32_t* stage,
                                           const int (&total)[MT][NT][4],
                                           const bool (&live)[MT], int t,
                                           int co0) {
  constexpr int N = NT * 8, P = N + 4, C4 = N / 4, kRowStep = 32 / C4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int c4 = lane % C4, row0 = lane / C4;
  const int co = co0 + 4 * c4;
  const Tile tl = tile_of(c, t);
  const int pixels = c.tr * c.tc;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (!live[mt]) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        stage[gid * P + nt * 8 + 2 * tig] = total[mt][nt][2 * h];
        stage[gid * P + nt * 8 + 2 * tig + 1] = total[mt][nt][2 * h + 1];
      }
      __syncwarp();
#pragma unroll
      for (int row = row0; row < 8; row += kRowStep) {
        const int m = (mt * kWarps + warp) * 16 + 8 * h + row;
        const int my = quot(m, c.inv_tc), mx = m - my * c.tc;
        const int y = tl.y0 + my, xx = tl.x0 + mx;
        if (m >= pixels || y >= c.h_out || xx >= c.w_out || co >= c.c_out)
          continue;
        int32_t* dst =
            out + ((static_cast<int64_t>(tl.b) * c.h_out + y) * c.w_out +
                   xx) * c.c_out + co;
        const int32_t* src = stage + row * P + 4 * c4;
        if (c.vec_out) {
          *reinterpret_cast<int4*>(dst) =
              *reinterpret_cast<const int4*>(src);
        } else {
          for (int e = 0; e < 4 && co + e < c.c_out; ++e) dst[e] = src[e];
        }
      }
      __syncwarp();
    }
  }
}

// Grid (ceil(C_out / N), blocks per channel tile); block kThreads.  Block
// (x, y) owns channels x N .. x N + N and walks the pixel tiles y, y +
// gridDim.y, ...; each (tile, channel chunk) is one stage of its loop.
// Warp w holds m-tiles w, w + 8, ... (MT of them) of each pixel tile.
template <int NT, int MT>
__global__ void __launch_bounds__(kThreads, 2)
bseg_conv2d_kernel(const int8_t* __restrict__ x,
                   const int32_t* __restrict__ kappa,
                   int32_t* __restrict__ out, Conv c) {
  constexpr int N = NT * 8;
  extern __shared__ __align__(128) uint8_t smem[];
  const Layout l = layout(c, N);
  uint8_t* btile = smem;
  int32_t* qoff = reinterpret_cast<int32_t*>(smem + l.b_tile);
  uint8_t* strips = smem + l.b_tile + l.q_table;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* stage = reinterpret_cast<int32_t*>(strips + l.strips) +
                   warp * 8 * (N + 4);
  const int co0 = blockIdx.x * N;

  // strip offset of each 16-byte K chunk q = (r S + s) cc / 16 + c16
  const int cpc = 1 << c.cpc_log;
  for (int q = threadIdx.x; q <= c.nq; q += kThreads) {
    const int rs = q >> c.cpc_log, s = rs % c.taps, r = rs / c.taps;
    qoff[q] = q < c.nq ? (r * c.sw + s) * c.pp + (q & (cpc - 1)) * 16 : 0;
  }
  const int my_tiles =
      (c.n_tiles - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y;
  const int stages = my_tiles * c.n_chunks;
  if (stages <= 0) return;
  load_strip(c, x, strips, blockIdx.y, 0);
  cp_async_commit();
  if (c.n_chunks == 1) decode_taps<N>(c, kappa, btile, co0, 0);

  // this lane's A rows: pixel m of each of the warp's m-tiles (pixels
  // past the tile read pixel 0 and are dropped)
  const int pixels = c.tr * c.tc;
  int pix_off[MT];
  bool live[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m0 = (mt * kWarps + warp) * 16;
    const int m = m0 + lane % 16 < pixels ? m0 + lane % 16 : 0;
    const int my = quot(m, c.inv_tc);
    pix_off[mt] = (my * c.sw + m - my * c.tc) * c.pp;
    live[mt] = m0 < pixels;
  }
  int total[MT][NT][4];
  for (int i = 0; i < stages; ++i) {
    const int t = blockIdx.y + (i / c.n_chunks) * gridDim.y;
    const int ch = i % c.n_chunks;
    if (i + 1 < stages)
      load_strip(c, x, strips + ((i + 1) & 1) * c.strip_bytes,
                 blockIdx.y + ((i + 1) / c.n_chunks) * gridDim.y,
                 (i + 1) % c.n_chunks);
    cp_async_commit();
    if (c.n_chunks > 1) decode_taps<N>(c, kappa, btile, co0, ch);
    cp_async_wait<1>();
    __syncthreads();   // strip i, the B tile and the K offsets are in place
    if (live[0]) {
      if (ch == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) total[mt][nt][e] = 0;
      }
      const uint8_t* strip = strips + (i & 1) * c.strip_bytes;
      for (int j = 0; j < c.slices; ++j) {
        int acc[MT][NT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
        const uint8_t* bt = btile + j * N * c.bp;
        if (j == c.slices - 1)
          k_loop<NT, MT, false>(c, strip, pix_off, live, qoff, bt, acc);
        else
          k_loop<NT, MT, true>(c, strip, pix_off, live, qoff, bt, acc);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              total[mt][nt][e] += static_cast<int>(
                  static_cast<uint32_t>(acc[mt][nt][e]) << (8 * j));
      }
      if (ch == c.n_chunks - 1)
        store_tile<NT, MT>(c, out, stage, total, live, t, co0);
    }
    __syncthreads();   // strip i and the B tile are free again
  }
}

template <int NT, int MT>
cudaError_t launch(const int8_t* x, const int32_t* kappa, int32_t* out,
                   const Conv& c, int grid_y, int smem, cudaStream_t stream) {
  const auto kernel = bseg_conv2d_kernel<NT, MT>;
  static int configured = 0;   // above 48 KB only after opting in
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  const dim3 grid((c.c_out + NT * 8 - 1) / (NT * 8), grid_y);
  kernel<<<grid, kThreads, smem, stream>>>(x, kappa, out, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() of the launch (0 = success).  `wide` selects
// the [2, G, kh, C_in, C_out] limb-plane kappa.  The tiles (n_tile output
// channels, tr x tc pixels in mt m16 tiles a warp, cc channels per chunk),
// the blocks per channel tile and the shared memory come from
// bseg_conv2d.py's launch_shape; `smem` must equal this file's layout().
int bseg_conv2d(const void* x_pad, const void* kappa, void* out, int b,
                int h_pad, int w_pad, int c_in, int kh, int groups,
                int c_out, int h_out, int w_out, int n_k, int lane,
                int slices, int wide, int n_tile, int mt, int tr, int tc,
                int cc, int grid_y, int smem, void* stream) {
  if (b < 1 || h_out < 1 || w_out < 1 || c_in < 1 || c_out < 1 || kh < 1 ||
      groups < 1 || n_k < 1 || lane < 2 || n_k * lane > 64 || slices < 1 ||
      slices > kMaxSlices || tr < 1 || tc < 1 || tc > 1024 ||
      tr * tc > 16 * kWarps * mt || (cc != 16 && cc != 32 && cc != 64) ||
      grid_y < 1 || h_pad < h_out + kh - 1)
    return cudaErrorInvalidValue;
  Conv c;
  c.h_pad = h_pad;
  c.w_pad = w_pad;
  c.c_in = c_in;
  c.kh = kh;
  c.groups = groups;
  c.c_out = c_out;
  c.h_out = h_out;
  c.w_out = w_out;
  c.n_k = n_k;
  c.lane = lane;
  c.slices = slices;
  c.wide = wide != 0;
  c.narrow = !c.wide && n_k * lane <= 32 && lane < 32;
  c.tr = tr;
  c.tc = tc;
  c.cc = cc;
  c.taps = groups * n_k;
  c.n_chunks = (c_in + cc - 1) / cc;
  c.sh = tr + kh - 1;
  c.sw = tc + c.taps - 1;
  const int cpc = cc / 16;
  c.cpc_log = cpc == 1 ? 0 : cpc == 2 ? 1 : 2;
  c.pp = 16 * (cpc % 2 ? cpc : cpc + 1);   // an odd number of 16-byte runs
  c.nq = kh * c.taps * cpc;
  c.bp = 16 * (c.nq + c.nq % 2 + 1);
  c.strip_bytes = c.sh * c.sw * c.pp;
  c.inv_sw = 1.0f / c.sw;
  c.inv_tc = 1.0f / tc;
  c.tiles_x = (w_out + tc - 1) / tc;
  c.tiles_y = (h_out + tr - 1) / tr;
  c.n_tiles = b * c.tiles_x * c.tiles_y;
  c.vec_x = c_in % 16 == 0 && reinterpret_cast<uintptr_t>(x_pad) % 16 == 0;
  c.vec_out = c_out % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (layout(c, n_tile).total != smem || smem > kMaxSmem ||
      grid_y > c.n_tiles || c.sw > 1024 || c.sh * c.sw >= (1 << 20))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x_pad);
  const int32_t* k = static_cast<const int32_t*>(kappa);
  int32_t* o = static_cast<int32_t*>(out);
  switch (n_tile * 8 + mt) {   // MT m-tiles a warp, NT * MT <= 8
    case 8 * 8 + 1: return launch<1, 1>(xp, k, o, c, grid_y, smem, s);
    case 8 * 8 + 2: return launch<1, 2>(xp, k, o, c, grid_y, smem, s);
    case 8 * 8 + 4: return launch<1, 4>(xp, k, o, c, grid_y, smem, s);
    case 16 * 8 + 1: return launch<2, 1>(xp, k, o, c, grid_y, smem, s);
    case 16 * 8 + 2: return launch<2, 2>(xp, k, o, c, grid_y, smem, s);
    case 16 * 8 + 4: return launch<2, 4>(xp, k, o, c, grid_y, smem, s);
    case 32 * 8 + 1: return launch<4, 1>(xp, k, o, c, grid_y, smem, s);
    case 32 * 8 + 2: return launch<4, 2>(xp, k, o, c, grid_y, smem, s);
    case 64 * 8 + 1: return launch<8, 1>(xp, k, o, c, grid_y, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
