// Unpack-in-kernel quantized matmul (B5) for Hopper (sm_90a), on the bf16
// tensor cores.
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul (its
// body _body): y = x @ (unpack(words) * scale), the memory-packed route of
// the packed_matmul dispatch (plan = None).
//
// What is computed.  x [m, k] is bfloat16 or float32; words [k, nw] int32
// hold per = 32 / w two's-complement w-bit fields each, word j of a row
// holding columns j * per .. j * per + per - 1 (the lane layout of
// packbits.cu), so n = nw * per; scale [n] float32.  As in the reference,
// the products of x and the sign-extended fields are summed in float32
// and the sum is multiplied by the column's scale at the end: y [m, n]
// float32.
//
// Why the bf16 tensor cores compute it.  A field has at most 8 bits
// (|f| <= 128), so it is exact in bf16, and a bf16 value times it is
// exact in float32: mma.sync.m16n8k16 bf16 with float32 accumulation
// forms B5's products exactly and only the summation rounds.  float32 x
// is split exactly into three bf16 parts, x = hi + mid + lo, by
// truncation: hi keeps x's top 8 significand bits, mid the next 8 of the
// remainder, lo the last 8 (the remainders are exact float32
// differences); three MMAs into the same accumulator then see every bit
// of x.  The split is exact for |x| >= 2^-110 and for 0 (below, bits under
// bf16's smallest subnormal 2^-133 are lost, an absolute error below
// 2^-126 |f| a term); truncation, unlike rounding to nearest, never
// rounds the largest float32 up to a bf16 infinity.  TF32 is never used
// (it keeps 10 bits of x).
//
// The summation.  The tensor cores may align a step's products to the
// largest exponent and truncate, which over K = 5632 terms can drift one
// way.  So the MMA accumulator restarts every kAccStages stages of 64 k
// (the wrapper's ACC_STAGES) and each chunk's sum is added to a
// separate float32 total by an ordinary (round-to-nearest) FADD.  The
// total is multiplied by the scale once.  Every order is fixed by the
// launch's geometry, so a launch is bit-identical to the next.
//
// Bound.  The weights are w / 8 bytes per element; x and y are small
// beside them at the decode shape (m = 8: tinyllama's 2048 x 5632 W4
// matrix is 5.8 MB against 0.2 MB of x and y).  The 2 m n k operations
// per w n k / 8 bytes of words are 16 m / w per byte; at ~295 bf16
// operations per byte of memory rate (989 TFLOP/s over 3.35 TB/s) W4 with
// bf16 x is bound by bytes up to m ~ 74 (the decode shape) and by
// operations at m = 128.  float32 x needs three MMAs a product.
//
// What the design does about it (the shape of csrc/sdv.cu's B1/B2).
// A block owns up to 128 output columns (a multiple of 4 words, 120 at
// w = 3, 5, 6) and 8 rows of x (m <= 8, one MMA n-tile) or 64 (m > 8),
// and walks its K chunk in stages of 64:
//   1. a cp.async ring (4 stages at 8 rows, 3 at 64) of word tiles
//      [64 k][words] and x tiles [rows][64 k] (16-byte copies where the
//      rows are aligned, else 4 bytes, or plain loads for unaligned bf16
//      rows), zero-filled past every edge;
//   2. each word is decoded once into its per fields as bf16 (shift,
//      mask, bias, a float magic number: no division, no I2F) into a
//      swizzled A tile [128 columns][64 k], 4 k an 8-byte store;
//   3. mma.sync.m16n8k16 bf16 multiplies it: columns on M (ldmatrix.x4),
//      x rows on N, the B fragments read straight from the staged x rows
//      (ldmatrix for bf16; float32 rows split into hi/mid/lo in
//      registers);
//   4. the block's sums go through shared memory to 16-byte rows of y.
// Where the grid is small (m = 8: n / 128 column tiles, 2-44 blocks on
// tinyllama's shapes) K is split across blocks to fill the card.  Each
// split writes its float32 partial to a workspace; the last block of a
// tile to finish (an integer ticket per tile, which that block resets to
// 0 for the next launch) adds the partials in split order 0..S-1, applies
// the scale and writes y.  No float atomics, so the result does not
// depend on which block finishes last.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kSlots = 128;        // output columns (A rows) per block
constexpr int kBK = 64;            // k per stage: four MMA k-steps of 16
constexpr int kOutPitch = kSlots + 4;   // floats per staged output row
constexpr int kDecodeRows = 8;
constexpr int kPrefillRows = 64;
constexpr int kReduceBatch = 16;        // split partials loaded at once
// stages of 64 k between restarts of the MMA accumulator, whose chunk
// sums are added into a float32 total
constexpr int kAccStages = 1;

// w-bit fields: per word, and word columns per block (a multiple of 4, so
// a tile's words start 16-byte aligned)
template <int W>
struct Field {
  static constexpr int kPer = 32 / W;
  static constexpr int kWords = (kSlots / kPer) / 4 * 4;
  static constexpr int kCols = kWords * kPer;
};

// The row tile: warps along the columns (M) x along the x rows (N), and
// the stages of the ring (deeper at 8 rows, whose stages are small)
template <int R>
struct Rows;
template <>
struct Rows<kDecodeRows> {
  static constexpr int kWarpsM = 8, kWarpsN = 1, kStages = 4;
};
template <>
struct Rows<kPrefillRows> {
  static constexpr int kWarpsM = 4, kWarpsN = 2, kStages = 3;
};

// 4-byte words per staged x row: bf16 (64 k + 8 pad) / 2 or float32
// (64 k + 8 pad); the pads make the B-fragment reads conflict-free
template <bool kF32>
__host__ __device__ constexpr int x_pitch() {
  return kF32 ? kBK + 8 : kBK / 2 + 4;
}

template <int W, int R, bool kF32>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ring = Rows<R>::kStages * (kBK * Field<W>::kWords +
                                           R * x_pitch<kF32>()) * 4;
  constexpr int out = R * kOutPitch * 4;
  return (ring > out ? ring : out) + kSlots * kBK * 2;
}

struct Params {
  const void* x;
  const int32_t* words;
  const float* scale;
  float* y;
  float* ws;        // [splits][m][n] partials (splits > 1)
  int* tickets;     // one per (column tile, row tile), zero between launches
  int m, k, nw, n, kchunk, splits;
  bool vec_w, vec_x, vec_y;
};

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// D += A (16 x 16, row) * B (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c (8 k) of A row r in the [128][64] bf16
// tile: the chunk index is XORed with (r ^ r >> 3) & 7, so the 8 rows of
// an ldmatrix (consecutive rows) and the 8 rows of a decode store (rows
// j per + i of 8 consecutive words, per = 4 or 8) hit 8 distinct 16-byte
// bank groups
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * (kBK * 2) + ((c ^ ((r ^ (r >> 3)) & 7)) << 4);
}

// The high halves (bf16 bits) of two float32 values as one bf16 pair,
// a in the low half
__device__ __forceinline__ uint32_t pack_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// x = hi + mid + lo, each exactly a bf16 (see the head comment): the
// three parts' float32 bits, whose low halves are zero
__device__ __forceinline__ void split3(float x, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFF0000u;
  const float r = x - __uint_as_float(hi);
  mid = __float_as_uint(r) & 0xFFFF0000u;
  lo = __float_as_uint(r - __uint_as_float(mid));
}

template <int W, int R, bool kF32>
struct Smem {
  int32_t* words;   // [stages][kBK][kWords]
  uint32_t* xs;     // [stages][R][x_pitch]
  uint8_t* a;       // [kSlots][kBK] bf16, swizzled
  float* out;       // [R][kOutPitch], over the ring after the K loop
  __device__ explicit Smem(uint8_t* base) {
    constexpr int ring = Rows<R>::kStages * (kBK * Field<W>::kWords +
                                             R * x_pitch<kF32>());
    constexpr int out_words = R * kOutPitch;
    words = reinterpret_cast<int32_t*>(base);
    xs = reinterpret_cast<uint32_t*>(words + Rows<R>::kStages * kBK *
                                                 Field<W>::kWords);
    out = reinterpret_cast<float*>(base);
    a = base + 4 * (ring > out_words ? ring : out_words);
  }
};

// Start the copies of stage k0: words [k0, +64) x [g0, +kWords), x rows
// [r0, +R) x [k0, +64), zero past kend, nw and m
template <int W, int R, bool kF32>
__device__ __forceinline__ void load_stage(const Params& p,
                                           const Smem<W, R, kF32>& sm,
                                           int slot, int k0, int kend, int g0,
                                           int r0) {
  constexpr int kWords = Field<W>::kWords;
  constexpr int kXP = x_pitch<kF32>();
  const int tid = threadIdx.x;
  int32_t* ws = sm.words + slot * kBK * kWords;
  if (p.vec_w) {   // nw % 4 == 0: rows of 16-byte chunks
    for (int idx = tid; idx < kBK * (kWords / 4); idx += kThreads) {
      const int kk = idx / (kWords / 4), gl = (idx % (kWords / 4)) * 4;
      const bool ok = k0 + kk < kend && g0 + gl < p.nw;
      cp_async16(ws + kk * kWords + gl,
                 ok ? p.words + static_cast<int64_t>(k0 + kk) * p.nw + g0 + gl
                    : p.words,
                 ok);
    }
  } else {
    for (int idx = tid; idx < kBK * kWords; idx += kThreads) {
      const int kk = idx / kWords, gl = idx % kWords;
      const bool ok = k0 + kk < kend && g0 + gl < p.nw;
      cp_async4(ws + kk * kWords + gl,
                ok ? p.words + static_cast<int64_t>(k0 + kk) * p.nw + g0 + gl
                   : p.words,
                ok);
    }
  }
  uint32_t* xs = sm.xs + slot * R * kXP;
  if constexpr (kF32) {
    const float* x = static_cast<const float*>(p.x);
    if (p.vec_x) {   // k % 4 == 0: 4 floats a copy
      for (int idx = tid; idx < R * (kBK / 4); idx += kThreads) {
        const int rr = idx / (kBK / 4), kk = (idx % (kBK / 4)) * 4;
        const bool ok = r0 + rr < p.m && k0 + kk < kend;
        cp_async16(xs + rr * kXP + kk,
                   ok ? x + static_cast<int64_t>(r0 + rr) * p.k + k0 + kk : x,
                   ok);
      }
    } else {
      for (int idx = tid; idx < R * kBK; idx += kThreads) {
        const int rr = idx / kBK, kk = idx % kBK;
        const bool ok = r0 + rr < p.m && k0 + kk < kend;
        cp_async4(xs + rr * kXP + kk,
                  ok ? x + static_cast<int64_t>(r0 + rr) * p.k + k0 + kk : x,
                  ok);
      }
    }
  } else {
    const uint16_t* x = static_cast<const uint16_t*>(p.x);
    if (p.vec_x) {   // k % 8 == 0: 8 bf16 a copy
      for (int idx = tid; idx < R * (kBK / 8); idx += kThreads) {
        const int rr = idx / (kBK / 8), kk = (idx % (kBK / 8)) * 8;
        const bool ok = r0 + rr < p.m && k0 + kk < kend;
        cp_async16(xs + rr * kXP + kk / 2,
                   ok ? x + static_cast<int64_t>(r0 + rr) * p.k + k0 + kk : x,
                   ok);
      }
    } else {         // rows 2-byte aligned: plain loads and stores
      uint16_t* xh = reinterpret_cast<uint16_t*>(xs);
      for (int idx = tid; idx < R * kBK; idx += kThreads) {
        const int rr = idx / kBK, kk = idx % kBK;
        const bool ok = r0 + rr < p.m && k0 + kk < kend;
        xh[rr * 2 * kXP + kk] =
            ok ? __ldg(x + static_cast<int64_t>(r0 + rr) * p.k + k0 + kk)
               : static_cast<uint16_t>(0);
      }
    }
  }
}

// Decode the stage's words into the A tile: task (j, kq) takes the 4 k of
// quarter kq of word column j and writes field i's 4 bf16 values to half
// kq & 1 of chunk kq / 2 of A row j per + i with one 8-byte store
template <int W, int R, bool kF32>
__device__ __forceinline__ void decode_stage(const Smem<W, R, kF32>& sm,
                                             int slot) {
  constexpr int kWords = Field<W>::kWords, kPer = Field<W>::kPer;
  constexpr uint32_t kMask = (1u << W) - 1u, kHalf = 1u << (W - 1);
  // 2^23 + u - (2^23 + half) = u - half, exact
  constexpr float kMagic = 8388608.0f + static_cast<float>(kHalf);
  for (int t = threadIdx.x; t < kWords * (kBK / 4); t += kThreads) {
    const int j = t % kWords, kq = t / kWords;
    const int32_t* src = sm.words + slot * kBK * kWords + kq * 4 * kWords + j;
    uint32_t wd[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) wd[q] = static_cast<uint32_t>(src[q * kWords]);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // biased field u = f + half in [0, 2^W): its two's complement
        // with the sign bit flipped
        const uint32_t u = ((wd[q] >> (i * W)) & kMask) ^ kHalf;
        v[q] = __float_as_uint(__uint_as_float(0x4B000000u | u) - kMagic);
      }
      *reinterpret_cast<uint2*>(sm.a + tile_off(j * kPer + i, kq >> 1) +
                                (kq & 1) * 8) =
          make_uint2(pack_hi(v[0], v[1]), pack_hi(v[2], v[3]));
    }
  }
}

// One block: columns [blockIdx.x * kCols, +kCols), rows [blockIdx.y * R,
// +R), k in [blockIdx.z * kchunk, +kchunk)
template <int W, int R, bool kF32>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_kernel(Params p) {
  using F = Field<W>;
  constexpr int kWarpsN = Rows<R>::kWarpsN;
  constexpr int kWM = kSlots / Rows<R>::kWarpsM, kWN = R / kWarpsN;
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  constexpr int kXP = x_pitch<kF32>();
  constexpr int kStages = Rows<R>::kStages;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int last_block;
  const Smem<W, R, kF32> sm(smem);

  const int g0 = blockIdx.x * F::kWords, r0 = blockIdx.y * R;
  const int split = blockIdx.z;
  const int kbeg = split * p.kchunk;
  const int kend = min(p.k, kbeg + p.kchunk);
  const int nstages = (kend - kbeg + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const int gid = lane_id / 4, tig = lane_id % 4;
  const int m_base = (warp / kWarpsN) * kWM;
  const int n_base = (warp % kWarpsN) * kWN;

  float acc[kMT][kNT][4], total[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = total[mt][nt][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load_stage(p, sm, s, kbeg + s * kBK, kend, g0, r0);
    cp_async_commit();
  }
  for (int t = 0; t < nstages; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage t landed; the A tile of stage t-1 is free
    const int next = t + kStages - 1;
    if (next < nstages)
      load_stage(p, sm, next % kStages, kbeg + next * kBK, kend, g0, r0);
    cp_async_commit();
    decode_stage(sm, t % kStages);
    __syncthreads();
    const uint32_t* xs = sm.xs + (t % kStages) * R * kXP;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        if (m_base + mt * 16 < F::kCols)
          ldmatrix_x4(a[mt], sm.a + tile_off(m_base + mt * 16 + lane_id % 16,
                                             2 * ks + lane_id / 16));
      // bf16 B fragments of all n-tiles by ldmatrix: matrix (nt, h) is
      // rows n_base + 8 nt .. + 7 of the staged x, k 16 ks + 8 h .. + 7
      uint32_t bx[kNT][2];
      if constexpr (!kF32) {
        const uint8_t* xb = reinterpret_cast<const uint8_t*>(xs) +
                            (ks * 16 + ((lane_id / 8) % 2) * 8) * 2;
#pragma unroll
        for (int nt = 0; nt < kNT; nt += 2) {
          const int row = n_base + nt * 8 + (lane_id / 16) * 8 + lane_id % 8;
          if (nt + 1 < kNT) {
            uint32_t r[4];
            ldmatrix_x4(r, xb + row * kXP * 4);
            bx[nt][0] = r[0];
            bx[nt][1] = r[1];
            bx[nt + 1][0] = r[2];
            bx[nt + 1][1] = r[3];
          } else {
            ldmatrix_x2(bx[nt][0], bx[nt][1],
                        xb + (n_base + nt * 8 + lane_id % 8) * kXP * 4);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // B fragment: x[row][k0 + 2 tig, +1] and x[row][k0 + 2 tig + 8, +9]
        uint32_t b[3][2];
        constexpr int kParts = kF32 ? 3 : 1;
        if constexpr (kF32) {
          const int row = n_base + nt * 8 + gid;
          const float* xr = reinterpret_cast<const float*>(xs) + row * kXP +
                            ks * 16 + 2 * tig;
          const float2 lo2 = *reinterpret_cast<const float2*>(xr);
          const float2 hi2 = *reinterpret_cast<const float2*>(xr + 8);
          uint32_t h[4], md[4], l[4];
          split3(lo2.x, h[0], md[0], l[0]);
          split3(lo2.y, h[1], md[1], l[1]);
          split3(hi2.x, h[2], md[2], l[2]);
          split3(hi2.y, h[3], md[3], l[3]);
          // smallest part first
          b[0][0] = pack_hi(l[0], l[1]);
          b[0][1] = pack_hi(l[2], l[3]);
          b[1][0] = pack_hi(md[0], md[1]);
          b[1][1] = pack_hi(md[2], md[3]);
          b[2][0] = pack_hi(h[0], h[1]);
          b[2][1] = pack_hi(h[2], h[3]);
        } else {
          b[0][0] = bx[nt][0];
          b[0][1] = bx[nt][1];
        }
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if (m_base + mt * 16 >= F::kCols) continue;   // padding columns
#pragma unroll
          for (int q = 0; q < kParts; ++q)
            mma_bf16(acc[mt][nt], a[mt], b[q][0], b[q][1]);
        }
      }
    }
    if ((t + 1) % kAccStages == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            total[mt][nt][e] += acc[mt][nt][e];
            acc[mt][nt][e] = 0.0f;
          }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every MMA is done: the ring becomes the output stage

  // accumulator e of an m16n8 tile: column gid (+8 for e >= 2), row
  // 2 tig (+1 for odd e)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = m_base + mt * 16 + gid + (e >= 2 ? 8 : 0);
        const int row = n_base + nt * 8 + 2 * tig + (e & 1);
        sm.out[row * kOutPitch + col] = total[mt][nt][e] + acc[mt][nt][e];
      }
  __syncthreads();

  const int c0 = g0 * F::kPer;
  const int64_t plane = static_cast<int64_t>(p.m) * p.n;
  constexpr int kUnits = R * (F::kCols / 4);
  if (p.splits > 1) {   // this split's partial, unscaled
    float* ws = p.ws + split * plane;
    for (int u = threadIdx.x; u < kUnits; u += kThreads) {
      const int rr = u / (F::kCols / 4), cc = (u % (F::kCols / 4)) * 4;
      const int row = r0 + rr, col = c0 + cc;
      if (row >= p.m || col >= p.n) continue;
      const float* src = sm.out + rr * kOutPitch + cc;
      float* dst = ws + static_cast<int64_t>(row) * p.n + col;
      if (p.vec_y) {
        *reinterpret_cast<float4*>(dst) =
            *reinterpret_cast<const float4*>(src);
      } else {
        for (int q = 0; q < 4 && col + q < p.n; ++q) dst[q] = src[q];
      }
    }
    __threadfence();
    __syncthreads();
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (threadIdx.x == 0)
      last_block = atomicAdd(p.tickets + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    if (threadIdx.x == 0) p.tickets[tile] = 0;   // for the next launch
  }
  for (int u = threadIdx.x; u < kUnits; u += kThreads) {
    const int rr = u / (F::kCols / 4), cc = (u % (F::kCols / 4)) * 4;
    const int row = r0 + rr, col = c0 + cc;
    if (row >= p.m || col >= p.n) continue;
    const int64_t off = static_cast<int64_t>(row) * p.n + col;
    float v[4];
    if (p.splits > 1) {   // the partials in split order 0..S-1
      for (int q = 0; q < 4; ++q) v[q] = 0.0f;
      for (int s0 = 0; s0 < p.splits; s0 += kReduceBatch) {
        // a batch of partials in flight at once, then added in order
        float4 t4[kReduceBatch];
#pragma unroll
        for (int b = 0; b < kReduceBatch; ++b) {
          if (s0 + b >= p.splits) break;
          const float* src = p.ws + (s0 + b) * plane + off;
          if (p.vec_y) {
            t4[b] = __ldcg(reinterpret_cast<const float4*>(src));
          } else {
            t4[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            float* t = reinterpret_cast<float*>(&t4[b]);
            for (int q = 0; q < 4 && col + q < p.n; ++q)
              t[q] = __ldcg(src + q);
          }
        }
#pragma unroll
        for (int b = 0; b < kReduceBatch; ++b) {
          if (s0 + b >= p.splits) break;
          v[0] += t4[b].x;
          v[1] += t4[b].y;
          v[2] += t4[b].z;
          v[3] += t4[b].w;
        }
      }
    } else {
      for (int q = 0; q < 4; ++q) v[q] = sm.out[rr * kOutPitch + cc + q];
    }
    float* dst = p.y + off;
    if (p.vec_y) {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(p.scale + col));
      *reinterpret_cast<float4*>(dst) =
          make_float4(v[0] * s4.x, v[1] * s4.y, v[2] * s4.z, v[3] * s4.w);
    } else {
      for (int q = 0; q < 4 && col + q < p.n; ++q)
        dst[q] = v[q] * __ldg(p.scale + col + q);
    }
  }
}

template <int W, int R, bool kF32>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  constexpr int bytes = smem_bytes<W, R, kF32>();
  if (!configured) {   // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        quant_matmul_kernel<W, R, kF32>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  quant_matmul_kernel<W, R, kF32><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int W>
cudaError_t dispatch_rows(const Params& p, int rows, bool f32, dim3 grid,
                          cudaStream_t s) {
  if (rows == kDecodeRows)
    return f32 ? launch<W, kDecodeRows, true>(p, grid, s)
               : launch<W, kDecodeRows, false>(p, grid, s);
  return f32 ? launch<W, kPrefillRows, true>(p, grid, s)
             : launch<W, kPrefillRows, false>(p, grid, s);
}

int words_per_tile(int w) {
  switch (w) {
    case 2: return Field<2>::kWords;
    case 3: return Field<3>::kWords;
    case 4: return Field<4>::kWords;
    case 5: return Field<5>::kWords;
    case 6: return Field<6>::kWords;
    case 7: return Field<7>::kWords;
    default: return Field<8>::kWords;
  }
}

}  // namespace

extern "C" {

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [m, k] (bf16 if x_bf16 else f32) @ (fields of words [k, nw] * scale
// [n]) -> y [m, n] f32, n = nw * (32 / w).  rows: 8 or 64 x rows a block;
// kchunk: k a split (a multiple of 64); ws: [ceil(k / kchunk)][m][n]
// float32 partials and tickets: one zeroed int per (column tile, row
// tile), both unused with one split.  Returns cudaGetLastError() of the
// launch (0 = success).
int quant_matmul(const void* x, const void* words, const void* scale,
                 void* y, void* ws, void* tickets, int m, int k, int nw,
                 int w, int x_bf16, int rows, int kchunk,
                 void* stream) {
  if (w < 2 || w > 8 || m < 1 || k < 1 || nw < 1 ||
      (rows != kDecodeRows && rows != kPrefillRows) || kchunk < kBK ||
      kchunk % kBK != 0)
    return cudaErrorInvalidValue;
  const int per = 32 / w;
  const int splits = (k + kchunk - 1) / kchunk;
  const int tiles_x = (nw + words_per_tile(w) - 1) / words_per_tile(w);
  const int tiles_y = (m + rows - 1) / rows;
  if (tiles_y > 65535 || splits > 65535 ||
      static_cast<int64_t>(nw) * per > 0x7FFFFFFF ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  Params p{x,
           static_cast<const int32_t*>(words),
           static_cast<const float*>(scale),
           static_cast<float*>(y),
           static_cast<float*>(ws),
           static_cast<int*>(tickets),
           m, k, nw, nw * per, kchunk, splits,
           nw % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0,
           k % (x_bf16 ? 8 : 4) == 0 &&
               reinterpret_cast<uintptr_t>(x) % 16 == 0,
           (nw * per) % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(ws) % 16 == 0};
  const dim3 grid(tiles_x, tiles_y, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = !x_bf16;
  switch (w) {
    case 2: return dispatch_rows<2>(p, rows, f32, grid, s);
    case 3: return dispatch_rows<3>(p, rows, f32, grid, s);
    case 4: return dispatch_rows<4>(p, rows, f32, grid, s);
    case 5: return dispatch_rows<5>(p, rows, f32, grid, s);
    case 6: return dispatch_rows<6>(p, rows, f32, grid, s);
    case 7: return dispatch_rows<7>(p, rows, f32, grid, s);
    default: return dispatch_rows<8>(p, rows, f32, grid, s);
  }
}

}  // extern "C"
