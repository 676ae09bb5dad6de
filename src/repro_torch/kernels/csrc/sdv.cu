// Packed SDV GEMV (B1) and GEMM (B2) for Hopper (sm_90a), on the int8
// tensor cores.  B2 at many rows (sdv_matmul.WGMMA_MIN_ROWS and up) of
// single-limb words and operands within 8 bits runs csrc/sdv_wgmma.cu
// instead (TMA, wgmma, the words decoded once for 256 rows); this file
// keeps the GEMV, B2 at fewer rows, the two-limb DSP48E2/DSP58 words and
// the byte-sliced operands.
//
// Replaces the two TPU kernels of the JAX package's decode/prefill path:
//   B1  repro/kernels/sdv_matvec.py::sdv_matvec  (decode, <= 8 rows)
//   B2  repro/kernels/sdv_matmul.py::sdv_matmul  (prefill, > 8 rows)
// both built on the shared body repro/kernels/sdv_matmul.py::_body.
//
// What is computed: the exact int32 per-lane dot products
//   out[r, g, i] = sum_k x[r, k] * a_i(word[k, g])   (mod 2^32)
// of integer activations (w_b bits) against SDV storage words
// ([K, G] int32, or [2, K, G] int32 lo/hi limb planes for the wide
// DSP48E2/DSP58 words).  Lane i of a word (paper Sec. III-C, the storage
// layout of ops.prepare_sdv_weights) is
//   signed:   r_i - s_i 2^(w_a-1), r_i the (w_a-1)-bit field at i L and
//             s_i the parked sign bit at packed_width + i;
//   unsigned: the w_a-bit field at i L.
// The DSP computes these sums with one wide multiply per (row, group, k)
// and tracks the carries between lanes (sdv_matmul_plain repeats that
// step by step); both give the exact integer sums, which is what lets
// this kernel take another road to the same bits.
//
// Bound: bytes.  At w_a, w_b <= 8 every lane value and activation fits
// an int8 (.s8, or .u8 for unsigned storage / unsigned activations), so
// the products are int8 tensor-core work: 2 R M K operations at 1,979
// TOP/s is below the words' bytes (4 M K / n at 3.35 TB/s) up to R ~ 590
// rows at n = 2.  The packing still pays where the bytes are: a layer
// streams the words, never int8 weights.
//
// Wider operands (the planner's w_b = a_bits + 1 = 9, W16A16, ...) are
// cut into byte slices, v = sum_j 2^(8j) s_j: the top slice signed (.s8)
// when the operand is, the lower ones unsigned (.u8), at most 4 slices
// (only the low 32 bits of an operand reach a sum mod 2^32).  Each slice
// pair (ia, ib) with ia + ib <= 3 is a block of its own (the grid's z
// axis runs over K splits x slice pairs) that decodes lane byte ia and
// activation byte ib into the same int8 tiles and adds its sum, shifted
// left 8 (ia + ib) bits in 32-bit integers, into the zeroed output: the
// integer MMA wraps (no .satfinite), so the total is the exact sum mod
// 2^32, the reference's lo32.  Operands of at most 8 bits run the
// unsliced kernels, which carry no slice arithmetic.
//
// What the design does about it.  Each block owns up to 64 word columns
// (bg groups, n * bg <= 128 output channels) and 8 (B1) or 128 (B2)
// activation rows, and walks its K chunk in stages of 64:
//   1. a 3-stage ring of word tiles [64 k][bg] (both limb planes) and
//      activation tiles in shared memory, filled with cp.async (16 bytes
//      a thread where the rows are 16-byte aligned, else 4), zero-filled
//      past the K, G and row edges;
//   2. each word is decoded once into its n lanes as int8, into an A tile
//      [128 slots][64 k] (K contiguous; slot i * bg + gl holds lane i of
//      group g0 + gl): one thread decodes 16 consecutive k of one group
//      and writes each lane's 16 bytes with one 16-byte store, ~6 integer
//      instructions per weight;
//   3. the int32 activations are narrowed to an int8 B tile [rows][64 k];
//   4. mma.sync m16n8k32 (int8 in, int32 accumulate) multiplies the
//      tiles: channels on M, rows on N, fragments by ldmatrix from tiles
//      swizzled against bank conflicts.
// Where the grid is small the K loop is split across blocks to fill the
// 132 SMs; the partial sums are added with integer atomics into the
// zeroed output, exact in any order, hence deterministic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 15;    // plan_sdv's largest n is 10
constexpr int kThreads = 256;    // 8 warps
constexpr int kTileM = 128;      // lane slots (output channels) per block
constexpr int kMaxGroups = 64;   // word columns per block
constexpr int kBK = 64;          // k per stage: two mma k-steps of 32
constexpr int kStages = 3;
constexpr int kGemvRows = 8;
constexpr int kGemmRows = 128;
constexpr int kXPitch = kBK + 4;  // int32 per staged B2 activation row

// Flag bits 3-4 and 5-6 hold the byte slices of the lanes and of the
// activations, minus 1
enum Flags : int { kSignedA = 1, kSignedB = 2, kTwoLimb = 4 };
constexpr int kSlicesA = 3, kSlicesB = 5;

struct Params {
  const int32_t* x;   // B1: x_t [K, rows]; B2: x [rows, K]
  const int32_t* w;   // [K, G] or [2, K, G]
  int32_t* out;       // [rows, G, n]
  int rows, K, G, n, lane, w_a, sign_shift, bg, kchunk;
  int a_slices, b_slices, splits;   // byte slices; K splits per slice pair
  bool signed_a, signed_b, vec_w, vec_x, accumulate;
};

// B1 and B2 differ in their row tile, warp layout and activation layout
template <bool kGemm>
struct Shape;
template <>
struct Shape<false> {          // B1: 8 rows, K-major activations
  static constexpr int kBN = kGemvRows, kWarpsM = 8, kWarpsN = 1;
  static constexpr int kXStage = kBK * kGemvRows;
};
template <>
struct Shape<true> {           // B2: 128 rows, row-major activations
  static constexpr int kBN = kGemmRows, kWarpsM = 2, kWarpsN = 4;
  static constexpr int kXStage = kGemmRows * kXPitch;
};

template <bool kGemm, bool kTwoLimb>
constexpr int smem_bytes() {
  return kStages * ((kTwoLimb ? 2 : 1) * kBK * kMaxGroups +
                    Shape<kGemm>::kXStage) * 4 +
         kTileM * kBK + Shape<kGemm>::kBN * kBK;
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2],
                                            const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// D += A (16 x 32, row) * B (32 x 8, col), int8 in, int32 accumulate
template <bool kAU8, bool kBU8>
struct Mma;
#define SDV_MMA(AU8, BU8, TYPES)                                          \
  template <>                                                             \
  struct Mma<AU8, BU8> {                                                  \
    __device__ __forceinline__ static void run(int (&d)[4],               \
                                               const uint32_t (&a)[4],    \
                                               const uint32_t (&b)[2]) {  \
      asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TYPES         \
                   ".s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "         \
                   "{%0,%1,%2,%3};\n"                                     \
                   : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])       \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),          \
                     "r"(b[0]), "r"(b[1]));                               \
    }                                                                     \
  };
SDV_MMA(false, false, "s8.s8")
SDV_MMA(false, true, "s8.u8")
SDV_MMA(true, false, "u8.s8")
SDV_MMA(true, true, "u8.u8")
#undef SDV_MMA

// Byte offset of 16-byte chunk c (0..3) of row r in a [rows][64] int8
// tile: the chunk index is XORed with bits 1..2 of the row, so the 8 rows
// an ldmatrix (or a 16-byte store per row) touches hit 8 distinct bank
// groups
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// The low bytes of four int32 values, as one little-endian word
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Bits s.. of the stored word (hi:lo for the two-limb words)
template <bool kTwoLimb>
__device__ __forceinline__ uint32_t shr(uint32_t lo, uint32_t hi, int s) {
  if constexpr (kTwoLimb)
    return s < 32 ? __funnelshift_r(lo, hi, s) : hi >> (s - 32);
  else
    return lo >> s;
}

template <bool kGemm, bool kTwoLimb>
struct Smem {
  int32_t* words;   // [kStages][planes][kBK][kMaxGroups]
  int32_t* xs;      // [kStages][kXStage]
  uint8_t* a;       // [kTileM][kBK], swizzled
  uint8_t* b;       // [kBN][kBK], swizzled
  static constexpr int kPlanes = kTwoLimb ? 2 : 1;
  static constexpr int kWordStage = kPlanes * kBK * kMaxGroups;
  __device__ explicit Smem(uint8_t* base) {
    words = reinterpret_cast<int32_t*>(base);
    xs = words + kStages * kWordStage;
    a = reinterpret_cast<uint8_t*>(xs + kStages * Shape<kGemm>::kXStage);
    b = a + kTileM * kBK;
  }
};

// Start the cp.async copies of stage k0 (word tile + activation tile)
template <bool kGemm, bool kTwoLimb>
__device__ __forceinline__ void load_stage(const Params& p,
                                           const Smem<kGemm, kTwoLimb>& sm,
                                           int slot, int k0, int kend, int g0,
                                           int r0) {
  const int tid = threadIdx.x;
  int32_t* ws = sm.words + slot * Smem<kGemm, kTwoLimb>::kWordStage;
  const int64_t plane = static_cast<int64_t>(p.K) * p.G;
#pragma unroll
  for (int pl = 0; pl < Smem<kGemm, kTwoLimb>::kPlanes; ++pl) {
    int32_t* dst = ws + pl * kBK * kMaxGroups;
    const int32_t* src = p.w + pl * plane;
    if (p.vec_w) {   // G % 4 == 0: rows of 16-byte chunks
      for (int idx = tid; idx < kBK * (kMaxGroups / 4); idx += kThreads) {
        const int kk = idx / (kMaxGroups / 4);
        const int gl = (idx % (kMaxGroups / 4)) * 4;
        if (gl >= p.bg) continue;
        const bool ok = k0 + kk < kend && g0 + gl < p.G;
        cp_async16(dst + kk * kMaxGroups + gl,
                   ok ? src + static_cast<int64_t>(k0 + kk) * p.G + g0 + gl
                      : src,
                   ok);
      }
    } else {
      for (int idx = tid; idx < kBK * kMaxGroups; idx += kThreads) {
        const int kk = idx / kMaxGroups, gl = idx % kMaxGroups;
        if (gl >= p.bg) continue;
        const bool ok = k0 + kk < kend && g0 + gl < p.G;
        cp_async4(dst + kk * kMaxGroups + gl,
                  ok ? src + static_cast<int64_t>(k0 + kk) * p.G + g0 + gl
                     : src,
                  ok);
      }
    }
  }
  int32_t* xs = sm.xs + slot * Shape<kGemm>::kXStage;
  if constexpr (kGemm) {   // x [rows, K] -> [kGemmRows][kXPitch]
    if (p.vec_x) {         // K % 4 == 0
      for (int idx = tid; idx < kGemmRows * (kBK / 4); idx += kThreads) {
        const int rr = idx / (kBK / 4), kk = (idx % (kBK / 4)) * 4;
        const bool ok = r0 + rr < p.rows && k0 + kk < kend;
        cp_async16(xs + rr * kXPitch + kk,
                   ok ? p.x + static_cast<int64_t>(r0 + rr) * p.K + k0 + kk
                      : p.x,
                   ok);
      }
    } else {
      for (int idx = tid; idx < kGemmRows * kBK; idx += kThreads) {
        const int rr = idx / kBK, kk = idx % kBK;
        const bool ok = r0 + rr < p.rows && k0 + kk < kend;
        cp_async4(xs + rr * kXPitch + kk,
                  ok ? p.x + static_cast<int64_t>(r0 + rr) * p.K + k0 + kk
                     : p.x,
                  ok);
      }
    }
  } else {                 // x_t [K, rows]: the stage is one contiguous run
    const int valid = (kend - k0) * p.rows;
    for (int e = tid; e < kBK * p.rows; e += kThreads) {
      const bool ok = e < valid;
      cp_async4(xs + e, ok ? p.x + static_cast<int64_t>(k0) * p.rows + e
                           : p.x,
                ok);
    }
  }
}

// Decode the stage's words into the A tile: thread (gl, ku) takes the 16
// k of chunk ku of group g0 + gl and writes byte ia of lane i's 16 values
// to slot i * bg + gl
template <bool kGemm, bool kTwoLimb>
__device__ __forceinline__ void decode_stage(const Params& p,
                                             const Smem<kGemm, kTwoLimb>& sm,
                                             int slot, int ia) {
  const int gl = threadIdx.x % kMaxGroups, ku = threadIdx.x / kMaxGroups;
  if (gl >= p.bg) return;
  const int32_t* ws = sm.words + slot * Smem<kGemm, kTwoLimb>::kWordStage +
                      ku * 16 * kMaxGroups + gl;
  uint32_t lo[16], hi[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    lo[j] = static_cast<uint32_t>(ws[j * kMaxGroups]);
    hi[j] = kTwoLimb ? static_cast<uint32_t>(ws[kBK * kMaxGroups +
                                                j * kMaxGroups])
                     : 0u;
  }
  // signed: the field's w_a - 1 bits minus the sign bit moved to bit
  // w_a - 1 (the low byte is the lane's two's complement); unsigned: the
  // field's w_a bits
  const int rbits = p.signed_a ? p.w_a - 1 : p.w_a;
  const uint32_t rmask = rbits >= 32 ? ~0u : (1u << rbits) - 1u;
  const uint32_t smask = p.signed_a ? 1u << (p.w_a - 1) : 0u;
  for (int i = 0; i < p.n; ++i) {
    const int s = i * p.lane;
    const int t = p.signed_a ? p.sign_shift + i - (p.w_a - 1) : 0;
    uint32_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = ((shr<kTwoLimb>(lo[j], hi[j], s) & rmask) -
              (shr<kTwoLimb>(lo[j], hi[j], t) & smask)) >> (8 * ia);
    uint4 q;
    q.x = pack4(v[0], v[1], v[2], v[3]);
    q.y = pack4(v[4], v[5], v[6], v[7]);
    q.z = pack4(v[8], v[9], v[10], v[11]);
    q.w = pack4(v[12], v[13], v[14], v[15]);
    *reinterpret_cast<uint4*>(sm.a + tile_off(i * p.bg + gl, ku)) = q;
  }
}

// Narrow byte ib of the stage's int32 activations into the int8 B tile
// [rows][64 k]
template <bool kGemm, bool kTwoLimb>
__device__ __forceinline__ void convert_stage(const Params& p,
                                              const Smem<kGemm, kTwoLimb>& sm,
                                              int slot, int ib) {
  const int32_t* xs = sm.xs + slot * Shape<kGemm>::kXStage;
  if constexpr (kGemm) {
    // unit (row rr, chunk c); consecutive threads on consecutive rows,
    // conflict-free through the padded pitch
    for (int u = threadIdx.x; u < kGemmRows * 4; u += kThreads) {
      const int rr = u % kGemmRows, c = u / kGemmRows;
      const int4* src = reinterpret_cast<const int4*>(xs + rr * kXPitch +
                                                      c * 16);
      uint32_t w4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = src[q];
        w4[q] = pack4(v.x >> (8 * ib), v.y >> (8 * ib), v.z >> (8 * ib),
                      v.w >> (8 * ib));
      }
      *reinterpret_cast<uint4*>(sm.b + tile_off(rr, c)) =
          make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  } else {
    if (threadIdx.x >= kGemvRows * 4) return;
    const int b = threadIdx.x % kGemvRows, c = threadIdx.x / kGemvRows;
    uint32_t v[16];
#pragma unroll
    for (int q = 0; q < 16; ++q)
      v[q] = b < p.rows
                 ? static_cast<uint32_t>(xs[(c * 16 + q) * p.rows + b]) >>
                       (8 * ib)
                 : 0u;
    *reinterpret_cast<uint4*>(sm.b + tile_off(b, c)) =
        make_uint4(pack4(v[0], v[1], v[2], v[3]),
                   pack4(v[4], v[5], v[6], v[7]),
                   pack4(v[8], v[9], v[10], v[11]),
                   pack4(v[12], v[13], v[14], v[15]));
  }
}

// One block: channels g0 * n .. (g0 + bg) * n, rows r0 .. r0 + kBN, k in
// [split * kchunk, + kchunk), lane byte ia times activation byte ib
template <bool kGemm, bool kTwoLimb, bool kAU8, bool kBU8>
__device__ __forceinline__ void sdv_body(const Params& p, int split, int ia,
                                         int ib) {
  using S = Shape<kGemm>;
  constexpr int kWM = kTileM / S::kWarpsM, kWN = S::kBN / S::kWarpsN;
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  extern __shared__ __align__(128) uint8_t smem[];
  const Smem<kGemm, kTwoLimb> sm(smem);

  const int g0 = blockIdx.x * p.bg, r0 = blockIdx.y * S::kBN;
  const int kbeg = split * p.kchunk;
  const int kend = min(p.K, kbeg + p.kchunk);
  const int nstages = (kend - kbeg + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane_id = threadIdx.x % 32;
  const int m_base = (warp / S::kWarpsN) * kWM;
  const int n_base = (warp % S::kWarpsN) * kWN;
  const int slots = p.n * p.bg;

  int acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) load_stage(p, sm, s, kbeg + s * kBK, kend, g0, r0);
    cp_async_commit();
  }
  for (int t = 0; t < nstages; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage t landed; the tiles of stage t-1 are free
    const int next = t + kStages - 1;
    if (next < nstages)
      load_stage(p, sm, next % kStages, kbeg + next * kBK, kend, g0, r0);
    cp_async_commit();
    decode_stage(p, sm, t % kStages, ia);
    convert_stage(p, sm, t % kStages, ib);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        ldmatrix_x2(b[nt], sm.b + tile_off(n_base + nt * 8 + lane_id % 8,
                                           2 * ks + (lane_id / 8) % 2));
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if (m_base + mt * 16 >= slots) continue;   // padding slots
        uint32_t a[4];
        ldmatrix_x4(a, sm.a + tile_off(m_base + mt * 16 + lane_id % 16,
                                       2 * ks + lane_id / 16));
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
          Mma<kAU8, kBU8>::run(acc[mt][nt], a, b[nt]);
      }
    }
  }

  // accumulator e of a m16n8 tile: slot gid (+8 for e >= 2), row
  // 2 tig (+1 for odd e)
  const int gid = lane_id / 4, tig = lane_id % 4;
  const int64_t row_stride = static_cast<int64_t>(p.G) * p.n;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int slot = m_base + mt * 16 + gid + (e >= 2 ? 8 : 0);
      if (slot >= slots) continue;
      const int i = slot / p.bg, g = g0 + slot % p.bg;
      if (g >= p.G) continue;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int r = r0 + n_base + nt * 8 + 2 * tig + (e & 1);
        if (r >= p.rows) continue;
        int32_t* o = p.out + r * row_stride +
                     static_cast<int64_t>(g) * p.n + i;
        const int32_t v = static_cast<int32_t>(
            static_cast<uint32_t>(acc[mt][nt][e]) << (8 * (ia + ib)));
        if (p.accumulate)
          atomicAdd(o, v);
        else
          *o = v;
      }
    }
}

template <bool kTwoLimb, bool kAU8, bool kBU8>
__global__ void __launch_bounds__(kThreads, 2)
sdv_gemv_kernel(Params p) {
  sdv_body<false, kTwoLimb, kAU8, kBU8>(p, blockIdx.z, 0, 0);
}

template <bool kTwoLimb, bool kAU8, bool kBU8>
__global__ void __launch_bounds__(kThreads, 1)
sdv_gemm_kernel(Params p) {
  sdv_body<true, kTwoLimb, kAU8, kBU8>(p, blockIdx.z, 0, 0);
}

// Slice pair `pair` in the order (ia, ib), ia + ib <= 3, ib fastest
// (sdv_matmul.slice_pairs mirrors it)
__device__ __forceinline__ void slice_pair(const Params& p, int pair,
                                           int& ia, int& ib) {
  for (ia = 0; ia < p.a_slices; ++ia) {
    const int nb = min(p.b_slices, 4 - ia);
    if (pair < nb) break;
    pair -= nb;
  }
  ib = pair;
}

// The sliced operands: blockIdx.z = pair * splits + split; the top slice
// of a signed operand is .s8, every other slice .u8
template <bool kGemm, bool kTwoLimb>
__device__ __forceinline__ void sliced_body(const Params& p) {
  int ia, ib;
  slice_pair(p, blockIdx.z / p.splits, ia, ib);
  const int split = blockIdx.z % p.splits;
  const bool au8 = !(p.signed_a && ia == p.a_slices - 1);
  const bool bu8 = !(p.signed_b && ib == p.b_slices - 1);
  if (au8) {
    if (bu8)
      sdv_body<kGemm, kTwoLimb, true, true>(p, split, ia, ib);
    else
      sdv_body<kGemm, kTwoLimb, true, false>(p, split, ia, ib);
  } else {
    if (bu8)
      sdv_body<kGemm, kTwoLimb, false, true>(p, split, ia, ib);
    else
      sdv_body<kGemm, kTwoLimb, false, false>(p, split, ia, ib);
  }
}

template <bool kTwoLimb>
__global__ void __launch_bounds__(kThreads, 2)
sdv_gemv_kernel_sliced(Params p) {
  sliced_body<false, kTwoLimb>(p);
}

template <bool kTwoLimb>
__global__ void __launch_bounds__(kThreads, 1)
sdv_gemm_kernel_sliced(Params p) {
  sliced_body<true, kTwoLimb>(p);
}

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, bool& configured, int bytes,
                          const Params& p, dim3 grid, cudaStream_t stream) {
  if (!configured) {   // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool kGemm, bool kTwoLimb, bool kAU8, bool kBU8>
cudaError_t launch(const Params& p, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  return launch_kernel(kGemm ? sdv_gemm_kernel<kTwoLimb, kAU8, kBU8>
                             : sdv_gemv_kernel<kTwoLimb, kAU8, kBU8>,
                       configured, smem_bytes<kGemm, kTwoLimb>(), p, grid,
                       stream);
}

template <bool kGemm, bool kTwoLimb>
cudaError_t launch_sliced(const Params& p, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  return launch_kernel(kGemm ? sdv_gemm_kernel_sliced<kTwoLimb>
                             : sdv_gemv_kernel_sliced<kTwoLimb>,
                       configured, smem_bytes<kGemm, kTwoLimb>(), p, grid,
                       stream);
}

template <bool kGemm>
cudaError_t dispatch(const Params& p, int flags, dim3 grid,
                     cudaStream_t stream) {
  if (p.a_slices > 1 || p.b_slices > 1)
    return flags & kTwoLimb ? launch_sliced<kGemm, true>(p, grid, stream)
                            : launch_sliced<kGemm, false>(p, grid, stream);
  const int key = (flags & kTwoLimb ? 4 : 0) | (flags & kSignedA ? 0 : 2) |
                  (flags & kSignedB ? 0 : 1);
  switch (key) {
    case 0: return launch<kGemm, false, false, false>(p, grid, stream);
    case 1: return launch<kGemm, false, false, true>(p, grid, stream);
    case 2: return launch<kGemm, false, true, false>(p, grid, stream);
    case 3: return launch<kGemm, false, true, true>(p, grid, stream);
    case 4: return launch<kGemm, true, false, false>(p, grid, stream);
    case 5: return launch<kGemm, true, false, true>(p, grid, stream);
    case 6: return launch<kGemm, true, true, false>(p, grid, stream);
    default: return launch<kGemm, true, true, true>(p, grid, stream);
  }
}

template <bool kGemm>
int run(const void* x, const void* w, void* out, int rows, int K, int G,
        int n, int lane, int w_a, int sign_shift, int flags, int bg,
        int kchunk, void* stream) {
  constexpr int kBN = Shape<kGemm>::kBN;
  if (n < 1 || n > kMaxLanes || rows < 1 || K < 1 || G < 1 ||
      (!kGemm && rows > kGemvRows) || bg < 4 || bg % 4 != 0 ||
      bg > kMaxGroups || n * bg > kTileM || kchunk < kBK ||
      kchunk % kBK != 0 || w_a < 1 || w_a > 32)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (K + kchunk - 1) / kchunk;
  const int a_slices = ((flags >> kSlicesA) & 3) + 1;
  const int b_slices = ((flags >> kSlicesB) & 3) + 1;
  int pairs = 0;
  for (int ia = 0; ia < a_slices; ++ia) pairs += min(b_slices, 4 - ia);
  Params p{static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
           static_cast<int32_t*>(out), rows, K, G, n, lane, w_a, sign_shift,
           bg, kchunk, a_slices, b_slices, splits, (flags & kSignedA) != 0,
           (flags & kSignedB) != 0,
           G % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0,
           K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0,
           splits * pairs > 1};
  if (p.accumulate) {   // split-K blocks add into a zeroed output
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(rows) * G * n * sizeof(int32_t), s);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((G + bg - 1) / bg, (rows + kBN - 1) / kBN, splits * pairs);
  return dispatch<kGemm>(p, flags, grid, s);
}

}  // namespace

extern "C" {

const char* sdv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (bytes): B2 (gemm) or B1, on the
// two-limb or the INT32 words.
int sdv_smem_bytes(int gemm, int two_limb) {
  if (gemm)
    return two_limb ? smem_bytes<true, true>() : smem_bytes<true, false>();
  return two_limb ? smem_bytes<false, true>() : smem_bytes<false, false>();
}

// Both launchers return cudaGetLastError() of their launch (0 = success).
// B1: x_t [K, rows] (rows <= 8); B2: x [rows, K].  bg: word columns per
// block (a multiple of 4, n * bg <= 128); kchunk: K per block (a multiple
// of 64); flags: Flags | (lane slices - 1) << 3 | (activation slices - 1)
// << 5.
int sdv_gemv(const void* x_t, const void* w, void* out, int rows, int K,
             int G, int n, int lane, int w_a, int sign_shift, int flags,
             int bg, int kchunk, void* stream) {
  return run<false>(x_t, w, out, rows, K, G, n, lane, w_a, sign_shift, flags,
                    bg, kchunk, stream);
}

int sdv_gemm(const void* x, const void* w, void* out, int rows, int K, int G,
             int n, int lane, int w_a, int sign_shift, int flags, int bg,
             int kchunk, void* stream) {
  return run<true>(x, w, out, rows, K, G, n, lane, w_a, sign_shift, flags,
                   bg, kchunk, stream);
}

}  // extern "C"
