// Packed SDV GEMM (B2) at many rows on Hopper's own pipeline (sm_90a):
// TMA, mbarriers and wgmma.
//
// Replaces, beside csrc/sdv.cu's sdv_gemm_kernel, the TPU kernel
//   B2  repro/kernels/sdv_matmul.py::sdv_matmul  (prefill, > 8 rows)
// for the calls with many rows: single-limb words (INT32 datapath) and
// operands of at most 8 bits, at or above sdv_matmul.WGMMA_MIN_ROWS rows.
// It computes what sdv_gemm_kernel computes, the exact int32 per-lane
// dot products out[r, g, i] = sum_k x[r, k] * a_i(word[k, g]) (mod 2^32),
// with x given as int8 (uint8 for unsigned activations) [rows, Kp], Kp
// the K rounded up to 16 (zeros past K), so TMA can bring it as it is.
//
// Bound: operations.  At 4096 rows a llava layer's 7 projections are
// 2 R M K = 1.8e12 int8 operations (0.90 ms at 1,979 TOP/s) against
// 0.44 GB of words (0.13 ms at 3.35 TB/s); the decode of the words into
// int8 lanes (~2 integer instructions per lane byte) is the work that
// the tensor cores do not do, and the words (4 bytes per n = 2 lanes)
// are twice an int8 weight's bytes through the L2.  Measured (PERF.md,
// H100): 28.5% of that bound; at the 4096 x 14336 call the TMA ring
// alone takes 55% of the time and the decode, on the consumers' path,
// most of the rest.
//
// What the design does about it.  A block owns 2 x 64 lane slots (two
// warpgroups of n * bgw <= 64 output channels each, bgw word columns)
// and 256 activation rows, and walks K in stages of 64:
//   1. a producer warpgroup (one thread of it, the rest of its registers
//      handed to the consumers with setmaxnreg) keeps a ring of stages
//      (up to 6) full with TMA:
//      the activation tile [256 rows][64 k] (64-byte swizzle, the layout
//      wgmma reads) and the word tile [64 k][2 bgw] (zeros past the K, G
//      and row edges), each stage completed through an mbarrier;
//   2. each consumer warpgroup decodes its bgw word columns of the stage
//      into an int8 A tile [64 slots][64 k] (slot gl * n + i holds lane i
//      of group gl: the slots are the block's output channels in order),
//      four k at a time with byte permutes (the field's byte of four
//      words, shifted and masked, plus the sign byte times 2^8 - 2^(w_a-1)),
//      once for all 256 rows;
//   3. it issues two wgmma.mma_async m64n256k32 (s8/u8 in, s32
//      accumulate, wrapping: no .satfinite) on the A tile and the
//      activation tile, and while they run decodes the next stage's
//      words into its second A tile, then waits and frees the stage;
//   4. blocks are persistent over the output tiles (row tiles fastest, so
//      the blocks in flight share their word columns in the L2) and store
//      their accumulators straight to out: 8 consecutive channels of a
//      row per 32-byte sector.  No split K, no atomics: the output is
//      written once, deterministic.
// The decoded lanes never leave shared memory: a layer streams its words.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kConsumers = 2;               // warpgroups running wgmma
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kSlots = 64;                  // lane slots (M) a warpgroup
constexpr int kRows = 256;                  // activation rows (N) a block
constexpr int kBK = 64;                     // k a stage (an int8 row)
constexpr int kMaxLanes = 15;
constexpr int kMaxSmem = 232448;
constexpr int kXStage = kRows * kBK;        // bytes
constexpr int kATile = kSlots * kBK;        // bytes
constexpr int kAlign = 1024;                // swizzle atoms line up
enum Flags : int { kSignedA = 1, kSignedB = 2 };

__host__ __device__ constexpr int word_stage_bytes(int bgw) {
  return kBK * kConsumers * bgw * 4;
}

__host__ __device__ constexpr int smem_bytes(int bgw, int stages) {
  return kAlign + stages * (kXStage + word_stage_bytes(bgw) + 16) +
         kConsumers * 2 * kATile;
}

struct Params {
  int32_t* out;     // [rows, G, n]
  int rows, K, G, n, lane, w_a, sign_shift, bgw, stages;
  int row_tiles, tiles, k_stages;
  bool signed_a;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The ring: activation tiles, word tiles, the A tiles (two a warpgroup)
// and the full / empty barriers of each stage
struct Smem {
  uint8_t* xs;
  int32_t* ws;
  uint8_t* as;
  uint64_t* full;
  uint64_t* empty;
  int wstage;       // int32 of one word tile
  __device__ Smem(uint8_t* raw, const Params& p) {
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + kAlign - 1) &
        ~static_cast<uintptr_t>(kAlign - 1));
    wstage = word_stage_bytes(p.bgw) / 4;
    xs = base;
    ws = reinterpret_cast<int32_t*>(xs + p.stages * kXStage);
    as = reinterpret_cast<uint8_t*>(ws + p.stages * wstage);
    full = reinterpret_cast<uint64_t*>(as + kConsumers * 2 * kATile);
    empty = full + p.stages;
  }
  __device__ uint8_t* x(int s) const { return xs + s * kXStage; }
  __device__ int32_t* w(int s) const { return ws + s * wstage; }
  __device__ uint8_t* a(int c, int b) const {
    return as + (c * 2 + b) * kATile;
  }
};

// --- mbarriers and TMA ------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// --- wgmma ------------------------------------------------------------

// K-major tile of 64-byte rows in the 64-byte swizzle (chunk c of row r
// at chunk c ^ ((r >> 1) & 3)): leading offset unused, 8-row groups 512
// bytes apart
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return ((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) |
         (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the accumulators in place across the asynchronous products
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 slots, 256 rows] += A[64, 32 k] * B[32 k, 256], int8 in, int32
// accumulate (wrapping)
template <bool kAU8, bool kBU8>
struct Wgmma;
#define SDV_WGMMA(AU8, BU8, TYPES)                                           \
  template <>                                                                \
  struct Wgmma<AU8, BU8> {                                                   \
    __device__ __forceinline__ static void run(int (&d)[128], uint64_t da,   \
                                               uint64_t db) {                \
      asm volatile(                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                      \
          "wgmma.mma_async.sync.aligned.m64n256k32.s32." TYPES " "           \
          "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "    \
          "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
          "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
          "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
          "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, " \
          "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, " \
          "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, " \
          "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "  \
          "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, " \
          "%115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, " \
          "%126, %127}, %128, %129, p;\n}\n"                                 \
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),      \
            "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),      \
            "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),              \
            "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),              \
            "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),              \
            "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),              \
            "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),              \
            "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]),              \
            "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),              \
            "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),              \
            "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),              \
            "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),              \
            "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),              \
            "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]),              \
            "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),              \
            "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),              \
            "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),              \
            "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),              \
            "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),              \
            "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]),              \
            "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),              \
            "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),              \
            "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]),              \
            "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),              \
            "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),            \
            "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]),          \
            "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),          \
            "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),          \
            "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]),          \
            "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),          \
            "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),          \
            "+r"(d[126]), "+r"(d[127])                                       \
          : "l"(da), "l"(db), "r"(1));                                       \
    }                                                                        \
  };
SDV_WGMMA(false, false, "s8.s8")
SDV_WGMMA(false, true, "s8.u8")
SDV_WGMMA(true, false, "u8.s8")
SDV_WGMMA(true, true, "u8.u8")
#undef SDV_WGMMA

// --- the decode -------------------------------------------------------

// Byte `sel` picks of four words, in k order: byte B of each when sel =
// B | (B + 4) << 4
__device__ __forceinline__ uint32_t gather(const uint32_t* w, uint32_t sel) {
  return __byte_perm(__byte_perm(w[0], w[1], sel),
                     __byte_perm(w[2], w[3], sel), 0x5410);
}

__device__ __forceinline__ uint32_t byte_sel(int byte) {
  return static_cast<uint32_t>(byte | (byte + 4) << 4);
}

// How lane i of a word is decoded, four k at a time in one register:
// the field's byte of four words (or, where the field straddles two
// bytes, the low byte of the words shifted), shifted and masked; a signed
// lane adds the bit of its sign byte times 2^8 - 2^(w_a - 1), the lane's
// two's complement byte (the sign bit at bit k of its byte weighs
// (2^8 - 2^(w_a - 1)) >> k in place when k < w_a, which saves a shift)
struct LaneCode {
  uint32_t fsel, fshift;  // the field: byte selector, shift
  bool straddles;         // shift the words first
  uint32_t ssel, sshift;  // the sign: byte selector, shift to its weight
  uint32_t sbit, smul;    // the sign bit in each byte, its weight
};

__device__ __forceinline__ LaneCode lane_code(const Params& p, int i) {
  const int rbits = p.signed_a ? p.w_a - 1 : p.w_a;
  const int s = i * p.lane;
  LaneCode lc;
  lc.straddles = (s & 7) + rbits > 8;
  lc.fsel = byte_sel(lc.straddles ? 0 : s >> 3);
  lc.fshift = lc.straddles ? s : s & 7;
  const int sb = p.sign_shift + i, k = sb & 7;
  const uint32_t smul = (0x100u - (1u << (p.w_a - 1))) & 0xFFu;
  lc.ssel = byte_sel(sb >> 3);
  const bool in_place = k <= p.w_a - 1;
  lc.sshift = in_place ? 0 : k;
  lc.sbit = 0x01010101u << (in_place ? k : 0);
  lc.smul = in_place ? smul >> k : smul;
  return lc;
}

// Lane i of the 16 words w (k in order) -> its 16 bytes q; sgn caches the
// sign byte (selector *cur) that the lanes share
__device__ __forceinline__ void decode_lane(const LaneCode& lc, bool sgn_a,
                                            uint32_t rmask,
                                            const uint32_t (&w)[16],
                                            uint32_t (&sgn)[4],
                                            uint32_t& cur, uint32_t (&q)[4]) {
  if (lc.straddles) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint32_t t[4] = {w[4 * v] >> lc.fshift, w[4 * v + 1] >> lc.fshift,
                             w[4 * v + 2] >> lc.fshift,
                             w[4 * v + 3] >> lc.fshift};
      q[v] = gather(t, lc.fsel) & rmask;
    }
  } else if (lc.fshift == 0) {
#pragma unroll
    for (int v = 0; v < 4; ++v) q[v] = gather(w + 4 * v, lc.fsel) & rmask;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      q[v] = (gather(w + 4 * v, lc.fsel) >> lc.fshift) & rmask;
  }
  if (!sgn_a) return;
  if (lc.ssel != cur) {
    cur = lc.ssel;
#pragma unroll
    for (int v = 0; v < 4; ++v) sgn[v] = gather(w + 4 * v, cur);
  }
  if (lc.sshift == 0) {
#pragma unroll
    for (int v = 0; v < 4; ++v) q[v] += (sgn[v] & lc.sbit) * lc.smul;
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v)
      q[v] += ((sgn[v] >> lc.sshift) & lc.sbit) * lc.smul;
  }
}

// Decode the stage's words of warpgroup c's bgw columns into its A tile:
// thread unit (gl, kc) takes the 16 k of chunk kc of column gl and
// writes lane i's 16 bytes to slot gl * n + i with one 16-byte store.
// kN > 0: n = kN, the lane loop unrolled and each lane's code computed
// once a kernel; kN = 0: any n, the codes computed as they are needed.
template <int kN>
struct Decoder {
  LaneCode code[kN > 0 ? kN : 1];
  uint32_t rmask;
  __device__ explicit Decoder(const Params& p) {
    const int rbits = p.signed_a ? p.w_a - 1 : p.w_a;
    rmask = ((1u << rbits) - 1u) * 0x01010101u;
    if constexpr (kN > 0) {
#pragma unroll
      for (int i = 0; i < kN; ++i) code[i] = lane_code(p, i);
    }
  }

  __device__ __forceinline__ void run(const Params& p, const int32_t* ws,
                                      uint8_t* a, int c, int tl) const {
    const int pitch = kConsumers * p.bgw;
    const int units = p.bgw * (kBK / 16);
    const int n = kN > 0 ? kN : p.n;
    for (int u = tl; u < units; u += 128) {
      const int gl = u % p.bgw, kc = u / p.bgw;
      const int32_t* src = ws + kc * 16 * pitch + c * p.bgw + gl;
      uint32_t w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        w[j] = static_cast<uint32_t>(src[j * pitch]);
      uint32_t sgn[4], cur = ~0u, q[4] = {0u, 0u, 0u, 0u};
      const auto put = [&](int i) {
        const int slot = gl * n + i;
        *reinterpret_cast<uint4*>(a + slot * kBK +
                                  ((kc ^ ((slot >> 1) & 3)) << 4)) =
            make_uint4(q[0], q[1], q[2], q[3]);
      };
      if constexpr (kN > 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          decode_lane(code[i], p.signed_a, rmask, w, sgn, cur, q);
          put(i);
        }
      } else {
        for (int i = 0; i < n; ++i) {
          decode_lane(lane_code(p, i), p.signed_a, rmask, w, sgn, cur, q);
          put(i);
        }
      }
    }
  }
};

// --- the roles --------------------------------------------------------

__device__ __forceinline__ void produce(const Params& p, const Smem& sm,
                                        const CUtensorMap* tx,
                                        const CUtensorMap* tw) {
  const uint32_t bytes = kXStage + word_stage_bytes(p.bgw);
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int r0 = (tile % p.row_tiles) * kRows;
    const int g0 = (tile / p.row_tiles) * kConsumers * p.bgw;
    for (int t = 0; t < p.k_stages; ++t, ++it) {
      const int s = it % p.stages;
      mbar_wait(&sm.empty[s], ((it / p.stages) & 1) ^ 1);
      mbar_expect_tx(&sm.full[s], bytes);
      tma_load(sm.x(s), tx, &sm.full[s], t * kBK, r0);
      tma_load(sm.w(s), tw, &sm.full[s], g0, t * kBK);
    }
  }
}

// Accumulator d[4 j + e] of a m64n256 tile: slot 16 warp + lane / 4 (+8
// for e >= 2), row 8 j + 2 (lane % 4) (+1 for odd e)
__device__ __forceinline__ void store(const Params& p, const int (&d)[128],
                                      int r0, int g0, int c, int tl) {
  const int warp = tl / 32, l = tl % 32;
  const int64_t pitch = static_cast<int64_t>(p.G) * p.n;
  const int64_t chbase = static_cast<int64_t>(g0 + c * p.bgw) * p.n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = warp * 16 + l / 4 + 8 * h;
    const int64_t ch = chbase + slot;
    if (slot >= p.n * p.bgw || ch >= pitch) continue;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = r0 + 8 * j + 2 * (l % 4) + e;
        if (r < p.rows) p.out[r * pitch + ch] = d[4 * j + 2 * h + e];
      }
  }
}

template <bool kAU8, bool kBU8, int kN>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm,
                                        int c) {
  const int tl = threadIdx.x % 128;
  const Decoder<kN> dec(p);
  int d[128];
  int it = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int r0 = (tile % p.row_tiles) * kRows;
    const int g0 = (tile / p.row_tiles) * kConsumers * p.bgw;
#pragma unroll
    for (int i = 0; i < 128; ++i) d[i] = 0;
    mbar_wait(&sm.full[it % p.stages], (it / p.stages) & 1);
    dec.run(p, sm.w(it % p.stages), sm.a(c, 0), c, tl);
    for (int t = 0; t < p.k_stages; ++t) {
      const int s = (it + t) % p.stages;
      // this warpgroup's A tile is written: hand it to the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
      fence_acc(d);
      wgmma_fence();
      const uint64_t da = desc_sw64(sm.a(c, t & 1));
      const uint64_t db = desc_sw64(sm.x(s));
      Wgmma<kAU8, kBU8>::run(d, da, db);
      Wgmma<kAU8, kBU8>::run(d, da + 2, db + 2);   // k 32..63: +32 bytes
      wgmma_commit();
      fence_acc(d);
      if (t + 1 < p.k_stages) {   // decode the next stage meanwhile
        const int it1 = it + t + 1, s1 = it1 % p.stages;
        mbar_wait(&sm.full[s1], (it1 / p.stages) & 1);
        dec.run(p, sm.w(s1), sm.a(c, (t + 1) & 1), c, tl);
      }
      wgmma_wait();
      fence_acc(d);
      mbar_arrive(&sm.empty[s]);
    }
    it += p.k_stages;
    store(p, d, r0, g0, c, tl);
  }
}

template <bool kAU8, bool kBU8, int kN>
__global__ void __launch_bounds__(kThreads, 1)
sdv_gemm_kernel_wgmma(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_w,
                      const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw, p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the producer gives its registers to the consumers' accumulators
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128)
      produce(p, sm, &tmap_x, &tmap_w);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<kAU8, kBU8, kN>(p, sm, wg);
  }
}

// --- host side --------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, through the runtime
// (the library links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D tensor map of a row-major [outer, inner] array with `pitch`
// bytes between rows; tiles of box_outer x box_inner, zeros out of bounds
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            uint64_t inner, uint64_t outer, uint64_t pitch,
            uint32_t box_inner, uint32_t box_outer,
            CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {pitch};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kAU8, bool kBU8, int kN>
cudaError_t launch(const CUtensorMap& tx, const CUtensorMap& tw,
                   const Params& p, int blocks, cudaStream_t stream) {
  static bool configured = false;
  const auto kernel = sdv_gemm_kernel_wgmma<kAU8, kBU8, kN>;
  if (!configured) {   // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<blocks, kThreads, smem_bytes(p.bgw, p.stages), stream>>>(tx, tw,
                                                                     p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* sdv_wgmma_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one block (bytes) at bgw word columns a
// warpgroup and `stages` pipeline stages.
int sdv_wgmma_smem_bytes(int bgw, int stages) {
  return smem_bytes(bgw, stages);
}

// x [rows, Kp] int8 (uint8 for unsigned activations; Kp % 16 == 0, zeros
// past K), w [K, G] int32 single-limb words (G % 4 == 0), out [rows, G,
// n] int32.  bgw: word columns a warpgroup (a multiple of 4, n * bgw <=
// 64); stages: the ring's depth; blocks: the persistent grid; flags:
// signed lanes (1), signed activations (2).  Returns cudaGetLastError()
// of the launch (0 = success), or cudaErrorInvalidValue for operands the
// kernel does not take or a tensor map cuTensorMapEncodeTiled refuses.
int sdv_gemm_wgmma(const void* x, const void* w, void* out, int rows, int K,
                   int Kp, int G, int n, int lane, int w_a, int sign_shift,
                   int flags, int bgw, int stages, int blocks,
                   void* stream) {
  if (n < 1 || n > kMaxLanes || rows < 1 || K < 1 || Kp < K ||
      Kp % 16 != 0 || G < 1 || G % 4 != 0 || bgw < 4 || bgw % 4 != 0 ||
      n * bgw > kSlots || w_a < 1 || w_a > 8 || stages < 2 ||
      smem_bytes(bgw, stages) > kMaxSmem || blocks < 1 ||
      (flags & ~(kSignedA | kSignedB)) != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!encode(&tx, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, Kp, rows, Kp, kBK,
              kRows, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !encode(&tw, CU_TENSOR_MAP_DATA_TYPE_INT32, w, G, K,
              static_cast<uint64_t>(G) * 4, kConsumers * bgw, kBK,
              CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const int row_tiles = (rows + kRows - 1) / kRows;
  const int col_tiles = (G + kConsumers * bgw - 1) / (kConsumers * bgw);
  Params p{static_cast<int32_t*>(out), rows, K, G, n, lane, w_a,
           sign_shift, bgw, stages, row_tiles, row_tiles * col_tiles,
           (K + kBK - 1) / kBK, (flags & kSignedA) != 0};
  const int grid = blocks < p.tiles ? blocks : p.tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the serving plans' n = 2 (W4A8 .. W8A8 on the INT32 word) with the
  // lane loop unrolled; any other n with it at run time
  const int key = (flags & kSignedA ? 0 : 2) | (flags & kSignedB ? 0 : 1);
  if (n == 2) {
    switch (key) {
      case 0: return launch<false, false, 2>(tx, tw, p, grid, s);
      case 1: return launch<false, true, 2>(tx, tw, p, grid, s);
      case 2: return launch<true, false, 2>(tx, tw, p, grid, s);
      default: return launch<true, true, 2>(tx, tw, p, grid, s);
    }
  }
  switch (key) {
    case 0: return launch<false, false, 0>(tx, tw, p, grid, s);
    case 1: return launch<false, true, 0>(tx, tw, p, grid, s);
    case 2: return launch<true, false, 0>(tx, tw, p, grid, s);
    default: return launch<true, true, 0>(tx, tw, p, grid, s);
  }
}

}  // extern "C"
