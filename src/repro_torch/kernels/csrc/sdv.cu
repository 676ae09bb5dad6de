// Packed SDV GEMV (B1) and GEMM (B2) for Hopper (sm_90a).
//
// Replaces the two TPU kernels of the JAX package's decode/prefill path:
//   B1  repro/kernels/sdv_matvec.py::sdv_matvec  (decode, <= 8 rows)
//   B2  repro/kernels/sdv_matmul.py::sdv_matmul  (prefill, > 8 rows)
// both built on the shared body repro/kernels/sdv_matmul.py::_body.
//
// What is computed (per row r, lane group g, over k = 0..K-1), paper
// Sec. III-C:
//   u      = stored word (int32 zero-extended, or hi:lo limb planes)
//   d      = u mod 2^sign_shift               (sign-sliced remainders D)
//   sbits  = (u >> sign_shift) & (2^n - 1)     (parked sign bits)
//   packed = d - sum_i bit_i << (i L + w_a - 1)   (the pre-adder D - A;
//            unsigned elements: packed = d)
//   acc   += packed * x[r, k]                  (one wide MAC for n lanes)
//   spill tracking: for each lane boundary i = 1..n the low two bits of
//   the accumulator at i L, before and after the MAC, are compared with
//   the expected (a_i * x) mod 4 (the fractured-LUT reference product;
//   the virtual observer lane n expects 0); the mismatch is the carry
//   out of lane i-1: in [-1, 1] for signed operands, [0, 2] when both
//   are unsigned (Fig. 4).
// Eq. 3 then gives out[r, g, i] = (int32)((S_i << L) + field_i - S_{i-1}).
//
// All word arithmetic is uint64: signed overflow is undefined in C++, and
// a mod-2^64 wrap agrees with the TPU's mod-2^32 wrap and the DSP's
// 48-bit wrap on every bit the extractor reads, so one body serves the
// INT32 word and the wide DSP48E2/DSP58 words.
//
// Bound: both kernels are bound by memory at the work they must do (the
// int8 tensor-core rate is far above what n-lane packing needs).  On the
// INT32 W4 plan a word carries 2 weights in 4 bytes, the bytes of bf16
// weights; the wide [2, K, G] transport carries 3 weights in 8 bytes.
// What the design does about it: every stored word is read from device
// memory exactly once per call.  B1 keeps all (<= 8) rows' accumulators
// and spill counters of one lane group in one thread's registers, so a
// word fetched once serves every decode row (what the TPU's 8-row block
// bought); B2 stages a [BK, BG] tile of words and a [BR, BK] tile of
// activations in shared memory and gives each thread 8 rows of one
// group.  The K loop is split across blocks to fill the 132 SMs: the
// lane values of each K chunk are exact integers, so chunks are
// extracted separately and summed with integer atomics (exact in any
// order, hence deterministic).  The per-lane spill tracking costs
// integer instructions per (row, group, k); that, not the memory, is
// what these first kernels spend their time on.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 15;   // plan_sdv's largest n for w_a, w_b <= 8
constexpr int kRowsPerThread = 8;

// GEMV launch shape
constexpr int kGemvThreads = 64;  // one lane group per thread
constexpr int kGemvKTile = 256;   // k steps of activations staged at once
constexpr int kGemvMaxRows = kRowsPerThread;

// GEMM launch shape: (BG groups) x (BR/8 row threads) per block
constexpr int kGemmBG = 64;
constexpr int kGemmRowThreads = 4;
constexpr int kGemmBR = kGemmRowThreads * kRowsPerThread;  // 32 rows
constexpr int kGemmBK = 32;

enum Flags : int { kSignedA = 1, kSignedSpill = 2, kTwoLimb = 4 };

struct Plan {
  int lane;        // L
  int w_a;         // element width
  int sign_shift;  // plan.packed_width
  int flags;
};

__device__ __forceinline__ uint64_t load_word(const int32_t* __restrict__ w,
                                              int64_t plane, int64_t idx,
                                              bool two_limb) {
  uint64_t lo = static_cast<uint32_t>(w[idx]);
  if (!two_limb) return lo;
  uint64_t hi = static_cast<uint32_t>(w[plane + idx]);
  return (hi << 32) | lo;
}

// The pre-adder and the 2-LSB reference factors of one stored word.
template <int N>
struct Operand {
  uint64_t packed;
  uint32_t lsb2[N + 1];  // a_i mod 4 at boundary i (index 1..N; N: 0)
};

template <int N>
__device__ __forceinline__ void decode(uint64_t u, const Plan& p,
                                       Operand<N>& op) {
  const bool signed_a = p.flags & kSignedA;
  const uint64_t d = u & ((uint64_t(1) << p.sign_shift) - 1);
  uint32_t sbits = 0;
  uint64_t a_word = 0;
  if (signed_a) {
    sbits = static_cast<uint32_t>(u >> p.sign_shift) & ((1u << N) - 1);
#pragma unroll
    for (int i = 0; i < N; ++i)
      a_word += static_cast<uint64_t>((sbits >> i) & 1u)
                << (i * p.lane + p.w_a - 1);
  }
  op.packed = d - a_word;
#pragma unroll
  for (int i = 1; i < N; ++i) {
    uint32_t r2 = static_cast<uint32_t>(d >> (i * p.lane)) & 3u;
    if (signed_a && p.w_a < 3) r2 = (r2 + 2u * ((sbits >> i) & 1u)) & 3u;
    op.lsb2[i] = r2;
  }
  op.lsb2[N] = 0;  // virtual observer lane
}

// One wide MAC of one row plus the spill update at every lane boundary.
template <int N>
__device__ __forceinline__ void mac(uint64_t& acc, int (&spill)[N],
                                    const Operand<N>& op, int32_t x,
                                    const Plan& p) {
  const uint64_t acc2 = acc + op.packed * static_cast<uint64_t>(
                                              static_cast<int64_t>(x));
  const uint32_t x4 = static_cast<uint32_t>(x) & 3u;
  const bool signed_spill = p.flags & kSignedSpill;
#pragma unroll
  for (int i = 1; i <= N; ++i) {
    const int s = i * p.lane;
    const uint32_t mm = (static_cast<uint32_t>(acc2 >> s) -
                         static_cast<uint32_t>(acc >> s) -
                         op.lsb2[i] * x4) & 3u;
    spill[i - 1] += (signed_spill && mm == 3u) ? -1 : static_cast<int>(mm);
  }
  acc = acc2;
}

// Eq. 3 extraction of one row's lanes into out[N] (int32, wrapping).
template <int N>
__device__ __forceinline__ void extract(uint64_t acc, const int (&spill)[N],
                                        const Plan& p, int32_t* out,
                                        bool accumulate) {
  const uint64_t mask = (uint64_t(1) << p.lane) - 1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t v = (static_cast<uint64_t>(static_cast<int64_t>(spill[i]))
                  << p.lane) + ((acc >> (i * p.lane)) & mask);
    if (i > 0) v -= static_cast<uint64_t>(static_cast<int64_t>(spill[i - 1]));
    const int32_t lane_value =
        static_cast<int32_t>(static_cast<uint32_t>(v));
    if (accumulate)
      atomicAdd(out + i, lane_value);
    else
      out[i] = lane_value;
  }
}

// B1: x_t [K, B] (K-major), w [K, G] or [2, K, G] -> out [B, G, N].
// Grid (ceil(G / 64), K splits); one thread per lane group g.
template <int N>
__global__ void __launch_bounds__(kGemvThreads)
sdv_gemv_kernel(const int32_t* __restrict__ x_t,
                const int32_t* __restrict__ w, int32_t* __restrict__ out,
                int B, int K, int G, int kchunk, Plan p) {
  __shared__ int32_t xs[kGemvKTile * kGemvMaxRows];
  const int g = blockIdx.x * kGemvThreads + threadIdx.x;
  const int k0 = blockIdx.y * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const bool two_limb = p.flags & kTwoLimb;
  const int64_t plane = static_cast<int64_t>(K) * G;

  uint64_t acc[kGemvMaxRows];
  int spill[kGemvMaxRows][N];
#pragma unroll
  for (int r = 0; r < kGemvMaxRows; ++r) {
    acc[r] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) spill[r][i] = 0;
  }

  for (int kt = k0; kt < k1; kt += kGemvKTile) {
    const int kn = min(kGemvKTile, k1 - kt);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kn * B; idx += kGemvThreads)
      xs[idx] = x_t[static_cast<int64_t>(kt) * B + idx];
    __syncthreads();
    if (g < G) {
      for (int kk = 0; kk < kn; ++kk) {
        Operand<N> op;
        decode<N>(load_word(w, plane,
                            static_cast<int64_t>(kt + kk) * G + g, two_limb),
                  p, op);
#pragma unroll
        for (int r = 0; r < kGemvMaxRows; ++r)
          if (r < B) mac<N>(acc[r], spill[r], op, xs[kk * B + r], p);
      }
    }
  }
  if (g >= G) return;
  const bool accumulate = gridDim.y > 1;
#pragma unroll
  for (int r = 0; r < kGemvMaxRows; ++r)
    if (r < B)
      extract<N>(acc[r], spill[r], p,
                 out + (static_cast<int64_t>(r) * G + g) * N, accumulate);
}

// B2: x [R, K] (row-major), w [K, G] or [2, K, G] -> out [R, G, N].
// Grid (ceil(G / BG), ceil(R / BR), K splits); block (BG, BR / 8): each
// thread owns 8 rows of one lane group.
template <int N>
__global__ void __launch_bounds__(kGemmBG * kGemmRowThreads)
sdv_gemm_kernel(const int32_t* __restrict__ x,
                const int32_t* __restrict__ w, int32_t* __restrict__ out,
                int R, int K, int G, int kchunk, Plan p) {
  __shared__ uint64_t ws[kGemmBK][kGemmBG];
  __shared__ int32_t xs[kGemmBK][kGemmBR + 1];  // +1: conflict-free fill
  const int tid = threadIdx.y * kGemmBG + threadIdx.x;
  constexpr int kThreads = kGemmBG * kGemmRowThreads;
  const int g0 = blockIdx.x * kGemmBG;
  const int r0 = blockIdx.y * kGemmBR;
  const int g = g0 + threadIdx.x;
  const int rbase = threadIdx.y * kRowsPerThread;  // within the tile
  const int k0 = blockIdx.z * kchunk;
  const int k1 = min(K, k0 + kchunk);
  const bool two_limb = p.flags & kTwoLimb;
  const int64_t plane = static_cast<int64_t>(K) * G;

  uint64_t acc[kRowsPerThread];
  int spill[kRowsPerThread][N];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    acc[j] = 0;
#pragma unroll
    for (int i = 0; i < N; ++i) spill[j][i] = 0;
  }

  for (int kt = k0; kt < k1; kt += kGemmBK) {
    const int kn = min(kGemmBK, k1 - kt);
    __syncthreads();
    for (int idx = tid; idx < kGemmBK * kGemmBG; idx += kThreads) {
      const int kk = idx / kGemmBG, gg = idx % kGemmBG;
      ws[kk][gg] = (kk < kn && g0 + gg < G)
                       ? load_word(w, plane,
                                   static_cast<int64_t>(kt + kk) * G + g0 + gg,
                                   two_limb)
                       : 0;
    }
    for (int idx = tid; idx < kGemmBR * kGemmBK; idx += kThreads) {
      const int rr = idx / kGemmBK, kk = idx % kGemmBK;
      xs[kk][rr] = (kk < kn && r0 + rr < R)
                       ? x[static_cast<int64_t>(r0 + rr) * K + kt + kk]
                       : 0;
    }
    __syncthreads();
    if (g < G) {
      for (int kk = 0; kk < kn; ++kk) {
        Operand<N> op;
        decode<N>(ws[kk][threadIdx.x], p, op);
#pragma unroll
        for (int j = 0; j < kRowsPerThread; ++j)
          mac<N>(acc[j], spill[j], op, xs[kk][rbase + j], p);
      }
    }
  }
  if (g >= G) return;
  const bool accumulate = gridDim.z > 1;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + rbase + j;
    if (r < R)
      extract<N>(acc[j], spill[j], p,
                 out + (static_cast<int64_t>(r) * G + g) * N, accumulate);
  }
}

template <int N>
cudaError_t launch_gemv(const int32_t* x_t, const int32_t* w, int32_t* out,
                        int B, int K, int G, int kchunk, Plan p,
                        cudaStream_t stream) {
  const dim3 grid((G + kGemvThreads - 1) / kGemvThreads,
                  (K + kchunk - 1) / kchunk);
  sdv_gemv_kernel<N><<<grid, kGemvThreads, 0, stream>>>(x_t, w, out, B, K, G,
                                                        kchunk, p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_gemm(const int32_t* x, const int32_t* w, int32_t* out,
                        int R, int K, int G, int kchunk, Plan p,
                        cudaStream_t stream) {
  const dim3 grid((G + kGemmBG - 1) / kGemmBG, (R + kGemmBR - 1) / kGemmBR,
                  (K + kchunk - 1) / kchunk);
  const dim3 block(kGemmBG, kGemmRowThreads);
  sdv_gemm_kernel<N><<<grid, block, 0, stream>>>(x, w, out, R, K, G, kchunk,
                                                 p);
  return cudaGetLastError();
}

#define SDV_DISPATCH(FN, ...)                            \
  switch (n) {                                           \
    case 1: return FN<1>(__VA_ARGS__);                   \
    case 2: return FN<2>(__VA_ARGS__);                   \
    case 3: return FN<3>(__VA_ARGS__);                   \
    case 4: return FN<4>(__VA_ARGS__);                   \
    case 5: return FN<5>(__VA_ARGS__);                   \
    case 6: return FN<6>(__VA_ARGS__);                   \
    case 7: return FN<7>(__VA_ARGS__);                   \
    case 8: return FN<8>(__VA_ARGS__);                   \
    case 9: return FN<9>(__VA_ARGS__);                   \
    case 10: return FN<10>(__VA_ARGS__);                 \
    case 11: return FN<11>(__VA_ARGS__);                 \
    case 12: return FN<12>(__VA_ARGS__);                 \
    case 13: return FN<13>(__VA_ARGS__);                 \
    case 14: return FN<14>(__VA_ARGS__);                 \
    case 15: return FN<15>(__VA_ARGS__);                 \
    default: return cudaErrorInvalidValue;               \
  }

cudaError_t prepare(int32_t* out, int64_t out_elems, int K, int kchunk,
                    cudaStream_t stream) {
  // split-K blocks accumulate into a zeroed output
  if (kchunk < K)
    return cudaMemsetAsync(out, 0, out_elems * sizeof(int32_t), stream);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* sdv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every launcher returns cudaGetLastError() of its launch (0 = success).
int sdv_gemv(const void* x_t, const void* w, void* out, int B, int K, int G,
             int n, int lane, int w_a, int sign_shift, int flags, int kchunk,
             void* stream) {
  if (n < 1 || n > kMaxLanes || B < 1 || B > kGemvMaxRows || kchunk < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare(static_cast<int32_t*>(out),
                            static_cast<int64_t>(B) * G * n, K, kchunk, s);
  if (err != cudaSuccess) return err;
  const Plan p{lane, w_a, sign_shift, flags};
  SDV_DISPATCH(launch_gemv, static_cast<const int32_t*>(x_t),
               static_cast<const int32_t*>(w), static_cast<int32_t*>(out), B,
               K, G, kchunk, p, s)
}

int sdv_gemm(const void* x, const void* w, void* out, int R, int K, int G,
             int n, int lane, int w_a, int sign_shift, int flags, int kchunk,
             void* stream) {
  if (n < 1 || n > kMaxLanes || R < 1 || kchunk < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = prepare(static_cast<int32_t*>(out),
                            static_cast<int64_t>(R) * G * n, K, kchunk, s);
  if (err != cudaSuccess) return err;
  const Plan p{lane, w_a, sign_shift, flags};
  SDV_DISPATCH(launch_gemm, static_cast<const int32_t*>(x),
               static_cast<const int32_t*>(w), static_cast<int32_t*>(out), R,
               K, G, kchunk, p, s)
}

}  // extern "C"
