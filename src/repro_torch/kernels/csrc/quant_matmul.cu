// Unpack-in-kernel quantized matmul (B5) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul (its
// body _body): y = x @ (unpack(words) * scale), the memory-packed route of
// the packed_matmul dispatch (plan = None).
//
// What is computed.  x [m, k] is bfloat16 or float32; words [k, nw] int32
// hold per = 32 / w two's-complement w-bit fields each, word j of a row
// holding columns j * per .. j * per + per - 1 (the lane layout of
// packbits.cu), so n = nw * per; scale [n] float32.  As in the reference,
// x is widened to float32, each field is sign-extended and converted to
// float32, the products are summed in float32, and the sum is multiplied
// by the column's scale at the end: y [m, n] float32.  No TF32 tensor
// cores (they keep ~10 mantissa bits); every product of a bf16 or f32
// value and an integer of at most 8 bits is summed by a float32 FMA.  Each
// output's K terms are summed in order k = 0, 1, ..., so a launch is
// deterministic; the sum order differs from a library GEMM's, which the
// callers' tolerances state.
//
// Bound.  The weights are w / 8 bytes per element; x (2 or 4 bytes per
// element) and y (4) are small beside them at the decode shape (m = 8:
// tinyllama's 2048 x 5632 W4 matrix is 5.8 MB against 0.2 MB of x and y).
// The 2 m n k operations per w n k / 8 bytes of words are 16 m / w per
// byte.  For bf16 x the function is the one bf16 tensor cores compute with
// float32 accumulation (each bf16 x int8 product is exact in float32), at
// ~295 operations per byte of memory rate (989 TFLOP/s over 3.35 TB/s): W4
// is bound by bytes up to m ~ 74 (the decode shape) and by operations at
// m = 128.  For float32 x only float32 FMAs keep the function (TF32 would
// round x), ~20 per byte (67 TFLOP/s): W4 is bound by operations from
// m = 8 on.  This design runs both on CUDA cores; the reference's MXU tile
// (128 x 256 x 512) has its Hopper counterpart in bf16 wgmma for bf16 x:
// a later redesign.
//
// What the design does about it (a first, simple design).  One block of
// 16 x 16 threads per output tile of BM x 64 (BM = 16 for m <= 16, the
// decode shape, else 64), walking K in slabs of 32: the block stages the
// slab's x rows (as float32, transposed, padded against bank conflicts)
// and the slab's 32 x 64 weight fields (unpacked and sign-extended once
// per slab, as float32) in shared memory, then each thread runs TM x 4
// FMAs per k from registers.  The ragged edges (any m, n, k) are masked:
// out-of-range x and fields are staged as zero and their outputs are not
// written.  At m = 8 the grid is only n / 64 blocks, too few to fill the
// card; a split-K is the planned redesign for that shape.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 16;              // threads along n (4 columns each)
constexpr int kTy = 16;              // threads along m (TM rows each)
constexpr int kBn = 4 * kTx;         // 64 columns per tile
constexpr int kBk = 32;              // K slab
constexpr int kThreads = kTx * kTy;

struct Qmm {
  int m, n, k, nw, w, per;
};

template <typename X>
__device__ __forceinline__ float to_f32(X v);

template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}

template <>
__device__ __forceinline__ float to_f32<uint16_t>(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);   // bf16 bits
}

// TM: output rows per thread (BM = 16 TM); X: float (f32) or uint16_t
// (bf16 bit patterns).
template <int TM, typename X>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const X* __restrict__ x,
                    const int32_t* __restrict__ words,
                    const float* __restrict__ scale,
                    float* __restrict__ y, Qmm p) {
  constexpr int kBm = kTy * TM;
  __shared__ float xs[kBk][kBm + 1];
  __shared__ float ws[kBk][kBn];
  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int m0 = blockIdx.y * kBm, n0 = blockIdx.x * kBn;
  const uint32_t mask = (1u << p.w) - 1u, half = 1u << (p.w - 1);

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.k; k0 += kBk) {
    // x slab [kBm, kBk] -> xs[kk][r] (coalesced along k)
    for (int e = tid; e < kBm * kBk; e += kThreads) {
      const int r = e / kBk, kk = e % kBk;
      const int gm = m0 + r, gk = k0 + kk;
      xs[kk][r] = (gm < p.m && gk < p.k)
                      ? to_f32(x[static_cast<int64_t>(gm) * p.k + gk])
                      : 0.0f;
    }
    // weight fields [kBk, kBn] -> ws[kk][c], sign-extended
    for (int e = tid; e < kBk * kBn; e += kThreads) {
      const int kk = e / kBn, c = e % kBn;
      const int gk = k0 + kk, gn = n0 + c;
      float v = 0.0f;
      if (gk < p.k && gn < p.n) {
        const uint32_t word = static_cast<uint32_t>(
            words[static_cast<int64_t>(gk) * p.nw + gn / p.per]);
        const uint32_t f = (word >> ((gn % p.per) * p.w)) & mask;
        v = static_cast<float>(static_cast<int>(f) -
                               ((f & half) ? (1 << p.w) : 0));
      }
      ws[kk][c] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBk; ++kk) {
      float a[TM], b[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + kTy * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kk][tx + kTx * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + kTx * j;
    if (gn >= p.n) continue;
    const float s = scale[gn];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gm = m0 + ty + kTy * i;
      if (gm < p.m) y[static_cast<int64_t>(gm) * p.n + gn] = acc[i][j] * s;
    }
  }
}

template <int TM, typename X>
cudaError_t launch(const void* x, const int32_t* words, const float* scale,
                   float* y, const Qmm& p, cudaStream_t s) {
  const dim3 grid((p.n + kBn - 1) / kBn, (p.m + kTy * TM - 1) / (kTy * TM));
  quant_matmul_kernel<TM, X><<<grid, kThreads, 0, s>>>(
      static_cast<const X*>(x), words, scale, y, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [m, k] (bf16 if x_bf16 else f32) @ (fields of words [k, nw] * scale
// [n]) -> y [m, n] f32, n = nw * (32 / w).  Returns cudaGetLastError() of
// the launch (0 = success).
int quant_matmul(const void* x, const void* words, const void* scale,
                 void* y, int m, int k, int nw, int w, int x_bf16,
                 void* stream) {
  if (w < 2 || w > 8 || m < 1 || k < 1 || nw < 1)
    return cudaErrorInvalidValue;
  Qmm p;
  p.m = m;
  p.k = k;
  p.nw = nw;
  p.w = w;
  p.per = 32 / w;
  p.n = nw * p.per;
  const int tm = m <= kTy ? 1 : 4;
  if ((m + kTy * tm - 1) / (kTy * tm) > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* wd = static_cast<const int32_t*>(words);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  if (tm == 1)
    return x_bf16 ? launch<1, uint16_t>(x, wd, sc, out, p, s)
                  : launch<1, float>(x, wd, sc, out, p, s);
  return x_bf16 ? launch<4, uint16_t>(x, wd, sc, out, p, s)
                : launch<4, float>(x, wd, sc, out, p, s);
}

}  // extern "C"
