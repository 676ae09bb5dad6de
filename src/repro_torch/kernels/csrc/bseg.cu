// Cross-channel BSEG packed conv2d (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bseg_conv2d.py::bseg_conv2d (its
// body _body): the dense stride-1 'same' conv2d of the paper's UltraNet
// through Binary Segmentation (Sec. III-D, Figs. 6/7).
//
// What is computed.  x_pad [B, H_pad, W_pad, C_in] int8 holds unsigned
// activations in [0, 2^w_i); kappa holds one packed kernel-row factor per
// (tap group g, kernel row r, input channel ci, output channel co), the
// kw taps reversed through the pre-adder at weight-prep time.  For each
// output row y, pipeline p = (r, ci), tap group g and output channel co a
// carry word starts at bias_full and runs n_steps = ceil((W + n_k - 1) /
// n_i) steps in order; step t
//   word  = kappa[g, r, ci, co] * iota(x_pad[y + r, t n_i + g n_k + j, ci],
//                                      j < n_i) + carry
//   lanes: p < n_i completed outputs field_p - bias; p >= n_i the high
//          part field_p - lo_p - bias of each carried lane (lo_p = its
//          low w_l bits, Fig. 7)
//   carry = bias_top + sum_{p >= n_i} (lo_p + bias) << ((p - n_i) L)
// and lane p is added into an output-row accumulator at index t n_i + p.
// Output column c is accumulator index c + n_k - 1.  The sum over
// (r, ci, g) is the paper's adder tree: plain int32 addition, exact in
// any order, so it runs as shared-memory (and, across blocks, global)
// integer atomics.
//
// Word arithmetic is unsigned (signed overflow is undefined in C++).
// The INT32 word wraps mod 2^32 in the reference and every field the
// split reads lies below n_lanes L <= 32 bits, so a uint32 word gives the
// same lanes; FP32M words are exact non-negative integers below 2^24, on
// which the reference's floor-divides and mods are shifts and masks, so
// FP32M runs in the same uint32 body (the wrapper converts the float32
// kappa to int32, exactly).  The wide DSP48E2/DSP58 words arrive as hi:lo
// int32 limb planes, which wrap mod 2^64 exactly like uint64.
//
// Bound.  The bytes are x_pad (int8), kappa and the int32 output: at
// UltraNet's 416x416 frame, batch 8, the output dominates (88.6 MB for the
// first layer) and the 8 3x3 stages move ~0.18 GB, ~55 us at 3.35 TB/s.
// The work is bseg_conv2d_num_multiplies wide multiplies (1.84e9 for those
// stages on the INT32 plan) and each costs ~25-40 integer instructions:
// the multiply (one IMAD on uint32, several on uint64), the input
// packing, n_lanes field extractions with bias and slice, and n_i shared
// atomics.  So the kernel is bound by integer issue, far above both the
// bytes and the int8 tensor-core rate that the roofline counts.
//
// What the design does about it.  Every carry chain (y, p, g, co) is one
// thread's loop, with the carry word, the kappa factor and a window of
// n_lanes lane sums in registers: each lane is added into the shared row
// accumulator once, when it is complete for that chain (n_i atomics per
// step, not n_lanes).  A block owns one output row and a warp-wide tile of
// output channels (threadIdx.x, so kappa loads and accumulator updates
// are coalesced and conflict-free, and the warp's threads of one pipeline
// read the same activation byte); its thread rows share the pipelines.
// Pipelines split across blocks until ~4 blocks per SM are in flight,
// the partial rows then summed into a zeroed output with global atomics.
// The narrow words run in 32-bit arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 12;  // plan_bseg's largest n_lanes for w <= 8

struct Conv {
  int h_pad, w_pad, c_in, kh, groups, c_out, h_out, w_out;
  int n_steps, n_i, n_k, lane, w_l;
  int pipes_per_block;
  unsigned long long bias_full, bias_top;
};

template <typename Word>
__device__ __forceinline__ Word load_kappa(const int32_t* __restrict__ k,
                                           int64_t plane, int64_t idx);

template <>
__device__ __forceinline__ uint32_t load_kappa<uint32_t>(
    const int32_t* __restrict__ k, int64_t, int64_t idx) {
  return static_cast<uint32_t>(k[idx]);
}

template <>
__device__ __forceinline__ uint64_t load_kappa<uint64_t>(
    const int32_t* __restrict__ k, int64_t plane, int64_t idx) {
  const uint64_t lo = static_cast<uint32_t>(k[idx]);
  const uint64_t hi = static_cast<uint32_t>(k[plane + idx]);
  return (hi << 32) | lo;
}

// Grid (B * h_out, ceil(C_out / co_tile), pipeline splits); block
// (co_tile, pipe_threads).  Dynamic shared memory: the row accumulator
// [n_steps * n_i][co_tile] int32.
template <typename Word, int NL>
__global__ void bseg_conv2d_kernel(const int8_t* __restrict__ x,
                                   const int32_t* __restrict__ kappa,
                                   int32_t* __restrict__ out, Conv c) {
  extern __shared__ int32_t acc[];
  const int co_tile = blockDim.x;
  const int tid = threadIdx.y * co_tile + threadIdx.x;
  const int nthreads = co_tile * blockDim.y;
  const int row = blockIdx.x;                 // b * h_out + y
  const int bb = row / c.h_out, y = row % c.h_out;
  const int co0 = blockIdx.y * co_tile;
  const int co = co0 + threadIdx.x;
  const int khc = c.kh * c.c_in;
  const int p0 = blockIdx.z * c.pipes_per_block;
  const int p1 = min(khc, p0 + c.pipes_per_block);
  const int buf = c.n_steps * c.n_i;

  for (int i = tid; i < buf * co_tile; i += nthreads) acc[i] = 0;
  __syncthreads();

  if (co < c.c_out) {
    const int L = c.lane, n_i = c.n_i;
    const Word mask = (Word(1) << L) - 1;
    const Word lo_mask = (Word(1) << c.w_l) - 1;
    const Word bias = Word(1) << (L - 1);
    const Word bias_full = static_cast<Word>(c.bias_full);
    const Word bias_top = static_cast<Word>(c.bias_top);
    const int64_t plane = static_cast<int64_t>(c.groups) * khc * c.c_out;
    for (int p = p0 + threadIdx.y; p < p1; p += blockDim.y) {
      const int r = p / c.c_in, ci = p % c.c_in;
      const int8_t* xrow =
          x + ((static_cast<int64_t>(bb) * c.h_pad + y + r) * c.w_pad) *
                  c.c_in + ci;
      for (int g = 0; g < c.groups; ++g) {
        const Word kap = load_kappa<Word>(
            kappa, plane,
            (static_cast<int64_t>(g) * khc + p) * c.c_out + co);
        const int8_t* xg = xrow + static_cast<int64_t>(g) * c.n_k * c.c_in;
        Word carry = bias_full;
        int32_t win[NL];  // lane sums at accumulator index t n_i + q
#pragma unroll
        for (int q = 0; q < NL; ++q) win[q] = 0;
        for (int t = 0; t < c.n_steps; ++t) {
          const int8_t* xs = xg + static_cast<int64_t>(t) * n_i * c.c_in;
          Word iota = 0;
          for (int j = 0; j < n_i; ++j)
            iota += static_cast<Word>(static_cast<int32_t>(
                        __ldg(xs + static_cast<int64_t>(j) * c.c_in)))
                    << (j * L);
          const Word word = kap * iota + carry;   // one wide MAC
          carry = bias_top;
#pragma unroll
          for (int q = 0; q < NL; ++q) {
            const Word f = (word >> (q * L)) & mask;
            if (q < n_i) {                          // completed output
              win[q] += static_cast<int32_t>(static_cast<uint32_t>(f - bias));
            } else {                                // Fig. 7 slice
              const Word lo = f & lo_mask;
              win[q] += static_cast<int32_t>(
                  static_cast<uint32_t>(f - lo - bias));
              carry += (lo + bias) << ((q - n_i) * L);
            }
          }
          // indices below (t + 1) n_i are complete for this chain:
          // add them to the row and slide the window down n_i lanes
          for (int j = 0; j < n_i; ++j) {
            atomicAdd(&acc[(t * n_i + j) * co_tile + threadIdx.x], win[0]);
#pragma unroll
            for (int q = 0; q + 1 < NL; ++q) win[q] = win[q + 1];
            win[NL - 1] = 0;
          }
        }
        // what is left in the window lies at indices >= n_steps n_i,
        // past the last output column (W + n_k - 2): discarded
      }
    }
  }
  __syncthreads();

  const bool accumulate = gridDim.z > 1;
  for (int i = tid; i < c.w_out * co_tile; i += nthreads) {
    const int col = i / co_tile, cc = i % co_tile;
    if (co0 + cc >= c.c_out) continue;
    const int32_t v = acc[(col + c.n_k - 1) * co_tile + cc];
    int32_t* dst = out + (static_cast<int64_t>(row) * c.w_out + col) *
                             c.c_out + co0 + cc;
    if (accumulate)
      atomicAdd(dst, v);
    else
      *dst = v;
  }
}

template <typename Word, int NL>
cudaError_t launch(const int8_t* x, const int32_t* kappa, int32_t* out,
                   const Conv& c, int b, int co_tile, int pipe_threads,
                   int smem, cudaStream_t stream) {
  const auto kernel = bseg_conv2d_kernel<Word, NL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int khc = c.kh * c.c_in;
  const dim3 grid(b * c.h_out, (c.c_out + co_tile - 1) / co_tile,
                  (khc + c.pipes_per_block - 1) / c.pipes_per_block);
  const dim3 block(co_tile, pipe_threads);
  kernel<<<grid, block, smem, stream>>>(x, kappa, out, c);
  return cudaGetLastError();
}

template <typename Word>
cudaError_t dispatch(int n_lanes, const int8_t* x, const int32_t* kappa,
                     int32_t* out, const Conv& c, int b, int co_tile,
                     int pipe_threads, int smem, cudaStream_t s) {
#define BSEG_CASE(N) \
  case N:            \
    return launch<Word, N>(x, kappa, out, c, b, co_tile, pipe_threads, smem, s);
  switch (n_lanes) {
    BSEG_CASE(1) BSEG_CASE(2) BSEG_CASE(3) BSEG_CASE(4) BSEG_CASE(5)
    BSEG_CASE(6) BSEG_CASE(7) BSEG_CASE(8) BSEG_CASE(9) BSEG_CASE(10)
    BSEG_CASE(11) BSEG_CASE(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef BSEG_CASE
}

}  // namespace

extern "C" {

const char* bseg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() of the launch (0 = success).  `wide` selects
// the [2, G, kh, C_in, C_out] limb-plane kappa and the uint64 word.
int bseg_conv2d(const void* x_pad, const void* kappa, void* out, int b,
                int h_pad, int w_pad, int c_in, int kh, int groups,
                int c_out, int h_out, int w_out, int n_i, int n_k,
                int n_lanes, int lane, int w_l, unsigned long long bias_full,
                unsigned long long bias_top, int wide, int co_tile,
                int pipe_threads, int pipes_per_block, int smem,
                void* stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_i < 1 || n_i > n_lanes ||
      lane < 1 || lane > 31 || co_tile < 1 || pipe_threads < 1 ||
      co_tile * pipe_threads > 1024 || pipes_per_block < 1 || b < 1 ||
      h_out < 1 || w_out < 1 || (!wide && n_lanes * lane > 32) ||
      (wide && n_lanes * lane > 64))
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
  c.n_steps = (w_out + n_k - 1 + n_i - 1) / n_i;
  c.n_i = n_i;
  c.n_k = n_k;
  c.lane = lane;
  c.w_l = w_l;
  c.pipes_per_block = pipes_per_block;
  c.bias_full = bias_full;
  c.bias_top = bias_top;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(kappa);
  const int8_t* xp = static_cast<const int8_t*>(x_pad);
  int32_t* o = static_cast<int32_t*>(out);
  if (pipes_per_block < kh * c_in) {
    // split pipelines accumulate into a zeroed output
    const cudaError_t err = cudaMemsetAsync(
        o, 0,
        static_cast<size_t>(b) * h_out * w_out * c_out * sizeof(int32_t), s);
    if (err != cudaSuccess) return err;
  }
  if (wide)
    return dispatch<uint64_t>(n_lanes, xp, k, o, c, b, co_tile, pipe_threads,
                              smem, s);
  return dispatch<uint32_t>(n_lanes, xp, k, o, c, b, co_tile, pipe_threads,
                            smem, s);
}

}  // extern "C"
