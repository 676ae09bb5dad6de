// Depthwise causal BSEG conv1d (B4) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bseg_conv1d.py::bseg_conv1d (its
// body _body): the short depthwise conv of the Mamba2 and Griffin (RG-LRU)
// blocks through Binary Segmentation (paper Sec. III-D, Figs. 6/7).
//
// What is computed.  x_pad [B, S_pad, C] int8 holds unsigned activations
// in [0, 2^w_i), left-padded by the caller; kappa holds one packed factor
// per (tap group g, channel c), the group's n_k taps reversed through the
// pre-adder at weight-prep time.  Every (b, c, g) is a carry chain: the
// carry word starts at bias_full and runs n_steps = ceil((S_out + n_k - 1)
// / n_i) steps in order; step t
//   word  = kappa[g, c] * iota(x_pad[b, t n_i + g n_k + j, c], j < n_i)
//           + carry
//   lanes: q < n_i completed outputs field_q - bias; q >= n_i the high
//          part field_q - lo_q - bias of each carried lane (lo_q = its
//          low w_l bits, Fig. 7)
//   carry = bias_top + sum_{q >= n_i} (lo_q + bias) << ((q - n_i) L)
// and lane q is added into the row accumulator at index t n_i + q, summed
// over the groups.  Output s is accumulator index s + n_k - 1.
//
// Word arithmetic is unsigned (signed overflow is undefined in C++).  The
// INT32 word wraps mod 2^32 in the reference and every field the split
// reads lies below n_lanes L <= 32 bits, so a uint32 word gives the same
// lanes; FP32M words are exact non-negative integers below 2^24, on which
// the reference's floor-divides and mods are shifts and masks, so FP32M
// runs in the same uint32 body (the wrapper converts the float32 kappa to
// int32, exactly).  The wide DSP48E2/DSP58 words arrive as hi:lo int32
// limb planes, which wrap mod 2^64 exactly like uint64.
//
// Bound.  Per output the kernel reads one int8 sample and writes one
// int32 (kappa is G words per channel), and it does G wide multiplies per
// n_i outputs: ~5 bytes against a handful of integer instructions, so it
// is bound by bytes.  At the decode shape (B = 8, S = 4, C = 1792) it
// moves ~0.2 MB, below a microsecond at 3.35 TB/s: a decode step's call is
// launch-bound.
//
// What the design does about it.  One thread owns one (b, c) carry chain,
// with the G carry words, the G factors and a window of n_lanes lane sums
// in registers; it writes each output once it is complete (no atomics,
// no shared memory).  Neighbouring threads take neighbouring channels, so
// the int8 loads and the int32 stores of a warp are coalesced.  B * C is
// only 14,336-20,480 chains at batch 8, too few to fill the card at long
// S, so the outputs of a chain are cut into chunks, one thread each.  The
// carry only moves low parts of a lane into the same accumulator index,
// so a chain restarted at step t0 with a fresh carry word gives every
// accumulator index >= t0 n_i + n_k - 1 exactly, i.e. every output
// s >= t0 n_i: a chunk of outputs [s0, s1) starts at step floor(s0 / n_i)
// and stops after the step that completes output s1 - 1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLanes = 12;   // plan_bseg's largest n_lanes for w <= 8
constexpr int kMaxGroups = 8;   // tap groups: ceil(taps / n_k), taps <= 8

struct Conv1d {
  int s_pad, c, groups, s_out, n_steps, n_i, n_k, lane, w_l, chunk;
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

// Grid (ceil(C / blockDim.x), B, chunks); one thread per (b, c, chunk).
template <typename Word, int NL>
__global__ void bseg_conv1d_kernel(const int8_t* __restrict__ x,
                                   const int32_t* __restrict__ kappa,
                                   int32_t* __restrict__ out, Conv1d p) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= p.c) return;
  const int bb = blockIdx.y;
  const int s0 = blockIdx.z * p.chunk;
  const int s1 = min(p.s_out, s0 + p.chunk);
  if (s0 >= s1) return;
  const int n_i = p.n_i, L = p.lane, lag = p.n_k - 1;
  // a fresh chain at step t0 gives every output s >= t0 n_i exactly;
  // output s is complete after step floor((s + n_k - 1) / n_i)
  const int t0 = s0 / n_i;
  const int t1 = min(p.n_steps, (s1 - 1 + lag) / n_i + 1);

  const Word mask = (Word(1) << L) - 1;
  const Word lo_mask = (Word(1) << p.w_l) - 1;
  const Word bias = Word(1) << (L - 1);
  const Word bias_full = static_cast<Word>(p.bias_full);
  const Word bias_top = static_cast<Word>(p.bias_top);
  const int64_t plane = static_cast<int64_t>(p.groups) * p.c;

  Word kap[kMaxGroups], carry[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    kap[g] = 0;
    carry[g] = bias_full;
    if (g < p.groups)
      kap[g] = load_kappa<Word>(kappa, plane,
                                static_cast<int64_t>(g) * p.c + ch);
  }
  int32_t win[NL];  // lane sums at accumulator index t n_i + q
#pragma unroll
  for (int q = 0; q < NL; ++q) win[q] = 0;

  const int8_t* xb = x + static_cast<int64_t>(bb) * p.s_pad * p.c + ch;
  int32_t* ob = out + static_cast<int64_t>(bb) * p.s_out * p.c + ch;
  for (int t = t0; t < t1; ++t) {
    const int tau = t * n_i;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < p.groups) {
        const int8_t* xs =
            xb + static_cast<int64_t>(tau + g * p.n_k) * p.c;
        Word iota = 0;
        for (int j = 0; j < n_i; ++j)
          iota += static_cast<Word>(static_cast<int32_t>(
                      __ldg(xs + static_cast<int64_t>(j) * p.c)))
                  << (j * L);
        const Word word = kap[g] * iota + carry[g];   // one wide MAC
        Word next = bias_top;
#pragma unroll
        for (int q = 0; q < NL; ++q) {
          const Word f = (word >> (q * L)) & mask;
          if (q < n_i) {                              // completed output
            win[q] += static_cast<int32_t>(static_cast<uint32_t>(f - bias));
          } else {                                    // Fig. 7 slice
            const Word lo = f & lo_mask;
            win[q] += static_cast<int32_t>(
                static_cast<uint32_t>(f - lo - bias));
            next += (lo + bias) << ((q - n_i) * L);
          }
        }
        carry[g] = next;
      }
    }
    // indices below (t + 1) n_i are complete: write the chunk's outputs
    // among them and slide the window down n_i lanes
    for (int j = 0; j < n_i; ++j) {
      const int s = tau + j - lag;
      if (s >= s0 && s < s1) ob[static_cast<int64_t>(s) * p.c] = win[0];
#pragma unroll
      for (int q = 0; q + 1 < NL; ++q) win[q] = win[q + 1];
      win[NL - 1] = 0;
    }
  }
}

template <typename Word, int NL>
cudaError_t launch(const int8_t* x, const int32_t* kappa, int32_t* out,
                   const Conv1d& p, int b, int threads, cudaStream_t stream) {
  const int chunks = (p.s_out + p.chunk - 1) / p.chunk;
  const dim3 grid((p.c + threads - 1) / threads, b, chunks);
  bseg_conv1d_kernel<Word, NL><<<grid, threads, 0, stream>>>(x, kappa, out,
                                                              p);
  return cudaGetLastError();
}

template <typename Word>
cudaError_t dispatch(int n_lanes, const int8_t* x, const int32_t* kappa,
                     int32_t* out, const Conv1d& p, int b, int threads,
                     cudaStream_t s) {
#define BSEG1D_CASE(N) \
  case N:              \
    return launch<Word, N>(x, kappa, out, p, b, threads, s);
  switch (n_lanes) {
    BSEG1D_CASE(1) BSEG1D_CASE(2) BSEG1D_CASE(3) BSEG1D_CASE(4)
    BSEG1D_CASE(5) BSEG1D_CASE(6) BSEG1D_CASE(7) BSEG1D_CASE(8)
    BSEG1D_CASE(9) BSEG1D_CASE(10) BSEG1D_CASE(11) BSEG1D_CASE(12)
    default:
      return cudaErrorInvalidValue;
  }
#undef BSEG1D_CASE
}

}  // namespace

extern "C" {

const char* bseg1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() of the launch (0 = success).  `wide` selects
// the [2, G, C] limb-plane kappa and the uint64 word; `chunk` is the
// outputs per thread, `threads` the block size.
int bseg_conv1d(const void* x_pad, const void* kappa, void* out, int b,
                int s_pad, int c, int groups, int s_out, int n_i, int n_k,
                int n_lanes, int lane, int w_l, unsigned long long bias_full,
                unsigned long long bias_top, int wide, int chunk,
                int threads, void* stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_i < 1 || n_i > n_lanes ||
      n_k < 1 || lane < 1 || lane > 31 || groups < 1 ||
      groups > kMaxGroups || b < 1 || b > 65535 || c < 1 || s_out < 1 ||
      chunk < 1 || (s_out + chunk - 1) / chunk > 65535 || threads < 32 ||
      threads > 1024 || threads % 32 != 0 ||
      (!wide && n_lanes * lane > 32) || (wide && n_lanes * lane > 64))
    return cudaErrorInvalidValue;
  Conv1d p;
  p.s_pad = s_pad;
  p.c = c;
  p.groups = groups;
  p.s_out = s_out;
  p.n_steps = (s_out + n_k - 1 + n_i - 1) / n_i;
  p.n_i = n_i;
  p.n_k = n_k;
  p.lane = lane;
  p.w_l = w_l;
  p.chunk = chunk;
  p.bias_full = bias_full;
  p.bias_top = bias_top;
  // the step schedule reads x_pad rows below
  // (n_steps - 1) n_i + (groups - 1) n_k + n_i
  if (s_pad < (p.n_steps - 1) * n_i + (groups - 1) * n_k + n_i)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(kappa);
  const int8_t* xp = static_cast<const int8_t*>(x_pad);
  int32_t* o = static_cast<int32_t*>(out);
  if (wide)
    return dispatch<uint64_t>(n_lanes, xp, k, o, p, b, threads, s);
  return dispatch<uint32_t>(n_lanes, xp, k, o, p, b, threads, s);
}

}  // extern "C"
