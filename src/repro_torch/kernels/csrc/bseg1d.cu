// Depthwise causal BSEG conv1d (B4) for Hopper (sm_90a), on decoded taps.
//
// Replaces the TPU kernel repro/kernels/bseg_conv1d.py::bseg_conv1d (its
// body _body): the short depthwise conv of the Mamba2 and Griffin (RG-LRU)
// blocks through Binary Segmentation (paper Sec. III-D, Figs. 6/7).
//
// What is computed.  x_pad [B, S_pad, C] int8 holds unsigned activations
// in [0, 2^w_i), left-padded by the caller; kappa holds one packed factor
// per (tap group g, channel c), the group's n_k taps reversed through the
// pre-adder at weight-prep time: [G, C] int32 (INT32), float32 (FP32M,
// exact integers below 2^24) or [2, G, C] int32 lo/hi limb planes
// (DSP48E2/DSP58).  The reference runs a carry word per (row, channel,
// group) through n_i samples a wide multiply, with guard bits and Fig. 7
// slicing.  With its guard bits every lane of that arithmetic is exact,
// so its result is the plain correlation with the decoded taps, mod 2^32:
//   out[b, s, c] = sum_{j < G n_k} tap_j[c] * x_pad[b, s + j, c]
// where lane i of group g's factor, sign-extended from L bits after the
// lower lanes are taken off, is tap g n_k + n_k - 1 - i (the taps past
// the conv's own are zero).  This kernel computes that sum; it has no
// carry word and no serial step chain (bseg_conv1d_plain repeats the
// reference's word arithmetic, and the tests hold the two equal).
//
// The decode.  A factor W = sum_i v_i 2^(iL) with v_i in [-2^(L-1),
// 2^(L-1)) is exact in a 64-bit integer on every word form (int32
// sign-extended, FP32M's float integers converted exactly, the limb
// planes joined); W + H, H = 2^(L-1) in each of the n_k lanes, has a
// non-negative field v_i + 2^(L-1) in every lane and no borrow between
// them, so v_i = ((W + H) >> iL & (2^L - 1)) - 2^(L-1), in uint64 (W + H
// lies in [0, 2^(n_k L))).  The host fills each tap's group and bit
// offset into the launch's parameters, so a thread decodes any tap by
// one load and a few integer instructions; it starts those loads and its
// first rows of x_pad together, and decodes once they have landed.
// Products and sums are uint32: they wrap mod 2^32 like the reference's
// INT32 word (and only the low 32 bits of the exact sums are kept on
// every word form).
//
// Bound: bytes.  Per output the conv reads one int8 sample and writes one
// int32, ~5 bytes, against 2 G n_k integer operations (K = 4-6 taps on the
// W4A4 plans): depthwise, nothing is summed across channels, so there is
// no GEMM shape for the tensor cores.  At the decode shape (B = 8, 4
// samples, C = 1792) a call moves ~0.2 MB, below a microsecond at 3.35
// TB/s: it is one DRAM round trip plus the launch.
//
// What the design does about it.  A thread owns 4 adjacent channels of one
// batch row (a 4-byte load of x_pad per row, a 16-byte store per output
// row; a warp reads 128 contiguous bytes a row) and a strip of outputs
// along S, walked in sub-strips of T = 8 outputs.  It decodes its
// taps into registers once (KT = 4, 8 or 16 at a time, the fewest that
// hold the plan's G n_k taps; more taps take further passes that add into
// the outputs), loads the sub-strip's T + taps - 1 rows, all unrolled and
// in flight before any arithmetic, and keeps the last taps - 1 rows in
// registers as it slides to the next sub-strip, so each sample is read
// once; the next sub-strip's rows are loaded while this one computes and
// stores.  At the decode shape the strip is the whole row (4 outputs, 7 row
// loads a thread); at long rows the host cuts strips of ~32 outputs so
// the threads fill the card.  C % 4 != 0, or operands not aligned to
// their vectors, take byte loads and 4-byte stores for every channel.
// No shared memory, no atomics: each output is written by one thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxGroups = 8;
constexpr int kMaxLanes = 12;
constexpr int kMaxTaps = kMaxGroups * kMaxLanes;
constexpr int kSubStrip = 8;   // outputs a thread computes between loads

enum Kind : int { kInt32 = 0, kFp32 = 1, kTwoLimb = 2 };

struct Conv1d {
  int s_pad, c, groups, s_out, taps, strip;
  bool vec;
  unsigned long long bias;   // H: 2^(L-1) in each of the n_k lanes
  unsigned long long mask;   // 2^L - 1
  unsigned long long half;   // 2^(L-1)
  uint8_t tap_group[kMaxTaps];   // tap j: its group g
  uint8_t tap_shift[kMaxTaps];   // and its lane's bit offset i L
};

// The factor of a tap as W + H in uint64, from its raw 32-bit words: lo
// (the int32 word, FP32M's float bits, or the low limb) and hi (the high
// limb)
template <int kKind>
__device__ __forceinline__ uint64_t biased_word(int32_t lo, int32_t hi,
                                                uint64_t bias) {
  if constexpr (kKind == kInt32) {
    return static_cast<uint64_t>(static_cast<int64_t>(lo)) + bias;
  } else if constexpr (kKind == kFp32) {
    // an exact integer below 2^24: the conversion is exact
    return static_cast<uint64_t>(__float2ll_rn(__int_as_float(lo))) + bias;
  } else {
    return ((static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
            static_cast<uint32_t>(lo)) + bias;
  }
}

// The 4 channels of row `row`, one byte each (zero past C), packed
__device__ __forceinline__ uint32_t load_row(const int8_t* __restrict__ xb,
                                             int64_t row, const Conv1d& p,
                                             int nc) {
  const int8_t* src = xb + row * p.c;
  if (p.vec) return __ldg(reinterpret_cast<const uint32_t*>(src));
  uint32_t v = 0;
#pragma unroll
  for (int ch = 0; ch < 4; ++ch)
    if (ch < nc)
      v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + ch)))
           << (8 * ch);
  return v;
}

__device__ __forceinline__ void store_row(int32_t* __restrict__ dst,
                                          const uint32_t (&v)[4],
                                          const Conv1d& p, int nc,
                                          bool accumulate) {
  uint32_t o[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) o[ch] = v[ch];
  if (p.vec) {
    int4* d = reinterpret_cast<int4*>(dst);
    if (accumulate) {
      const int4 prev = *d;
      o[0] += static_cast<uint32_t>(prev.x);
      o[1] += static_cast<uint32_t>(prev.y);
      o[2] += static_cast<uint32_t>(prev.z);
      o[3] += static_cast<uint32_t>(prev.w);
    }
    *d = make_int4(static_cast<int>(o[0]), static_cast<int>(o[1]),
                   static_cast<int>(o[2]), static_cast<int>(o[3]));
  } else {
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      if (ch >= nc) break;
      const uint32_t prev =
          accumulate ? static_cast<uint32_t>(dst[ch]) : 0u;
      dst[ch] = static_cast<int32_t>(o[ch] + prev);
    }
  }
}

// Grid (ceil(C / 4 / blockDim.x), strips, B); one thread per (b, channel
// quad, strip).  KT: taps decoded per pass.
template <int kKind, int KT>
__global__ void __launch_bounds__(256)
bseg_conv1d_kernel(const int8_t* __restrict__ x,
                   const void* __restrict__ kappa,
                   int32_t* __restrict__ out, const Conv1d p) {
  constexpr int T = kSubStrip;
  constexpr int kWin = T + KT - 1;
  const int c0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= p.c) return;
  const int bb = blockIdx.z;
  const int s0 = blockIdx.y * p.strip;
  const int s1 = min(p.s_out, s0 + p.strip);
  const int nc = min(4, p.c - c0);
  const int8_t* xb = x + static_cast<int64_t>(bb) * p.s_pad * p.c + c0;
  int32_t* ob = out + static_cast<int64_t>(bb) * p.s_out * p.c + c0;
  const int32_t* kw = static_cast<const int32_t*>(kappa);
  const int64_t plane = static_cast<int64_t>(p.groups) * p.c;

  for (int j0 = 0; j0 < p.taps; j0 += KT) {
    const int nt = min(KT, p.taps - j0);   // taps of this pass
    // the raw factor words of the pass's taps and the first sub-strip's
    // rows are all loaded before the decode uses any of them
    int32_t lo[KT][4], hi[KT][4];
#pragma unroll
    for (int jj = 0; jj < KT; ++jj)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        lo[jj][ch] = hi[jj][ch] = 0;
        if (jj < nt && ch < nc) {
          const int64_t idx =
              static_cast<int64_t>(p.tap_group[j0 + jj]) * p.c + c0 + ch;
          lo[jj][ch] = __ldg(kw + idx);
          if (kKind == kTwoLimb) hi[jj][ch] = __ldg(kw + plane + idx);
        }
      }
    // win[r]: row s + j0 + r of the sub-strip at s, 4 channels packed;
    // nxt[r]: the rows of the next sub-strip, loaded ahead
    uint32_t win[kWin], nxt[kWin];
    {
      const int need = min(T, s1 - s0) + nt - 1;
#pragma unroll
      for (int r = 0; r < kWin; ++r)
        nxt[r] = r < need ? load_row(xb, static_cast<int64_t>(s0) + j0 + r,
                                     p, nc)
                          : 0u;
    }
    // lane (W + H) >> iL & (2^L - 1), minus 2^(L-1); zero past the taps
    uint32_t tap[KT][4];
#pragma unroll
    for (int jj = 0; jj < KT; ++jj)
#pragma unroll
      for (int ch = 0; ch < 4; ++ch) {
        const uint64_t wd = biased_word<kKind>(lo[jj][ch], hi[jj][ch],
                                               p.bias);
        tap[jj][ch] = jj < nt && ch < nc
                          ? static_cast<uint32_t>(
                                ((wd >> p.tap_shift[j0 + jj]) & p.mask) -
                                p.half)
                          : 0u;
      }
    for (int s = s0; s < s1; s += T) {
      const int len = min(T, s1 - s);
      // rows below `have` slide down T from the previous sub-strip, the
      // rest arrived in nxt
      const int have = s == s0 ? 0 : nt - 1;
#pragma unroll
      for (int r = 0; r < kWin; ++r) {
        if (r + T < kWin && r < have)
          win[r] = win[r + T];
        else
          win[r] = nxt[r];
      }
      // load the next sub-strip's new rows while this one computes
      const int sn = s + T;
      if (sn < s1) {
        const int need = min(T, s1 - sn) + nt - 1;
#pragma unroll
        for (int r = 0; r < kWin; ++r)
          if (r >= nt - 1 && r < need)
            nxt[r] = load_row(xb, static_cast<int64_t>(sn) + j0 + r, p, nc);
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (t >= len) break;
        uint32_t acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int jj = 0; jj < KT; ++jj)
#pragma unroll
          for (int ch = 0; ch < 4; ++ch)
            acc[ch] += tap[jj][ch] *
                       __byte_perm(win[t + jj], 0u, 0x4440 + ch);
        store_row(ob + static_cast<int64_t>(s + t) * p.c, acc, p, nc,
                  j0 > 0);
      }
    }
  }
}

template <int kKind, int KT>
cudaError_t launch(const int8_t* x, const void* kappa, int32_t* out,
                   const Conv1d& p, int b, int threads, cudaStream_t s) {
  const int quads = (p.c + 3) / 4;
  const dim3 grid((quads + threads - 1) / threads,
                  (p.s_out + p.strip - 1) / p.strip, b);
  bseg_conv1d_kernel<kKind, KT><<<grid, threads, 0, s>>>(x, kappa, out, p);
  return cudaGetLastError();
}

template <int kKind>
cudaError_t dispatch(const int8_t* x, const void* kappa, int32_t* out,
                     const Conv1d& p, int b, int threads, cudaStream_t s) {
  if (p.taps <= 4) return launch<kKind, 4>(x, kappa, out, p, b, threads, s);
  if (p.taps <= 8) return launch<kKind, 8>(x, kappa, out, p, b, threads, s);
  return launch<kKind, 16>(x, kappa, out, p, b, threads, s);
}

}  // namespace

extern "C" {

const char* bseg1d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Returns cudaGetLastError() of the launch (0 = success).  kind: 0 int32
// [G, C] factors, 1 float32 [G, C], 2 [2, G, C] limb planes; n_k taps a
// group of L = lane bits each; `strip` outputs per thread, `threads` per
// block.
int bseg_conv1d(const void* x_pad, const void* kappa, void* out, int b,
                int s_pad, int c, int groups, int s_out, int n_k, int lane,
                int kind, int strip, int threads, void* stream) {
  if (groups < 1 || groups > kMaxGroups || n_k < 1 || n_k > kMaxLanes ||
      lane < 1 || n_k * lane > 64 || kind < kInt32 || kind > kTwoLimb ||
      b < 1 || b > 65535 || c < 1 || s_out < 1 || strip < 1 ||
      (s_out + strip - 1) / strip > 65535 || threads < 32 ||
      threads > 256 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  Conv1d p;
  p.s_pad = s_pad;
  p.c = c;
  p.groups = groups;
  p.s_out = s_out;
  p.taps = groups * n_k;
  p.strip = strip;
  // output s reads rows s .. s + taps - 1
  if (s_pad < s_out + p.taps - 1) return cudaErrorInvalidValue;
  p.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(x_pad) % 4 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  p.half = 1ull << (lane - 1);
  p.mask = lane >= 64 ? ~0ull : (1ull << lane) - 1;
  p.bias = 0;
  for (int i = 0; i < n_k; ++i) p.bias += p.half << (i * lane);
  for (int j = 0; j < kMaxTaps; ++j) {   // past the taps: never decoded
    p.tap_group[j] = static_cast<uint8_t>(j < p.taps ? j / n_k : 0);
    p.tap_shift[j] = static_cast<uint8_t>(
        j < p.taps ? (n_k - 1 - j % n_k) * lane : 0);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x_pad);
  int32_t* o = static_cast<int32_t*>(out);
  switch (kind) {
    case kInt32: return dispatch<kInt32>(xp, kappa, o, p, b, threads, s);
    case kFp32: return dispatch<kFp32>(xp, kappa, o, p, b, threads, s);
    default: return dispatch<kTwoLimb>(xp, kappa, o, p, b, threads, s);
  }
}

}  // extern "C"
