// Lane pack (B6) and unpack (B7) of the memory-packed weights for Hopper
// (sm_90a).
//
// Replaces the TPU kernels repro/kernels/packbits.py::pack_words (body
// _pack_body) and ::unpack_words (body _unpack_body): the HBM storage
// layout of the memory-packed serving mode, per = 32 / w two's-complement
// w-bit fields in one int32 word, word j of a row holding columns
// j * per .. j * per + per - 1 (field i in bits i w .. i w + w - 1).  For
// w = 3, 5, 6 and 7 the top 32 - per w bits stay zero.
//
// Since a row of n = nw * per values maps to nw words, the flat value
// index of word i's field f is i * per + f whatever the row: both kernels
// are one-dimensional over the m * nw words, and the row split is the
// caller's.
//
// Word arithmetic is unsigned: each field is masked to w bits first and
// shifted as uint32 (for w = 8, field 3 moves into the sign bit, which a
// signed shift of a negative int8 would leave undefined in C++).  Unpack
// sign-extends each field: f >= 2^(w-1) ? f - 2^w : f.
//
// Bound.  Both are shifts and masks over 4 + per bytes per word (4 bytes
// of word and per bytes of int8 values, one read and one written): bound
// by bytes at the card's memory rate.  Unpacking a tinyllama-1.1b decode
// step's 155 W4 matrices moves ~0.55 GB of words in and ~1.1 GB of int8
// out.
//
// What the design does about it.  One thread per word, a grid-stride loop
// over the words; neighbouring threads take neighbouring words, so the
// 4-byte word accesses of a warp are coalesced, and the per int8 values of
// a word move as one 4-, 8- or 16-byte vector when per is 4, 8 or 16
// (w = 8, 4, 2; the wrapper checks that the int8 side starts 16-byte
// aligned) and as bytes otherwise.  No shared memory: nothing is reused.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

template <int W>
struct Fields {
  static constexpr int kPer = 32 / W;
  static constexpr uint32_t kMask = (1u << W) - 1u;
  static constexpr uint32_t kHalf = 1u << (W - 1);
};

// The aligned vector type that moves the per int8 values of one word in
// one access, where there is one (per = 4, 8, 16).
template <int Per>
struct Vec {
  static constexpr bool kOk = false;
};
template <>
struct Vec<4> {
  static constexpr bool kOk = true;
  using T = uint32_t;
};
template <>
struct Vec<8> {
  static constexpr bool kOk = true;
  using T = uint2;
};
template <>
struct Vec<16> {
  static constexpr bool kOk = true;
  using T = uint4;
};

template <int W>
__device__ __forceinline__ uint32_t pack_one(const int8_t* __restrict__ v) {
  using F = Fields<W>;
  uint8_t b[F::kPer];
  if constexpr (Vec<F::kPer>::kOk) {
    const auto vec = *reinterpret_cast<const typename Vec<F::kPer>::T*>(v);
    memcpy(b, &vec, F::kPer);
  } else {
#pragma unroll
    for (int f = 0; f < F::kPer; ++f) b[f] = static_cast<uint8_t>(v[f]);
  }
  uint32_t word = 0u;
#pragma unroll
  for (int f = 0; f < F::kPer; ++f)
    word |= (static_cast<uint32_t>(b[f]) & F::kMask) << (f * W);
  return word;
}

template <int W>
__device__ __forceinline__ void unpack_one(uint32_t word,
                                           int8_t* __restrict__ out) {
  using F = Fields<W>;
  uint8_t b[F::kPer];
#pragma unroll
  for (int f = 0; f < F::kPer; ++f) {
    const uint32_t u = (word >> (f * W)) & F::kMask;
    // sign-extend the w-bit field and keep its low byte (two's complement)
    b[f] = static_cast<uint8_t>((u & F::kHalf) ? u - (1u << W) : u);
  }
  if constexpr (Vec<F::kPer>::kOk) {
    typename Vec<F::kPer>::T vec;
    memcpy(&vec, b, F::kPer);
    *reinterpret_cast<typename Vec<F::kPer>::T*>(out) = vec;
  } else {
#pragma unroll
    for (int f = 0; f < F::kPer; ++f) out[f] = static_cast<int8_t>(b[f]);
  }
}

template <int W>
__global__ void pack_words_kernel(const int8_t* __restrict__ vals,
                                  int32_t* __restrict__ words,
                                  int64_t n_words) {
  constexpr int kPer = Fields<W>::kPer;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_words; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    words[i] = static_cast<int32_t>(pack_one<W>(vals + i * kPer));
}

template <int W>
__global__ void unpack_words_kernel(const int32_t* __restrict__ words,
                                    int8_t* __restrict__ vals,
                                    int64_t n_words) {
  constexpr int kPer = Fields<W>::kPer;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n_words; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    unpack_one<W>(static_cast<uint32_t>(words[i]), vals + i * kPer);
}

template <int W>
cudaError_t launch(bool pack, const void* src, void* dst, int64_t n_words,
                   int blocks, int threads, cudaStream_t s) {
  if (pack)
    pack_words_kernel<W><<<blocks, threads, 0, s>>>(
        static_cast<const int8_t*>(src), static_cast<int32_t*>(dst),
        n_words);
  else
    unpack_words_kernel<W><<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(src), static_cast<int8_t*>(dst),
        n_words);
  return cudaGetLastError();
}

cudaError_t dispatch(int w, bool pack, const void* src, void* dst,
                     long long n_words, int blocks, int threads,
                     void* stream) {
  if (w < 2 || w > 8 || n_words < 1 || blocks < 1 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 2: return launch<2>(pack, src, dst, n_words, blocks, threads, s);
    case 3: return launch<3>(pack, src, dst, n_words, blocks, threads, s);
    case 4: return launch<4>(pack, src, dst, n_words, blocks, threads, s);
    case 5: return launch<5>(pack, src, dst, n_words, blocks, threads, s);
    case 6: return launch<6>(pack, src, dst, n_words, blocks, threads, s);
    case 7: return launch<7>(pack, src, dst, n_words, blocks, threads, s);
    default: return launch<8>(pack, src, dst, n_words, blocks, threads, s);
  }
}

}  // namespace

extern "C" {

const char* packbits_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// int8 vals [n_words * (32 / w)] -> int32 words [n_words].  Returns
// cudaGetLastError() of the launch (0 = success).
int pack_words(const void* vals, void* words, long long n_words, int w,
               int blocks, int threads, void* stream) {
  return dispatch(w, true, vals, words, n_words, blocks, threads, stream);
}

// int32 words [n_words] -> int8 vals [n_words * (32 / w)], sign-extended.
int unpack_words(const void* words, void* vals, long long n_words, int w,
                 int blocks, int threads, void* stream) {
  return dispatch(w, false, words, vals, n_words, blocks, threads, stream);
}

}  // extern "C"
