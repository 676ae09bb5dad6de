// Lane pack (B6), unpack (B7) and the fused unpack-and-dequantize of
// the memory-packed serving path (B7 as the path runs it) for Hopper
// (sm_90a).
//
// Replaces the TPU kernels repro/kernels/packbits.py::pack_words (body
// _pack_body) and ::unpack_words (body _unpack_body): the HBM storage
// layout of the memory-packed serving mode, per = 32 / w two's-complement
// w-bit fields in one int32 word, word j of a row holding columns
// j * per .. j * per + per - 1 (field i in bits i w .. i w + w - 1).  For
// w = 3, 5, 6 and 7 the top 32 - per w bits stay zero.  The fused kernel
// replaces unpack_words together with the dequant that
// repro/models/quantized.py::materialize runs after it (in jnp, outside
// its Pallas kernel): fields to float32, times the per-column scale, the
// padded columns trimmed, cast to the activation dtype.
//
// Word arithmetic is unsigned: each field is masked to w bits first and
// shifted as uint32 (for w = 8, field 3 moves into the sign bit, which a
// signed shift of a negative int8 would leave undefined in C++).  Unpack
// sign-extends each field: f >= 2^(w-1) ? f - 2^w : f.
//
// pack_words_kernel / unpack_words_kernel.  Since a row of n = nw * per
// values maps to nw words, the flat value index of word i's field f is
// i * per + f whatever the row: both are one-dimensional over the m * nw
// words.  Shifts and masks over 4 + per bytes per word, bound by bytes.
// One thread per word, a grid-stride loop; neighbouring threads take
// neighbouring words, and the per int8 values of a word move as one 4-,
// 8- or 16-byte vector when per is 4, 8 or 16 (w = 8, 4, 2; the wrapper
// checks that the int8 side starts 16-byte aligned) and as bytes
// otherwise.  unpack_words stays as the counterpart of the TPU function;
// no model path runs it.
//
// unpack_dequant_kernel<W, OutT, kVec>: out[r, c] = OutT(float(q[r, c]) *
// scale[r / rows_per_scale, c]) for c < d_out, out [m, d_out] written
// directly; OutT is bfloat16 or float.  Bit for bit the chain it
// replaces (int8 unpack, .to(float32) * scale, [:, :d_out],
// .to(dtype)): float(q) is exact, the product is one round-to-nearest
// multiply (__fmul_rn) and the cast one round-to-nearest-even
// conversion (__float2bfloat16_rn; the build keeps subnormals: no
// --use_fast_math).
//
// Bound.  A pure stream: w / 8 bytes of word in and sizeof(OutT) out per
// weight (W4 to bf16: 0.5 + 2 bytes, against ~20.5 for the chain's four
// passes), the scales negligible.  A tinyllama-1.1b memory decode step
// materializes 1.034 G weights: 0.772 ms at 3.35 TB/s.
//
// What the design does about it.
//   - Loads: a warp owns a span of 128 words of one row, 4 a lane, each
//     lane one 16-byte load (neighbouring lanes on neighbouring vectors,
//     a warp 512 contiguous bytes) where the row's word count is a
//     multiple of 4; 4-byte loads otherwise.  A warp keeps kDepth rows
//     of words in flight (a ring in registers, the next row loaded as
//     soon as one is taken out): with one, each row waited for its own
//     DRAM round trip.
//   - Stores: a lane's 4 words would put 4 per outputs of one lane side
//     by side, so one store instruction across a warp would touch every
//     32-byte sector only in part.  Four shuffles transpose the words
//     within each quad of lanes: store k then has the quad's 4 lanes on 4
//     neighbouring words (64 contiguous bytes at W4 to bf16: two whole
//     sectors).  A word's per outputs go out as the widest unit of at
//     most 16 bytes that divides them (16 at W4 to bf16, W2, and W4/W8
//     to float) where d_out * sizeof(OutT) and the base keep every row
//     aligned to it (kVec); otherwise the scalar-store instantiation
//     writes element by element.  Normal stores, not streaming ones: the
//     bf16 GEMM that follows reads the output, and most projections
//     (8.4 MB for q/o, 23 MB for the MLP) fit in the 50 MB L2.
//   - The trim (c >= d_out) is masked in the kernel; no strided copy.
//   - Scales: a block's slab of rows lies in one group of
//     rows_per_scale rows (a stacked container: one group a layer), so
//     a lane reads its 4 words' per scales once, beside its first words,
//     and keeps them in registers while its warp walks down the slab (a
//     block's 8 warps take every 8th row): a scale is read once per
//     warp, not once per weight.  (Staging them once per block in shared
//     memory behind a barrier is slower: the smem-scales variant of
//     scripts/dequant_breakdown.py.)
//   - One wave: the wrapper (packbits.launch_shape) cuts each group's
//     rows into as many slabs (grid y, a multiple of 8 rows each) as fill
//     kMinBlocks blocks on every SM with the row's spans (grid x), so no
//     second, part-empty wave of blocks trails the first.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
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


// ---------------------------------------------------------------------------
// unpack_dequant_kernel: the fused unpack-and-dequantize
// ---------------------------------------------------------------------------

constexpr int kSpanWords = 128;   // words a warp owns in a row: 32 lanes x 4
constexpr int kWarps = 8;         // warps a block; they split its rows
// blocks an SM holds (registers capped to fit; the wrapper sizes its
// grid to one wave of them: packbits.DEQUANT_BLOCKS_PER_SM)
constexpr int kMinBlocks = 2;
// rows of words a warp has in flight
constexpr int kDepth = 4;
constexpr unsigned kFull = 0xffffffffu;

// The widest store unit (bytes, at most 16) that divides a word's outputs.
__host__ __device__ constexpr int store_unit(int word_bytes, int elem) {
  return word_bytes % 16 == 0 ? 16 : word_bytes % 8 == 0 ? 8
       : word_bytes % 4 == 0 ? 4 : elem;
}

template <int Bytes> struct Unit;
template <> struct Unit<16> { using T = uint4; };
template <> struct Unit<8> { using T = uint2; };
template <> struct Unit<4> { using T = uint32_t; };
template <> struct Unit<2> { using T = uint16_t; };

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a[i] for a lane-dependent i, by selects (no local memory)
__device__ __forceinline__ uint32_t pick(const uint32_t (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// The lane's 4 words of row r (zero past the row's end, and for rows at
// or past rows_end).
__device__ __forceinline__ void load_words(const int32_t* __restrict__ words,
                                           int r, int rows_end, int own,
                                           int nw, bool vec,
                                           uint32_t (&v)[4]) {
  const int32_t* row = words + static_cast<int64_t>(r) * nw;
  const bool live = r < rows_end;
  if (vec) {   // nw % 4 == 0 and 16-byte rows: own < nw covers all four
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (live && own < nw) u = *reinterpret_cast<const uint4*>(row + own);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = live && own + j < nw ? static_cast<uint32_t>(row[own + j]) : 0u;
  }
}

// One word's per fields, scaled and cast, stored at columns col.. of a
// row (those below d_out).
template <int W, typename OutT, bool kVec>
__device__ __forceinline__ void dequant_store(uint32_t word,
                                              const float (&s)[32 / W],
                                              OutT* __restrict__ orow,
                                              int col, int d_out) {
  constexpr int kPer = 32 / W;
  OutT v[kPer];
#pragma unroll
  for (int f = 0; f < kPer; ++f) {
    // field f to the top, then an arithmetic shift sign-extends it
    const int q = static_cast<int32_t>(word << (32 - W * (f + 1))) >>
                  (32 - W);
    v[f] = to_out<OutT>(__fmul_rn(static_cast<float>(q), s[f]));
  }
  if constexpr (kVec) {
    constexpr int kUnit = store_unit(kPer * sizeof(OutT), sizeof(OutT));
    constexpr int kElems = kUnit / sizeof(OutT);
    using U = typename Unit<kUnit>::T;
    // d_out and col are multiples of kElems: a unit is all in or all out
#pragma unroll
    for (int p = 0; p < kPer / kElems; ++p)
      if (col + p * kElems < d_out) {
        U u;
        memcpy(&u, v + p * kElems, kUnit);
        *reinterpret_cast<U*>(orow + col + p * kElems) = u;
      }
  } else {
#pragma unroll
    for (int f = 0; f < kPer; ++f)
      if (col + f < d_out) orow[col + f] = v[f];
  }
}

template <int W, typename OutT, bool kVec>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
unpack_dequant_kernel(const int32_t* __restrict__ words,
                      const float* __restrict__ scale,
                      OutT* __restrict__ out, int nw, int d_out,
                      int rows_per_scale, int rows_per_block,
                      bool vec_load) {
  constexpr int kPer = 32 / W;
  const int lane = threadIdx.x & 31;
  const int quad = lane >> 2, qi = lane & 3;
  const int span = static_cast<int>(blockIdx.x) * kSpanWords;
  const int own = span + 4 * lane;               // the words this lane loads
  // a block's slab lies in one group of rows_per_scale rows
  const int slabs = (rows_per_scale + rows_per_block - 1) / rows_per_block;
  const int g = static_cast<int>(blockIdx.y) / slabs;
  const int slab = g * rows_per_scale +
                   (static_cast<int>(blockIdx.y) % slabs) * rows_per_block;
  const int slab_end = min((g + 1) * rows_per_scale, slab + rows_per_block);
  const int first = slab + static_cast<int>(threadIdx.x >> 5);
  if (first >= slab_end) return;                 // the whole warp
  // after the transpose, store k writes word span + 16 quad + 4 k + qi;
  // its scales are read once and stay in registers for every row the
  // warp walks (16-byte runs where a word's scales are whole ones)
  int wcol[4];
  float s[4][kPer];
  const float* srow = scale + static_cast<int64_t>(g) * nw * kPer;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wcol[k] = span + 16 * quad + 4 * k + qi;
    const float* sw = srow + wcol[k] * kPer;
    if constexpr (kPer % 4 == 0) {
#pragma unroll
      for (int f = 0; f < kPer; f += 4) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (wcol[k] < nw) v = *reinterpret_cast<const float4*>(sw + f);
        s[k][f] = v.x; s[k][f + 1] = v.y;
        s[k][f + 2] = v.z; s[k][f + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int f = 0; f < kPer; ++f) s[k][f] = wcol[k] < nw ? sw[f] : 0.f;
    }
  }
  // ring[j] holds the words of row base + j * kWarps: kDepth rows in
  // flight, the next one loaded as soon as a row is taken out
  uint32_t ring[kDepth][4];
#pragma unroll
  for (int j = 0; j < kDepth; ++j)
    load_words(words, first + j * kWarps, slab_end, own, nw, vec_load,
               ring[j]);
  for (int base = first; base < slab_end; base += kDepth * kWarps) {
#pragma unroll
    for (int j = 0; j < kDepth; ++j) {
      const int row = base + j * kWarps;
      if (row >= slab_end) break;                // warp-uniform
      uint32_t cur[4] = {ring[j][0], ring[j][1], ring[j][2], ring[j][3]};
      load_words(words, row + kDepth * kWarps, slab_end, own, nw, vec_load,
                 ring[j]);
      // 4x4 transpose within the quad: round r reads lane (qi + r) & 3,
      // which sends its word qi; t[r] is then the quad's word
      // 4 ((qi + r) & 3) + qi
      uint32_t t[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        t[r] = __shfl_sync(kFull, pick(cur, (qi - r) & 3),
                           (lane & ~3) | ((qi + r) & 3));
      OutT* orow = out + static_cast<int64_t>(row) * d_out;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (wcol[k] < nw)
          dequant_store<W, OutT, kVec>(pick(t, (k - qi) & 3), s[k], orow,
                                       wcol[k] * kPer, d_out);
    }
  }
}

template <int W, typename OutT>
cudaError_t launch_dequant(const void* words, const void* scale, void* out,
                           int m, int nw, int d_out, int rows_per_scale,
                           int rows_per_block, bool vec_store, bool vec_load,
                           dim3 grid, cudaStream_t s) {
  const auto* wp = static_cast<const int32_t*>(words);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  if (vec_store)
    unpack_dequant_kernel<W, OutT, true><<<grid, kWarps * 32, 0, s>>>(
        wp, sp, op, nw, d_out, rows_per_scale, rows_per_block, vec_load);
  else
    unpack_dequant_kernel<W, OutT, false><<<grid, kWarps * 32, 0, s>>>(
        wp, sp, op, nw, d_out, rows_per_scale, rows_per_block, vec_load);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dequant_w(bool f32, const void* words, const void* scale,
                             void* out, int m, int nw, int d_out,
                             int rows_per_scale, int rows_per_block,
                             bool vec_store, bool vec_load, dim3 grid,
                             cudaStream_t s) {
  if (f32)
    return launch_dequant<W, float>(words, scale, out, m, nw, d_out,
                                    rows_per_scale, rows_per_block,
                                    vec_store, vec_load, grid, s);
  return launch_dequant<W, __nv_bfloat16>(words, scale, out, m, nw, d_out,
                                          rows_per_scale, rows_per_block,
                                          vec_store, vec_load, grid, s);
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

// int32 words [m, nw] and float32 scale [m / rows_per_scale, nw * (32 / w)]
// -> out [m, d_out], bfloat16 (out_f32 = 0) or float32 (out_f32 = 1):
// out[r, c] = float(field c of row r) * scale[r / rows_per_scale, c].
// scale must start 16-byte aligned when 4 divides 32 / w.
// vec_load: 16-byte word loads (nw % 4 == 0, words 16-byte aligned);
// vec_store: stores in the widest unit of at most 16 bytes that divides a
// word's outputs (every row aligned to it).  Grid: ceil(nw / 128) spans
// x (m / rows_per_scale) * ceil(rows_per_scale / rows_per_block) slabs
// of 256 threads, each slab within one group.  Returns
// cudaGetLastError() of the launch (0 = success).
int unpack_dequant(const void* words, const void* scale, void* out, int m,
                   int nw, int d_out, int rows_per_scale, int w, int out_f32,
                   int vec_store, int vec_load, int rows_per_block,
                   void* stream) {
  if (w < 2 || w > 8 || m < 1 || nw < 1 || d_out < 1 ||
      d_out > nw * (32 / w) || rows_per_scale < 1 || m % rows_per_scale ||
      rows_per_block < 1)
    return cudaErrorInvalidValue;
  const int elem = out_f32 ? 4 : 2;
  const int unit = store_unit((32 / w) * elem, elem);
  if (vec_load && (nw % 4 || reinterpret_cast<uintptr_t>(words) % 16))
    return cudaErrorInvalidValue;
  // a word's scales load as 16-byte runs where they are whole ones
  if ((32 / w) % 4 == 0 && reinterpret_cast<uintptr_t>(scale) % 16)
    return cudaErrorInvalidValue;
  if (vec_store && ((static_cast<int64_t>(d_out) * elem) % unit ||
                    reinterpret_cast<uintptr_t>(out) % unit))
    return cudaErrorInvalidValue;
  // grid y: every group's rows in slabs of rows_per_block
  const int64_t slabs = static_cast<int64_t>(m / rows_per_scale) *
      ((rows_per_scale + rows_per_block - 1) / rows_per_block);
  if (slabs > 65535) return cudaErrorInvalidValue;
  const dim3 grid((nw + kSpanWords - 1) / kSpanWords,
                  static_cast<unsigned>(slabs));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool f32 = out_f32 != 0, vs = vec_store != 0, vl = vec_load != 0;
  switch (w) {
    case 2: return launch_dequant_w<2>(f32, words, scale, out, m, nw, d_out,
                                       rows_per_scale, rows_per_block, vs,
                                       vl, grid, s);
    case 3: return launch_dequant_w<3>(f32, words, scale, out, m, nw, d_out,
                                       rows_per_scale, rows_per_block, vs,
                                       vl, grid, s);
    case 4: return launch_dequant_w<4>(f32, words, scale, out, m, nw, d_out,
                                       rows_per_scale, rows_per_block, vs,
                                       vl, grid, s);
    case 5: return launch_dequant_w<5>(f32, words, scale, out, m, nw, d_out,
                                       rows_per_scale, rows_per_block, vs,
                                       vl, grid, s);
    case 6: return launch_dequant_w<6>(f32, words, scale, out, m, nw, d_out,
                                       rows_per_scale, rows_per_block, vs,
                                       vl, grid, s);
    case 7: return launch_dequant_w<7>(f32, words, scale, out, m, nw, d_out,
                                       rows_per_scale, rows_per_block, vs,
                                       vl, grid, s);
    default: return launch_dequant_w<8>(f32, words, scale, out, m, nw,
                                        d_out, rows_per_scale,
                                        rows_per_block, vs, vl, grid, s);
  }
}

}  // extern "C"
