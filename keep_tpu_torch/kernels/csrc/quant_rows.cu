// Per-row int8 quantization (with an optional LayerNorm and per-channel
// pre-scale in front) and the fp32 row LayerNorm, for Hopper (sm_90a).
//
// Replaces the row-wise stages of the TPU int8 megakernels, which run them
// on VMEM-resident blocks between their MXU dots:
//   - keep_tpu/kernels/_kops.py `quant_rows` and `ln_rows`, as called by
//     qmatmul.py `_qmm_kernel` / `_qmm_bsd_kernel` (pallas_call :80, :151),
//     qmlp.py `_make_qmlp_bsd_kernel` (:227) and qblock.py
//     `_make_qattn_kernel` / `_make_qattn_postln_kernel` (:79, :182).
//
// quant_rows, per row r of x[M, K] (bf16 or fp32, read as fp32):
//   y = LN(x_r; g, b, eps)            if g is given
//   y = y · pre_scale                 if pre_scale is given (SmoothQuant 1/s)
//   scale_r = max(max|y|, 1e-8)·(1/127)
//   q_r = clip(rint(y·(1/scale_r)), ±127)  as int8 (round half to even)
// ln_rows, per row of x[M, D] fp32: LN(x_r) cast once to the output dtype
// (bf16 or fp32): the post-LN exit of the BERT sub-blocks.
//
// What bounds them on this card: bytes. Each reads a row once and writes it
// once; there is nothing to reuse. A row is held in registers by a group of
// threads sized to it (one warp up to K = 1024, two up to 2048, four up to
// 4096), each thread taking chunks of 16 consecutive values with 16-byte
// loads and writing its codes (or outputs) with 16-byte stores; a block of
// 256 threads holds 8, 4 or 2 rows, so that the 25,216 rows of a
// bucket-128 ViT-L dispatch fill every SM. The LN statistics and the
// abs-max are reductions over the group (warp shuffles, then shared memory
// across its warps); the row is never re-read from device memory. K must be
// a multiple of 16 and the row data 16-byte aligned.

#include "kops.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kChunk = 16;             // consecutive values a thread loads
constexpr int kChunks = 2;             // chunks a thread holds at most
constexpr int kMaxK = 128 * kChunks * kChunk;  // 4096

__device__ __forceinline__ void load16(const float* p, float (&v)[kChunk]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = f.x;
    v[4 * i + 1] = f.y;
    v[4 * i + 2] = f.z;
    v[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[kChunk]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[8 * i + 2 * j] = f.x;
      v[8 * i + 2 * j + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[kChunk]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p,
                                        const float (&v)[kChunk]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
    reinterpret_cast<uint4*>(p)[i] = u;
  }
}

// Sum or max over the kRowThreads threads that hold one row; every one of
// them gets the result. `scratch` is this row's kRowThreads/32 slots of
// shared memory; the partial results of the warps are combined in warp
// order by every thread, so all of them get the same bits. Every thread of
// the block calls it (it may hold __syncthreads).
template <int kRowThreads, typename T, typename Op>
__device__ __forceinline__ T group_reduce(T x, T* scratch, Op op) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = op(x, __shfl_xor_sync(0xffffffffu, x, o));
  if constexpr (kRowThreads > 32) {
    constexpr int kWarps = kRowThreads / 32;
    const int w = (threadIdx.x % kRowThreads) / 32;
    if (threadIdx.x % 32 == 0) scratch[w] = x;
    __syncthreads();
    x = scratch[0];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) x = op(x, scratch[i]);
    __syncthreads();
  }
  return x;
}

struct Add {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// The row's values a thread holds: chunk c is elements
// (j + c·kRowThreads)·16 … +15 of the row, j the thread's place in its
// group; `n` of them lie inside the row.
template <int kRowThreads>
struct RowSlice {
  float v[kChunks][kChunk];
  bool in[kChunks];

  __device__ __forceinline__ static int start(int c) {
    return ((threadIdx.x % kRowThreads) + c * kRowThreads) * kChunk;
  }

  template <typename T>
  __device__ __forceinline__ void load(const T* row, int K, bool live) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      in[c] = live && start(c) < K;
      if (in[c]) {
        load16(row + start(c), v[c]);
      } else {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) v[c][i] = 0.f;
      }
    }
  }

  // LayerNorm in place with the mean and 1/sqrt(var + eps) of the row: the
  // mean first, then the mean of (x − mean)², as _kops.ln_rows does. Both
  // sums run in fp64 and are rounded once to fp32 (a mean is the sum times
  // 1/n, as torch's mean reduction computes it), so that the statistics do
  // not depend on the order of summation: the plain version gets the same
  // fp32 values, where two fp32 sums in different orders would move an int8
  // code now and then. 1/sqrt is an IEEE square root and division.
  __device__ __forceinline__ void layer_norm(const float* g, const float* b,
                                             float eps, int K,
                                             double* scratch) {
    // four partial sums a thread, so that the fp64 adds do not wait on
    // each other
    double s[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (in[c])
#pragma unroll
        for (int i = 0; i < kChunk; ++i) s[i % 4] += double(v[c][i]);
    const double inv_n = 1.0 / double(K);
    const float mu = float(group_reduce<kRowThreads>(
        (s[0] + s[1]) + (s[2] + s[3]), scratch, Add()) * inv_n);
    double q[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (in[c])
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          const double d = double(__fsub_rn(v[c][i], mu));
          q[i % 4] += d * d;
        }
    const float var = float(group_reduce<kRowThreads>(
        (q[0] + q[1]) + (q[2] + q[3]), scratch, Add()) * inv_n);
    const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (in[c]) {
        float gg[kChunk], bb[kChunk];
        load16(g + start(c), gg);
        load16(b + start(c), bb);
#pragma unroll
        for (int i = 0; i < kChunk; ++i)
          v[c][i] = kops::ln_apply(v[c][i], mu, rstd, gg[i], bb[i]);
      }
  }
};

template <int kRowThreads, typename T>
__global__ void __launch_bounds__(kBlock)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, float eps,
                  const float* __restrict__ pre_scale, int8_t* __restrict__ q,
                  float* __restrict__ scale, int M, int K) {
  constexpr int kRows = kBlock / kRowThreads;
  constexpr int kWarps = kRowThreads / 32;
  __shared__ double dscratch[kRows][kWarps];
  __shared__ float fscratch[kRows][kWarps];
  const int rib = threadIdx.x / kRowThreads;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + rib;
  const bool live = row < M;
  RowSlice<kRowThreads> s;
  s.load(x + row * K, K, live);
  if (ln_g != nullptr) s.layer_norm(ln_g, ln_b, eps, K, dscratch[rib]);
  if (pre_scale != nullptr) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      if (s.in[c]) {
        float p[kChunk];
        load16(pre_scale + s.start(c), p);
#pragma unroll
        for (int i = 0; i < kChunk; ++i) s.v[c][i] = __fmul_rn(s.v[c][i], p[i]);
      }
  }
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < kChunk; ++i) amax = fmaxf(amax, fabsf(s.v[c][i]));
  amax = group_reduce<kRowThreads>(amax, fscratch[rib], Max());
  if (!live) return;
  const float sc = kops::quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, sc);
  int8_t* qr = q + row * K;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (s.in[c]) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[i] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          w[i] |= static_cast<uint32_t>(static_cast<uint8_t>(
                      kops::quant_code(s.v[c][4 * i + j], inv)))
                  << (8 * j);
      }
      *reinterpret_cast<uint4*>(qr + s.start(c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  if (threadIdx.x % kRowThreads == 0) scale[row] = sc;
}

template <int kRowThreads, typename TOut>
__global__ void __launch_bounds__(kBlock)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, float eps,
               TOut* __restrict__ out, int M, int D) {
  constexpr int kRows = kBlock / kRowThreads;
  constexpr int kWarps = kRowThreads / 32;
  __shared__ double dscratch[kRows][kWarps];
  const int rib = threadIdx.x / kRowThreads;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + rib;
  const bool live = row < M;
  RowSlice<kRowThreads> s;
  s.load(x + row * D, D, live);
  s.layer_norm(ln_g, ln_b, eps, D, dscratch[rib]);
  if (!live) return;
  TOut* o = out + row * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (s.in[c]) store16(o + s.start(c), s.v[c]);
}

// The threads that hold one row of K values: as few as keep a thread's
// share within kChunks chunks.
template <template <int, typename> class Launch, typename T, typename... A>
cudaError_t by_row_width(int M, int K, cudaStream_t st, A... args) {
  if (K <= 32 * kChunks * kChunk) return Launch<32, T>::run(M, st, args...);
  if (K <= 64 * kChunks * kChunk) return Launch<64, T>::run(M, st, args...);
  return Launch<128, T>::run(M, st, args...);
}

template <int kRowThreads, typename T>
struct QuantLaunch {
  template <typename... A>
  static cudaError_t run(int M, cudaStream_t st, A... args) {
    constexpr int kRows = kBlock / kRowThreads;
    quant_rows_kernel<kRowThreads, T>
        <<<(M + kRows - 1) / kRows, kBlock, 0, st>>>(args...);
    return cudaGetLastError();
  }
};

template <int kRowThreads, typename T>
struct LnLaunch {
  template <typename... A>
  static cudaError_t run(int M, cudaStream_t st, A... args) {
    constexpr int kRows = kBlock / kRowThreads;
    ln_rows_kernel<kRowThreads, T>
        <<<(M + kRows - 1) / kRows, kBlock, 0, st>>>(args...);
    return cudaGetLastError();
  }
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. All tensors are contiguous and
// 16-byte aligned, and K (D) is a multiple of 16. dtype codes: 0 = float32,
// 1 = bfloat16. Each returns the cudaError_t of its launch
// (cudaErrorInvalidValue for arguments it does not take).

// x [M, K] (x_dtype) → q int8 [M, K], scale fp32 [M]. ln_g/ln_b fp32 [K] or
// both null; pre_scale fp32 [K] or null.
extern "C" int keep_quant_rows(const void* x, int x_dtype, const void* ln_g,
                               const void* ln_b, float eps,
                               const void* pre_scale, void* q, void* scale,
                               int M, int K, void* stream) {
  if (M < 1 || K < 1 || K > kMaxK || K % kChunk
      || (ln_g == nullptr) != (ln_b == nullptr) || !aligned16(x)
      || !aligned16(q) || (ln_g != nullptr && (!aligned16(ln_g)
                                               || !aligned16(ln_b)))
      || (pre_scale != nullptr && !aligned16(pre_scale)))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* ps = static_cast<const float*>(pre_scale);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  switch (x_dtype) {
    case 0:
      return int(by_row_width<QuantLaunch, float>(
          M, K, st, static_cast<const float*>(x), g, b, eps, ps, qo, so, M,
          K));
    case 1:
      return int(by_row_width<QuantLaunch, __nv_bfloat16>(
          M, K, st, static_cast<const __nv_bfloat16*>(x), g, b, eps, ps, qo,
          so, M, K));
    default:
      return int(cudaErrorInvalidValue);
  }
}

// x fp32 [M, D] → LN → out [M, D] (out_dtype).
extern "C" int keep_ln_rows(const void* x, const void* ln_g, const void* ln_b,
                            float eps, void* out, int out_dtype, int M, int D,
                            void* stream) {
  if (M < 1 || D < 1 || D > kMaxK || D % kChunk || !aligned16(x)
      || !aligned16(ln_g) || !aligned16(ln_b) || !aligned16(out))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  switch (out_dtype) {
    case 0:
      return int(by_row_width<LnLaunch, float>(
          M, D, st, xi, g, b, eps, static_cast<float*>(out), M, D));
    case 1:
      return int(by_row_width<LnLaunch, __nv_bfloat16>(
          M, D, st, xi, g, b, eps, static_cast<__nv_bfloat16*>(out), M, D));
    default:
      return int(cudaErrorInvalidValue);
  }
}
