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
// once; there is nothing to reuse. One block of 256 threads owns one row and
// keeps it in registers (up to 16 values a thread, so K ≤ 4096): the LN
// statistics and the abs-max are block reductions over those registers, and
// the row is never re-read from device memory. Loads and stores are
// coalesced but scalar (2 or 4 bytes a thread); vector loads are left for
// later.

#include "kops.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;
constexpr int kMaxK = kThreads * kPer;  // 4096

template <typename T>
__global__ void __launch_bounds__(kThreads)
quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_g,
                  const float* __restrict__ ln_b, float eps,
                  const float* __restrict__ pre_scale, int8_t* __restrict__ q,
                  float* __restrict__ scale, int K) {
  __shared__ double moments[32];
  __shared__ float scratch[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * K;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < K ? kops::to_float(xr[i]) : 0.f;
  }
  if (ln_g != nullptr) {
    float mu, rstd;
    kops::row_moments<kThreads, kPer>(v, K, eps, moments, mu, rstd);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < K) v[j] = kops::ln_apply(v[j], mu, rstd, ln_g[i], ln_b[i]);
    }
  }
  if (pre_scale != nullptr) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = threadIdx.x + j * kThreads;
      if (i < K) v[j] = __fmul_rn(v[j], pre_scale[i]);
    }
  }
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (threadIdx.x + j * kThreads < K) amax = fmaxf(amax, fabsf(v[j]));
  amax = kops::block_max<kThreads>(amax, scratch);
  const float s = kops::quant_scale(amax);
  const float inv = __fdiv_rn(1.0f, s);
  int8_t* qr = q + row * K;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < K) qr[i] = kops::quant_code(v[j], inv);
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ ln_g,
               const float* __restrict__ ln_b, float eps,
               TOut* __restrict__ out, int D) {
  __shared__ double moments[32];
  const long long row = blockIdx.x;
  const float* xr = x + row * D;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < D ? xr[i] : 0.f;
  }
  float mu, rstd;
  kops::row_moments<kThreads, kPer>(v, D, eps, moments, mu, rstd);
  TOut* o = out + row * D;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < D)
      o[i] = kops::from_float<TOut>(
          kops::ln_apply(v[j], mu, rstd, ln_g[i], ln_b[i]));
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. All tensors are contiguous.
// dtype codes: 0 = float32, 1 = bfloat16. Each returns the cudaError_t of
// its launch.

// x [M, K] (x_dtype) → q int8 [M, K], scale fp32 [M]. ln_g/ln_b fp32 [K] or
// both null; pre_scale fp32 [K] or null.
extern "C" int keep_quant_rows(const void* x, int x_dtype, const void* ln_g,
                               const void* ln_b, float eps,
                               const void* pre_scale, void* q, void* scale,
                               int M, int K, void* stream) {
  if (M < 1 || K < 1 || K > kMaxK || (ln_g == nullptr) != (ln_b == nullptr))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  const float* ps = static_cast<const float*>(pre_scale);
  int8_t* qo = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(scale);
  switch (x_dtype) {
    case 0:
      quant_rows_kernel<float><<<M, kThreads, 0, st>>>(
          static_cast<const float*>(x), g, b, eps, ps, qo, so, K);
      break;
    case 1:
      quant_rows_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), g, b, eps, ps, qo, so, K);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

// x fp32 [M, D] → LN → out [M, D] (out_dtype).
extern "C" int keep_ln_rows(const void* x, const void* ln_g, const void* ln_b,
                            float eps, void* out, int out_dtype, int M, int D,
                            void* stream) {
  if (M < 1 || D < 1 || D > kMaxK) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  const float* g = static_cast<const float*>(ln_g);
  const float* b = static_cast<const float*>(ln_b);
  switch (out_dtype) {
    case 0:
      ln_rows_kernel<float><<<M, kThreads, 0, st>>>(
          xi, g, b, eps, static_cast<float*>(out), D);
      break;
    case 1:
      ln_rows_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
          xi, g, b, eps, static_cast<__nv_bfloat16*>(out), D);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
