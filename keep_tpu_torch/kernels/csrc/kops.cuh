// Device-side math shared by the int8 kernels (quant_rows.cu, int8_gemm.cu).
//
// Counterpart of keep_tpu/kernels/_kops.py: the JAX package keeps the
// quantize / GELU / LayerNorm math of every int8 Pallas kernel in one module
// so that the fused and unfused paths round identically (_kops.py:3-7,
// "import, don't copy"). The CUDA kernels include this header for the same
// reason, and keep_tpu_torch/kernels/_kops.py holds the same math in plain
// PyTorch.
//
// Every multiply and add that the JAX code writes as two operations is
// written with __fmul_rn / __fadd_rn here, so that nvcc cannot contract it
// into one fused multiply-add and round once where the reference rounds
// twice.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kops {

// tanh-approx GELU, 0.5·x·(1 + tanh(c·(x + 0.044715·x·x·x))), evaluated
// left to right as in _kops.gelu_tanh.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2/pi)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float t = tanhf(__fmul_rn(c, __fadd_rn(x, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, t));
}

// Per-row abs-max int8 scale: max(amax, 1e-8)·(1/127) (_kops.quant_rows).
__device__ __forceinline__ float quant_scale(float amax) {
  return __fmul_rn(fmaxf(amax, 1e-8f), 1.0f / 127.0f);
}

// One int8 code: clip(round(x·(1/scale)), ±127), rounding half to even
// (jnp.round), never half away from zero (roundf). `inv` is 1/scale,
// computed once per row by the caller with an IEEE division.
__device__ __forceinline__ int8_t quant_code(float x, float inv) {
  const float r = rintf(__fmul_rn(x, inv));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// Row LayerNorm of one value given the row's mean and 1/sqrt(var + eps):
// (x − mu)·rstd·g + b, left to right as in _kops.ln_rows.
__device__ __forceinline__ float ln_apply(float x, float mu, float rstd,
                                          float g, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), g), b);
}

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide sum / max for a block of kThreads (a multiple of 32, at most
// 1024). `scratch` holds 32 values of shared memory; every thread gets the
// result. The scratch is reusable right after the call returns.
template <int kThreads, typename T>
__device__ T block_sum(T x, T* scratch) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  T t = lane < kWarps ? scratch[lane] : T(0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();
  return t;
}

template <int kThreads>
__device__ float block_max(float x, float* scratch) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  x = warp_max(x);
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  float t = lane < kWarps ? scratch[lane] : 0.f;
  t = warp_max(t);
  __syncthreads();
  return t;
}

// Mean and 1/sqrt(var + eps) of the `n` values a block holds, `vals[j]`
// being element threadIdx.x + j·kThreads (absent elements ignored): the
// mean first, then the mean of (x − mean)², as _kops.ln_rows does. Both
// sums run in fp64 and are rounded once to fp32, so that the statistics do
// not depend on the order of summation: the plain version
// (keep_tpu_torch/kernels/_kops.py ln_rows_reference) gets the same fp32
// values, where two fp32 sums in different orders would move an int8 code
// now and then. 1/sqrt is an IEEE square root and an IEEE division.
template <int kThreads, int kPer>
__device__ void row_moments(const float (&vals)[kPer], int n, float eps,
                            double* scratch, float& mu, float& rstd) {
  double s = 0.0;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (threadIdx.x + j * kThreads < n) s += double(vals[j]);
  // a mean is the sum times 1/n, as torch's mean reduction computes it
  const double inv_n = 1.0 / double(n);
  mu = float(block_sum<kThreads>(s, scratch) * inv_n);
  double v = 0.0;
#pragma unroll
  for (int j = 0; j < kPer; ++j)
    if (threadIdx.x + j * kThreads < n) {
      const double d = double(__fsub_rn(vals[j], mu));
      v += d * d;
    }
  const float var = float(block_sum<kThreads>(v, scratch) * inv_n);
  rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

}  // namespace kops
