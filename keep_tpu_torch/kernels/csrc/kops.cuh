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

}  // namespace kops
