// Shared pieces of the slab attention kernels (attention_qkv_slab.cu, the
// forward, and attention_qkv_slab_bwd.cu, its backward): the head width and
// tile constants, element access for fp32 and bf16 slabs, the staging of a
// head's 64-wide column slice into padded shared rows, warp reductions and
// the load of one 64-wide row into registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = 32;
constexpr int kMaxSeq = 512;
constexpr int kKeysPerLane = kMaxSeq / 32;

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  // one element per 32-bit word; 64 + 1 pad words per row
  static constexpr int kRowWords = kHeadDim + 1;
  __device__ static void pair(const uint32_t* row, int i, float& a, float& b) {
    a = __uint_as_float(row[2 * i]);
    b = __uint_as_float(row[2 * i + 1]);
  }
  __device__ static float round(float x) { return x; }
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
  __device__ static void store(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  // two elements per 32-bit word (low half first); 32 + 1 pad words per row
  static constexpr int kRowWords = kHeadDim / 2 + 1;
  __device__ static void pair(const uint32_t* row, int i, float& a, float& b) {
    const uint32_t w = row[i];
    a = __uint_as_float(w << 16);
    b = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  __device__ static void store(__nv_bfloat16* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
};

// Copies the 64-wide slice of S rows (row stride `stride` elements) into
// padded shared rows, with 16-byte global loads.
template <typename T>
__device__ void stage_rows(uint32_t* dst, const T* src, int S,
                           long long stride) {
  constexpr int kChunks = kHeadDim * int(sizeof(T)) / 16;
  constexpr int kElemsPerChunk = 16 / int(sizeof(T));
  constexpr int W = Elem<T>::kRowWords;
  for (int idx = threadIdx.x; idx < S * kChunks; idx += kThreads) {
    const int j = idx / kChunks;
    const int c = idx - j * kChunks;
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(
        src + j * stride + c * kElemsPerChunk));
    uint32_t* d = dst + j * W + c * 4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// Loads one 64-wide row into fp32 registers. Every lane of a warp reads the
// whole row: one broadcast transaction per 16-byte load.
template <typename T>
__device__ void load_row(const T* src, float (&x)[kHeadDim]) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < kHeadDim * int(sizeof(T)) / 16; ++c) {
    const uint4 v = __ldg(s + c);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    // a 16-byte chunk holds 8 / sizeof(T) element pairs
#pragma unroll
    for (int k = 0; k < 8 / int(sizeof(T)); ++k) {
      float a, b;
      Elem<T>::pair(w, k, a, b);
      const int base = c * (16 / int(sizeof(T))) + 2 * k;
      x[base] = a;
      x[base + 1] = b;
    }
  }
}

__device__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace
