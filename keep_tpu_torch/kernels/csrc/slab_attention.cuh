// Shared pieces of the slab attention kernels: the forward's fp32 body
// and entry point (attention_qkv_slab.cu), the backward's entry point and
// fp32 bodies (attention_qkv_slab_bwd.cu), and, through
// wgmma_attention.cuh, the bf16 wgmma bodies of both.
//
// Two families live here:
//   - the fp32 CUDA-core bodies: the head width and tile constants, element
//     access for fp32 and bf16 slabs, the staging of a head's 64-wide column
//     slice into padded shared rows, warp reductions and the load of one
//     64-wide row into registers;
//   - pieces of the bf16 wgmma bodies: the bf16 row size, the packing of
//     two fp32 values into a bf16 pair, the quad reductions of a row's four
//     threads, the key-bias row and the ldmatrix load of the forward's
//     one-pass body's A fragments from a swizzled tile.
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

// Element strides of a q, k or v operand: row j of head h of batch row b
// starts at b * batch + h * head + j * row.
struct Strides {
  long long batch, head, row;
};

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

// ---- fp32 CUDA-core bodies ---------------------------------------------------

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

// ---- pieces of the bf16 wgmma bodies -----------------------------------------

constexpr int kRowBytes = kHeadDim * 2; // one bf16 row: 8 chunks of 16 bytes

using bf16 = __nv_bfloat16;

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][64] bf16 tile
// whose chunks are XOR-swizzled by the row's low three bits (TMA's
// 128-byte swizzle): the 8 rows an ldmatrix phase reads hit 8 distinct
// chunk columns, 32 distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two fp32 values rounded to bf16 and packed, the lower index in the low
// half (the order of a wgmma A fragment register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments (16 rows x 64 columns, four k16 steps) of the 16 rows
// starting at `r0` of a swizzled tile.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], uint32_t tile,
                                            int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], tile + swz(r0 + (lane & 15), 2 * kk + (lane >> 4)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The staged key-bias row of a block: bias[j] for keys j < S (0 without a
// bias), -inf for the zero-filled keys S..sp-1.
__device__ __forceinline__ void fill_bias(float* bias_s,
                                          const float* __restrict__ bias,
                                          int S, int sp) {
  for (int j = threadIdx.x; j < sp; j += blockDim.x)
    bias_s[j] = j < S ? (bias ? bias[j] : 0.f) : -INFINITY;
}

}  // namespace
