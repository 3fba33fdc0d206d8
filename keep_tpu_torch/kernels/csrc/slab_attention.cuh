// Shared pieces of the slab attention kernels: the forward's fp32 bodies
// and entry point (attention_qkv_slab.cu) and, through
// wgmma_attention.cuh, the wgmma bodies of the forward and the backward
// (bf16, and the backward's split-TF32 fp32 kernels through
// tf32_attention.cuh).
//
// Two families live here:
//   - the fp32 forward's CUDA-core pieces: the head width and block
//     constants, the operand strides and the warp reductions;
//   - pieces of the wgmma bodies: the bf16 row size, the store of two
//     fp32 values into a bf16 or fp32 row, the packing of two fp32 values
//     into a bf16 pair, the quad reductions of a row's four threads, the
//     key-bias row and the ldmatrix load of the forward's one-pass body's A
//     fragments from a swizzled tile.
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

// Element strides of a q, k or v operand: row j of head h of batch row b
// starts at b * batch + h * head + j * row.
struct Strides {
  long long batch, head, row;
};

// The store of two fp32 values as a row's adjacent elements of type T.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static void store(float* dst, float a, float b) {
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static void store(__nv_bfloat16* dst, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  }
};

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

// ---- pieces of the wgmma bodies -----------------------------------------

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
