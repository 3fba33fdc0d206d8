// Shared pieces of the slab attention kernels (attention_qkv_slab.cu, the
// forward, and attention_qkv_slab_bwd.cu, its backward).
//
// Two families live here:
//   - the fp32 CUDA-core bodies: the head width and tile constants, element
//     access for fp32 and bf16 slabs, the staging of a head's 64-wide column
//     slice into padded shared rows, warp reductions and the load of one
//     64-wide row into registers;
//   - the bf16 tensor-core bodies: cp.async staging into XOR-swizzled shared
//     tiles (rows past S zero-filled), ldmatrix fragment loads and
//     mma.sync.m16n8k16 bf16 with fp32 accumulators.
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

// ---- bf16 tensor-core bodies -------------------------------------------------

constexpr int kTcRows = 64;             // query (or key) rows per block
constexpr int kTcWarps = kTcRows / 16;  // one m16 row tile per warp
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcTile = 64;             // keys (or queries) per step
constexpr int kRowBytes = kHeadDim * 2; // one bf16 row: 8 chunks of 16 bytes

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][64] bf16 tile
// whose chunks are XOR-swizzled by the row's low three bits: the 8 rows an
// ldmatrix phase reads hit 8 distinct chunk columns, 32 distinct banks.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return uint32_t(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts the copy of rows [r0, r0 + n) of a 64-wide bf16 slice (row stride
// `stride` elements) into the swizzled tile at shared address `dst`; rows
// at or past `limit` are zero-filled (their source is not read).
__device__ __forceinline__ void stage_async(uint32_t dst, const bf16* src,
                                            long long stride, int r0, int n,
                                            int limit) {
  for (int idx = threadIdx.x; idx < n * 8; idx += kTcThreads) {
    const int r = idx >> 3;
    const int c = idx & 7;
    const bool ok = r0 + r < limit;
    cp_async16(dst + swz(r, c), ok ? src + (r0 + r) * stride + c * 8 : src,
               ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to bf16 and packed, the lower index in the low
// half (the order of an mma fragment register).
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

// acc[n] (n = 0..kN-1) = A · Bᵀ over the 64-wide rows, where B's rows are
// the 8·kN rows starting at `r0` of a swizzled tile: column n·8 + j of the
// product is row r0 + n·8 + j. For q·kᵀ, do·vᵀ, k·qᵀ and v·doᵀ.
template <int kN>
__device__ __forceinline__ void mma_abt(float (&acc)[kN][4],
                                        const uint32_t (&a)[4][4],
                                        uint32_t tile, int r0, int lane) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int p = 0; p < kN / 2; ++p) {
      uint32_t b[4];
      ldsm_x4(b, tile + swz(r0 + 16 * p + (lane & 7) + ((lane >> 4) << 3),
                            2 * kk + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * p], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc[n] (n = 0..7, 8 columns each of the 64-wide rows) += P · X, where P
// is 16 rows x 16·chunks held as mma A fragments (p[c] covers k rows
// 16c..16c+15 of X) and X's k rows are the rows starting at `r0` of a
// swizzled tile, read transposed. For p·v, ds·k, pᵀ·do and dsᵀ·q.
template <int kChunks>
__device__ __forceinline__ void mma_ax(float (&acc)[8][4],
                                       const uint32_t (&p)[kChunks][4],
                                       uint32_t tile, int r0, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      uint32_t b[4];
      ldsm_x4_t(b, tile + swz(r0 + 16 * c + (lane & 7) +
                                  (((lane >> 3) & 1) << 3),
                              2 * d + (lane >> 4)));
      mma_bf16(acc[2 * d], p[c], b[0], b[1]);
      mma_bf16(acc[2 * d + 1], p[c], b[2], b[3]);
    }
  }
}

// The A fragment of k rows 16c..16c+15 built from two accumulator tiles
// (columns 16c..16c+7 and 16c+8..16c+15 of a 16-row product), each value
// rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
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
  for (int j = threadIdx.x; j < sp; j += kTcThreads)
    bias_s[j] = j < S ? (bias ? bias[j] : 0.f) : -INFINITY;
}

// s = (q·kᵀ)·scale + bias for the 64 keys from `kb`, in the reference's
// order (a rounded product, then a rounded sum): element e of tile n is row
// gid + 8·(e >> 1) of the warp's 16 and key kb + 8n + 2·(lane & 3) + (e & 1).
__device__ __forceinline__ void scores(float (&s)[8][4],
                                       const uint32_t (&qa)[4][4],
                                       uint32_t k_s, int kb,
                                       const float* bias_s, float scale,
                                       int lane) {
  mma_abt<8>(s, qa, k_s, kb, lane);
  const float* bias = bias_s + kb + 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * n);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), (e & 1) ? bb.y : bb.x);
  }
}

// Raises the running max m of this thread's rows (gid, gid + 8) to cover
// one tile of scores, and returns in `alpha` exp(old m - new m), the factor
// that rescales sums taken against the old max (0 on the first tile).
__device__ __forceinline__ void raise_max(const float (&s)[8][4],
                                          float (&m)[2], float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // every tile holds a key < S, so the new max is finite
    mx[i] = quad_max(mx[i]);
    alpha[i] = expf(__fsub_rn(m[i], mx[i]));
    m[i] = mx[i];
  }
}

// Shared memory of a bf16 tensor-core body that keeps `tiles` 64-row tiles
// and the whole K and V slices (S rounded up to 64 rows each) plus an fp32
// key-bias row.
__host__ __device__ inline size_t tc_smem_bytes(int tiles, int S) {
  const int sp = (S + kTcTile - 1) / kTcTile * kTcTile;
  return size_t(tiles * kTcRows + 2 * sp) * kRowBytes + size_t(sp) * 4;
}

}  // namespace
