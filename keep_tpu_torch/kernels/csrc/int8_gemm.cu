// int8 × int8 → int32 GEMM with the fused dequant epilogue of the TPU int8
// kernels, for Hopper (sm_90a).
//
// Replaces the MXU dot and epilogue of:
//   - keep_tpu/kernels/qmatmul.py `_qmm_kernel` / `_qmm_bsd_kernel`
//     (pallas_call :80 and :151): out = acc·a·s + bias (+ tanh-GELU);
//   - keep_tpu/kernels/qmlp.py `_make_qmlp_bsd_kernel` (pallas_call :227):
//     h = acc·(a·s) + bias → GELU, then out = acc·(a·s) + bias (+ x);
//   - keep_tpu/kernels/qblock.py `_make_qattn_kernel` /
//     `_make_qattn_postln_kernel` (pallas_call :79 and :182): the qkv slab
//     acc·(a·s) + bias, and the projection acc·(a·s) + bias + x.
// `_kops.int8_dot` is the dot; the epilogue math is kops.cuh's.
//
// What it computes, for A int8 [M, K] row-major (the per-row quantized
// activations, scales a fp32 [M]) and B int8 [N, K] row-major (the torch
// layout of the weight, per-column scales s fp32 [N]):
//   acc[m, n] = Σ_k A[m, k]·B[n, k]                  exactly, in int32
//   v = (acc·a[m])·s[n]       (order 0, qmatmul)   or
//   v = acc·(a[m]·s[n])       (order 1, qblock / qmlp)
//   v = v + bias[n];  v = gelu_tanh(v) if asked;  v = res[m, n] + v if given
//   out[m, n] = v in the output dtype (bf16 or fp32); res is bf16 or fp32.
// The two dequant orders are kept apart because fp32 multiplication is not
// associative and each TPU kernel has its own.
//
// What bounds it on this card: at the KEEP shapes (M = B·197 or B·256 rows,
// K and N of 768 to 4096) the int8 tensor-core rate; operands are reused
// from shared memory 128 times per load. Design (simple first): one block of
// 8 warps per 128 × 128 output tile; K walks in steps of 64 bytes through a
// two-stage cp.async ring of A and B tiles in shared memory (rows padded by
// 16 bytes so the fragment loads of a warp hit 32 distinct banks); each warp
// owns a 64 × 32 sub-tile and issues
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 on fragments it loads
// with 32-bit shared-memory reads. Rows past M and K columns past K are
// zero-filled by cp.async, so M is arbitrary and K need only be a multiple
// of 16; N must be a multiple of 8.
//
// What it leaves on the table: wgmma and TMA (the H100's full int8 rate),
// ldmatrix, a deeper pipeline, and a persistent schedule; the epilogue
// stores two elements at a time straight from the mma fragments.

#include "kops.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;            // bytes of K per stage
constexpr int kRow = BK + 16;     // padded shared-memory row, bytes
constexpr int kThreads = 256;     // 8 warps: 2 along M × 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMi = kWarpM / 16;  // m16 tiles per warp
constexpr int kNi = kWarpN / 8;   // n8 tiles per warp
constexpr int kStageBytes = (BM + BN) * kRow;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [row0, row0 + 128) × bytes [k0, k0 + 64) of a [rows, K] int8
// matrix into a padded shared tile, 16 bytes per cp.async.
__device__ __forceinline__ void load_tile(uint8_t* dst, const int8_t* src,
                                          int rows, int K, int row0, int k0) {
#pragma unroll
  for (int it = 0; it < (128 * BK / 16) / kThreads; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (BK / 16);
    const int c = (idx % (BK / 16)) * 16;
    const int gr = row0 + r;
    const int gk = k0 + c;
    const bool ok = gr < rows && gk < K;
    const int8_t* g = ok ? src + (long long)gr * K + gk : src;
    cp_async16(dst + r * kRow + c, g, ok);
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename TOut, typename TRes>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ A, const float* __restrict__ a_scale,
                 const int8_t* __restrict__ B, const float* __restrict__ b_scale,
                 const float* __restrict__ bias, const TRes* __restrict__ res,
                 TOut* __restrict__ out, int M, int N, int K, int order,
                 int gelu) {
  __shared__ __align__(16) uint8_t smem[2 * kStageBytes];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / (BN / kWarpN)) * kWarpM;  // warp's row offset
  const int wn = (warp % (BN / kWarpN)) * kWarpN;  // warp's column offset
  const int g = lane / 4;                          // mma groupID
  const int t = lane % 4;                          // mma threadID_in_group

  int acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_count = (K + BK - 1) / BK;
  load_tile(smem, A, M, K, m0, 0);
  load_tile(smem + BM * kRow, B, N, K, n0, 0);
  cp_async_commit();

  for (int kt = 0; kt < kt_count; ++kt) {
    uint8_t* stage = smem + (kt & 1) * kStageBytes;
    if (kt + 1 < kt_count) {
      uint8_t* next = smem + ((kt + 1) & 1) * kStageBytes;
      load_tile(next, A, M, K, m0, (kt + 1) * BK);
      load_tile(next + BM * kRow, B, N, K, n0, (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* As = stage;
    const uint8_t* Bs = stage + BM * kRow;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t af[kMi][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const uint8_t* p = As + (wm + i * 16 + g) * kRow + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const uint8_t* p = Bs + (wn + j * 8 + g) * kRow + ks + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int i = 0; i < kMi; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();  // the stage is overwritten by the load two steps on
  }

  // Epilogue: fragment element e of tile (i, j) is row g (+8 for e ≥ 2),
  // column 2t + (e & 1).
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float am = a_scale[m];
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
        if (n >= N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float accf = __int2float_rn(acc[i][j][half * 2 + e]);
          const float sn = b_scale[n + e];
          float x = order == 0 ? __fmul_rn(__fmul_rn(accf, am), sn)
                               : __fmul_rn(accf, __fmul_rn(am, sn));
          x = __fadd_rn(x, bias[n + e]);
          if (gelu) x = kops::gelu_tanh(x);
          if (res != nullptr)
            x = __fadd_rn(kops::to_float(res[(long long)m * N + n + e]), x);
          v[e] = x;
        }
        store_pair<TOut>(out + (long long)m * N + n, v[0], v[1]);
      }
    }
  }
}

template <typename TOut, typename TRes>
cudaError_t launch(const void* A, const void* a_scale, const void* B,
                   const void* b_scale, const void* bias, const void* res,
                   void* out, int M, int N, int K, int order, int gelu,
                   cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<TOut, TRes><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(A), static_cast<const float*>(a_scale),
      static_cast<const int8_t*>(B), static_cast<const float*>(b_scale),
      static_cast<const float*>(bias), static_cast<const TRes*>(res),
      static_cast<TOut*>(out), M, N, K, order, gelu);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_out(int res_dtype, const void* A, const void* a_scale,
                       const void* B, const void* b_scale, const void* bias,
                       const void* res, void* out, int M, int N, int K,
                       int order, int gelu, cudaStream_t stream) {
  if (res_dtype == 1)
    return launch<TOut, __nv_bfloat16>(A, a_scale, B, b_scale, bias, res, out,
                                       M, N, K, order, gelu, stream);
  return launch<TOut, float>(A, a_scale, B, b_scale, bias, res, out, M, N, K,
                             order, gelu, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. A int8 [M, K], a_scale fp32 [M],
// B int8 [N, K], b_scale fp32 [N], bias fp32 [N], res [M, N] (res_dtype) or
// null, out [M, N] (out_dtype); all contiguous, A and B 16-byte aligned.
// dtype codes: 0 = float32, 1 = bfloat16. order: 0 = (acc·a)·s, 1 = acc·(a·s).
// Returns the cudaError_t of the launch.
extern "C" int keep_int8_gemm(const void* A, const void* a_scale,
                              const void* B, const void* b_scale,
                              const void* bias, const void* res, int res_dtype,
                              void* out, int out_dtype, int M, int N, int K,
                              int order, int gelu, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 16 || (order != 0 && order != 1)
      || (res_dtype != 0 && res_dtype != 1) || (M + BM - 1) / BM > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return int(launch_out<float>(res_dtype, A, a_scale, B, b_scale, bias,
                                   res, out, M, N, K, order, gelu, st));
    case 1:
      return int(launch_out<__nv_bfloat16>(res_dtype, A, a_scale, B, b_scale,
                                           bias, res, out, M, N, K, order,
                                           gelu, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
