// int8 × int8 → int32 GEMM with the fused dequant epilogue of the TPU int8
// kernels, for Hopper (sm_90a): wgmma fed by TMA.
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
// associative and each TPU kernel has its own. The int32 sums are exact in
// any order, so the result equals the plain version's bit for bit.
//
// What bounds it on this card: at the KEEP shapes (M = B·197 or B·256 rows,
// K and N of 768 to 4096) the int8 tensor-core rate, except where the fp32
// output (the MLP hidden, [M, 4096]) makes the bytes as long. Design:
//   - one persistent block per SM walks the 128 × 128 output tiles in row
//     order, so the blocks running together share a few A panels and all
//     of B (at most 4 MB) in the L2;
//   - one producer thread keeps a ring of 4 stages full: each stage is a
//     128-byte K slab of A's 128 rows and B's 128 rows, brought in by TMA
//     (cp.async.bulk.tensor) with the 128-byte swizzle, completion counted
//     on an mbarrier; rows past M or N and bytes past K arrive as zeros;
//   - two consumer warpgroups take the block's tiles in turn (ping-pong):
//     each runs wgmma.mma_async m64n128k32 s8 on its tile's two 64-row
//     halves of A against the B slab, K-major on both sides (the layout
//     the activations and the torch-layout weight already have), keeps one
//     group of products in flight and hands the slab before it back on a
//     second mbarrier;
//   - the epilogue stages a warpgroup's int32 tile, half by half, through
//     shared memory and writes 8 outputs a thread with 16-byte stores
//     (residual read the same way), while the other warpgroup's products
//     run on the tensor cores.
// So M is arbitrary, K need only be a multiple of 16 (TMA's stride rule)
// and N a multiple of 8 (the 16-byte stores).

#include "hopper.cuh"
#include "kops.cuh"

namespace {

constexpr int BM = 128;                 // a tile: two 64-row wgmma halves
constexpr int BN = 128;                 // wgmma m64n128k32
constexpr int BK = 128;                 // bytes of K a stage: one swizzle row
constexpr int kStages = 4;
constexpr int kConsumers = 2;           // warpgroups that run wgmma
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStageBytes = (BM + BN) * BK;
constexpr int kPitch = BN + 8;          // int32 words of a staged output row
constexpr int kEpiWords = 64 * kPitch;  // one warpgroup's staged tile
constexpr int kSmemBytes = 1024 + kStages * kStageBytes
                           + kConsumers * kEpiWords * 4
                           + (2 * kStages + kConsumers) * 8;

// Hands a stage back to the producer: one arrival from each warp, after
// the warp's own wait for the products that read it.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma.
__device__ __forceinline__ void acc_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 rows × 128 cols of this warpgroup] (+)= A[64 × 32] · B[128 × 32]ᵀ,
// both from shared memory. Element i of d is row 16·warp + lane/4 +
// 8·((i/2) % 2), column 8·(i/4) + 2·(lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// 8 consecutive values of a residual row as fp32, with 16-byte loads.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 consecutive outputs with 16-byte stores.
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p,
                                       const float (&v)[8]) {
  uint4 o;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = o;
}

template <typename TOut, typename TRes>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const float* __restrict__ a_scale,
                 const float* __restrict__ b_scale,
                 const float* __restrict__ bias, const TRes* __restrict__ res,
                 TOut* __restrict__ out, int M, int N, int K, int order,
                 int gelu) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start 1024-byte aligned
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem;
  int* staged = reinterpret_cast<int*>(smem + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kConsumers * kEpiWords);
  uint64_t* empty = full + kStages;
  uint64_t* turn = empty + kStages;  // a consumer's turn on the ring

  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int kt_count = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival
      mbar_init(&empty[s], 4);  // each warp of the warpgroup that read it
    }
    for (int w = 0; w < kConsumers; ++w) mbar_init(&turn[w], 4);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring full ------------------------
    // (its warpgroup gives registers to the consumers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < kt_count; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);   // the first round passes
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(st, &map_a, &full[stage], kt * BK, m0);
          tma_load_2d(st + BM * BK, &map_b, &full[stage], kt * BK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: each warpgroup takes every other tile of the block, so
  // that one's epilogue runs while the other's products do ---------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  const int t = threadIdx.x % 128;
  int* tile_out = staged + wg * kEpiWords;
  int acc[2][64];  // the tile's two 64-row halves
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0;
  for (int local = wg, i = 0;; local += kConsumers, ++i) {
    const long long tile =
        blockIdx.x + static_cast<long long>(local) * gridDim.x;
    if (tile >= tiles) break;
    // the two warpgroups take turns on the ring, tile by tile, so that a
    // wait on a stage's barrier never runs a lap ahead of the producer:
    // warpgroup 1's i-th turn follows warpgroup 0's i-th, and warpgroup
    // 0's i-th follows warpgroup 1's (i − 1)-th
    if (wg == 1) mbar_wait(&turn[1], i & 1);
    else if (i > 0) mbar_wait(&turn[0], (i - 1) & 1);
    const int m0 = static_cast<int>(tile / n_tiles) * BM;
    const int n0 = static_cast<int>(tile % n_tiles) * BN;
    // the ring position of this tile's first slab: the producer loads the
    // block's tiles in order, kt_count slabs each
    long long pos = static_cast<long long>(local) * kt_count;
    for (int kt = 0; kt < kt_count; ++kt, ++pos) {
      const int stage = static_cast<int>(pos % kStages);
      mbar_wait(&full[stage], static_cast<uint32_t>(pos / kStages) & 1);
      const uint8_t* st = ring + stage * kStageBytes;
      const uint64_t da0 = smem_desc(st);
      const uint64_t da1 = smem_desc(st + 64 * BK);
      const uint64_t db = smem_desc(st + BM * BK);
      acc_fence(acc[0]);
      acc_fence(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        wgmma_s8(acc[0], da0 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
        wgmma_s8(acc[1], da1 + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      }
      wgmma_commit();
      acc_fence(acc[0]);
      acc_fence(acc[1]);
      // the previous slab's products are done: its stage goes back
      wgmma_wait<1>();
      if (kt > 0) release(&empty[(pos - 1) % kStages], lane);
    }
    release(&turn[1 - wg], lane);  // done waiting on the ring
    wgmma_wait<0>();
    acc_fence(acc[0]);
    acc_fence(acc[1]);
    release(&empty[(pos - 1) % kStages], lane);

    const int col = 8 * (t % 16);
    const int n = n0 + col;
    float sn[8], bn[8];
    if (n < N) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sn[e] = b_scale[n + e];
        bn[e] = bias[n + e];
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // the half's accumulators into shared memory, row-major with a padded
      // pitch (the 8-byte stores of a half-warp then hit 32 distinct banks)
      bar_sync(1 + wg);  // every thread is done reading the previous half
      {
        const int r = warp * 16 + lane / 4;
        const int c = 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          *reinterpret_cast<int2*>(&tile_out[r * kPitch + 8 * j + c]) =
              make_int2(acc[half][4 * j], acc[half][4 * j + 1]);
          *reinterpret_cast<int2*>(&tile_out[(r + 8) * kPitch + 8 * j + c]) =
              make_int2(acc[half][4 * j + 2], acc[half][4 * j + 3]);
        }
      }
      bar_sync(1 + wg);
      if (n >= N) continue;
      // 8 columns a thread, 8 rows a pass: kops.cuh's math in the plain
      // version's order, then 16-byte stores
#pragma unroll 2
      for (int p = 0; p < 8; ++p) {
        const int r = t / 16 + 8 * p;
        const int m = m0 + half * 64 + r;
        if (m >= M) break;
        const int4 lo = *reinterpret_cast<const int4*>(&tile_out[r * kPitch + col]);
        const int4 hi =
            *reinterpret_cast<const int4*>(&tile_out[r * kPitch + col + 4]);
        const int a8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const float am = a_scale[m];
        const long long off = static_cast<long long>(m) * N + n;
        float rv[8];
        if (res != nullptr) load8(res + off, rv);
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float accf = __int2float_rn(a8[e]);
          float x = order == 0 ? __fmul_rn(__fmul_rn(accf, am), sn[e])
                               : __fmul_rn(accf, __fmul_rn(am, sn[e]));
          x = __fadd_rn(x, bn[e]);
          if (gelu) x = kops::gelu_tanh(x);
          if (res != nullptr) x = __fadd_rn(rv[e], x);
          v[e] = x;
        }
        store8(out + off, v);
      }
    }
  }
}

// The TMA map of an int8 [rows, K] row-major matrix in boxes of 128 rows ×
// 128 bytes with the 128-byte swizzle; reads past the edges give zeros.
bool int8_map(CUtensorMap* map, const void* ptr, int rows, int K) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TOut, typename TRes>
cudaError_t launch(const CUtensorMap& map_a, const CUtensorMap& map_b,
                   const void* a_scale, const void* b_scale, const void* bias,
                   const void* res, void* out, int M, int N, int K, int order,
                   int gelu, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_gemm_kernel<TOut, TRes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  int8_gemm_kernel<TOut, TRes><<<grid, kThreads, kSmemBytes, stream>>>(
      map_a, map_b, static_cast<const float*>(a_scale),
      static_cast<const float*>(b_scale), static_cast<const float*>(bias),
      static_cast<const TRes*>(res), static_cast<TOut*>(out), M, N, K, order,
      gelu);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_out(int res_dtype, const CUtensorMap& map_a,
                       const CUtensorMap& map_b, const void* a_scale,
                       const void* b_scale, const void* bias, const void* res,
                       void* out, int M, int N, int K, int order, int gelu,
                       cudaStream_t stream) {
  if (res_dtype == 1)
    return launch<TOut, __nv_bfloat16>(map_a, map_b, a_scale, b_scale, bias,
                                       res, out, M, N, K, order, gelu, stream);
  return launch<TOut, float>(map_a, map_b, a_scale, b_scale, bias, res, out,
                             M, N, K, order, gelu, stream);
}

}  // namespace

// Plain C entry point, loaded with ctypes. A int8 [M, K], a_scale fp32 [M],
// B int8 [N, K], b_scale fp32 [N], bias fp32 [N], res [M, N] (res_dtype) or
// null, out [M, N] (out_dtype); all contiguous; A, B, res and out 16-byte
// aligned; K a multiple of 16, N of 8. dtype codes: 0 = float32,
// 1 = bfloat16. order: 0 = (acc·a)·s, 1 = acc·(a·s). Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments it does
// not take, cudaErrorNotSupported when libcuda has no TMA encoder).
extern "C" int keep_int8_gemm(const void* A, const void* a_scale,
                              const void* B, const void* b_scale,
                              const void* bias, const void* res, int res_dtype,
                              void* out, int out_dtype, int M, int N, int K,
                              int order, int gelu, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 16 || (order != 0 && order != 1)
      || (res_dtype != 0 && res_dtype != 1) || (out_dtype != 0 && out_dtype != 1)
      || !aligned16(A) || !aligned16(B) || !aligned16(out)
      || (res != nullptr && !aligned16(res)))
    return int(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!int8_map(&map_a, A, M, K) || !int8_map(&map_b, B, N, K))
    return int(cudaErrorNotSupported);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    return int(launch_out<float>(res_dtype, map_a, map_b, a_scale, b_scale,
                                 bias, res, out, M, N, K, order, gelu, st));
  return int(launch_out<__nv_bfloat16>(res_dtype, map_a, map_b, a_scale,
                                       b_scale, bias, res, out, M, N, K,
                                       order, gelu, st));
}
