// LayerNorm fused into the matmul that follows it, for Hopper (sm_90a).
//
// Replaces the TPU kernel keep_tpu/kernels/ln_matmul.py `ln_matmul`
// (`_ln_mm_kernel`, pallas_call at :51), which the ViT runs under
// `fuse_ln=True` for the qkv projection after norm1 and fc1 after norm2
// (keep_tpu/models/vit.py:141-152, :173-184).
//
// What it computes, for x [M, K] (fp32 or bf16), the LayerNorm's g, b fp32
// [K], the weight W [N, K] (the torch layout, the transpose of the JAX
// kernel's w [K, N]) and bias fp32 [N]:
//   mu, rstd = the row's mean and 1/sqrt(var + eps), taken as quant_rows.cu
//              takes them: fp64 sums rounded once to fp32
//   y[m, k]  = ((x - mu)·rstd)·g + b in fp32 (kops::ln_apply), rounded to
//              W's dtype                  -- equal, bit for bit, to
//              keep_tpu_torch/kernels/_kops.py ln_rows_reference
//   out[m, n] = Σ_k y[m, k]·W[n, k] accumulated in fp32, + bias[n] in fp32,
//              cast to the output dtype (fp32 or bf16).
// Types: fp32 x with fp32 W (CUDA-core FMAs, never TF32), or bf16 x with
// bf16 W (tensor cores, fp32 accumulators; a product of two bf16 values is
// exact in fp32).
//
// What bounds it on this card: operations. At the ViT-L shapes (M = B·197,
// K = 1024, N = 3072 or 4096) the product does 2·M·K·N = 4.0–5.3·10^10
// FLOP per call at B = 32 and reads ~19 MB, so the bf16 tensor-core rate
// sets the bound (0.040 / 0.053 ms at 989 TFLOP/s). What the TPU kernel buys,
// and this one keeps, is that the normalised [M, K] never touches device
// memory: each K-chunk of x is normalised and rounded as it is staged into
// shared memory.
//
// Design (simple first):
//   1. `ln_stats_kernel`: one warp per row writes (mu, rstd) to an fp32
//      [M, 2] scratch (two passes over the row, from L2 the second time).
//   2. The GEMM: one block of 8 warps per 128 × 128 output tile; K walks in
//      chunks of 32 bf16 (64 bytes) through two shared-memory stages. W's
//      chunk arrives by cp.async (zero-filled past N and K); x's chunk is
//      loaded into registers one step ahead, normalised with its rows'
//      statistics and g, b, rounded to bf16 and stored into the stage (zero
//      past M and K, so that the padding adds nothing). Rows are padded by 16
//      bytes so that the fragment loads of a warp hit 32 distinct banks. Each
//      warp owns a 64 × 32 sub-tile and issues
//      mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. The epilogue
//      adds the bias and stores two elements at a time.
//   The fp32 form is a plain 64 × 64 tiled FMA loop with the same
//   normalisation as it stages x.
//
// What it leaves on the table: wgmma and TMA (the card's full bf16 rate), a
// deeper pipeline, ldmatrix, and a persistent schedule; every column block
// normalises its x rows again (cheap next to the product).

#include "kops.cuh"

namespace {

// ---- 1. row statistics ------------------------------------------------------

constexpr int kStatWarps = 8;

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// stats[2m] = mean, stats[2m + 1] = 1/sqrt(var + eps) of row m: the mean
// first, then the mean of (x − mean)², both summed in fp64 and rounded once,
// as quant_rows.cu and _kops.ln_rows_reference take them.
template <typename T>
__global__ void __launch_bounds__(kStatWarps * 32)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int M,
                int K, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kStatWarps + threadIdx.x / 32;
  if (row >= M) return;  // uniform across the warp; no block barrier follows
  const T* xr = x + (long long)row * K;
  double s = 0.0;
  for (int k = lane; k < K; k += 32) s += double(kops::to_float(xr[k]));
  const double inv_n = 1.0 / double(K);
  const float mu = float(warp_sum_d(s) * inv_n);
  double v = 0.0;
  for (int k = lane; k < K; k += 32) {
    const double d = double(__fsub_rn(kops::to_float(xr[k]), mu));
    v += d * d;
  }
  const float var = float(warp_sum_d(v) * inv_n);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
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

// ---- 2a. bf16: tensor cores ---------------------------------------------------

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;              // bf16 elements of K per stage (64 bytes)
constexpr int kRow = BK * 2 + 16;   // padded shared-memory row, bytes
constexpr int kThreads = 256;       // 8 warps: 2 along M × 4 along N
constexpr int kWarpM = 64;
constexpr int kWarpN = 32;
constexpr int kMi = kWarpM / 16;    // m16 tiles per warp
constexpr int kNi = kWarpN / 8;     // n8 tiles per warp
constexpr int kStageBytes = (BM + BN) * kRow;
constexpr int kChunks = BM * BK / 8 / kThreads;  // 16-byte chunks a thread
                                                 // stages per tile (2)

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

// Copies rows [n0, n0 + 128) × columns [k0, k0 + 32) of W [N, K] into a
// padded shared tile, 16 bytes (8 bf16) per cp.async.
__device__ __forceinline__ void load_w(uint8_t* dst,
                                       const __nv_bfloat16* __restrict__ W,
                                       int N, int K, int n0, int k0) {
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (BK / 8);
    const int c = (idx % (BK / 8)) * 8;
    const int gn = n0 + r;
    const int gk = k0 + c;
    const bool ok = gn < N && gk < K;
    const __nv_bfloat16* g = ok ? W + (long long)gn * K + gk : W;
    cp_async16(dst + r * kRow + c * 2, g, ok);
  }
}

// Loads this thread's raw x chunks of rows [m0, m0 + 128) × columns
// [k0, k0 + 32) into registers (zeros past M and K).
__device__ __forceinline__ void load_x(uint4 (&regs)[kChunks],
                                       const __nv_bfloat16* __restrict__ X,
                                       int M, int K, int m0, int k0) {
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (BK / 8);
    const int c = (idx % (BK / 8)) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    regs[it] = ok ? __ldg(reinterpret_cast<const uint4*>(
                        X + (long long)(m0 + r) * K + k0 + c))
                  : make_uint4(0, 0, 0, 0);
  }
}

// Normalises the chunks held in registers and stores them, rounded to bf16,
// into the shared A tile; positions past M or K are stored as zeros.
__device__ __forceinline__ void store_x(uint8_t* dst,
                                        const uint4 (&regs)[kChunks],
                                        const float* __restrict__ g,
                                        const float* __restrict__ b,
                                        const float* mu_s, const float* rstd_s,
                                        int M, int K, int m0, int k0) {
#pragma unroll
  for (int it = 0; it < kChunks; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int r = idx / (BK / 8);
    const int c = (idx % (BK / 8)) * 8;
    const int gk = k0 + c;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (m0 + r < M && gk < K) {
      const float mu = mu_s[r], rstd = rstd_s[r];
      const float4 g0 = __ldg(reinterpret_cast<const float4*>(g + gk));
      const float4 g1 = __ldg(reinterpret_cast<const float4*>(g + gk + 4));
      const float4 b0 = __ldg(reinterpret_cast<const float4*>(b + gk));
      const float4 b1 = __ldg(reinterpret_cast<const float4*>(b + gk + 4));
      const float gg[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const uint32_t in[4] = {regs[it].x, regs[it].y, regs[it].z, regs[it].w};
      uint32_t o[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // the low half of a word is the element of the lower index
        const float lo = __uint_as_float(in[w] << 16);
        const float hi = __uint_as_float(in[w] & 0xffff0000u);
        const __nv_bfloat162 y = __halves2bfloat162(
            __float2bfloat16_rn(
                kops::ln_apply(lo, mu, rstd, gg[2 * w], bb[2 * w])),
            __float2bfloat16_rn(
                kops::ln_apply(hi, mu, rstd, gg[2 * w + 1], bb[2 * w + 1])));
        o[w] = *reinterpret_cast<const uint32_t*>(&y);
      }
      packed = make_uint4(o[0], o[1], o[2], o[3]);
    }
    *reinterpret_cast<uint4*>(dst + r * kRow + c * 2) = packed;
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads)
ln_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ X,
                      const float* __restrict__ stats,
                      const float* __restrict__ g, const float* __restrict__ b,
                      const __nv_bfloat16* __restrict__ W,
                      const float* __restrict__ bias, TOut* __restrict__ out,
                      int M, int N, int K) {
  __shared__ __align__(16) uint8_t smem[2 * kStageBytes];
  __shared__ float mu_s[BM];
  __shared__ float rstd_s[BM];
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / (BN / kWarpN)) * kWarpM;  // warp's row offset
  const int wn = (warp % (BN / kWarpN)) * kWarpN;  // warp's column offset
  const int gid = lane / 4;                        // mma groupID
  const int t = lane % 4;                          // mma threadID_in_group

  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const bool ok = m0 + i < M;
    mu_s[i] = ok ? stats[2 * (m0 + i)] : 0.f;
    rstd_s[i] = ok ? stats[2 * (m0 + i) + 1] : 0.f;
  }

  float acc[kMi][kNi][4];
#pragma unroll
  for (int i = 0; i < kMi; ++i)
#pragma unroll
    for (int j = 0; j < kNi; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int kt_count = (K + BK - 1) / BK;
  uint4 xr[kChunks];
  load_w(smem + BM * kRow, W, N, K, n0, 0);
  cp_async_commit();
  load_x(xr, X, M, K, m0, 0);
  __syncthreads();  // mu_s, rstd_s
  store_x(smem, xr, g, b, mu_s, rstd_s, M, K, m0, 0);

  for (int kt = 0; kt < kt_count; ++kt) {
    uint8_t* stage = smem + (kt & 1) * kStageBytes;
    uint8_t* next = smem + ((kt + 1) & 1) * kStageBytes;
    const bool more = kt + 1 < kt_count;
    if (more) {
      // the next chunk's loads fly while this one is multiplied
      load_w(next + BM * kRow, W, N, K, n0, (kt + 1) * BK);
      cp_async_commit();
      load_x(xr, X, M, K, m0, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's x (stored last step) and W are in place
    const uint8_t* As = stage;
    const uint8_t* Bs = stage + BM * kRow;
#pragma unroll
    for (int ks = 0; ks < BK * 2; ks += 32) {  // 16 bf16 = 32 bytes per mma
      uint32_t af[kMi][4];
#pragma unroll
      for (int i = 0; i < kMi; ++i) {
        const uint8_t* p = As + (wm + i * 16 + gid) * kRow + ks + t * 4;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kRow + 16);
      }
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const uint8_t* p = Bs + (wn + j * 8 + gid) * kRow + ks + t * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 16);
#pragma unroll
        for (int i = 0; i < kMi; ++i) mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
    // the other stage was last read in the previous step, before its
    // closing barrier: it is free for the next chunk of x
    if (more) store_x(next, xr, g, b, mu_s, rstd_s, M, K, m0, (kt + 1) * BK);
    __syncthreads();
  }

  // Epilogue: fragment element e of tile (i, j) is row gid (+8 for e ≥ 2),
  // column 2t + (e & 1).
#pragma unroll
  for (int i = 0; i < kMi; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + i * 16 + gid + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < kNi; ++j) {
        const int n = n0 + wn + j * 8 + t * 2;
        if (n >= N) continue;
        store_pair<TOut>(out + (long long)m * N + n,
                         __fadd_rn(acc[i][j][half * 2], bias[n]),
                         __fadd_rn(acc[i][j][half * 2 + 1], bias[n + 1]));
      }
    }
  }
}

// ---- 2b. fp32: CUDA-core FMAs -------------------------------------------------

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int kFThreads = 256;  // 16 × 16 threads, 4 × 4 outputs each

template <typename TOut>
__global__ void __launch_bounds__(kFThreads)
ln_matmul_f32_kernel(const float* __restrict__ X,
                     const float* __restrict__ stats,
                     const float* __restrict__ g, const float* __restrict__ b,
                     const float* __restrict__ W,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     int M, int N, int K) {
  __shared__ float As[FK][FM + 4];  // [k][m], normalised x
  __shared__ float Bs[FK][FN + 4];  // [k][n]
  __shared__ float mu_s[FM];
  __shared__ float rstd_s[FM];
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int i = threadIdx.x; i < FM; i += kFThreads) {
    const bool ok = m0 + i < M;
    mu_s[i] = ok ? stats[2 * (m0 + i)] : 0.f;
    rstd_s[i] = ok ? stats[2 * (m0 + i) + 1] : 0.f;
  }
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int it = 0; it < FM * FK / kFThreads; ++it) {
      const int idx = threadIdx.x + it * kFThreads;
      const int r = idx / FK;
      const int c = idx % FK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[c][r] = gm < M && gk < K
                     ? kops::ln_apply(X[(long long)gm * K + gk], mu_s[r],
                                      rstd_s[r], g[gk], b[gk])
                     : 0.f;
      Bs[c][r] = gn < N && gk < K ? W[(long long)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;  // N is a multiple of 8, so n + 1 < N too
      store_pair<TOut>(out + (long long)m * N + n,
                       __fadd_rn(acc[i][j], bias[n]),
                       __fadd_rn(acc[i][j + 1], bias[n + 1]));
    }
  }
}

template <typename T, typename TOut>
cudaError_t launch(const void* x, const void* g, const void* b, float eps,
                   const void* w, const void* bias, void* stats, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  ln_stats_kernel<T><<<(M + kStatWarps - 1) / kStatWarps, kStatWarps * 32, 0,
                       stream>>>(static_cast<const T*>(x),
                                 static_cast<float*>(stats), M, K, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const float* st = static_cast<const float*>(stats);
  const float* gg = static_cast<const float*>(g);
  const float* bb = static_cast<const float*>(b);
  const float* bi = static_cast<const float*>(bias);
  if constexpr (sizeof(T) == 2) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    ln_matmul_bf16_kernel<TOut><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), st, gg, bb,
        static_cast<const __nv_bfloat16*>(w), bi, static_cast<TOut*>(out), M,
        N, K);
  } else {
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    ln_matmul_f32_kernel<TOut><<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(x), st, gg, bb,
        static_cast<const float*>(w), bi, static_cast<TOut*>(out), M, N, K);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [M, K] and w [N, K] of one
// dtype (0 = float32, 1 = bfloat16), ln_g, ln_b fp32 [K], bias fp32 [N],
// stats an fp32 [M, 2] scratch, out [M, N] (out_dtype: 0 = float32,
// 1 = bfloat16); all contiguous, x and w 16-byte aligned. K must be a
// multiple of 16 and at most 4096, N a multiple of 8. Returns the
// cudaError_t of the launches.
extern "C" int keep_ln_matmul(const void* x, const void* ln_g,
                              const void* ln_b, float eps, const void* w,
                              const void* bias, void* stats, void* out,
                              int dtype, int out_dtype, int M, int N, int K,
                              void* stream) {
  if (M < 1 || N < 1 || K < 16 || K > 4096 || K % 16 || N % 8 ||
      (M + FM - 1) / FM > 65535)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return int(launch<float, float>(x, ln_g, ln_b, eps, w, bias, stats, out,
                                    M, N, K, st));
  if (dtype == 0 && out_dtype == 1)
    return int(launch<float, __nv_bfloat16>(x, ln_g, ln_b, eps, w, bias,
                                            stats, out, M, N, K, st));
  if (dtype == 1 && out_dtype == 0)
    return int(launch<__nv_bfloat16, float>(x, ln_g, ln_b, eps, w, bias,
                                            stats, out, M, N, K, st));
  if (dtype == 1 && out_dtype == 1)
    return int(launch<__nv_bfloat16, __nv_bfloat16>(
        x, ln_g, ln_b, eps, w, bias, stats, out, M, N, K, st));
  return int(cudaErrorInvalidValue);
}
