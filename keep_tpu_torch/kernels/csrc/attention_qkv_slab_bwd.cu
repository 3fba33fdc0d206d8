// Backward of the fused multi-head attention over the unsplit qkv slab, for
// Hopper (sm_90a).
//
// Replaces keep_tpu/kernels/flash_attention.py `_slab_attn_bwd` (:221-245),
// the closed-form VJP that `jax.custom_vjp` attaches to the Pallas forward
// (`_slab_attn_fwd_kernel`, pallas_call at :190). Both KEEP towers reach it
// through `attention_qkv_slab` whenever a block's parameters train.
//
// What it computes, per batch row b and head h, with q/k/v the 64-wide
// column slices of qkv[B, S, 3*H*64] and do the slice of dout[B, S, H*64]:
//   s  = (q . k^T) * Dh^-0.5 + key_bias[b, :]        fp32 (bf16 . bf16 exact)
//   p  = softmax(s), kept in fp32 (the forward rounds p before p . v; the
//        backward does not, as in the JAX code)
//   dv = p^T . do,  dp = do . v^T,  ds = p o (dp - rowsum(dp o p))
//   dq = (ds . k) * scale,  dk = (ds^T . q) * scale
// all summed in fp32 and cast once to the slab dtype, written into the slab
// layout of dqkv[B, S, 3*H*64]: dq lanes, then dk, then dv (the layout
// `_slab_split` reads). No gradient flows to the key bias.
//
// What bounds it on this card: the fp32 pipes. The design runs every product
// as scalar FMAs from shared memory (5 S^2 Dh FMAs per (b, h), with the score
// recomputed twice), not on the tensor cores; the bytes moved (the slab,
// dout and dqkv once, K/V/Q re-read from L2 per tile) are small next to that.
//
// Design (simple first, deterministic: no atomics, every output element is
// written by exactly one thread):
//   Kernel A, one block per (32 query rows, head, batch row), 8 warps, a warp
//   per query row at a time, as the forward:
//     phase 1: K -> shared; each lane scores keys lane, lane+32, ...; warp
//              max and sum; the fp32 p row -> shared;
//     phase 2: V -> shared (over K); dp for the lane's keys, the warp sums
//              rowsum(dp o p), ds overwrites p in shared; the row's max, sum
//              and rowsum go to a small fp32 [B, H, S] x 4 buffer;
//     phase 3: K -> shared again; lane l sums dq columns 2l, 2l+1.
//     Dynamic shared memory as the forward's: at most 194 KB (fp32, S=512).
//   Kernel B, one block per (32 keys, head, batch row): K and V of the tile
//   in shared fp32; a loop over the query rows in chunks of 32 stages q, do
//   and the row statistics, rebuilds p and ds for the 32 x 32 tile (thread =
//   one (row, key) pair, lane = key, stride-65 rows so the warp hits 32
//   banks), then each thread accumulates 2 keys x 4 dims of dk and dv.
//   41 KB of static shared memory.
//
// What it leaves on the table: tensor cores (mma/wgmma), TMA/cp.async
// overlap, and the third recompute of the scores (kernel A's phase 3 could
// keep ds rows of a key tile instead of re-staging K).

#include "slab_attention.cuh"

namespace {

constexpr int kKeyTile = 32;
constexpr int kQueryChunk = 32;
constexpr int kPad = kHeadDim + 1;     // fp32 words per staged row
constexpr int kTilePad = kKeyTile + 1;  // fp32 words per p / ds row

template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_attention_bwd_dq_kernel(const T* __restrict__ qkv,
                             const float* __restrict__ key_bias,
                             const T* __restrict__ dout, T* __restrict__ dqkv,
                             float4* __restrict__ stats, int S, int H,
                             float scale) {
  extern __shared__ uint32_t smem[];
  constexpr int W = Elem<T>::kRowWords;
  constexpr int kRowsPerWarp = kRowsPerBlock / kWarps;
  uint32_t* kv_s = smem;                                  // [S][W]
  float* p_s = reinterpret_cast<float*>(smem + S * W);    // [32][S]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * kHeadDim;
  const long long stride = 3LL * D;
  const T* slab = qkv + (long long)b * S * stride;
  const T* dslab = dout + (long long)b * S * D;
  T* gslab = dqkv + (long long)b * S * stride;
  const float* bias = key_bias + (long long)b * S;
  float4* st = stats + ((long long)b * H + h) * S;

  float row_max[kRowsPerWarp], row_sum[kRowsPerWarp];

  // Phase 1: K -> shared memory; scores and the fp32 softmax -> shared.
  stage_rows<T>(kv_s, slab + D + h * kHeadDim, S, stride);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + kWarps * k;
    const int row = row0 + r;
    row_max[k] = 0.f;
    row_sum[k] = 1.f;
    if (row >= S) break;  // uniform across the warp
    float q[kHeadDim];
    load_row<T>(slab + row * stride + h * kHeadDim, q);
    float s[kKeysPerLane];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      s[i] = -INFINITY;
      if (j < S) {
        const uint32_t* krow = kv_s + j * W;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim / 2; ++d) {
          float a, bb;
          Elem<T>::pair(krow, d, a, bb);
          acc = fmaf(q[2 * d], a, acc);
          acc = fmaf(q[2 * d + 1], bb, acc);
        }
        s[i] = acc * scale + bias[j];
        m = fmaxf(m, s[i]);
      }
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      if (lane + 32 * i < S) {
        s[i] = expf(s[i] - m);
        sum += s[i];
      }
    }
    sum = warp_sum(sum);
    float* prow = p_s + r * S;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < S) prow[j] = s[i] / sum;
    }
    row_max[k] = m;
    row_sum[k] = sum;
  }
  __syncthreads();

  // Phase 2: V -> shared; dp, rowsum(dp o p), ds over p in shared.
  stage_rows<T>(kv_s, slab + 2 * D + h * kHeadDim, S, stride);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + kWarps * k;
    const int row = row0 + r;
    if (row >= S) break;
    float g[kHeadDim];
    load_row<T>(dslab + (long long)row * D + h * kHeadDim, g);
    float* prow = p_s + r * S;
    float dp[kKeysPerLane];
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      dp[i] = 0.f;
      if (j < S) {
        const uint32_t* vrow = kv_s + j * W;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < kHeadDim / 2; ++d) {
          float a, bb;
          Elem<T>::pair(vrow, d, a, bb);
          acc = fmaf(g[2 * d], a, acc);
          acc = fmaf(g[2 * d + 1], bb, acc);
        }
        dp[i] = acc;
        rs = fmaf(acc, prow[j], rs);
      }
    }
    rs = warp_sum(rs);
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int j = lane + 32 * i;
      if (j < S) prow[j] = prow[j] * (dp[i] - rs);
    }
    if (lane == 0) st[row] = make_float4(row_max[k], row_sum[k], rs, 0.f);
  }
  __syncthreads();

  // Phase 3: K -> shared again; lane l owns dq columns 2l, 2l+1.
  stage_rows<T>(kv_s, slab + D + h * kHeadDim, S, stride);
  __syncthreads();
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int row = row0 + r;
    if (row >= S) break;
    const float* dsrow = p_s + r * S;
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float ds = dsrow[j];
      float a, bb;
      Elem<T>::pair(kv_s + j * W, lane, a, bb);
      o0 = fmaf(ds, a, o0);
      o1 = fmaf(ds, bb, o1);
    }
    Elem<T>::store(gslab + row * stride + h * kHeadDim + 2 * lane, o0 * scale,
                   o1 * scale);
  }
}

// Stages rows first..first+31 of a 64-wide column slice (row stride
// `stride` elements) as fp32 into dst[32][kPad]; rows at or past S are zero.
template <typename T>
__device__ void stage_tile(float* dst, const T* src, long long stride,
                           int first, int S) {
  for (int idx = threadIdx.x; idx < 32 * kHeadDim; idx += kThreads) {
    const int r = idx / kHeadDim;
    const int d = idx - r * kHeadDim;
    const int row = first + r;
    dst[r * kPad + d] =
        row < S ? Elem<T>::to_float(src[row * stride + d]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_attention_bwd_dkv_kernel(const T* __restrict__ qkv,
                              const float* __restrict__ key_bias,
                              const T* __restrict__ dout, T* __restrict__ dqkv,
                              const float4* __restrict__ stats, int S, int H,
                              float scale) {
  __shared__ float k_s[kKeyTile * kPad];
  __shared__ float v_s[kKeyTile * kPad];
  __shared__ float q_s[kQueryChunk * kPad];
  __shared__ float g_s[kQueryChunk * kPad];
  __shared__ float p_s[kQueryChunk * kTilePad];
  __shared__ float ds_s[kQueryChunk * kTilePad];
  __shared__ float4 st_s[kQueryChunk];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kKeyTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * kHeadDim;
  const long long stride = 3LL * D;
  const T* slab = qkv + (long long)b * S * stride;
  const T* dslab = dout + (long long)b * S * D;
  T* gslab = dqkv + (long long)b * S * stride;
  const float4* st = stats + ((long long)b * H + h) * S;

  stage_tile<T>(k_s, slab + D + h * kHeadDim, stride, key0, S);
  stage_tile<T>(v_s, slab + 2 * D + h * kHeadDim, stride, key0, S);
  // in the score phase a thread's key is key0 + lane
  const int key = key0 + lane;
  const float bias_j = key < S ? key_bias[(long long)b * S + key] : 0.f;
  // in the accumulation a thread owns keys 2kg, 2kg+1 of the tile and dims
  // dg, dg+16, dg+32, dg+48
  const int dg = threadIdx.x % 16;
  const int kg = threadIdx.x / 16;
  float dk[2][4] = {}, dv[2][4] = {};

  for (int i0 = 0; i0 < S; i0 += kQueryChunk) {
    __syncthreads();  // the previous chunk's accumulation is done with q_s..
    stage_tile<T>(q_s, slab + h * kHeadDim, stride, i0, S);
    stage_tile<T>(g_s, dslab + h * kHeadDim, D, i0, S);
    if (threadIdx.x < kQueryChunk) {
      const int row = i0 + threadIdx.x;
      st_s[threadIdx.x] = row < S ? st[row] : make_float4(0.f, 1.f, 0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kQueryChunk / kWarps; ++r) {
      const int i = warp + kWarps * r;
      float p = 0.f, ds = 0.f;
      if (i0 + i < S && key < S) {
        const float* qi = q_s + i * kPad;
        const float* gi = g_s + i * kPad;
        const float* kj = k_s + lane * kPad;
        const float* vj = v_s + lane * kPad;
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(qi[d], kj[d], s);
          dp = fmaf(gi[d], vj[d], dp);
        }
        const float4 sv = st_s[i];
        p = expf(s * scale + bias_j - sv.x) / sv.y;
        ds = p * (dp - sv.z);
      }
      p_s[i * kTilePad + lane] = p;
      ds_s[i * kTilePad + lane] = ds;
    }
    __syncthreads();
    const int rows = min(kQueryChunk, S - i0);
    for (int i = 0; i < rows; ++i) {
      const float p0 = p_s[i * kTilePad + 2 * kg];
      const float p1 = p_s[i * kTilePad + 2 * kg + 1];
      const float d0 = ds_s[i * kTilePad + 2 * kg];
      const float d1 = ds_s[i * kTilePad + 2 * kg + 1];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float g = g_s[i * kPad + dg + 16 * c];
        const float q = q_s[i * kPad + dg + 16 * c];
        dv[0][c] = fmaf(p0, g, dv[0][c]);
        dv[1][c] = fmaf(p1, g, dv[1][c]);
        dk[0][c] = fmaf(d0, q, dk[0][c]);
        dk[1][c] = fmaf(d1, q, dk[1][c]);
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int j = key0 + 2 * kg + kk;
    if (j >= S) continue;
    T* row = gslab + j * stride + h * kHeadDim;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = dg + 16 * c;
      row[D + d] = Elem<T>::from_float(dk[kk][c] * scale);
      row[2 * D + d] = Elem<T>::from_float(dv[kk][c]);
    }
  }
}

template <typename T>
cudaError_t launch_bwd(const void* qkv, const void* key_bias, const void* dout,
                       void* dqkv, void* stats, int B, int S, int H,
                       float scale, cudaStream_t stream) {
  const size_t smem =
      size_t(S) * Elem<T>::kRowWords * 4 + size_t(kRowsPerBlock) * S * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_attention_bwd_dq_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
  }
  const T* q = static_cast<const T*>(qkv);
  const float* kb = static_cast<const float*>(key_bias);
  const T* g = static_cast<const T*>(dout);
  T* out = static_cast<T*>(dqkv);
  float4* st = static_cast<float4*>(stats);
  const dim3 grid_a((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  slab_attention_bwd_dq_kernel<T><<<grid_a, kThreads, smem, stream>>>(
      q, kb, g, out, st, S, H, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_b((S + kKeyTile - 1) / kKeyTile, H, B);
  slab_attention_bwd_dkv_kernel<T><<<grid_b, kThreads, 0, stream>>>(
      q, kb, g, out, st, S, H, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. `qkv` is a contiguous
// [B, S, 3*H*head_dim] tensor, `key_bias` a contiguous fp32 [B, S] tensor
// (zeros where nothing is masked), `dout` a contiguous [B, S, H*head_dim]
// tensor of the slab's dtype, `dqkv` a contiguous tensor shaped and typed as
// `qkv`, `stats` a 16-byte aligned fp32 scratch of B*H*S*4 floats. dtype:
// 0 = float32, 1 = bfloat16. Launches kernel A then kernel B on `stream` and
// returns the cudaError_t of the launches.
extern "C" int keep_attention_qkv_slab_bwd(const void* qkv,
                                           const void* key_bias,
                                           const void* dout, void* dqkv,
                                           void* stats, int B, int S, int H,
                                           int head_dim, int dtype,
                                           float scale, void* stream) {
  if (head_dim != kHeadDim || S < 1 || S > kMaxSeq || H < 1 || B < 1 ||
      B > 65535 || H > 65535 || key_bias == nullptr)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return int(launch_bwd<float>(qkv, key_bias, dout, dqkv, stats, B, S, H,
                                   scale, st));
    case 1:
      return int(launch_bwd<__nv_bfloat16>(qkv, key_bias, dout, dqkv, stats,
                                           B, S, H, scale, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
