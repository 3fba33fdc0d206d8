// Backward of the fused multi-head attention over the unsplit qkv slab, for
// Hopper (sm_90a).
//
// Replaces keep_tpu/kernels/flash_attention.py `_slab_attn_bwd` (:221-245),
// the closed-form VJP that `jax.custom_vjp` attaches to the Pallas forward
// (`_slab_attn_fwd_kernel`, pallas_call at :190). Both KEEP towers reach it
// through `attention_qkv_slab` whenever a block's parameters train.
//
// What it computes, per batch row b and head h, with q/k/v the Dh-wide
// column slices of qkv[B, S, 3*H*Dh] and do the slice of dout[B, S, H*Dh]:
//   s  = (q . k^T) * Dh^-0.5 + key_bias[b, :]        fp32 (bf16 . bf16 exact)
//   p  = softmax(s), kept in fp32 (the forward rounds p before p . v; the
//        backward does not, as in the JAX code)
//   dv = p^T . do,  dp = do . v^T,  ds = p o (dp - rowsum(dp o p))
//   dq = (ds . k) * scale,  dk = (ds^T . q) * scale
// summed in fp32 and cast once to the slab dtype, written into the slab
// layout of dqkv[B, S, 3*H*Dh]: dq lanes, then dk, then dv (the layout
// `_slab_split` reads). No gradient flows to the key bias.
//
// Both forms are deterministic: two kernels and no atomics, every output
// element written by exactly one thread, every sum taken in a fixed order.
// Kernel A runs per query tile and writes each row's statistics (max, sum,
// rowsum(dp o p)) to an fp32 [B, H, S] x 4 scratch, and dq; kernel B runs
// per key tile, rebuilds p and ds from the statistics and writes dk and dv.
//
// What bounds it on this card: bytes in principle (the slab, dout and dqkv
// once: 0.027 ms at ViT-L B=32), in practice the products. Without atomics
// the scores are taken three times (twice in A, once in B), and dp twice in
// A and once in B, so the two kernels run 9 S^2 Dh multiply-adds per
// (b, h) against the 5 of one fused kernel with atomic dq sums. Kernel A
// takes them twice because rowsum(dp o p) needs a whole row of p before
// any ds, and a warp cannot keep its 16 x S scores in registers at S = 512;
// dq is summed in the second pass, with no third pass over K.
//
// bf16 form, on the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32
// accumulators), 4 warps of 16 rows per block. p and ds are rounded to bf16
// only as operands of their products (dv = p^T . do, dq = ds . k,
// dk = ds^T . q), a departure from the JAX package's fp32 products that
// stays inside the bf16 gate (max |d| <= 1e-2 * max |plain|; the CPU model
// of this rounding is held to the JAX VJP in tests/test_torch_attention_
// grad.py). rowsum(dp o p) keeps p in fp32.
//   Kernel A, one block per (64 query rows, head, batch row): Q and dO's
//   rows and the whole K and V slices go to shared memory by cp.async
//   (swizzled 128-byte rows, rows past S zero-filled), once.
//     pass 1: per 64-key tile, s = q . k^T and dp = do . v^T; the row max
//             m, the sum l and u = sum exp(s - m) * dp with an online
//             rescale; rowsum(dp o p) = u / l. Statistics -> scratch.
//     pass 2: s and dp again; p = exp(s - m) / l and ds = p (dp - rowsum)
//             in fp32; ds rounded to bf16; dq += ds . k (K read by
//             ldmatrix.trans).
//   Kernel B, one block per (64 keys, head, batch row): K and V of the tile
//   are held as A fragments in registers; the query rows stream through two
//   shared-memory stages by cp.async (Q, dO and their statistics, the next
//   tile in flight while the current one is multiplied). Per 32 queries:
//   s^T = k . q^T and dp^T = v . do^T, p^T and ds^T in fp32, then
//   dv += p^T . do and dk += ds^T . q with p^T and ds^T rounded to bf16.
// fp32 form: the CUDA-core kernels (scalar FMAs, 32-row tiles, padded
// shared rows), whose gate is atol 2e-4 / rtol 1e-4.
//
// Shapes: the whole-slice bodies above take Dh = 64 and S <= 512 (the KEEP towers
// at 224^2) and keep the whole K and V slices of a head in shared memory.
// Every other Dh in 64..128 (multiples of 8) and every S goes to streamed
// bodies of the same two-kernel layout, whose shared memory does not grow
// with S:
//   bf16: kernel A keeps Q and dO of its 64 query rows in shared memory
//   and streams K and V in 64-key tiles through two cp.async stages, twice
//   (pass 1 the statistics, pass 2 ds and dq); kernel B keeps K and V of
//   its 64 keys and streams Q, dO and their statistics through two stages.
//   A row holds Dh padded with zeros to a multiple of 16, plus one 16-byte
//   chunk of pitch (the forward's streamed layout, slab_attention.cuh);
//   operand fragments are loaded from shared memory per k16 step, which
//   keeps the registers for the Dh-wide accumulators (dq; dk and dv).
//   fp32: kernel A, one block per 32 query rows, streams K and V in 64-key
//   tiles twice (an online max / sum in pass 1), ds through shared memory
//   into dq; kernel B is the fp32 kernel B above with its rows sized by
//   Dh.
//
// What it leaves on the table: wgmma and TMA; one fused kernel (dq summed
// by atomics, which would cost the determinism); keeping dS tiles of kernel
// A for kernel B instead of recomputing the scores.

#include "slab_attention.cuh"

namespace {

// ---- fp32: CUDA-core FMAs ------------------------------------------------------

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
__device__ void stage_tile_f32(float* dst, const T* src, long long stride,
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

  stage_tile_f32<T>(k_s, slab + D + h * kHeadDim, stride, key0, S);
  stage_tile_f32<T>(v_s, slab + 2 * D + h * kHeadDim, stride, key0, S);
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
    stage_tile_f32<T>(q_s, slab + h * kHeadDim, stride, i0, S);
    stage_tile_f32<T>(g_s, dslab + h * kHeadDim, D, i0, S);
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

// ---- bf16: tensor cores ----------------------------------------------------------

// Kernel A: statistics and dq of 64 query rows.
__global__ void __launch_bounds__(kTcThreads)
slab_attention_bwd_tc_dq_kernel(const bf16* __restrict__ qkv,
                                const float* __restrict__ key_bias,
                                const bf16* __restrict__ dout,
                                bf16* __restrict__ dqkv,
                                float4* __restrict__ stats, int S, int H,
                                float scale) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int sp = (S + kTcTile - 1) / kTcTile * kTcTile;
  const uint32_t q_s = smem_addr(tc_smem);                  // [64][64]
  const uint32_t g_s = q_s + kTcRows * kRowBytes;        // [64][64] dO
  const uint32_t k_s = g_s + kTcRows * kRowBytes;        // [sp][64]
  const uint32_t v_s = k_s + sp * kRowBytes;             // [sp][64]
  float* bias_s = reinterpret_cast<float*>(
      tc_smem + (2 * kTcRows + 2 * sp) * kRowBytes);        // [sp]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * kHeadDim;
  const long long stride = 3LL * D;
  const bf16* slab = qkv + (long long)b * S * stride + h * kHeadDim;
  const bf16* dslab = dout + (long long)b * S * D + h * kHeadDim;

  stage_async(q_s, slab, stride, row0, kTcRows, S);
  stage_async(g_s, dslab, D, row0, kTcRows, S);
  stage_async(k_s, slab + D, stride, 0, sp, S);
  stage_async(v_s, slab + 2 * D, stride, 0, sp, S);
  cp_async_commit();
  fill_bias(bias_s, key_bias + (long long)b * S, S, sp);
  cp_async_wait<0>();
  __syncthreads();

  uint32_t qa[4][4], ga[4][4];
  load_a_rows(qa, q_s, 16 * warp, lane);
  load_a_rows(ga, g_s, 16 * warp, lane);

  // Pass 1: the row max m, sum l and u = sum exp(s - m) dp.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  for (int kb = 0; kb < sp; kb += kTcTile) {
    float s[8][4], dp[8][4], alpha[2];
    scores(s, qa, k_s, kb, bias_s, scale, lane);
    mma_abt<8>(dp, ga, v_s, kb, lane);
    raise_max(s, m, alpha);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] *= alpha[i];
      u[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(__fsub_rn(s[n][e], m[e >> 1]));
        l[e >> 1] += x;
        u[e >> 1] = fmaf(x, dp[n][e], u[e >> 1]);
      }
  }
  float inv[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    inv[i] = 1.f / quad_sum(l[i]);
    delta[i] = quad_sum(u[i]) * inv[i];  // rowsum(dp o p), p in fp32
  }
  float4* st = stats + ((long long)b * H + h) * S;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
      if (row < S) st[row] = make_float4(m[i], inv[i], delta[i], 0.f);
    }
  }

  // Pass 2: ds = p o (dp - rowsum), rounded to bf16; dq += ds . k.
  float dq[8][4] = {};
  for (int kb = 0; kb < sp; kb += kTcTile) {
    float s[8][4], dp[8][4];
    scores(s, qa, k_s, kb, bias_s, scale, lane);
    mma_abt<8>(dp, ga, v_s, kb, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = __fmul_rn(expf(__fsub_rn(s[n][e], m[i])), inv[i]);
        s[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], delta[i]));
      }
    uint32_t da[4][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_to_a(da[c], s[2 * c], s[2 * c + 1]);
    mma_ax<4>(dq, da, k_s, kb, lane);
  }

  bf16* gslab = dqkv + (long long)b * S * stride + h * kHeadDim;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row >= S) continue;
    bf16* dst = gslab + row * stride + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      Elem<bf16>::store(dst + 8 * n, __fmul_rn(dq[n][2 * i], scale),
                        __fmul_rn(dq[n][2 * i + 1], scale));
  }
}

constexpr int kStatsBytes = kTcTile * 16;  // 64 float4
constexpr int kStageBytes = 2 * kTcTile * kRowBytes + kStatsBytes;
constexpr size_t kDkvSmem = 2 * kTcRows * kRowBytes + 2 * kStageBytes;

// Starts the copies of query rows [r0, r0 + 64) of Q, dO and their
// statistics into one stage (rows past S zero-filled: their p and ds are 0).
__device__ __forceinline__ void stage_queries(uint32_t stage, const bf16* q,
                                              const bf16* g,
                                              const float4* st,
                                              long long stride, int D, int r0,
                                              int S) {
  stage_async(stage, q, stride, r0, kTcTile, S);
  stage_async(stage + kTcTile * kRowBytes, g, D, r0, kTcTile, S);
  if (threadIdx.x < kTcTile) {
    const int row = r0 + threadIdx.x;
    cp_async16(stage + 2 * kTcTile * kRowBytes + threadIdx.x * 16,
               row < S ? st + row : st, row < S);
  }
}

// Kernel B: dk and dv of 64 keys.
__global__ void __launch_bounds__(kTcThreads)
slab_attention_bwd_tc_dkv_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ key_bias,
                                 const bf16* __restrict__ dout,
                                 bf16* __restrict__ dqkv,
                                 const float4* __restrict__ stats, int S,
                                 int H, float scale) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const uint32_t k_s = smem_addr(tc_smem);                  // [64][64]
  const uint32_t v_s = k_s + kTcRows * kRowBytes;        // [64][64]
  const uint32_t stages = v_s + kTcRows * kRowBytes;     // 2 x (Q, dO, stats)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * kHeadDim;
  const long long stride = 3LL * D;
  const bf16* slab = qkv + (long long)b * S * stride + h * kHeadDim;
  const bf16* dslab = dout + (long long)b * S * D + h * kHeadDim;
  const float4* st = stats + ((long long)b * H + h) * S;

  stage_async(k_s, slab + D, stride, key0, kTcRows, S);
  stage_async(v_s, slab + 2 * D, stride, key0, kTcRows, S);
  stage_queries(stages, slab, dslab, st, stride, D, 0, S);
  cp_async_commit();

  // this thread's keys (rows of s^T): gid and gid + 8 of the warp's 16
  float kbias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 16 * warp + (lane >> 2) + 8 * i;
    kbias[i] = key < S ? key_bias[(long long)b * S + key] : -INFINITY;
  }
  uint32_t ka[4][4], va[4][4];
  float dk[8][4] = {}, dv[8][4] = {};
  const int tiles = (S + kTcTile - 1) / kTcTile;
  for (int qt = 0; qt < tiles; ++qt) {
    if (qt + 1 < tiles) {
      stage_queries(stages + ((qt + 1) & 1) * kStageBytes, slab, dslab, st,
                    stride, D, (qt + 1) * kTcTile, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (qt == 0) {
      load_a_rows(ka, k_s, 16 * warp, lane);
      load_a_rows(va, v_s, 16 * warp, lane);
    }
    const uint32_t q_s = stages + (qt & 1) * kStageBytes;
    const uint32_t g_s = q_s + kTcTile * kRowBytes;
    const float4* sts = reinterpret_cast<const float4*>(
        tc_smem + (q_s - smem_addr(tc_smem)) + 2 * kTcTile * kRowBytes);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;  // this step's 32 queries in the tile
      float s[4][4], dp[4][4];
      mma_abt<4>(s, ka, q_s, c0, lane);
      mma_abt<4>(dp, va, g_s, c0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 sq = sts[c0 + 8 * n + 2 * (lane & 3) + (e & 1)];
          const float x = __fadd_rn(__fmul_rn(s[n][e], scale), kbias[e >> 1]);
          const float p = __fmul_rn(expf(__fsub_rn(x, sq.x)), sq.y);
          s[n][e] = p;
          dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], sq.z));
        }
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc_to_a(pa[c], s[2 * c], s[2 * c + 1]);
        acc_to_a(da[c], dp[2 * c], dp[2 * c + 1]);
      }
      mma_ax<2>(dv, pa, g_s, c0, lane);
      mma_ax<2>(dk, da, q_s, c0, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  bf16* gslab = dqkv + (long long)b * S * stride + h * kHeadDim;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 16 * warp + (lane >> 2) + 8 * i;
    if (key >= S) continue;
    bf16* dst = gslab + key * stride + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      Elem<bf16>::store(dst + D + 8 * n, __fmul_rn(dk[n][2 * i], scale),
                        __fmul_rn(dk[n][2 * i + 1], scale));
      Elem<bf16>::store(dst + 2 * D + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}


// ---- any Dh in 64..128 and any S: K, V and the query rows streamed ----------

// acc[n] (n < kN) = A . B^T over kDP columns: A the 16 rows from `ar0` of
// the padded tile at `a`, B's rows the 8*kN rows from `br0` of the padded
// tile at `b` (column n*8 + j of the product is row br0 + n*8 + j).
// For s = q . k^T and dp = do . v^T (kernel A), s^T = k . q^T and
// dp^T = v . do^T (kernel B). A's fragments are loaded per k16 step, which
// keeps them out of the registers the wide accumulators need.
template <int kDP, int kN>
__device__ __forceinline__ void ptile_abt(float (&acc)[kN][4], uint32_t a,
                                          int ar0, uint32_t b, int br0,
                                          int lane) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + prow<kDP>(ar0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int p = 0; p < kN / 2; ++p) {
      uint32_t bf[4];
      ldsm_x4(bf, b + prow<kDP>(br0 + 16 * p + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)));
      mma_bf16(acc[2 * p], af, bf[0], bf[1]);
      mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[n] (n < kDP / 8) += P . X: P is 16 rows x 16*kChunks held as A
// fragments (p[c] covers k rows 16c..16c+15 of X), X's k rows are the rows
// from `r0` of the padded tile at `x`, read transposed. For dq = ds . k,
// dv = p^T . do and dk = ds^T . q.
template <int kDP, int kChunks>
__device__ __forceinline__ void ptile_ax(float (&acc)[kDP / 8][4],
                                         const uint32_t (&p)[kChunks][4],
                                         uint32_t x, int r0, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int d = 0; d < kDP / 16; ++d) {
      uint32_t bv[4];
      ldsm_x4_t(bv, x + prow<kDP>(r0 + 16 * c + (lane & 7) +
                                      (((lane >> 3) & 1) << 3),
                                  2 * d + (lane >> 4)));
      mma_bf16(acc[2 * d], p[c], bv[0], bv[1]);
      mma_bf16(acc[2 * d + 1], p[c], bv[2], bv[3]);
    }
  }
}

// Kernel A at any shape: statistics and dq of 64 query rows. Q and dO stay
// in shared memory; K and V stream through two stages, twice (pass 1: the
// statistics; pass 2: ds and dq), as in the whole-slice kernel A.
template <int kDP>
__global__ void __launch_bounds__(kTcThreads)
slab_attention_bwd_any_dq_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ key_bias,
                                 const bf16* __restrict__ dout,
                                 bf16* __restrict__ dqkv,
                                 float4* __restrict__ stats, int S, int H,
                                 int dh, float scale) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  constexpr uint32_t kTile = tile_bytes(kDP);
  const uint32_t q_s = smem_addr(tc_smem);  // Q, dO, K's 2 and V's 2 stages
  const uint32_t g_s = q_s + kTile;
  const uint32_t k_s = q_s + 2 * kTile;
  const uint32_t v_s = q_s + 4 * kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * dh;
  const long long stride = 3LL * D;
  const bf16* slab = qkv + (long long)b * S * stride + h * dh;
  const bf16* dslab = dout + (long long)b * S * D + h * dh;
  const float* bias = key_bias + (long long)b * S;
  const int tiles = (S + kTcTile - 1) / kTcTile;

  stage_tile<kDP>(q_s, slab, stride, row0, S, dh);
  stage_tile<kDP>(g_s, dslab, D, row0, S, dh);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float inv[2], delta[2];
  float dq[kDP / 8][4] = {};
  for (int pass = 0; pass < 2; ++pass) {
    stage_tile<kDP>(k_s, slab + D, stride, 0, S, dh);
    stage_tile<kDP>(v_s, slab + 2 * D, stride, 0, S, dh);
    cp_async_commit();
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        const uint32_t next = ((t + 1) & 1) * kTile;
        stage_tile<kDP>(k_s + next, slab + D, stride, (t + 1) * kTcTile, S,
                        dh);
        stage_tile<kDP>(v_s + next, slab + 2 * D, stride, (t + 1) * kTcTile,
                        S, dh);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint32_t cur = (t & 1) * kTile;
      const int kb = t * kTcTile;
      float s[8][4], dp[8][4];
      ptile_abt<kDP, 8>(s, q_s, 16 * warp, k_s + cur, 0, lane);
      ptile_abt<kDP, 8>(dp, g_s, 16 * warp, v_s + cur, 0, lane);
      // scaled, then biased (the reference's order); keys past S -inf
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kb + 8 * n + 2 * (lane & 3) + (e & 1);
          const float bj = j < S ? __ldg(bias + j) : -INFINITY;
          s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), bj);
        }
      if (pass == 0) {
        float alpha[2];
        raise_max(s, m, alpha);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] *= alpha[i];
          u[i] *= alpha[i];
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = expf(__fsub_rn(s[n][e], m[e >> 1]));
            l[e >> 1] += x;
            u[e >> 1] = fmaf(x, dp[n][e], u[e >> 1]);
          }
      } else {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float p = __fmul_rn(expf(__fsub_rn(s[n][e], m[i])), inv[i]);
            s[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], delta[i]));
          }
        uint32_t da[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_to_a(da[c], s[2 * c], s[2 * c + 1]);
        ptile_ax<kDP, 4>(dq, da, k_s + cur, 0, lane);
      }
      __syncthreads();  // this stage is refilled two tiles on
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        inv[i] = 1.f / quad_sum(l[i]);
        delta[i] = quad_sum(u[i]) * inv[i];  // rowsum(dp o p), p in fp32
      }
      float4* st = stats + ((long long)b * H + h) * S;
      if ((lane & 3) == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
          if (row < S) st[row] = make_float4(m[i], inv[i], delta[i], 0.f);
        }
      }
    }
  }

  bf16* gslab = dqkv + (long long)b * S * stride + h * dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * i;
    if (row >= S) continue;
    bf16* dst = gslab + row * stride + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kDP / 8; ++n)
      if (8 * n < dh)
        Elem<bf16>::store(dst + 8 * n, __fmul_rn(dq[n][2 * i], scale),
                          __fmul_rn(dq[n][2 * i + 1], scale));
  }
}

// Bytes of one stage of kernel B at any shape: Q, dO and their statistics.
template <int kDP>
__host__ __device__ constexpr uint32_t any_stage_bytes() {
  return 2 * tile_bytes(kDP) + kStatsBytes;
}

// Kernel B at any shape: dk and dv of 64 keys. K and V stay in shared
// memory (their fragments loaded per k16 step); the query rows stream
// through two stages, as in the whole-slice kernel B.
template <int kDP>
__global__ void __launch_bounds__(kTcThreads)
slab_attention_bwd_any_dkv_kernel(const bf16* __restrict__ qkv,
                                  const float* __restrict__ key_bias,
                                  const bf16* __restrict__ dout,
                                  bf16* __restrict__ dqkv,
                                  const float4* __restrict__ stats, int S,
                                  int H, int dh, float scale) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  constexpr uint32_t kTile = tile_bytes(kDP);
  constexpr uint32_t kStage = any_stage_bytes<kDP>();
  const uint32_t k_s = smem_addr(tc_smem);
  const uint32_t v_s = k_s + kTile;
  const uint32_t stages = k_s + 2 * kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * dh;
  const long long stride = 3LL * D;
  const bf16* slab = qkv + (long long)b * S * stride + h * dh;
  const bf16* dslab = dout + (long long)b * S * D + h * dh;
  const float4* st = stats + ((long long)b * H + h) * S;

  // Q, dO and the statistics of query rows r0.. into stage `at` (rows past
  // S zero-filled: their p and ds are 0)
  auto stage_queries = [&](uint32_t at, int r0) {
    stage_tile<kDP>(at, slab, stride, r0, S, dh);
    stage_tile<kDP>(at + kTile, dslab, D, r0, S, dh);
    if (threadIdx.x < kTcTile) {
      const int row = r0 + threadIdx.x;
      cp_async16(at + 2 * kTile + threadIdx.x * 16, row < S ? st + row : st,
                 row < S);
    }
  };
  stage_tile<kDP>(k_s, slab + D, stride, key0, S, dh);
  stage_tile<kDP>(v_s, slab + 2 * D, stride, key0, S, dh);
  stage_queries(stages, 0);
  cp_async_commit();

  // this thread's keys (rows of s^T): gid and gid + 8 of the warp's 16
  float kbias[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 16 * warp + (lane >> 2) + 8 * i;
    kbias[i] = key < S ? key_bias[(long long)b * S + key] : -INFINITY;
  }
  float dk[kDP / 8][4] = {}, dv[kDP / 8][4] = {};
  const int tiles = (S + kTcTile - 1) / kTcTile;
  for (int qt = 0; qt < tiles; ++qt) {
    if (qt + 1 < tiles) {
      stage_queries(stages + ((qt + 1) & 1) * kStage, (qt + 1) * kTcTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t q_s = stages + (qt & 1) * kStage;
    const uint32_t g_s = q_s + kTile;
    const float4* sts = reinterpret_cast<const float4*>(
        tc_smem + (q_s - smem_addr(tc_smem)) + 2 * kTile);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = 32 * half;  // this step's 32 queries in the tile
      float s[4][4], dp[4][4];
      ptile_abt<kDP, 4>(s, k_s, 16 * warp, q_s, c0, lane);
      ptile_abt<kDP, 4>(dp, v_s, 16 * warp, g_s, c0, lane);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 sq = sts[c0 + 8 * n + 2 * (lane & 3) + (e & 1)];
          const float x = __fadd_rn(__fmul_rn(s[n][e], scale), kbias[e >> 1]);
          const float p = __fmul_rn(expf(__fsub_rn(x, sq.x)), sq.y);
          s[n][e] = p;
          dp[n][e] = __fmul_rn(p, __fsub_rn(dp[n][e], sq.z));
        }
      uint32_t pa[2][4], da[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        acc_to_a(pa[c], s[2 * c], s[2 * c + 1]);
        acc_to_a(da[c], dp[2 * c], dp[2 * c + 1]);
      }
      ptile_ax<kDP, 2>(dv, pa, g_s, c0, lane);
      ptile_ax<kDP, 2>(dk, da, q_s, c0, lane);
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

  bf16* gslab = dqkv + (long long)b * S * stride + h * dh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 16 * warp + (lane >> 2) + 8 * i;
    if (key >= S) continue;
    bf16* dst = gslab + key * stride + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kDP / 8; ++n) {
      if (8 * n >= dh) continue;
      Elem<bf16>::store(dst + D + 8 * n, __fmul_rn(dk[n][2 * i], scale),
                        __fmul_rn(dk[n][2 * i + 1], scale));
      Elem<bf16>::store(dst + 2 * D + 8 * n, dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// ---- fp32 at any shape: CUDA-core FMAs, keys streamed ---------------------------

constexpr int kAnyKeys = 64;                // keys per staged tile (kernel A)
constexpr int kAnySlots = kAnyKeys / 32;    // keys a lane takes per tile
constexpr int kAnyRows = kRowsPerBlock / kWarps;  // query rows a warp owns
constexpr int kAnyCols = 128 / 32;          // dq columns a lane owns
constexpr int kDsPitch = kAnyKeys + 1;

// Shared floats of fp32 kernel A at any shape: K and V tiles of 64 rows of
// dh + 1 words (an odd pitch: the 32 rows a warp reads hit 32 banks), the
// block's q and dO rows [32][dh], and ds [32][65].
size_t f32_any_dq_words(int dh) {
  return size_t(2 * kAnyKeys * (dh + 1) + 2 * kRowsPerBlock * dh +
                kRowsPerBlock * kDsPitch);
}

// Copies rows [g, g + n) of a head's dh-wide fp32 slice (row stride
// `stride` elements) into rows of dh + 1 words.
__device__ void stage_any_f32(float* dst, const float* src, long long stride,
                              int g, int n, int dh) {
  for (int idx = threadIdx.x; idx < n * dh; idx += kThreads) {
    const int j = idx / dh;
    const int d = idx - j * dh;
    dst[j * (dh + 1) + d] = __ldg(src + (g + j) * stride + d);
  }
}

// Kernel A: one block per (32 query rows, head, batch row), 8 warps of 4
// rows, lane l taking keys l and l + 32 of each 64-key tile. Pass 1: the
// row max m, sum l and u = sum exp(s - m) dp with an online rescale;
// pass 2: ds = p (dp - u / l) into shared memory, then dq, lane l owning
// columns l, l + 32, ...
__global__ void __launch_bounds__(kThreads)
slab_attention_bwd_f32_any_dq_kernel(const float* __restrict__ qkv,
                                     const float* __restrict__ key_bias,
                                     const float* __restrict__ dout,
                                     float* __restrict__ dqkv,
                                     float4* __restrict__ stats, int S, int H,
                                     int dh, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int pitch = dh + 1;
  float* k_s = fsm;                                  // [64][dh+1]
  float* v_s = k_s + kAnyKeys * pitch;               // [64][dh+1]
  float* q_s = v_s + kAnyKeys * pitch;               // [32][dh]
  float* g_s = q_s + kRowsPerBlock * dh;             // [32][dh]
  float* ds_s = g_s + kRowsPerBlock * dh;            // [32][65]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 * kAnyRows;  // the warp's rows r0..r0+3
  const int D = H * dh;
  const long long stride = 3LL * D;
  const float* slab = qkv + (long long)b * S * stride + h * dh;
  const float* dslab = dout + (long long)b * S * D + h * dh;
  const float* bias = key_bias + (long long)b * S;

  for (int idx = threadIdx.x; idx < kRowsPerBlock * dh; idx += kThreads) {
    const int row = row0 + idx / dh;
    const int d = idx % dh;
    q_s[idx] = row < S ? slab[row * stride + d] : 0.f;
    g_s[idx] = row < S ? dslab[(long long)row * D + d] : 0.f;
  }
  float m[kAnyRows], l[kAnyRows], u[kAnyRows], delta[kAnyRows];
#pragma unroll
  for (int r = 0; r < kAnyRows; ++r) {
    m[r] = -INFINITY;
    l[r] = u[r] = delta[r] = 0.f;
  }
  float dq[kAnyRows][kAnyCols] = {};
  for (int pass = 0; pass < 2; ++pass) {
    for (int g = 0; g < S; g += kAnyKeys) {
      const int n = min(kAnyKeys, S - g);
      __syncthreads();  // the tiles' previous readers are done
      stage_any_f32(k_s, slab + D, stride, g, n, dh);
      stage_any_f32(v_s, slab + 2 * D, stride, g, n, dh);
      __syncthreads();
      float x[kAnyRows][kAnySlots], dp[kAnyRows][kAnySlots];
#pragma unroll
      for (int t = 0; t < kAnySlots; ++t) {
        const int jj = 32 * t + lane;
        float as[kAnyRows] = {}, ad[kAnyRows] = {};
        if (jj < n) {
          for (int d = 0; d < dh; ++d) {
            const float kv = k_s[jj * pitch + d];
            const float vv = v_s[jj * pitch + d];
#pragma unroll
            for (int r = 0; r < kAnyRows; ++r) {
              as[r] = fmaf(q_s[(r0 + r) * dh + d], kv, as[r]);
              ad[r] = fmaf(g_s[(r0 + r) * dh + d], vv, ad[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < kAnyRows; ++r) {
          x[r][t] = jj < n ? __fadd_rn(__fmul_rn(as[r], scale), bias[g + jj])
                           : -INFINITY;
          dp[r][t] = ad[r];
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int r = 0; r < kAnyRows; ++r) {
          // every tile holds a key < S, so the new max is finite
          const float mn = fmaxf(m[r], warp_max(fmaxf(x[r][0], x[r][1])));
          const float alpha = expf(m[r] - mn);
          float el = 0.f, eu = 0.f;
#pragma unroll
          for (int t = 0; t < kAnySlots; ++t) {
            const float e = expf(x[r][t] - mn);  // 0 for keys past S
            el += e;
            eu = fmaf(e, dp[r][t], eu);
          }
          l[r] = l[r] * alpha + warp_sum(el);
          u[r] = u[r] * alpha + warp_sum(eu);
          m[r] = mn;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kAnyRows; ++r)
#pragma unroll
          for (int t = 0; t < kAnySlots; ++t) {
            const float p = expf(x[r][t] - m[r]) / l[r];
            ds_s[(r0 + r) * kDsPitch + 32 * t + lane] =
                p * (dp[r][t] - delta[r]);
          }
        __syncwarp();  // a warp reads only its own ds rows
        for (int jj = 0; jj < n; ++jj) {
#pragma unroll
          for (int r = 0; r < kAnyRows; ++r) {
            const float dsv = ds_s[(r0 + r) * kDsPitch + jj];
#pragma unroll
            for (int i = 0; i < kAnyCols; ++i) {
              const int c = lane + 32 * i;
              if (c < dh) dq[r][i] = fmaf(dsv, k_s[jj * pitch + c], dq[r][i]);
            }
          }
        }
      }
    }
    if (pass == 0) {
      float4* st = stats + ((long long)b * H + h) * S;
#pragma unroll
      for (int r = 0; r < kAnyRows; ++r) {
        delta[r] = u[r] / l[r];  // rowsum(dp o p)
        const int row = row0 + r0 + r;
        if (lane == 0 && row < S)
          st[row] = make_float4(m[r], l[r], delta[r], 0.f);
      }
    }
  }
  float* gslab = dqkv + (long long)b * S * stride + h * dh;
#pragma unroll
  for (int r = 0; r < kAnyRows; ++r) {
    const int row = row0 + r0 + r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < kAnyCols; ++i) {
      const int c = lane + 32 * i;
      if (c < dh) gslab[row * stride + c] = dq[r][i] * scale;
    }
  }
}

// Kernel B: the fp32 dk / dv kernel above at any dh (its shared rows sized by
// dh, a thread owning dims dg, dg + 16, ... below dh). Its query rows
// already stream, so it takes any S.
constexpr int kAnyDims = 128 / 16;  // dims a thread owns in the accumulation

size_t f32_any_dkv_words(int dh) {
  return size_t(4 * kKeyTile * (dh + 1) + 2 * kQueryChunk * kTilePad +
                4 * kQueryChunk);
}

__global__ void __launch_bounds__(kThreads)
slab_attention_bwd_f32_any_dkv_kernel(const float* __restrict__ qkv,
                                      const float* __restrict__ key_bias,
                                      const float* __restrict__ dout,
                                      float* __restrict__ dqkv,
                                      const float4* __restrict__ stats,
                                      int S, int H, int dh, float scale) {
  extern __shared__ __align__(16) float fsm[];
  const int pitch = dh + 1;
  float4* st_s = reinterpret_cast<float4*>(fsm);     // [32]
  float* k_s = fsm + 4 * kQueryChunk;                // [32][dh+1]
  float* v_s = k_s + kKeyTile * pitch;
  float* q_s = v_s + kKeyTile * pitch;
  float* g_s = q_s + kQueryChunk * pitch;
  float* p_s = g_s + kQueryChunk * pitch;            // [32][33]
  float* ds_s = p_s + kQueryChunk * kTilePad;        // [32][33]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kKeyTile;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * dh;
  const long long stride = 3LL * D;
  const float* slab = qkv + (long long)b * S * stride + h * dh;
  const float* dslab = dout + (long long)b * S * D + h * dh;
  const float4* st = stats + ((long long)b * H + h) * S;

  // rows first..first+31 of a dh-wide slice; rows at or past S are zero
  auto stage = [&](float* dst, const float* src, long long rs, int first) {
    for (int idx = threadIdx.x; idx < 32 * dh; idx += kThreads) {
      const int r = idx / dh;
      const int d = idx - r * dh;
      const int row = first + r;
      dst[r * pitch + d] = row < S ? src[row * rs + d] : 0.f;
    }
  };
  stage(k_s, slab + D, stride, key0);
  stage(v_s, slab + 2 * D, stride, key0);
  const int key = key0 + lane;
  const float bias_j = key < S ? key_bias[(long long)b * S + key] : 0.f;
  const int dg = threadIdx.x % 16;
  const int kg = threadIdx.x / 16;
  float dk[2][kAnyDims] = {}, dv[2][kAnyDims] = {};

  for (int i0 = 0; i0 < S; i0 += kQueryChunk) {
    __syncthreads();  // the previous chunk's accumulation is done with q_s..
    stage(q_s, slab, stride, i0);
    stage(g_s, dslab, D, i0);
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
        const float* qi = q_s + i * pitch;
        const float* gi = g_s + i * pitch;
        const float* kj = k_s + lane * pitch;
        const float* vj = v_s + lane * pitch;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < dh; ++d) {
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
      for (int c = 0; c < kAnyDims; ++c) {
        const int d = dg + 16 * c;
        if (d >= dh) break;
        const float g = g_s[i * pitch + d];
        const float q = q_s[i * pitch + d];
        dv[0][c] = fmaf(p0, g, dv[0][c]);
        dv[1][c] = fmaf(p1, g, dv[1][c]);
        dk[0][c] = fmaf(d0, q, dk[0][c]);
        dk[1][c] = fmaf(d1, q, dk[1][c]);
      }
    }
  }

  float* gslab = dqkv + (long long)b * S * stride + h * dh;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int j = key0 + 2 * kg + kk;
    if (j >= S) continue;
    float* row = gslab + j * stride;
#pragma unroll
    for (int c = 0; c < kAnyDims; ++c) {
      const int d = dg + 16 * c;
      if (d >= dh) break;
      row[D + d] = dk[kk][c] * scale;
      row[2 * D + d] = dv[kk][c];
    }
  }
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

cudaError_t launch_bwd_f32(const float* qkv, const float* kb,
                           const float* dout, float* dqkv, float4* stats,
                           int B, int S, int H, float scale,
                           cudaStream_t stream) {
  const size_t smem = size_t(S) * Elem<float>::kRowWords * 4 +
                      size_t(kRowsPerBlock) * S * 4;
  cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_bwd_dq_kernel<float>),
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid_a((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  slab_attention_bwd_dq_kernel<float><<<grid_a, kThreads, smem, stream>>>(
      qkv, kb, dout, dqkv, stats, S, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_b((S + kKeyTile - 1) / kKeyTile, H, B);
  slab_attention_bwd_dkv_kernel<float><<<grid_b, kThreads, 0, stream>>>(
      qkv, kb, dout, dqkv, stats, S, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_tc(const bf16* qkv, const float* kb, const bf16* dout,
                          bf16* dqkv, float4* stats, int B, int S, int H,
                          float scale, cudaStream_t stream) {
  const size_t smem_a = tc_smem_bytes(2, S);
  cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_bwd_tc_dq_kernel), smem_a);
  if (e != cudaSuccess) return e;
  e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_bwd_tc_dkv_kernel),
      kDkvSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  slab_attention_bwd_tc_dq_kernel<<<grid, kTcThreads, smem_a, stream>>>(
      qkv, kb, dout, dqkv, stats, S, H, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  slab_attention_bwd_tc_dkv_kernel<<<grid, kTcThreads, kDkvSmem, stream>>>(
      qkv, kb, dout, dqkv, stats, S, H, scale);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32_any(const float* qkv, const float* kb,
                               const float* dout, float* dqkv, float4* stats,
                               int B, int S, int H, int dh, float scale,
                               cudaStream_t stream) {
  const size_t smem_a = f32_any_dq_words(dh) * 4;
  const size_t smem_b = f32_any_dkv_words(dh) * 4;
  cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_bwd_f32_any_dq_kernel),
      smem_a);
  if (e != cudaSuccess) return e;
  e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_bwd_f32_any_dkv_kernel),
      smem_b);
  if (e != cudaSuccess) return e;
  const dim3 grid_a((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  slab_attention_bwd_f32_any_dq_kernel<<<grid_a, kThreads, smem_a, stream>>>(
      qkv, kb, dout, dqkv, stats, S, H, dh, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid_b((S + kKeyTile - 1) / kKeyTile, H, B);
  slab_attention_bwd_f32_any_dkv_kernel<<<grid_b, kThreads, smem_b,
                                          stream>>>(qkv, kb, dout, dqkv,
                                                    stats, S, H, dh, scale);
  return cudaGetLastError();
}

template <int kDP>
cudaError_t launch_bwd_tc_any(const bf16* qkv, const float* kb,
                              const bf16* dout, bf16* dqkv, float4* stats,
                              int B, int S, int H, int dh, float scale,
                              cudaStream_t stream) {
  const size_t smem_a = 6 * size_t(tile_bytes(kDP));
  const size_t smem_b = 2 * size_t(tile_bytes(kDP)) +
                        2 * size_t(any_stage_bytes<kDP>());
  cudaError_t e = allow_smem(reinterpret_cast<const void*>(
                                 slab_attention_bwd_any_dq_kernel<kDP>),
                             smem_a);
  if (e != cudaSuccess) return e;
  e = allow_smem(reinterpret_cast<const void*>(
                     slab_attention_bwd_any_dkv_kernel<kDP>),
                 smem_b);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  slab_attention_bwd_any_dq_kernel<kDP><<<grid, kTcThreads, smem_a, stream>>>(
      qkv, kb, dout, dqkv, stats, S, H, dh, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  slab_attention_bwd_any_dkv_kernel<kDP>
      <<<grid, kTcThreads, smem_b, stream>>>(qkv, kb, dout, dqkv, stats, S, H,
                                             dh, scale);
  return cudaGetLastError();
}

// The bf16 bodies: the whole-slice ones at Dh = 64 and S <= 512, the
// streamed ones at
// Dh padded to a multiple of 16 elsewhere.
cudaError_t launch_bwd_bf16(const bf16* qkv, const float* kb,
                            const bf16* dout, bf16* dqkv, float4* stats,
                            int B, int S, int H, int dh, float scale,
                            cudaStream_t stream) {
  if (dh == kHeadDim && S <= kMaxSeq)
    return launch_bwd_tc(qkv, kb, dout, dqkv, stats, B, S, H, scale, stream);
  switch ((dh + 15) / 16) {
    case 4:
      return launch_bwd_tc_any<64>(qkv, kb, dout, dqkv, stats, B, S, H, dh,
                                   scale, stream);
    case 5:
      return launch_bwd_tc_any<80>(qkv, kb, dout, dqkv, stats, B, S, H, dh,
                                   scale, stream);
    case 6:
      return launch_bwd_tc_any<96>(qkv, kb, dout, dqkv, stats, B, S, H, dh,
                                   scale, stream);
    case 7:
      return launch_bwd_tc_any<112>(qkv, kb, dout, dqkv, stats, B, S, H, dh,
                                    scale, stream);
    case 8:
      return launch_bwd_tc_any<128>(qkv, kb, dout, dqkv, stats, B, S, H, dh,
                                    scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. `qkv` is a contiguous
// [B, S, 3*H*head_dim] tensor, `key_bias` a contiguous fp32 [B, S] tensor
// (zeros where nothing is masked), `dout` a contiguous [B, S, H*head_dim]
// tensor of the slab's dtype, `dqkv` a contiguous tensor shaped and typed as
// `qkv`, `stats` a 16-byte aligned fp32 scratch of B*H*S*4 floats. dtype:
// 0 = float32, 1 = bfloat16; head_dim a multiple of 8 from 64 to 128, any
// S. Launches kernel A then kernel B on `stream` and returns the
// cudaError_t of the launches.
extern "C" int keep_attention_qkv_slab_bwd(const void* qkv,
                                           const void* key_bias,
                                           const void* dout, void* dqkv,
                                           void* stats, int B, int S, int H,
                                           int head_dim, int dtype,
                                           float scale, void* stream) {
  if (head_dim % 8 || head_dim < 64 || head_dim > 128 || S < 1 || H < 1 ||
      B < 1 || B > 65535 || H > 65535 || key_bias == nullptr)
    return int(cudaErrorInvalidValue);
  const bool narrow = head_dim == kHeadDim && S <= kMaxSeq;  // the whole-slice bodies
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(key_bias);
  float4* stt = static_cast<float4*>(stats);
  switch (dtype) {
    case 0:
      if (!narrow)
        return int(launch_bwd_f32_any(
            static_cast<const float*>(qkv), kb,
            static_cast<const float*>(dout), static_cast<float*>(dqkv), stt,
            B, S, H, head_dim, scale, st));
      return int(launch_bwd_f32(
          static_cast<const float*>(qkv), kb, static_cast<const float*>(dout),
          static_cast<float*>(dqkv), stt, B, S, H, scale, st));
    case 1:
      return int(launch_bwd_bf16(
          static_cast<const bf16*>(qkv), kb, static_cast<const bf16*>(dout),
          static_cast<bf16*>(dqkv), stt, B, S, H, head_dim, scale, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
