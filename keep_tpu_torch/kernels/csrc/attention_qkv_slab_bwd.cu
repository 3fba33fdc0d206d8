// Backward of the fused multi-head attention over the unsplit qkv slab, for
// Hopper (sm_90a): the C entry point and the fp32 bodies.
//
// Replaces keep_tpu/kernels/flash_attention.py `_slab_attn_bwd` (:221-245),
// the closed-form VJP that `jax.custom_vjp` attaches to the Pallas forward
// (`_slab_attn_fwd_kernel`, pallas_call at :190). Both KEEP towers reach it
// through `attention_qkv_slab` whenever a block's parameters train.
//
// What it computes, per batch row b and head h, with q/k/v the Dh-wide
// column slices of qkv[B, S, 3*H*Dh] and do the slice of dout[B, S, H*Dh]:
//   s  = (q . k^T) * Dh^-0.5 + key_bias[b, :]
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
// Kernel A runs per query tile and writes each row's statistics (max, the
// sum or its inverse, rowsum(dp o p)) to an fp32 [B, H, S] x 4 scratch,
// and dq; kernel B runs per key tile, rebuilds p and ds from the
// statistics and writes dk and dv.
//
// bf16 (dtype 1), at every Dh and S: kernels A and B on wgmma fed by TMA,
// attention_qkv_slab_bwd_dq.cu and attention_qkv_slab_bwd_dkv.cu, whose
// heads set out their design; this file writes their TMA maps and launches
// them. p and ds are rounded to bf16 only as operands of their products
// (dv = p^T . do, dq = ds . k, dk = ds^T . q), a departure from the JAX
// package's fp32 products that stays inside the bf16 gate (max |d| <=
// 1e-2 * max |plain|; the CPU model of this rounding,
// tests/card_attention_model.py `card_body_attention_bwd`, is held to the
// JAX VJP in tests/test_torch_attention_grad.py).
//
// fp32 (dtype 0): exact CUDA-core bodies (scalar FMAs), whose gate is atol
// 2e-4 / rtol 1e-4. At Dh = 64 and S <= 512 kernel A keeps the whole K and
// V slices of a head in shared memory (32 query rows a block, the row of
// p and ds in shared memory) and kernel B takes 32 keys a block with the
// query rows in chunks of 32; at every other Dh in 64..128 (multiples of
// 8) and S, kernel A, one block per 32 query rows, streams K and V in
// 64-key tiles twice (an online max / sum in pass 1; ds through shared
// memory into dq in pass 2) and kernel B is the first kernel B with its
// rows sized by Dh.

#include "wgmma_attention.cuh"

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

// The bf16 form: kernel A then kernel B on wgmma, their operands through
// TMA maps of the slab's q, k and v lanes, of dout and of the statistics,
// in boxes of kTileKeys rows; cudaErrorNotSupported when libcuda has no
// TMA encoder or refuses a map.
cudaError_t launch_bwd_bf16(const bf16* qkv, const float* kb,
                            const bf16* dout, bf16* dqkv, float4* stats,
                            int B, int S, int H, int dh, float scale,
                            cudaStream_t stream) {
  if (!aligned16(qkv) || !aligned16(dout) || !aligned16(dqkv) ||
      !aligned16(stats))
    return cudaErrorInvalidValue;
  const long long D = (long long)H * dh;
  keep_attn::BwdArgs a;
  if (!head_map(&a.q, qkv, S * 3 * D, dh, 3 * D, B, S, H, dh, kTileKeys) ||
      !head_map(&a.k, qkv + D, S * 3 * D, dh, 3 * D, B, S, H, dh,
                kTileKeys) ||
      !head_map(&a.v, qkv + 2 * D, S * 3 * D, dh, 3 * D, B, S, H, dh,
                kTileKeys) ||
      !head_map(&a.dout, dout, S * D, dh, D, B, S, H, dh, kTileKeys) ||
      !stats_map(&a.stats_map, stats, B, S, H))
    return cudaErrorNotSupported;
  a.key_bias = kb;
  a.stats = stats;
  a.dqkv = dqkv;
  a.B = B;
  a.S = S;
  a.H = H;
  a.dh = dh;
  a.scale = scale;
  a.stream = stream;
  const cudaError_t e = keep_attn::launch_bwd_dq(a);
  if (e != cudaSuccess) return e;
  return keep_attn::launch_bwd_dkv(a);
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
  // the fp32 whole-slice bodies
  const bool narrow = head_dim == kHeadDim && S <= kMaxSeq;
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
