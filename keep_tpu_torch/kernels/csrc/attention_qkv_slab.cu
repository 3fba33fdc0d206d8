// Fused multi-head attention for Hopper (sm_90a), over the unsplit qkv slab,
// over split q, k and v, or over [B, H, S, Dh] heads.
//
// Replaces two TPU kernels of keep_tpu/kernels/flash_attention.py, which
// share the body `_sdpa` (:43-56):
//   - `_slab_attn_fwd_kernel` (pallas_call at :190), reached through
//     `attention_qkv_slab` from every ViT block under use_flash and from
//     KEEP's BERT: q, k and v are Dh-wide column slices of one slab
//     qkv[B, S, 3*H*Dh];
//   - `attention_qkv_heads` (pallas_call at :115), wrapped by
//     `flash_attention` (:251) and `ops.nn.mha_attention(use_flash=True)`:
//     q, k and v are three [B, S, H*Dh] tensors, or (flash_attention) three
//     [B, H, S, Dh] ones, handed over as they are. The TPU kernel takes a
//     group of heads per program; here every (query tile, head) is a block,
//     so the group changes nothing.
// One kernel body serves all three layouts: it reads q, k and v through
// three base pointers and one set of element strides (batch, head, row), so
// the entry points give the same bits on the same values.
//
// What it computes, per batch row b and head h:
//   s = (q . k^T) in fp32 * Dh^-0.5 + key_bias[b, :]        (fp32)
//   p = exp(s - rowmax(s)) / rowsum(...), then cast to the input dtype
//   o = p . v accumulated in fp32, cast to the output dtype -> out[B, S, H*Dh]
// The cast of p happens after the normalisation, as on the TPU. The output
// dtype is the input's, or fp32 for a bf16 input: that form replaces the
// attention inside the int8 megakernels, keep_tpu/kernels/qblock.py `_sdpa`
// / `_sdpa_masked` (:36-44, :131-139, in the pallas_calls at :79 and
// :182), which return the fp32 sum into an fp32 scratch that is quantized
// without a bf16 round.
//
// Shapes: every form takes every head width that is a multiple of 8 from
// 64 to 128 (the OpenCLIP zoo: 64, 80 for ViT-H, 88 for ViT-g and EVA01-g,
// 104 for ViT-bigG, 112 for ViT-e) and any S (577 for ViT-L-14-336, 785
// for KEEP's ViT-L/16 at 448^2).
//
// This file holds the entry point and the fp32 bodies. The bf16 input, with
// a bf16 or an fp32 output, goes to the wgmma bodies fed by TMA in
// attention_qkv_slab_wgmma.cu (one pass over the keys at Dh = 64 and
// S <= 320, K and V streamed through a ring elsewhere), which say what
// bounds them and how they are built.
//
// fp32 -> fp32 stays on the CUDA cores: its gate is the plain version's
// bits where PyTorch's warp softmax serves the row (S <= 1024; 2e-5 past
// it), and those bits come from its order of sums (a chain of fp32 FMAs
// per score and per output over d and over the keys in order; PyTorch's
// warp softmax: lane l sums keys l, l + 32, ... in order, then a
// butterfly; p normalised by division before p . v; expf). The tensor
// cores sum a product's terms in an order of their own, even in split
// TF32 (the fp32 backward's route, whose gate is a tolerance), so they
// cannot give those bits. What bounds the body is the CUDA cores' 67
// TFLOP/s for the 4 * S^2 * Dh FLOPs a head (0.30 ms at ViT-L B = 128).
//
// Where a block's scores fit in shared memory (`attention_f32_kept_kernel`:
// S up to 1,440 at Dh 64, 1,120 at Dh 128), each score is taken once and
// kept. One block per (32 query rows, head, batch row), 8 warps; the
// block's scores [32][S] stay in shared memory (129 KB at S = 1024), K and
// then V stream through 128-key stages by cp.async (two where they fit,
// so that the next tile loads while this one is summed). A lane owns a
// 4 x 4 tile: of scores (4 rows x 4 keys; 16 bytes of q and of k a load,
// 8 loads to 64 FMAs, no bank conflict: rows of Dh + 4 words), then of
// outputs (4 rows x 4 columns; p and v 16 bytes a load). Between them each
// warp takes its 4 rows' max, e = exp(s - m) in place with their sum, and
// p = e / sum in place. What it meets first is shared memory: 8 loads of
// 16 bytes to 64 FMAs feed an SM's FMA units at about half their rate;
// larger tiles would need more rows a block than the kept scores leave
// room for.
// Longer rows (`attention_f32_kernel`): the streamed three-pass body, 32 query
// rows a block, 8 warps of 4 rows, K (then V) staged 128 rows at a time:
// the row max, the row sum, then p (rounded after the division) into
// shared p^T and p . v, the scores recomputed each pass so that shared
// memory does not grow with S. Past S = 1024 PyTorch's block softmax
// serves the plain version's rows and sums in another order, so the gate
// there is 2e-5 for either body.

#include <atomic>

#include "slab_attention.cuh"

// The bf16 bodies, bf16 or fp32 out (attention_qkv_slab_wgmma.cu).
cudaError_t keep_attention_wgmma(const void* q, const void* k, const void* v,
                                 long long batch_stride,
                                 long long head_stride, long long row_stride,
                                 const float* key_bias, void* out,
                                 int out_f32, int B, int S, int H, int dh,
                                 float scale, cudaStream_t stream);

namespace {

constexpr int kMinHeadDim = 64;
constexpr int kMaxHeadDim = 128;

// ---- fp32: CUDA-core FMAs ------------------------------------------------------

constexpr int kWarpRows = kRowsPerBlock / kWarps;  // query rows a warp owns
constexpr int kPtStride = kRowsPerBlock + 4;        // floats per row of p^T
constexpr int kCcKeys = 128;                        // keys per staged tile
constexpr int kCcSlots = kCcKeys / 32;              // keys per lane per tile
constexpr int kCcCols = kMaxHeadDim / 32;           // output columns a lane owns
static_assert(kWarpRows == 4, "p^T rows are stored as one float4");

// Shared memory of the fp32 body, in words: a K (or V) tile of 128 rows of
// dh + 1 words (an odd pitch: the 32 rows a warp reads hit 32 banks),
// rounded up to 16 bytes; p^T [128][36] (16-byte rows, so a quarter warp's
// float4 accesses hit 32 banks); the block's q rows [32][dh].
size_t f32_smem_words(int dh) {
  return size_t((kCcKeys * (dh + 1) + 3) & ~3) + kCcKeys * kPtStride +
         kRowsPerBlock * dh;
}

// Copies rows [g, g + n) of a head's dh-wide fp32 slice (row stride
// `stride` elements) into rows of dh + 1 words, with 16-byte global loads.
__device__ void stage_f32(float* dst, const float* src, long long stride,
                          int g, int n, int dh) {
  const int chunks = dh / 4;
  for (int idx = threadIdx.x; idx < n * chunks; idx += kThreads) {
    const int j = idx / chunks;
    const int c = idx - j * chunks;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        src + (g + j) * stride + 4 * c));
    float* d = dst + j * (dh + 1) + 4 * c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// The scaled, biased scores of the warp's 4 rows (q rows r0..r0+3 of q_s)
// against this lane's keys of the staged tile (tile rows 32t + lane, keys
// g + 32t + lane), each a chain of FMAs over d in order, as the plain
// version's GEMM sums it. Keys at or past S are left out.
__device__ void f32_scores(float (&x)[kWarpRows][kCcSlots], const float* q_s,
                           const float* k_s, int r0, int lane, int g, int S,
                           int dh, const float* __restrict__ bias,
                           float scale) {
  float acc[kWarpRows][kCcSlots] = {};
#pragma unroll 2
  for (int d = 0; d < dh; d += 2) {
    float2 q[kWarpRows];
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r)
      q[r] = *reinterpret_cast<const float2*>(q_s + (r0 + r) * dh + d);
#pragma unroll
    for (int t = 0; t < kCcSlots; ++t) {
      const int jj = 32 * t + lane;
      if (g + jj < S) {
        const float a = k_s[jj * (dh + 1) + d];
        const float bb = k_s[jj * (dh + 1) + d + 1];
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          acc[r][t] = fmaf(q[r].x, a, acc[r][t]);
          acc[r][t] = fmaf(q[r].y, bb, acc[r][t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kCcSlots; ++t) {
    const int j = g + 32 * t + lane;
    const float bj = (bias && j < S) ? bias[j] : 0.f;
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      x[r][t] = __fmul_rn(acc[r][t], scale);
      if (bias) x[r][t] = __fadd_rn(x[r][t], bj);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q_base,
                     const float* __restrict__ k_base,
                     const float* __restrict__ v_base, Strides st,
                     const float* __restrict__ key_bias,
                     float* __restrict__ out, int S, int H, int dh,
                     float scale) {
  extern __shared__ __align__(16) float fsmem[];
  float* kv_s = fsmem;                                           // [128][dh+1]
  float* p_t = fsmem + ((kCcKeys * (dh + 1) + 3) & ~3);          // [128][36]
  float* q_s = p_t + kCcKeys * kPtStride;                        // [32][dh]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 * kWarpRows;  // the warp's rows r0..r0+3
  const long long head = b * st.batch + h * st.head;
  const float* bias = key_bias ? key_bias + (long long)b * S : nullptr;

  // the block's q rows (zeros past S) -> shared memory
  for (int idx = threadIdx.x; idx < kRowsPerBlock * dh; idx += kThreads) {
    const int row = row0 + idx / dh;
    q_s[idx] = row < S ? q_base[head + row * st.row + idx % dh] : 0.f;
  }

  // Passes 1 and 2: the row max m, then the row sum of exp(s - m), each
  // lane over its keys in order, then across the warp.
  float m[kWarpRows], sum[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    m[r] = -INFINITY;
    sum[r] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int g = 0; g < S; g += kCcKeys) {
      __syncthreads();  // the tile's previous readers are done
      stage_f32(kv_s, k_base + head, st.row, g, min(kCcKeys, S - g), dh);
      __syncthreads();
      float x[kWarpRows][kCcSlots];
      f32_scores(x, q_s, kv_s, r0, lane, g, S, dh, bias, scale);
#pragma unroll
      for (int t = 0; t < kCcSlots; ++t) {
        if (g + 32 * t + lane >= S) continue;
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          if (pass == 0)
            m[r] = fmaxf(m[r], x[r][t]);
          else
            sum[r] += expf(x[r][t] - m[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      if (pass == 0)
        m[r] = warp_max(m[r]);
      else
        sum[r] = warp_sum(sum[r]);
    }
  }

  // Pass 3: p = exp(s - m) / sum per staged tile into p^T, then V over it;
  // lane l owns output columns l, l + 32, ..., each a chain of FMAs over the
  // keys in order.
  float o[kWarpRows][kCcCols] = {};
  for (int g = 0; g < S; g += kCcKeys) {
    const int n = min(kCcKeys, S - g);
    __syncthreads();
    stage_f32(kv_s, k_base + head, st.row, g, n, dh);
    __syncthreads();
    float x[kWarpRows][kCcSlots];
    f32_scores(x, q_s, kv_s, r0, lane, g, S, dh, bias, scale);
#pragma unroll
    for (int t = 0; t < kCcSlots; ++t) {
      const int jj = 32 * t + lane;
      if (jj < n)
        *reinterpret_cast<float4*>(p_t + jj * kPtStride + r0) = make_float4(
            expf(x[0][t] - m[0]) / sum[0], expf(x[1][t] - m[1]) / sum[1],
            expf(x[2][t] - m[2]) / sum[2], expf(x[3][t] - m[3]) / sum[3]);
    }
    __syncthreads();
    stage_f32(kv_s, v_base + head, st.row, g, n, dh);
    __syncthreads();
    for (int jj = 0; jj < n; ++jj) {
      const float4 p = *reinterpret_cast<const float4*>(p_t + jj * kPtStride +
                                                        r0);
      const float pr[kWarpRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int i = 0; i < kCcCols; ++i) {
        const int c = lane + 32 * i;
        if (c < dh) {
          const float vv = kv_s[jj * (dh + 1) + c];
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) o[r][i] = fmaf(pr[r], vv, o[r][i]);
        }
      }
    }
  }
  const int D = H * dh;
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = row0 + r0 + r;
    if (row >= S) continue;
#pragma unroll
    for (int i = 0; i < kCcCols; ++i) {
      const int c = lane + 32 * i;
      if (c < dh) out[((long long)b * S + row) * D + h * dh + c] = o[r][i];
    }
  }
}

// ---- fp32: the scores kept -----------------------------------------------------

constexpr int kKeptKeys = 128;     // keys of a staged K or V tile
constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block may take

// Floats of a staged row (an odd number of 16-byte chunks: the 8
// consecutive rows a warp reads hit 8 distinct chunks of banks).
__host__ __device__ inline int kept_pitch(int dh) { return dh + 4; }

// Floats of a row of kept scores: S rounded up to 32, plus 8 (the 4 rows a
// warp writes or reads at once fall 8 banks apart).
__host__ __device__ inline int kept_score_pitch(int S) {
  return (S + 31) / 32 * 32 + 8;
}

// Shared memory of the kept body, in words: q rows [32][dh + 4], `stages`
// K / V stages [128][dh + 4], the scores [32][S + ...].
size_t kept_smem_words(int dh, int S, int stages) {
  return size_t(kept_pitch(dh)) * (kRowsPerBlock + stages * kKeptKeys) +
         size_t(kRowsPerBlock) * kept_score_pitch(S);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   uint32_t(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Rows [g, g + 128) of a head's dh-wide fp32 slice (row stride `stride`
// elements) into rows of dh + 4 words by cp.async, 16 bytes a thread, in
// this thread's newest group; rows at or past S are zero-filled without a
// read.
__device__ void stage_kept(float* dst, const float* src, long long stride,
                           int g, int S, int dh) {
  const int chunks = dh / 4;
  for (int idx = threadIdx.x; idx < kKeptKeys * chunks; idx += kThreads) {
    const int j = idx / chunks;
    const int c = idx - j * chunks;
    const bool valid = g + j < S;
    cp_async16(dst + j * kept_pitch(dh) + 4 * c,
               src + (valid ? (g + j) * stride : 0) + 4 * c, valid);
  }
  cp_async_commit();
}

// `stages`: 2 (the next tile loads while this one is summed) where they
// fit beside the scores, else 1.
__global__ void __launch_bounds__(kThreads)
attention_f32_kept_kernel(const float* __restrict__ q_base,
                          const float* __restrict__ k_base,
                          const float* __restrict__ v_base, Strides st,
                          const float* __restrict__ key_bias,
                          float* __restrict__ out, int S, int H, int dh,
                          float scale, int stages) {
  extern __shared__ __align__(16) float fsmem[];
  const int P = kept_pitch(dh);
  const int SP = kept_score_pitch(S);
  float* q_s = fsmem;                             // [32][P]
  float* kv_s = q_s + kRowsPerBlock * P;          // stages x [128][P]
  float* sc = kv_s + stages * kKeptKeys * P;      // [32][SP]: s, then p

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long head = b * st.batch + h * st.head;
  const float* bias = key_bias ? key_bias + (long long)b * S : nullptr;
  const int tiles = (S + kKeptKeys - 1) / kKeptKeys;

  // item i: K tile i, then (i >= tiles) V tile i - tiles, into stage
  // i % stages
  auto issue = [&](int i) {
    const bool v = i >= tiles;
    stage_kept(kv_s + (i % stages) * kKeptKeys * P,
               (v ? v_base : k_base) + head, st.row,
               (v ? i - tiles : i) * kKeptKeys, S, dh);
  };
  issue(0);
  // the block's q rows (zeros past S)
  const int chunks = dh / 4;
  for (int idx = threadIdx.x; idx < kRowsPerBlock * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int c = idx - r * chunks;
    *reinterpret_cast<float4*>(q_s + r * P + 4 * c) =
        row0 + r < S ? __ldg(reinterpret_cast<const float4*>(
                           q_base + head + (row0 + r) * st.row + 4 * c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // a lane's 4 x 4 tile: scores of rows rr + 4i, keys kk + 8j of a K tile;
  // then outputs of rows rr + 4i, columns cc .. cc + 3 (warps whose columns
  // start past Dh idle)
  const int rr = 16 * (warp & 1) + (lane >> 3);
  const int kk = 32 * (warp >> 1) + (lane & 7);
  const int cc = 32 * (warp >> 1) + 4 * (lane & 7);
  float o[4][4] = {};

#pragma unroll 1
  for (int i = 0; i < 2 * tiles; ++i) {
    if (stages == 2) {
      if (i + 1 < 2 * tiles)
        issue(i + 1);
      else
        cp_async_commit();
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // item i
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* tile = kv_s + (i % stages) * kKeptKeys * P;
    if (i < tiles && i * kKeptKeys + 32 * (warp >> 1) < S) {
      // each score a chain of FMAs over d in order, as the plain version's
      // GEMM sums it (a warp whose 32 keys all lie past S has none)
      const int g = i * kKeptKeys;
      float acc[4][4] = {};
      const float* qr = q_s + rr * P;
      const float* kr = tile + kk * P;
#pragma unroll 2
      for (int d = 0; d < dh; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          qv[r] = *reinterpret_cast<const float4*>(qr + 4 * r * P + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(kr + 8 * j * P + d);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[r][j] = fmaf(qv[r].x, kv[j].x, acc[r][j]);
            acc[r][j] = fmaf(qv[r].y, kv[j].y, acc[r][j]);
            acc[r][j] = fmaf(qv[r].z, kv[j].z, acc[r][j]);
            acc[r][j] = fmaf(qv[r].w, kv[j].w, acc[r][j]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = g + kk + 8 * j;
        if (key >= S) continue;
        const float bj = bias ? bias[key] : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float x = __fmul_rn(acc[r][j], scale);
          if (bias) x = __fadd_rn(x, bj);
          sc[(rr + 4 * r) * SP + key] = x;
        }
      }
    } else if (i >= tiles) {
      if (i == tiles) {
        // warp w's rows 4w .. 4w + 3: the max, e = exp(s - m) in place and
        // their sum (lane l over keys l, l + 32, ... in order, then the
        // butterfly), then p = e / sum in place
        for (int r = 4 * warp; r < 4 * warp + 4 && row0 + r < S; ++r) {
          float* x = sc + r * SP;
          float m = -INFINITY;
          for (int j = lane; j < S; j += 32) m = fmaxf(m, x[j]);
          m = warp_max(m);
          float sum = 0.f;
          for (int j = lane; j < S; j += 32) {
            const float e = expf(x[j] - m);
            x[j] = e;
            sum += e;
          }
          sum = warp_sum(sum);
          for (int j = lane; j < S; j += 32) x[j] = x[j] / sum;
        }
        __syncthreads();
      }
      // p . v over the tile's keys in order: each output a chain of FMAs
      const int g = (i - tiles) * kKeptKeys;
      const int n = min(kKeptKeys, S - g);
      if (cc < dh) {
        const float* pr = sc + rr * SP + g;
        int j = 0;
        for (; j + 4 <= n; j += 4) {
          float4 pv[4], vv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pv[r] = *reinterpret_cast<const float4*>(pr + 4 * r * SP + j);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            vv[e] = *reinterpret_cast<const float4*>(tile + (j + e) * P + cc);
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float pe = e == 0   ? pv[r].x
                               : e == 1 ? pv[r].y
                               : e == 2 ? pv[r].z
                                        : pv[r].w;
              o[r][0] = fmaf(pe, vv[e].x, o[r][0]);
              o[r][1] = fmaf(pe, vv[e].y, o[r][1]);
              o[r][2] = fmaf(pe, vv[e].z, o[r][2]);
              o[r][3] = fmaf(pe, vv[e].w, o[r][3]);
            }
        }
        for (; j < n; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(tile + j * P + cc);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float pe = pr[4 * r * SP + j];
            o[r][0] = fmaf(pe, vv.x, o[r][0]);
            o[r][1] = fmaf(pe, vv.y, o[r][1]);
            o[r][2] = fmaf(pe, vv.z, o[r][2]);
            o[r][3] = fmaf(pe, vv.w, o[r][3]);
          }
        }
      }
    }
    __syncthreads();  // the stage's readers are done before it refills
    if (stages == 1 && i + 1 < 2 * tiles) issue(i + 1);
  }
  if (cc >= dh) return;
  const int D = H * dh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = row0 + rr + 4 * r;
    if (row < S)
      *reinterpret_cast<float4*>(out + ((long long)b * S + row) * D +
                                 h * dh + cc) =
          make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
  }
}

// ---- launches -------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Lets `kernel` take `bytes` of dynamic shared memory: past 48 KB its limit
// is raised to kMaxSmem on the current card, once per card (`done` is the
// launcher's own table, one flag per device). No driver call per launch, and
// a launch from another thread never lowers the limit under this one.
cudaError_t allow_smem(const void* kernel, size_t bytes,
                       std::atomic<int> (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return cudaErrorInvalidDevice;
  if (done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kMaxSmem));
  if (e == cudaSuccess) done[dev].store(1, std::memory_order_release);
  return e;
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       Strides st, const float* key_bias, float* out, int B,
                       int S, int H, int dh, float scale,
                       cudaStream_t stream) {
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  if (kept_smem_words(dh, S, 1) * 4 <= kMaxSmem) {
    const int stages = kept_smem_words(dh, S, 2) * 4 <= kMaxSmem ? 2 : 1;
    const size_t smem = kept_smem_words(dh, S, stages) * 4;
    static std::atomic<int> kept_allowed[kMaxDevices];
    const cudaError_t e = allow_smem(
        reinterpret_cast<const void*>(attention_f32_kept_kernel), smem,
        kept_allowed);
    if (e != cudaSuccess) return e;
    attention_f32_kept_kernel<<<grid, kThreads, smem, stream>>>(
        q, k, v, st, key_bias, out, S, H, dh, scale, stages);
    return cudaGetLastError();
  }
  const size_t smem = f32_smem_words(dh) * 4;
  static std::atomic<int> allowed[kMaxDevices];
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(attention_f32_kernel), smem, allowed);
  if (e != cudaSuccess) return e;
  attention_f32_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, st, key_bias, out, S, H, dh, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes; returns the cudaError_t of the
// launch. `q`, `k` and `v` point at element (b=0, h=0, row 0, column 0) of
// each operand; row j of head h of batch row b starts at b * batch_stride +
// h * head_stride + j * row_stride elements, each 16-byte aligned, and its
// head_dim elements are contiguous. The slab passes qkv, qkv + D, qkv + 2D
// with strides (S*3D, head_dim, 3D); split q, k, v [B, S, D] pass
// (S*D, head_dim, D); [B, H, S, head_dim] heads pass their own strides.
// `key_bias` is a contiguous fp32 [B, S] tensor or null, `out` a contiguous
// [B, S, H*head_dim] tensor. dtype: 0 = float32 in and out, 1 = bfloat16 in
// and out, 2 = bfloat16 in and float32 out (all three: head_dim a multiple
// of 8 from 64 to 128, any S; q, k and v 16-byte aligned).
extern "C" int keep_attention(const void* q, const void* k, const void* v,
                              long long batch_stride, long long head_stride,
                              long long row_stride, const void* key_bias,
                              void* out, int B, int S, int H, int head_dim,
                              int dtype, float scale, void* stream) {
  if (S < 1 || H < 1 || B < 1 || B > 65535 || H > 65535 ||
      (batch_stride | head_stride | row_stride) % 8)
    return int(cudaErrorInvalidValue);
  if (head_dim % 8 || head_dim < kMinHeadDim || head_dim > kMaxHeadDim)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(key_bias);
  switch (dtype) {
    case 0:
      return int(launch_f32(static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v),
                            Strides{batch_stride, head_stride, row_stride},
                            kb, static_cast<float*>(out), B, S, H, head_dim,
                            scale, st));
    case 1:
    case 2:
      return int(keep_attention_wgmma(q, k, v, batch_stride, head_stride,
                                      row_stride, kb, out, dtype == 2, B, S,
                                      H, head_dim, scale, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
