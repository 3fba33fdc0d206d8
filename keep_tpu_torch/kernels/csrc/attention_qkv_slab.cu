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
// without a bf16 round; the entry point below sends it at Dh = 64 and
// S <= 512 (the KEEP towers' int8 blocks at 224^2) to its own body,
// single-pass wgmma fed by TMA (attention_qkv_slab_f32.cu), and at every
// other shape (an int8 KEEP at 384^2 or 448^2) to the streamed body below
// with an fp32 epilogue.
//
// Shapes: every form takes every head width that is a multiple of 8 from
// 64 to 128 (the OpenCLIP zoo: 64, 80 for ViT-H, 88 for ViT-g and EVA01-g,
// 104 for ViT-bigG, 112 for ViT-e) and any S (577 for ViT-L-14-336, 785
// for KEEP's ViT-L/16 at 448^2).
//
// What bounds it on this card: bytes in principle (q, k and v read once, the
// output written once: 0.015 ms at ViT-L B=32), but at these lengths the
// work per byte is low and what a block can keep busy decides: the two
// products, the exponentials (the MUFU pipe) and the fp32 softmax
// arithmetic.
//
// bf16 -> bf16, on the tensor cores: one block of 4 warps per (64 query
// rows, head, batch row), each warp owning 16 query rows; s = q . k^T and
// p . v on mma.sync.m16n8k16 (bf16 in, fp32 accumulators; fragments by
// ldmatrix, V's by ldmatrix.trans). Two passes over the keys, 64 at a time:
//   pass 1: s, scaled and biased, then the row max and sum with an online
//   rescale;
//   pass 2: s again, p = exp(s - m) * (1 / l) in fp32, rounded to bf16 as
//   the A operand of p . v. This keeps the reference's cast point (p
//   normalised, then rounded); an online softmax that normalised at the end
//   would round unnormalised p. The cost is a second q . k^T and a second
//   exp per score.
// Keys past S score -inf (the bias read in registers), their K and V rows
// are zero-filled by cp.async (src-size 0), so no 0 * NaN from stale shared
// memory reaches p . v. Query rows past S are computed from zero rows and
// never stored. Two bodies:
//   - Dh = 64, S <= 512 (the KEEP towers at 224^2, the zoo's Dh = 64
//     presets at 224^2): PR 5's body, which stages Q, the whole K slice and
//     then the whole V slice (at most 64 KB each) in 128-byte rows whose
//     16-byte chunks are XOR-swizzled by the row;
//   - any other shape, and the bf16 -> fp32 form outside the one-pass wgmma body (p
//     rounded to bf16 at the same point, o stored in fp32 uncast): K
//     (pass 1), then K and V (pass 2) stream through
//     two-stage cp.async rings of 64-row tiles, so shared memory no longer
//     grows with S (87 KB at Dh = 128). A row holds Dh padded with zeros to
//     a multiple of 16 (the k16 steps of q . k^T; the zeros add exact
//     zeros; p . v's padded columns are never stored), plus one 16-byte
//     chunk of pitch: an odd count of chunks, so the 8 rows an ldmatrix
//     phase reads start in 8 distinct bank groups without a swizzle.
// fp32 -> fp32 keeps an exact CUDA-core body: one block per (32 query
// rows, head, batch row), 8 warps of 4 rows each, K (then V) staged 128
// rows at a time in padded shared rows, the q rows in shared fp32. Three
// passes over the keys: the row max, the row sum, then p (rounded after the
// division) into shared p^T and p . v. Lane l takes keys l, l + 32, ...
// Every sum runs in the order of the plain version on the card (a chain of
// fp32 FMAs per score and per output over d and over the keys in order;
// PyTorch's warp softmax, which serves rows of up to 1024 fp32 values:
// lane partial sums over its keys in order, then a butterfly), so it gives
// the plain version's bits there; longer rows go to PyTorch's block softmax,
// which sums in another order. The tensor cores have no fp32 path that meets
// the fp32 gate (2e-5). The third pass recomputes the scores instead of
// keeping a row of them, so shared memory does not grow with S.
//
// What it leaves on the table: wgmma and TMA (the card's full bf16 rate),
// keeping K and V of a (b, h) in shared memory across its query tiles, and
// a persistent schedule.

#include "slab_attention.cuh"

// The bf16 -> fp32 body (attention_qkv_slab_f32.cu).
cudaError_t keep_attention_bf16_f32(const void* q, const void* k,
                                    const void* v, long long batch_stride,
                                    long long head_stride,
                                    long long row_stride,
                                    const float* key_bias, float* out, int B,
                                    int S, int H, float scale,
                                    cudaStream_t stream);

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

// ---- bf16: tensor cores, Dh = 64 and S <= 512 (PR 5's body) ------------------

__global__ void __launch_bounds__(kTcThreads)
slab_attention_tc_kernel(const bf16* __restrict__ q_base,
                         const bf16* __restrict__ k_base,
                         const bf16* __restrict__ v_base, Strides st,
                         const float* __restrict__ key_bias,
                         bf16* __restrict__ out, int S, int H, float scale) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int sp = (S + kTcTile - 1) / kTcTile * kTcTile;
  const uint32_t q_s = smem_addr(tc_smem);                  // [64][64]
  const uint32_t k_s = q_s + kTcRows * kRowBytes;        // [sp][64]
  const uint32_t v_s = k_s + sp * kRowBytes;             // [sp][64]
  float* bias_s = reinterpret_cast<float*>(
      tc_smem + (kTcRows + 2 * sp) * kRowBytes);            // [sp]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long head = b * st.batch + h * st.head;

  stage_async(q_s, q_base + head, st.row, row0, kTcRows, S);
  stage_async(k_s, k_base + head, st.row, 0, sp, S);
  cp_async_commit();
  stage_async(v_s, v_base + head, st.row, 0, sp, S);
  cp_async_commit();
  fill_bias(bias_s, key_bias ? key_bias + (long long)b * S : nullptr, S, sp);
  cp_async_wait<1>();  // Q and K
  __syncthreads();

  uint32_t qa[4][4];
  load_a_rows(qa, q_s, 16 * warp, lane);

  // Pass 1: row max m and sum l (this thread's part of rows gid, gid + 8).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kb = 0; kb < sp; kb += kTcTile) {
    float s[8][4], alpha[2];
    scores(s, qa, k_s, kb, bias_s, scale, lane);
    raise_max(s, m, alpha);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] *= alpha[i];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e >> 1] += expf(__fsub_rn(s[n][e], m[e >> 1]));
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / quad_sum(l[i]);

  // Pass 2: p = exp(s - m) / l rounded to bf16, o += p . v.
  cp_async_wait<0>();  // V
  __syncthreads();
  float o[8][4] = {};
  for (int kb = 0; kb < sp; kb += kTcTile) {
    float s[8][4];
    scores(s, qa, k_s, kb, bias_s, scale, lane);
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fmul_rn(expf(__fsub_rn(s[n][e], m[e >> 1])), inv[e >> 1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_to_a(pa[c], s[2 * c], s[2 * c + 1]);
    mma_ax<4>(o, pa, v_s, kb, lane);
  }

  const int D = H * kHeadDim;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * half;
    if (row >= S) continue;
    bf16* dst = out + ((long long)b * S + row) * D + h * kHeadDim +
                2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      Elem<bf16>::store(dst + 8 * n, o[n][2 * half], o[n][2 * half + 1]);
  }
}

// ---- bf16: tensor cores, any Dh and S (K and V streamed) ----------------------

// s = (q.k^T)*scale + bias for the 64 keys kb.. of the tile at `k_s`, in the
// reference's order (a rounded product, then a rounded sum), over kDP / 16
// k16 steps; keys at or past S score -inf. Fragment layout as `scores`.
template <int kDP>
__device__ __forceinline__ void tile_scores(
    float (&s)[8][4], const uint32_t (&qa)[kDP / 16][4], uint32_t k_s, int kb,
    const float* __restrict__ bias, int S, float scale, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, k_s + prow<kDP>(16 * p + (lane & 7) + ((lane >> 4) << 3),
                                 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[2 * p], qa[kk], b[0], b[1]);
      mma_bf16(s[2 * p + 1], qa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = kb + 8 * n + 2 * (lane & 3) + (e & 1);
      const float bj = j < S ? (bias ? __ldg(bias + j) : 0.f) : -INFINITY;
      s[n][e] = __fadd_rn(__fmul_rn(s[n][e], scale), bj);
    }
}

// TOut: bf16 (#1's bf16 -> bf16 form) or float (the bf16 -> fp32 form of
// the int8 blocks at the shapes the one-pass wgmma body does not take: o
// stored uncast)
template <int kDP, typename TOut>
__global__ void __launch_bounds__(kTcThreads)
attention_tc_any_kernel(const bf16* __restrict__ q_base,
                        const bf16* __restrict__ k_base,
                        const bf16* __restrict__ v_base, Strides st,
                        const float* __restrict__ key_bias,
                        TOut* __restrict__ out, int S, int H, int dh,
                        float scale) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  constexpr uint32_t kTile = tile_bytes(kDP);
  // Q, then K's two stages, then V's two stages
  const uint32_t q_s = smem_addr(tc_smem);
  const uint32_t k_s = q_s + kTile;
  const uint32_t v_s = q_s + 3 * kTile;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTcRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long head = b * st.batch + h * st.head;
  const bf16* kg = k_base + head;
  const bf16* vg = v_base + head;
  const float* bias = key_bias ? key_bias + (long long)b * S : nullptr;
  const int tiles = (S + kTcTile - 1) / kTcTile;

  // Pass 1: row max m and sum l (this thread's part of rows gid, gid + 8),
  // K streamed through two stages.
  stage_tile<kDP>(q_s, q_base + head, st.row, row0, S, dh);
  stage_tile<kDP>(k_s, kg, st.row, 0, S, dh);
  cp_async_commit();
  uint32_t qa[kDP / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      stage_tile<kDP>(k_s + ((t + 1) & 1) * kTile, kg, st.row,
                      (t + 1) * kTcTile, S, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk)
        ldsm_x4(qa[kk], q_s + prow<kDP>(16 * warp + (lane & 15),
                                        2 * kk + (lane >> 4)));
    }
    float s[8][4], alpha[2];
    tile_scores<kDP>(s, qa, k_s + (t & 1) * kTile, t * kTcTile, bias, S,
                     scale, lane);
    raise_max(s, m, alpha);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] *= alpha[i];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        l[e >> 1] += expf(__fsub_rn(s[n][e], m[e >> 1]));
    __syncthreads();  // this stage is refilled two tiles on
  }
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / quad_sum(l[i]);

  // Pass 2: p = exp(s - m) / l rounded to bf16, o += p . v, K and V
  // streamed together.
  stage_tile<kDP>(k_s, kg, st.row, 0, S, dh);
  stage_tile<kDP>(v_s, vg, st.row, 0, S, dh);
  cp_async_commit();
  float o[kDP / 8][4] = {};
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {
      const uint32_t next = ((t + 1) & 1) * kTile;
      stage_tile<kDP>(k_s + next, kg, st.row, (t + 1) * kTcTile, S, dh);
      stage_tile<kDP>(v_s + next, vg, st.row, (t + 1) * kTcTile, S, dh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t cur = (t & 1) * kTile;
    float s[8][4];
    tile_scores<kDP>(s, qa, k_s + cur, t * kTcTile, bias, S, scale, lane);
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = __fmul_rn(expf(__fsub_rn(s[n][e], m[e >> 1])), inv[e >> 1]);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_to_a(pa[c], s[2 * c], s[2 * c + 1]);
    // o += P . V over the tile's 4 chunks of 16 keys, 16 columns a step
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int d = 0; d < kDP / 16; ++d) {
        uint32_t bv[4];
        ldsm_x4_t(bv, v_s + cur +
                          prow<kDP>(16 * c + (lane & 7) +
                                        (((lane >> 3) & 1) << 3),
                                    2 * d + (lane >> 4)));
        mma_bf16(o[2 * d], pa[c], bv[0], bv[1]);
        mma_bf16(o[2 * d + 1], pa[c], bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  const int D = H * dh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 16 * warp + (lane >> 2) + 8 * half;
    if (row >= S) continue;
    TOut* dst = out + ((long long)b * S + row) * D + h * dh + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kDP / 8; ++n)
      if (8 * n < dh)
        Elem<TOut>::store(dst + 8 * n, o[n][2 * half], o[n][2 * half + 1]);
  }
}

// ---- launches -------------------------------------------------------------------

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       Strides st, const float* key_bias, float* out, int B,
                       int S, int H, int dh, float scale,
                       cudaStream_t stream) {
  const size_t smem = f32_smem_words(dh) * 4;
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(attention_f32_kernel), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  attention_f32_kernel<<<grid, kThreads, smem, stream>>>(
      q, k, v, st, key_bias, out, S, H, dh, scale);
  return cudaGetLastError();
}

cudaError_t launch_tc(const bf16* q, const bf16* k, const bf16* v,
                      Strides st, const float* key_bias, bf16* out, int B,
                      int S, int H, float scale, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(1, S);
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_tc_kernel), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  slab_attention_tc_kernel<<<grid, kTcThreads, smem, stream>>>(
      q, k, v, st, key_bias, out, S, H, scale);
  return cudaGetLastError();
}

template <int kDP, typename TOut>
cudaError_t launch_tc_any(const bf16* q, const bf16* k, const bf16* v,
                          Strides st, const float* key_bias, TOut* out, int B,
                          int S, int H, int dh, float scale,
                          cudaStream_t stream) {
  const size_t smem = 5 * size_t(tile_bytes(kDP));
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(attention_tc_any_kernel<kDP, TOut>),
      smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kTcRows - 1) / kTcRows, H, B);
  attention_tc_any_kernel<kDP, TOut><<<grid, kTcThreads, smem, stream>>>(
      q, k, v, st, key_bias, out, S, H, dh, scale);
  return cudaGetLastError();
}

// The streamed body at Dh padded to a multiple of 16.
template <typename TOut>
cudaError_t launch_streamed(const bf16* q, const bf16* k, const bf16* v,
                            Strides st, const float* key_bias, TOut* out,
                            int B, int S, int H, int dh, float scale,
                            cudaStream_t stream) {
  switch ((dh + 15) / 16) {
    case 4:
      return launch_tc_any<64>(q, k, v, st, key_bias, out, B, S, H, dh, scale,
                               stream);
    case 5:
      return launch_tc_any<80>(q, k, v, st, key_bias, out, B, S, H, dh, scale,
                               stream);
    case 6:
      return launch_tc_any<96>(q, k, v, st, key_bias, out, B, S, H, dh, scale,
                               stream);
    case 7:
      return launch_tc_any<112>(q, k, v, st, key_bias, out, B, S, H, dh,
                                scale, stream);
    case 8:
      return launch_tc_any<128>(q, k, v, st, key_bias, out, B, S, H, dh,
                                scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                        Strides st, const float* key_bias, bf16* out, int B,
                        int S, int H, int dh, float scale,
                        cudaStream_t stream) {
  if (dh == kHeadDim && S <= kMaxSeq)
    return launch_tc(q, k, v, st, key_bias, out, B, S, H, scale, stream);
  return launch_streamed(q, k, v, st, key_bias, out, B, S, H, dh, scale,
                         stream);
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
  const bool any_shape = head_dim % 8 == 0 && head_dim >= kMinHeadDim &&
                         head_dim <= kMaxHeadDim;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides strides{batch_stride, head_stride, row_stride};
  const float* kb = static_cast<const float*>(key_bias);
  switch (dtype) {
    case 0:
      if (!any_shape) return int(cudaErrorInvalidValue);
      return int(launch_f32(static_cast<const float*>(q),
                            static_cast<const float*>(k),
                            static_cast<const float*>(v), strides, kb,
                            static_cast<float*>(out), B, S, H, head_dim,
                            scale, st));
    case 1:
      if (!any_shape) return int(cudaErrorInvalidValue);
      return int(launch_bf16(static_cast<const bf16*>(q),
                             static_cast<const bf16*>(k),
                             static_cast<const bf16*>(v), strides, kb,
                             static_cast<bf16*>(out), B, S, H, head_dim,
                             scale, st));
    case 2:
      if (!any_shape) return int(cudaErrorInvalidValue);
      if (head_dim == kHeadDim && S <= kMaxSeq)  // the one-pass wgmma body
        return int(keep_attention_bf16_f32(q, k, v, batch_stride,
                                           head_stride, row_stride, kb,
                                           static_cast<float*>(out), B, S, H,
                                           scale, st));
      return int(launch_streamed(static_cast<const bf16*>(q),
                                 static_cast<const bf16*>(k),
                                 static_cast<const bf16*>(v), strides, kb,
                                 static_cast<float*>(out), B, S, H, head_dim,
                                 scale, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
