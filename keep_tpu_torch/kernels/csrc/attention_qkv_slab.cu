// Fused multi-head attention for Hopper (sm_90a), over the unsplit qkv slab,
// over split q, k and v, or over [B, H, S, Dh] heads.
//
// Replaces two TPU kernels of keep_tpu/kernels/flash_attention.py, which
// share the body `_sdpa` (:43-56):
//   - `_slab_attn_fwd_kernel` (pallas_call at :190), reached through
//     `attention_qkv_slab` from both KEEP towers: q, k and v are 64-wide
//     column slices of one slab qkv[B, S, 3*H*64];
//   - `attention_qkv_heads` (pallas_call at :115), wrapped by
//     `flash_attention` (:251) and `ops.nn.mha_attention(use_flash=True)`:
//     q, k and v are three [B, S, H*64] tensors, or (flash_attention) three
//     [B, H, S, 64] ones, handed over as they are. The TPU kernel takes a
//     group of heads per program; here every (query tile, head) is a block,
//     so the group changes nothing.
// One kernel body serves all three layouts: it reads q, k and v through
// three base pointers and one set of element strides (batch, head, row), so
// the entry points give the same bits on the same values.
//
// What it computes, per batch row b and head h:
//   s = (q . k^T) in fp32 * Dh^-0.5 + key_bias[b, :]        (fp32)
//   p = exp(s - rowmax(s)) / rowsum(...), then cast to the input dtype
//   o = p . v accumulated in fp32, cast to the output dtype -> out[B, S, H*64]
// The cast of p happens after the normalisation, as on the TPU. The output
// dtype is the input's, or fp32 for a bf16 input: that form replaces the
// attention inside the int8 megakernels, keep_tpu/kernels/qblock.py `_sdpa`
// / `_sdpa_masked` (:36-44, :131-139, in the pallas_calls at :79 and
// :182), which return the fp32 sum into an fp32 scratch that is quantized
// without a bf16 round; the entry point below sends it to its own body,
// single-pass wgmma fed by TMA (attention_qkv_slab_f32.cu).
//
// What bounds it on this card: bytes in principle (q, k and v read once, the
// output written once: 0.015 ms at ViT-L B=32), but at S <= 512 and Dh = 64
// the work per byte is low and what a block can keep busy decides: the two
// products, the exponentials (the MUFU pipe) and the fp32 softmax
// arithmetic.
//
// Design of the bf16 -> bf16 body, on the tensor cores: one block of 4
// warps per (64 query rows, head, batch row), each warp owning 16 query
// rows.
//   Staging: Q's 64 rows and the whole K slice in one cp.async group, the
//   whole V slice in a second group that lands while pass 1 runs (S <= 512:
//   at most 64 KB each). Shared rows are 128 bytes whose 16-byte chunks are
//   XOR-swizzled by the row (no padding, so cp.async and ldmatrix keep their
//   16-byte alignment and a warp's ldmatrix phase hits 32 banks). K and V
//   rows past S are zero-filled by cp.async (src-size 0), so no 0 * NaN
//   from stale shared memory reaches p . v; their scores are -inf through
//   the staged bias row. Q fragments stay in registers.
//   Pass 1: per 64-key tile, s = q . k^T on mma.sync.m16n8k16 (bf16 in,
//   fp32 accumulators; K fragments by ldmatrix), scaled and biased, then
//   the row max and sum with an online rescale.
//   Pass 2: s again, p = exp(s - m) * (1 / l) in fp32, rounded to bf16 as
//   the A operand of p . v (V fragments by ldmatrix.trans). This keeps the
//   reference's cast point (p normalised, then rounded); an online softmax
//   that normalised at the end would round unnormalised p. The cost is a
//   second q . k^T and a second exp per score.
//   Query rows past S are computed from zero rows and never stored.
// fp32 -> fp32 keeps an exact CUDA-core body: one block per (32 query
// rows, head, batch row), 8 warps of 4 rows each; K then V staged in
// padded shared rows, q rows in shared fp32, a 4 x 8 tile of scores per
// lane in registers per 256 keys (each K element loaded once for 4 rows),
// the scores and then p in shared memory (p^T), a 4 x 2 tile of outputs
// per lane. Every sum runs in the order of the plain version on the card
// (a chain of fp32 FMAs per output, the warp softmax), so it gives the
// plain version's bits: the tensor cores have no fp32 path that meets the
// fp32 gate (2e-5). The body is a template over the element types; only
// its fp32 instantiation is launched.
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

// ---- fp32: CUDA-core FMAs ------------------------------------------------------

constexpr int kWarpRows = kRowsPerBlock / kWarps;  // query rows a warp owns
constexpr int kPtStride = kRowsPerBlock + 4;        // floats per row of p^T
constexpr int kGroupSlots = 8;                      // keys per lane per pass
constexpr int kGroupKeys = 32 * kGroupSlots;
static_assert(kWarpRows == 4, "p^T rows are stored as one float4");

// Shared memory of the CUDA-core body: K (then V) in padded rows, rounded
// up to 16 bytes; p^T [S][36] (16-byte rows, so a quarter warp's float4
// accesses hit 32 banks); the block's q rows in fp32 [32][64].
template <typename T>
size_t cc_smem_words(int S) {
  return size_t((S * Elem<T>::kRowWords + 3) & ~3) + size_t(S) * kPtStride +
         kRowsPerBlock * kHeadDim;
}

template <typename T, typename TOut>
__global__ void __launch_bounds__(kThreads)
slab_attention_kernel(const T* __restrict__ q_base,
                      const T* __restrict__ k_base,
                      const T* __restrict__ v_base, Strides st,
                      const float* __restrict__ key_bias,
                      TOut* __restrict__ out, int S, int H, float scale) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr int W = Elem<T>::kRowWords;
  uint32_t* kv_s = smem;                                            // [S][W]
  float* p_t = reinterpret_cast<float*>(smem + ((S * W + 3) & ~3));  // [S][36]
  float* q_s = p_t + S * kPtStride;                                 // [32][64]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int lane = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32 * kWarpRows;  // the warp's rows r0..r0+3
  const int D = H * kHeadDim;
  const long long head = b * st.batch + h * st.head;
  const float* bias = key_bias ? key_bias + (long long)b * S : nullptr;

  // K and the block's q rows (zeros past S) -> shared memory.
  stage_rows<T>(kv_s, k_base + head, S, st.row);
  for (int idx = threadIdx.x; idx < kRowsPerBlock * kHeadDim;
       idx += kThreads) {
    const int row = row0 + idx / kHeadDim;
    q_s[idx] = row < S ? Elem<T>::to_float(
                             q_base[head + row * st.row + idx % kHeadDim])
                       : 0.f;
  }
  __syncthreads();

  // Scaled, biased scores of the warp's 4 rows -> p^T, 256 keys at a time:
  // lane l takes keys l, l + 32, ..., each a chain of FMAs over d in
  // order, as the plain version's GEMM sums it.
  for (int g = 0; g < S; g += kGroupKeys) {
    float acc[kWarpRows][kGroupSlots] = {};
#pragma unroll 2
    for (int d = 0; d < kHeadDim / 2; ++d) {
      float2 q[kWarpRows];
#pragma unroll
      for (int r = 0; r < kWarpRows; ++r)
        q[r] = *reinterpret_cast<const float2*>(q_s + (r0 + r) * kHeadDim +
                                                2 * d);
#pragma unroll
      for (int t = 0; t < kGroupSlots; ++t) {
        const int j = g + 32 * t + lane;
        if (j < S) {
          float a, bb;
          Elem<T>::pair(kv_s + j * W, d, a, bb);
#pragma unroll
          for (int r = 0; r < kWarpRows; ++r) {
            acc[r][t] = fmaf(q[r].x, a, acc[r][t]);
            acc[r][t] = fmaf(q[r].y, bb, acc[r][t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kGroupSlots; ++t) {
      const int j = g + 32 * t + lane;
      if (j < S) {
        float x[kWarpRows];
#pragma unroll
        for (int r = 0; r < kWarpRows; ++r) {
          x[r] = __fmul_rn(acc[r][t], scale);
          if (bias) x[r] = __fadd_rn(x[r], bias[j]);
        }
        *reinterpret_cast<float4*>(p_t + j * kPtStride + r0) =
            make_float4(x[0], x[1], x[2], x[3]);
      }
    }
  }

  // The warp softmax of each row, in the order of the plain version's:
  // lane partial sums over its keys in order, then a butterfly; p rounded
  // to the input dtype after the division.
  float m[kWarpRows], sum[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) m[r] = -INFINITY;
  for (int j = lane; j < S; j += 32) {
    const float4 x = *reinterpret_cast<const float4*>(p_t + j * kPtStride +
                                                      r0);
    m[0] = fmaxf(m[0], x.x);
    m[1] = fmaxf(m[1], x.y);
    m[2] = fmaxf(m[2], x.z);
    m[3] = fmaxf(m[3], x.w);
  }
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    m[r] = warp_max(m[r]);
    sum[r] = 0.f;
  }
  for (int j = lane; j < S; j += 32) {
    float4* x = reinterpret_cast<float4*>(p_t + j * kPtStride + r0);
    const float4 e = make_float4(expf(x->x - m[0]), expf(x->y - m[1]),
                                 expf(x->z - m[2]), expf(x->w - m[3]));
    *x = e;
    sum[0] += e.x;
    sum[1] += e.y;
    sum[2] += e.z;
    sum[3] += e.w;
  }
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) sum[r] = warp_sum(sum[r]);
  for (int j = lane; j < S; j += 32) {
    float4* x = reinterpret_cast<float4*>(p_t + j * kPtStride + r0);
    const float4 e = *x;
    *x = make_float4(
        Elem<T>::round(e.x / sum[0]), Elem<T>::round(e.y / sum[1]),
        Elem<T>::round(e.z / sum[2]), Elem<T>::round(e.w / sum[3]));
  }
  __syncthreads();

  // V over K; lane l owns output columns 2l, 2l+1 of the warp's 4 rows,
  // each a chain of FMAs over the keys in order.
  stage_rows<T>(kv_s, v_base + head, S, st.row);
  __syncthreads();
  float o[kWarpRows][2] = {};
  for (int j = 0; j < S; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(p_t + j * kPtStride +
                                                      r0);
    const float pr[kWarpRows] = {p.x, p.y, p.z, p.w};
    float a, bb;
    Elem<T>::pair(kv_s + j * W, lane, a, bb);
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      o[r][0] = fmaf(pr[r], a, o[r][0]);
      o[r][1] = fmaf(pr[r], bb, o[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    const int row = row0 + r0 + r;
    if (row < S)
      Elem<TOut>::store(out + ((long long)b * S + row) * D + h * kHeadDim +
                            2 * lane,
                        o[r][0], o[r][1]);
  }
}

// ---- bf16: tensor cores ----------------------------------------------------------

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

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <typename T, typename TOut>
cudaError_t launch_cc(const T* q, const T* k, const T* v, Strides st,
                      const float* key_bias, TOut* out, int B, int S, int H,
                      float scale, cudaStream_t stream) {
  const size_t smem = cc_smem_words<T>(S) * 4;
  const cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(slab_attention_kernel<T, TOut>), smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  slab_attention_kernel<T, TOut><<<grid, kThreads, smem, stream>>>(
      q, k, v, st, key_bias, out, S, H, scale);
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
// and out, 2 = bfloat16 in and float32 out (q, k and v 16-byte aligned).
extern "C" int keep_attention(const void* q, const void* k, const void* v,
                              long long batch_stride, long long head_stride,
                              long long row_stride, const void* key_bias,
                              void* out, int B, int S, int H, int head_dim,
                              int dtype, float scale, void* stream) {
  if (head_dim != kHeadDim || S < 1 || S > kMaxSeq || H < 1 || B < 1 ||
      B > 65535 || H > 65535 || (batch_stride | head_stride | row_stride) % 8)
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides strides{batch_stride, head_stride, row_stride};
  const float* kb = static_cast<const float*>(key_bias);
  const bf16* q16 = static_cast<const bf16*>(q);
  const bf16* k16 = static_cast<const bf16*>(k);
  const bf16* v16 = static_cast<const bf16*>(v);
  switch (dtype) {
    case 0:
      return int(launch_cc(static_cast<const float*>(q),
                           static_cast<const float*>(k),
                           static_cast<const float*>(v), strides, kb,
                           static_cast<float*>(out), B, S, H, scale, st));
    case 1:
      return int(launch_tc(q16, k16, v16, strides, kb,
                           static_cast<bf16*>(out), B, S, H, scale, st));
    case 2:
      return int(keep_attention_bf16_f32(q, k, v, batch_stride, head_stride,
                                         row_stride, kb,
                                         static_cast<float*>(out), B, S, H,
                                         scale, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
