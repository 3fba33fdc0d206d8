// Fused multi-head attention for Hopper (sm_90a), over the unsplit qkv slab
// or over split q, k and v.
//
// Replaces two TPU kernels of keep_tpu/kernels/flash_attention.py, which
// share the body `_sdpa` (:43-56):
//   - `_slab_attn_fwd_kernel` (pallas_call at :190), reached through
//     `attention_qkv_slab` from both KEEP towers: q, k and v are 64-wide
//     column slices of one slab qkv[B, S, 3*H*64] (q at h*64, k at
//     H*64 + h*64, v at 2*H*64 + h*64), row stride 3*H*64;
//   - `attention_qkv_heads` (pallas_call at :115), wrapped by
//     `flash_attention` (:251) and `ops.nn.mha_attention(use_flash=True)`:
//     q, k and v are three [B, S, H*64] tensors, head h at columns h*64,
//     row stride H*64. The TPU kernel takes a group of heads per program;
//     here every (query tile, head) is a block, so the group changes
//     nothing.
// One kernel body serves both: it reads q, k and v through three base
// pointers, a row stride and a batch stride (keep_attention_qkv_slab passes
// qkv, qkv + D, qkv + 2D with stride 3D; keep_attention_qkv_heads passes
// q, k, v with stride D), so the two entry points give the same bits on the
// same values.
//
// What it computes, per batch row b and head h:
//   s = (q . k^T) in fp32 * Dh^-0.5 + key_bias[b, :]        (fp32)
//   p = exp(s - rowmax(s)) / rowsum(...), then cast to the input dtype
//   o = p . v accumulated in fp32, cast to the output dtype -> out[B, S, H*64]
// The cast of p happens after the normalisation, as on the TPU. The output
// dtype is the input's, or fp32 for a bf16 slab: that instantiation replaces
// the attention inside the int8 megakernels, keep_tpu/kernels/qblock.py
// `_sdpa` / `_sdpa_masked` (:36-44, :131-139, in the pallas_calls at :79 and
// :182), which return the fp32 sum into an fp32 scratch that is quantized
// without a bf16 round.
//
// What bounds it on this card: bytes. q, k and v are read from device memory
// once per layer (each K/V head slice is re-read by every query tile, from
// L2), while the S x S scores never leave the SM: they live in registers and
// the normalised rows in shared memory. At S <= 512 the score work is small
// next to the projections around it.
//
// Design (simple first): one block per (query tile of 32 rows, head, batch
// row); 8 warps, one warp per query row at a time.
//   Phase 1: the block stages K for (b, h) in shared memory, each lane
//            computes the scores of keys lane, lane+32, ... in registers, the
//            warp reduces max and sum with shuffles, and the rounded p row is
//            written to shared memory.
//   Phase 2: V overwrites K in the same buffer; lane l accumulates output
//            columns 2l and 2l+1 over all keys.
// Shared rows are padded by one 32-bit word so that lane-per-key reads hit
// 32 distinct banks. Dynamic shared memory: S*(row words)*4 + 32*S*4 bytes,
// at most 194 KB (fp32, S = 512), above the 48 KB default, so the launcher
// raises the limit with cudaFuncSetAttribute.
//
// What the simple design leaves on the table: the dot products run on the
// fp32 pipes, not the tensor cores (no mma/wgmma); K and V are staged with
// plain loads, not TMA or cp.async, so copy and compute do not overlap; each
// query tile re-stages the whole K/V slice; and the softmax is the exact
// two-pass one over a full row, not an online softmax over key blocks.

#include "slab_attention.cuh"

namespace {

// q, k, v: the first element of head 0 of batch row 0 of each operand; row
// j of head h of batch row b starts at b * batch_stride + j * stride + h * 64.
template <typename T, typename TOut>
__global__ void __launch_bounds__(kThreads)
slab_attention_kernel(const T* __restrict__ q_base,
                      const T* __restrict__ k_base,
                      const T* __restrict__ v_base, long long stride,
                      long long batch_stride,
                      const float* __restrict__ key_bias,
                      TOut* __restrict__ out, int S, int H, float scale) {
  extern __shared__ uint32_t smem[];
  constexpr int W = Elem<T>::kRowWords;
  uint32_t* kv_s = smem;                                  // [S][W]
  float* p_s = reinterpret_cast<float*>(smem + S * W);    // [32][S]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int D = H * kHeadDim;
  const long long head = (long long)b * batch_stride + h * kHeadDim;
  const float* bias = key_bias ? key_bias + (long long)b * S : nullptr;

  // Phase 1: K -> shared memory; scores, softmax, rounded p -> shared memory.
  stage_rows<T>(kv_s, k_base + head, S, stride);
  __syncthreads();
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int row = row0 + r;
    if (row >= S) break;  // uniform across the warp
    float q[kHeadDim];
    load_row<T>(q_base + head + row * stride, q);

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
        float v = acc * scale;
        if (bias) v += bias[j];
        s[i] = v;
        m = fmaxf(m, v);
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
      if (j < S) prow[j] = Elem<T>::round(s[i] / sum);
    }
  }
  __syncthreads();

  // Phase 2: V -> the same buffer; lane l owns output columns 2l, 2l+1.
  stage_rows<T>(kv_s, v_base + head, S, stride);
  __syncthreads();
  for (int r = warp; r < kRowsPerBlock; r += kWarps) {
    const int row = row0 + r;
    if (row >= S) break;
    const float* prow = p_s + r * S;
    float o0 = 0.f, o1 = 0.f;
    for (int j = 0; j < S; ++j) {
      const float p = prow[j];
      float a, bb;
      Elem<T>::pair(kv_s + j * W, lane, a, bb);
      o0 = fmaf(p, a, o0);
      o1 = fmaf(p, bb, o1);
    }
    Elem<TOut>::store(
        out + ((long long)b * S + row) * D + h * kHeadDim + 2 * lane, o0, o1);
  }
}

template <typename T, typename TOut>
cudaError_t launch(const void* q, const void* k, const void* v,
                   long long stride, const void* key_bias, void* out, int B,
                   int S, int H, float scale, cudaStream_t stream) {
  const size_t smem =
      size_t(S) * Elem<T>::kRowWords * 4 + size_t(kRowsPerBlock) * S * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        slab_attention_kernel<T, TOut>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  slab_attention_kernel<T, TOut><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), stride, stride * S,
      static_cast<const float*>(key_bias), static_cast<TOut*>(out), S, H,
      scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int S, int H, int head_dim) {
  return head_dim != kHeadDim || S < 1 || S > kMaxSeq || H < 1 || B < 1 ||
         B > 65535 || H > 65535;
}

}  // namespace

// Plain C entry points, loaded with ctypes. They return the cudaError_t of
// the launch. `key_bias` is a contiguous fp32 [B, S] tensor or null, `out` a
// contiguous [B, S, H*head_dim] tensor.
//
// keep_attention_qkv_slab: `qkv` is a contiguous [B, S, 3*H*head_dim]
// tensor. dtype: 0 = float32 in and out, 1 = bfloat16 in and out,
// 2 = bfloat16 in and float32 out.
extern "C" int keep_attention_qkv_slab(const void* qkv, const void* key_bias,
                                       void* out, int B, int S, int H,
                                       int head_dim, int dtype, float scale,
                                       void* stream) {
  if (bad_shape(B, S, H, head_dim)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long D = (long long)H * kHeadDim;
  switch (dtype) {
    case 0: {
      const float* x = static_cast<const float*>(qkv);
      return int(launch<float, float>(x, x + D, x + 2 * D, 3 * D, key_bias,
                                      out, B, S, H, scale, st));
    }
    case 1: {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
      return int(launch<__nv_bfloat16, __nv_bfloat16>(
          x, x + D, x + 2 * D, 3 * D, key_bias, out, B, S, H, scale, st));
    }
    case 2: {
      const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(qkv);
      return int(launch<__nv_bfloat16, float>(x, x + D, x + 2 * D, 3 * D,
                                              key_bias, out, B, S, H, scale,
                                              st));
    }
    default:
      return int(cudaErrorInvalidValue);
  }
}

// keep_attention_qkv_heads: `q`, `k` and `v` are contiguous
// [B, S, H*head_dim] tensors of one dtype. dtype: 0 = float32 in and out,
// 1 = bfloat16 in and out.
extern "C" int keep_attention_qkv_heads(const void* q, const void* k,
                                        const void* v, const void* key_bias,
                                        void* out, int B, int S, int H,
                                        int head_dim, int dtype, float scale,
                                        void* stream) {
  if (bad_shape(B, S, H, head_dim)) return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long D = (long long)H * kHeadDim;
  switch (dtype) {
    case 0:
      return int(launch<float, float>(q, k, v, D, key_bias, out, B, S, H,
                                      scale, st));
    case 1:
      return int(launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, D, key_bias,
                                                      out, B, S, H, scale,
                                                      st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
