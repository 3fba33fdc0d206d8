// Backward of the fused multi-head attention over the unsplit qkv slab, for
// Hopper (sm_90a): the C entry point.
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
// Kernel A runs per 64 query rows and writes each row's statistics (max,
// the inverse of the sum, rowsum(dp o p)) to an fp32 [B, H, S] x 4
// scratch, and dq; kernel B runs per 64 keys, rebuilds p and ds from the
// statistics and writes dk and dv. A block's work depends on its (batch
// row, head) alone, so a launch over some of the heads (tensor
// parallelism) gives those heads' bits.
//
// bf16 (dtype 1), at every Dh and S: kernels A and B on wgmma fed by TMA,
// attention_qkv_slab_bwd_dq.cu and attention_qkv_slab_bwd_dkv.cu, whose
// heads set out their design. p and ds are rounded to bf16 only as
// operands of their products (dv = p^T . do, dq = ds . k, dk = ds^T . q),
// a departure from the JAX package's fp32 products that stays inside the
// bf16 gate (max |d| <= 1e-2 * max |plain|; the CPU model of this
// rounding, tests/card_attention_model.py `card_body_attention_bwd`, is
// held to the JAX VJP in tests/test_torch_attention_grad.py).
//
// fp32 (dtype 0), at every Dh and S: kernels A and B of the same structure
// on wgmma in split TF32 (each product hi . hi + hi . lo + lo . hi of
// TF32 parts, fp32 sums), attention_qkv_slab_bwd_f32_dq.cu and
// attention_qkv_slab_bwd_f32_dkv.cu, with tf32_attention.cuh; its gate is
// atol 2e-4 / rtol 1e-4, and its CPU model
// (`card_body_attention_bwd_f32`) is held to the JAX VJP there too.
//
// This file writes both forms' TMA maps and launches them.

#include "tf32_attention.cuh"

namespace {

// The fp32 form: kernel A then kernel B in split TF32 on wgmma, their
// operands through fp32 TMA maps of the slab's q, k and v lanes and of
// dout; cudaErrorNotSupported when libcuda has no TMA encoder or refuses a
// map.
cudaError_t launch_bwd_f32(const float* qkv, const float* kb,
                           const float* dout, float* dqkv, float4* stats,
                           int B, int S, int H, int dh, float scale,
                           cudaStream_t stream) {
  if (!aligned16(qkv) || !aligned16(dout) || !aligned16(dqkv) ||
      !aligned16(stats))
    return cudaErrorInvalidValue;
  const long long D = (long long)H * dh;
  keep_attn::BwdF32Args a;
  if (!f32_head_map(&a.q, qkv, S * 3 * D, dh, 3 * D, B, S, H, dh) ||
      !f32_head_map(&a.k, qkv + D, S * 3 * D, dh, 3 * D, B, S, H, dh) ||
      !f32_head_map(&a.v, qkv + 2 * D, S * 3 * D, dh, 3 * D, B, S, H, dh) ||
      !f32_head_map(&a.dout, dout, S * D, dh, D, B, S, H, dh))
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
  const cudaError_t e = keep_attn::launch_bwd_f32_dq(a);
  if (e != cudaSuccess) return e;
  return keep_attn::launch_bwd_f32_dkv(a);
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kb = static_cast<const float*>(key_bias);
  float4* stt = static_cast<float4*>(stats);
  switch (dtype) {
    case 0:
      return int(launch_bwd_f32(
          static_cast<const float*>(qkv), kb, static_cast<const float*>(dout),
          static_cast<float*>(dqkv), stt, B, S, H, head_dim, scale, st));
    case 1:
      return int(launch_bwd_bf16(
          static_cast<const bf16*>(qkv), kb, static_cast<const bf16*>(dout),
          static_cast<bf16*>(dqkv), stt, B, S, H, head_dim, scale, st));
    default:
      return int(cudaErrorInvalidValue);
  }
}
