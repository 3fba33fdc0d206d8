// Kernel A of the fp32 attention backward for Hopper (sm_90a): the row
// statistics and dq, in split TF32 on wgmma fed by TMA, at every head
// width the port takes (multiples of 8 from 64 to 128) and any S. Kernel
// B (dk, dv) is attention_qkv_slab_bwd_f32_dkv.cu; the entry point in
// attention_qkv_slab_bwd.cu writes the TMA maps and launches A, then B,
// on one stream. The split and the tiles' layout are set out in
// tf32_attention.cuh.
//
// Replaces, with kernel B, the fp32 path of
// keep_tpu/kernels/flash_attention.py `_slab_attn_bwd` (:221-245), the
// closed-form VJP of the Pallas slab attention. Per batch row b and head
// h, with q, k, v the Dh-wide lanes of qkv[B, S, 3*H*Dh] and do the lane
// of dout[B, S, H*Dh]:
//   s  = (q . k^T) * Dh^-0.5 + key_bias[b, :]
//   p  = softmax(s),  dp = do . v^T,  ds = p o (dp - rowsum(dp o p))
//   dq = (ds . k) * scale,  dk = (ds^T . q) * scale,  dv = p^T . do
// all in fp32 (each product in split TF32), written into the slab layout
// of dqkv. No gradient flows to the key bias. Deterministic: two kernels,
// no atomics, every output element written by one thread after sums in a
// fixed order; a block's work depends on its (batch row, head) alone.
//
// What bounds it on this card: its nine S^2*Dh products (the bf16 kernels'
// structure: rowsum(dp o p) needs a whole row before any ds, so kernel A
// takes s and dp twice and kernel B once more), each three TF32 products:
// at ViT-L B = 128 0.31 ms of TF32 tensor time, against 0.22 ms of bytes.
// On the CUDA cores the same work bounds at fp32's 67 TFLOP/s (0.76 ms).
// What the kernels meet first is shared memory: every tile is split by
// the threads (TF32 wgmma takes neither raw fp32 nor a transposed
// operand), and each wgmma m64n32k8 reads its B tile, and A too where A
// lives there. So a block holds what it can in registers and keeps to
// two blocks an SM at Dh 64, so that one block's splits and exponentials
// run under another's wgmma (F32Shape in tf32_attention.cuh).
//
// One block per (64 query rows, head, batch row), one warpgroup (four
// warps, 16 rows each) whose thread 0 also issues the TMA loads:
//   - Q's and dO's 64 rows come once by TMA (32 x 32 boxes, the 128-byte
//     swizzle; columns past Dh and rows past S arrive as zeros) and are
//     split in place into hi and a lo copy, the A operands of s and dp: at
//     Dh 64 the hi parts move into register fragments (F32Shape::kRegA)
//     and their tiles' space goes to the stage, past it both parts stay in
//     shared memory.
//   - The 32-key tiles K(t), V(t) arrive through one stage, twice (pass 1
//     and pass 2). The threads split each tile in place and write its lo
//     part beside it (the B operands of s and dp), and in pass 2 also
//     K(t)^T's two parts (dq's B operand). The stage is refilled for the
//     next tile once s and dp are summed, under the exponentials and dq.
//   - Pass 1: s = Q . K^T and dp = dO . V^T as two groups of kDP / 8 k8
//     steps x 3 wgmma (m64n32k8); the scores scaled, then biased (keys
//     past S at -inf); the online row max m and the sums l = sum e, u =
//     sum e * dp (e = exp(s - m)), each thread's in key order, rescaled by
//     exp(m_old - m_new) at each tile, then the quad's butterfly.
//     Statistics (m, 1/l, u/l) to the fp32 float4 scratch for kernel B.
//   - Pass 2: s and dp again; p = exp(s - m) * (1/l), ds = p (dp - u/l)
//     in fp32; ds split in registers into the A fragments of dq += ds . K
//     (B = K(t)^T, Dh in chunks of F32Shape::kN columns), four k8 steps x
//     3 wgmma a chunk.
//   - The epilogue scales dq in fp32, stages it through shared memory and
//     writes rows < S, columns < Dh, in 16-byte stores.
// Shared memory (F32Layout): 80 KB at Dh 64 (two blocks an SM), 168 KB at
// 96 and 224 KB at 128 (Dh padded to a multiple of 32; one block an SM).

#include "tf32_attention.cuh"

namespace {

// The key bias of this thread's keys of the 32-key tile from key0,
// bj[2n + e] for key key0 + 8n + 2*(lane % 4) + e (-inf at or past S).
__device__ __forceinline__ void load_bias32(float (&bj)[kF32Tile / 4],
                                            const float* __restrict__ bias,
                                            int key0, int S, int lane) {
  const int j0 = key0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < kF32Tile / 4; ++i) {
    const int j = j0 + 8 * (i >> 1) + (i & 1);
    bj[i] = j < S ? __ldg(bias + j) : -INFINITY;
  }
}

template <int kDP>
__global__ void __launch_bounds__(kConsumers, 1)
slab_attention_bwd_f32_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                                 const __grid_constant__ CUtensorMap map_k,
                                 const __grid_constant__ CUtensorMap map_v,
                                 const __grid_constant__ CUtensorMap map_do,
                                 const float* __restrict__ key_bias,
                                 float* __restrict__ dqkv,
                                 float4* __restrict__ stats, int S, int H,
                                 int dh, float scale) {
  using Sh = F32Shape<kDP>;
  using L = F32Layout<kDP>;
  constexpr int kT = kF32Tile;
  constexpr int kN = Sh::kN;
  constexpr int kRes = L::kRes;  // Q's or dO's 64 rows
  constexpr int kStr = L::kStr;  // a kT-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* ql = base;  // Q's and dO's lo parts
  uint8_t* gl = ql + kRes;
  uint8_t* qh = base + L::kHi;  // their hi parts (or landing)
  uint8_t* gh = qh + kRes;
  uint8_t* stage = base + L::kStage;  // K(t), V(t), split in place
  uint8_t* kl = base + L::kLoStr;
  uint8_t* vl = kl + kStr;
  uint8_t* kth = vl + kStr;  // K(t)^T [kDP][kT keys], keys at kpos
  uint8_t* ktl = kth + kStr;
  uint64_t* full = f32_barriers(smem_raw, base, L::kTiles);
  uint64_t* qg_bar = full + 1;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kQRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tiles = (S + kT - 1) / kT;

  // item i: tile i % tiles of pass i / tiles, into the stage
  auto load = [&](int i) {
    mbar_expect_tx(full, 2 * kStr);
    const int key0 = (i % tiles) * kT;
    load_rows<kDP>(stage, &map_k, full, kT, key0, h, b);
    load_rows<kDP>(stage + kStr, &map_v, full, kT, key0, h, b);
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(qg_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(qg_bar, 2 * kRes);
    load_rows<kDP>(qh, &map_q, qg_bar, kQRows, row0, h, b);
    load_rows<kDP>(gh, &map_do, qg_bar, kQRows, row0, h, b);
    if (!Sh::kRegA) load(0);
  }
  __syncthreads();
  mbar_wait(qg_bar, 0);
  split_tile<kDP, kQRows, false>(qh, ql, nullptr, nullptr, tid);
  split_tile<kDP, kQRows, false>(gh, gl, nullptr, nullptr, tid);
  uint32_t qf[kDP / 8][4], gf[kDP / 8][4];  // Q's and dO's hi (kRegA)
  if constexpr (Sh::kRegA) {
    consumers_sync();  // the split is done
    tile_fragments<kDP>(qf, qh, warp, lane);
    tile_fragments<kDP>(gf, gh, warp, lane);
    fence_proxy_async();
    consumers_sync();  // the stage may now take the landing area
    if (tid == 0) load(0);
  }

  const float* bias = key_bias + (long long)b * S;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float s[kT / 2], dp[kT / 2], bj[kT / 4];
  float dq[kDP / kN][kN / 2];
  uint32_t ah[kT / 8][4], al[kT / 8][4];
  // item i (tile i % tiles of pass i / tiles): wait for it, split it,
  // s = Q . K^T and dp = dO . V^T, refill the stage with item i + 1;
  // s scaled and biased: element e is row (e / 2) % 2, key 8 (e / 4) +
  // 2 (lane % 4) + e % 2 of this thread's
  auto products = [&](int i) {
    const bool pass2 = i >= tiles;
    uint8_t* ks = stage;
    uint8_t* vs = stage + kStr;
    mbar_wait(full, i & 1);
    wgmma_wait<0>();  // the previous tile's dq has read K^T
    if (pass2)
      split_tile<kDP, kT, true>(ks, kl, kth, ktl, tid);
    else
      split_tile<kDP, kT, false>(ks, kl, nullptr, nullptr, tid);
    split_tile<kDP, kT, false>(vs, vl, nullptr, nullptr, tid);
    fence_proxy_async();
    consumers_sync();
    if constexpr (Sh::kRegA) {
      issue_abt_tf32<kDP>(s, qf, ql, ks, kl);
      issue_abt_tf32<kDP>(dp, gf, gl, vs, vl);
    } else {
      issue_abt_tf32<kDP>(s, qh, ql, ks, kl);
      issue_abt_tf32<kDP>(dp, gh, gl, vs, vl);
    }
    load_bias32(bj, bias, (i % tiles) * kT, S, lane);
    wgmma_wait<0>();
    acc_fence<kT / 2>(s);
    acc_fence<kT / 2>(dp);
    consumers_sync();  // every warp is done with the stage
    if (tid == 0 && i + 1 < 2 * tiles) load(i + 1);
#pragma unroll
    for (int e = 0; e < kT / 2; ++e)
      s[e] = __fadd_rn(__fmul_rn(s[e], scale), bj[2 * (e >> 2) + (e & 1)]);
  };

  // Pass 1: the row max m, the sums l = sum e and u = sum e * dp, online.
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    products(t);
    // every tile holds a key < S, so the new max is finite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < kT / 2; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float alpha = expf(__fsub_rn(m[r], mx[r]));  // 0 at t = 0
      l[r] = __fmul_rn(l[r], alpha);
      u[r] = __fmul_rn(u[r], alpha);
      m[r] = mx[r];
    }
#pragma unroll
    for (int e = 0; e < kT / 2; ++e) {
      const int r = (e >> 1) & 1;
      const float x = expf(__fsub_rn(s[e], m[r]));
      l[r] = __fadd_rn(l[r], x);
      u[r] = __fmaf_rn(x, dp[e], u[r]);
    }
  }
  float inv[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    inv[r] = 1.f / quad_sum(l[r]);
    delta[r] = __fmul_rn(quad_sum(u[r]), inv[r]);  // rowsum(dp o p)
  }
  if ((lane & 3) == 0) {
    float4* st = stats + ((long long)b * H + h) * S;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * warp + (lane >> 2) + 8 * r;
      if (row < S) st[row] = make_float4(m[r], inv[r], delta[r], 0.f);
    }
  }

  // Pass 2: ds = p (dp - rowsum), then dq += ds . K over the tile's kT
  // keys (keys past S: p = 0, so ds = 0). dq's accumulators are
  // overwritten by the first product: no instruction but wgmma defines an
  // accumulator.
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    products(tiles + t);
#pragma unroll
    for (int e = 0; e < kT / 2; ++e) {
      const int r = (e >> 1) & 1;
      const float p = __fmul_rn(expf(__fsub_rn(s[e], m[r])), inv[r]);
      s[e] = __fmul_rn(p, __fsub_rn(dp[e], delta[r]));
    }
    acc_fragments(s, ah, al);
    issue_at_tf32<kDP, kN>(dq, ah, al, kth, ktl, t > 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c) acc_fence<kN / 2>(dq[c]);

  // every warp is past its last read of the tiles: dq through them
  constexpr int kPitch = out_pitch<kDP>();
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c)
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) dq[c][e] = __fmul_rn(dq[c][e], scale);
  consumers_sync();
  float* out = reinterpret_cast<float*>(base);
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c)
    stage_acc<kN, float, kPitch>(out, dq[c], kN * c, warp, lane);
  consumers_sync();
  store_rows<float, kPitch>(out, dqkv, b, h, row0, S, 3 * H, dh,
                            tid);  // the dq lane
}

template <int kDP>
cudaError_t launch_width(const keep_attn::BwdF32Args& a) {
  constexpr int smem = f32_smem_bytes(F32Layout<kDP>::kTiles);
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr = allow_smem(
      slab_attention_bwd_f32_dq_kernel<kDP>, smem, smem_allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_bwd_f32_dq_kernel<kDP><<<grid, kConsumers, smem,
                                          a.stream>>>(
      a.q, a.k, a.v, a.dout, a.key_bias, a.dqkv, a.stats, a.S, a.H, a.dh,
      a.scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t keep_attn::launch_bwd_f32_dq(const BwdF32Args& a) {
  switch ((a.dh + 31) / 32) {  // Dh padded to a multiple of 32
    case 2:
      return launch_width<64>(a);
    case 3:
      return launch_width<96>(a);
    case 4:
      return launch_width<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
