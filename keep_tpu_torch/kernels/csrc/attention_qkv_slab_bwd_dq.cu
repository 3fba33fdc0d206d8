// Kernel A of the bf16 attention backward for Hopper (sm_90a): the row
// statistics and dq, on wgmma fed by TMA, at every head width the port
// takes (multiples of 8 from 64 to 128) and any S. Kernel B (dk, dv) is
// attention_qkv_slab_bwd_dkv.cu; attention_qkv_slab_bwd.cu's entry point
// writes the TMA maps and launches A, then B, on one stream.
//
// Replaces, with kernel B, the bf16 path of keep_tpu/kernels/flash_attention.py
// `_slab_attn_bwd` (:221-245), the closed-form VJP of the Pallas slab
// attention. Per batch row b and head h, with q, k, v the Dh-wide lanes of
// qkv[B, S, 3*H*Dh] and do the lane of dout[B, S, H*Dh]:
//   s  = (q . k^T) * Dh^-0.5 + key_bias[b, :]   (fp32 sums of bf16 products)
//   p  = softmax(s) in fp32,  dp = do . v^T,  ds = p o (dp - rowsum(dp o p))
//   dq = (ds . k) * scale,  dk = (ds^T . q) * scale,  dv = p^T . do
// p and ds are rounded to bf16 only as the A operands of their products;
// rowsum(dp o p) keeps p in fp32; every sum is fp32, cast once to bf16 into
// the slab layout of dqkv (dq lanes, then dk, then dv). No gradient flows
// to the key bias. Deterministic: two kernels, no atomics, every output
// element written by one thread after sums in a fixed order.
//
// What bounds it on this card: bytes at the towers' shapes (ViT-L B = 128:
// 7 * B*S*H*Dh bf16 values, 361.5 MB, 0.108 ms at 3.35 TB/s), operations
// past S ~ 400 at Dh 64. Without atomics the two kernels take nine
// S^2*Dh products a head against the five of one kernel with atomic dq
// sums: rowsum(dp o p) needs a whole row of p before any ds, so kernel A
// takes s and dp twice, and kernel B takes them once more.
//
// Kernel A, one block per (64 query rows, head, batch row): one warpgroup
// (four warps, 16 rows each); its thread 0 also issues the TMA loads (a
// producer warp of its own would take the fifth warp's registers, and
// with them the third block an SM at Dh 64).
//   - Q's and dO's 64 rows come once by TMA (a 4-D map per
//     operand over [B, H, S, Dh], read through the slab's strides, boxes of
//     64 rows x 64 columns with the 128-byte swizzle: Dh > 64 is two
//     64-column panels, columns past Dh and rows past S arrive as zeros),
//     then the 64-key tiles K(0), V(0), K(1), V(1), ... stream through a
//     ring of stages twice, one pass each, each stage with a `full`
//     mbarrier (TMA's bytes) and an `empty` one (one arrival per warp once
//     its wgmma have read the stage; thread 0 then refills the stage).
//   - Pass 1, per tile: s = Q . K^T and dp = dO . V^T by wgmma (both
//     operands from shared memory, K-major, m64n64k16, Dh / 16 steps), as
//     two groups, so that the scores' max and exponentials run while dp is
//     summed (issuing the next tile's products before this tile's
//     elementwise work, in a second set of registers, was slower on an
//     H100, spilling or not); the scores scaled, then biased (the
//     reference's order), keys past S at -inf; the online max m (over the
//     quad of a row at each tile), and the sums l = sum e and u = sum e *
//     dp, e = exp(s - m), rescaled by exp(m_old - m_new) at each tile,
//     each thread's in key order, then the quad's butterfly. Statistics
//     (m, 1/l, u/l) to an fp32 float4 scratch for kernel B.
//   - Pass 2, per tile: s and dp again; p = exp(s - m) * (1/l) and
//     ds = p (dp - u/l) in fp32; ds rounded to bf16 in registers into the
//     wgmma A fragments; dq += ds . K on wgmma with A from registers and B
//     (K's tile) MN-major, one wgmma per 64 output columns and k16 step of
//     keys, the last tile's pieces past S too (their ds are exact zeros:
//     a wgmma under a branch is serialised by ptxas). K(t)'s stage is
//     held until that product is done, V(t)'s released once dp is.
//     Issuing the next tile's s and dp before this tile's ds . K was no
//     faster on an H100, across the loop's back edge (ptxas cannot see
//     which group a partial wait retires and serialises the wgmma, C7514)
//     or within a step of two tiles (more registers, spills past Dh 80);
//     ds through a swizzled shared tile as an A operand from shared
//     memory was within 5% either way (slower at Dh 64, faster at 88 and
//     104, without the spills at 96 and 112).
//   - The key bias of a tile is loaded once a key into registers (16
//     loads a thread, where a load an element was ~15% slower at the
//     towers' shapes), before the scores are waited for; only the last
//     tile tests keys past S.
//   - The epilogue scales dq in fp32, stages it through the ring and writes
//     rows < S, columns < Dh, in 16-byte stores.
// Six ring stages at Dh = 64 (65 KB of shared memory a block: three
// blocks an SM), four of two panels past it (97 KB: two), so that one
// block's exponentials overlap another's products.

#include "wgmma_attention.cuh"

namespace {

template <int kDP>
__host__ __device__ constexpr int dq_stages() {
  return kDP > 64 ? 4 : 6;  // at least 4: K(t) is held while V(t), K(t + 1)
                            // and V(t + 1) arrive
}

// Shared memory of kernel A at padded width kDP: Q's and dO's tiles, the
// ring's stages, 2 mbarriers a stage and Q / dO's, and 1 KB to align.
template <int kDP>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  constexpr int kPanels = (kDP + 63) / 64;
  return 1024 + size_t(kPanels) * kPanelBytes * (2 + dq_stages<kDP>()) +
         (2 * dq_stages<kDP>() + 1) * 8;
}

// The key bias of this thread's keys of the tile from key0, bj[2n + jj]
// for key key0 + 8n + 2*(lane % 4) + jj (-inf at or past S; only the last
// tile tests them). Loaded before the tile's scores are waited for, so
// that the loads run under the products.
__device__ __forceinline__ void load_bias(float (&bj)[16],
                                          const float* __restrict__ bias,
                                          int key0, int S, int lane) {
  const int j0 = key0 + 2 * (lane & 3);
  if (key0 + kTileKeys <= S) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      bj[i] = __ldg(bias + j0 + 8 * (i >> 1) + (i & 1));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = j0 + 8 * (i >> 1) + (i & 1);
      bj[i] = j < S ? __ldg(bias + j) : -INFINITY;
    }
  }
}

// s = s * scale + key bias (the reference's order): element i of s is
// row (i / 2) % 2 and key 8 * (i / 4) + i % 2 of this thread's.
__device__ __forceinline__ void bias_scores(float (&s)[32],
                                            const float (&bj)[16],
                                            float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i)
    s[i] = __fadd_rn(__fmul_rn(s[i], scale), bj[2 * (i >> 2) + (i & 1)]);
}

// Three blocks an SM at Dh 64, two past it (shared memory allows no more).
template <int kDP>
__global__ void __launch_bounds__(kConsumers, kDP == 64 ? 3 : 2)
slab_attention_bwd_wgmma_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                                   const __grid_constant__ CUtensorMap map_k,
                                   const __grid_constant__ CUtensorMap map_v,
                                   const __grid_constant__ CUtensorMap map_do,
                                   const float* __restrict__ key_bias,
                                   bf16* __restrict__ dqkv,
                                   float4* __restrict__ stats, int S, int H,
                                   int dh, float scale) {
  constexpr int kPanels = (kDP + 63) / 64;
  constexpr int kTile = kPanels * kPanelBytes;  // one operand's 64 rows
  constexpr int kStages = dq_stages<kDP>();
  constexpr int kN1 = kDP - 64;  // the second panel's output columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* g_s = q_s + kTile;  // dO
  uint8_t* ring = g_s + kTile;  // stage i at i * kTile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* qg_bar = empty + kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kQRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = (S + kTileKeys - 1) / kTileKeys;

  // item i of the ring, K(t) at i = 2t and V(t) at 2t + 1 of each pass,
  // loaded by thread 0 into stage i % kStages once the four warps released
  // the stage's previous item
  auto load = [&](int i) {
    const int st = i % kStages;
    if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
    mbar_expect_tx(&full[st], kTile);
    const int key0 = (i % (2 * tiles)) / 2 * kTileKeys;
    for (int p = 0; p < kPanels; ++p)
      tma_load_4d(ring + st * kTile + p * kPanelBytes,
                  (i & 1) ? &map_v : &map_k, &full[st], 64 * p, key0, h, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(qg_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(qg_bar, 2 * kTile);
    for (int p = 0; p < kPanels; ++p) {
      tma_load_4d(q_s + p * kPanelBytes, &map_q, qg_bar, 64 * p, row0, h, b);
      tma_load_4d(g_s + p * kPanelBytes, &map_do, qg_bar, 64 * p, row0, h, b);
    }
    for (int i = 0; i < kStages && i < 4 * tiles; ++i) load(i);
  }
  __syncthreads();

  const float* bias = key_bias + (long long)b * S;
  auto tile = [&](int i) { return ring + (i % kStages) * kTile; };
  auto arrived = [&](int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  };
  auto done_with = [&](int i) {
    release(&empty[i % kStages], lane);
    if (threadIdx.x == 0 && i + kStages < 4 * tiles) load(i + kStages);
  };
  mbar_wait(qg_bar, 0);

  // Pass 1: the row max m, the sums l = sum e and u = sum e * dp, online.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
  float s[32], dp[32], bj[16];
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    arrived(2 * t);
    issue_abt<kDP, 64>(s, q_s, tile(2 * t), 0);
    arrived(2 * t + 1);
    issue_abt<kDP, 64>(dp, g_s, tile(2 * t + 1), 0);
    load_bias(bj, bias, t * kTileKeys, S, lane);
    wgmma_wait<1>();  // s
    acc_fence<32>(s);
    done_with(2 * t);
    bias_scores(s, bj, scale);
    // every tile holds a key < S, so the new max is finite
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 32; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      const float alpha = expf(__fsub_rn(m[r], mx[r]));  // 0 at t = 0
      l[r] = __fmul_rn(l[r], alpha);
      u[r] = __fmul_rn(u[r], alpha);
      m[r] = mx[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = expf(__fsub_rn(s[i], m[(i >> 1) & 1]));
    wgmma_wait<0>();  // dp
    acc_fence<32>(dp);
    done_with(2 * t + 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      l[r] = __fadd_rn(l[r], s[i]);
      u[r] = __fmaf_rn(s[i], dp[i], u[r]);
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

  // Pass 2: ds = p (dp - rowsum) rounded to bf16; dq += ds . K. K(t) and
  // V(t) are items 2T + 2t and 2T + 2t + 1. dq's accumulators are
  // overwritten by the first product: no instruction but wgmma defines an
  // accumulator, which would make ptxas serialise the wgmma.
  float dq0[32];
  float dq1[kN1 > 0 ? kN1 / 2 : 1];
  uint32_t da[4][4];
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    const int i = 2 * tiles + 2 * t;
    arrived(i);
    issue_abt<kDP, 64>(s, q_s, tile(i), 0);
    arrived(i + 1);
    issue_abt<kDP, 64>(dp, g_s, tile(i + 1), 0);
    load_bias(bj, bias, t * kTileKeys, S, lane);
    wgmma_wait<1>();  // tile t - 1's ds . K, then s
    acc_fence<32>(s);
    if (t > 0) done_with(i - 2);  // K(t - 1)
    bias_scores(s, bj, scale);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int r = (j >> 1) & 1;
      s[j] = __fmul_rn(expf(__fsub_rn(s[j], m[r])), inv[r]);  // p
    }
    wgmma_wait<0>();  // dp
    acc_fence<32>(dp);
    done_with(i + 1);  // V(t)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * c + 2 * j;
        const int r = j & 1;
        da[c][j] = pack_bf16(__fmul_rn(s[e], __fsub_rn(dp[e], delta[r])),
                             __fmul_rn(s[e + 1],
                                       __fsub_rn(dp[e + 1], delta[r])));
      }
    const uint8_t* k_tile = tile(i);
    acc_fence<32>(dq0);
    if constexpr (kN1 > 0) acc_fence<kN1 / 2>(dq1);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 keys are 2 KB of a panel (+128)
      wgmma_rs<1>(Width<64>{}, dq0, da[c], smem_desc_mn(k_tile) + 128 * c,
                  t > 0 || c > 0);
      if constexpr (kN1 > 0)
        wgmma_rs<1>(Width<kN1>{}, dq1, da[c],
                    smem_desc_mn(k_tile + kPanelBytes) + 128 * c,
                    t > 0 || c > 0);
    }
    wgmma_commit();
    acc_fence<32>(dq0);
    if constexpr (kN1 > 0) acc_fence<kN1 / 2>(dq1);
  }
  wgmma_wait<0>();
  acc_fence<32>(dq0);
  if constexpr (kN1 > 0) acc_fence<kN1 / 2>(dq1);

  // every consumer warp is past its last read of the ring: dq through it
  constexpr int kPitch = out_pitch<kDP>();
#pragma unroll
  for (int i = 0; i < 32; ++i) dq0[i] = __fmul_rn(dq0[i], scale);
  if constexpr (kN1 > 0) {
#pragma unroll
    for (int i = 0; i < kN1 / 2; ++i) dq1[i] = __fmul_rn(dq1[i], scale);
  }
  consumers_sync();
  bf16* stage = reinterpret_cast<bf16*>(ring);
  stage_acc<64, bf16, kPitch>(stage, dq0, 0, warp, lane);
  if constexpr (kN1 > 0)
    stage_acc<kN1, bf16, kPitch>(stage, dq1, 64, warp, lane);
  consumers_sync();
  store_rows<bf16, kPitch>(stage, dqkv, b, h, row0, S, 3 * H, dh,
                           threadIdx.x);  // the dq lane
}

template <int kDP>
cudaError_t launch_width(const keep_attn::BwdArgs& a) {
  constexpr size_t smem = dq_smem_bytes<kDP>();
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr = allow_smem(
      slab_attention_bwd_wgmma_dq_kernel<kDP>, int(smem), smem_allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_bwd_wgmma_dq_kernel<kDP><<<grid, kConsumers, smem,
                                            a.stream>>>(
      a.q, a.k, a.v, a.dout, a.key_bias, a.dqkv, a.stats, a.S, a.H, a.dh,
      a.scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t keep_attn::launch_bwd_dq(const BwdArgs& a) {
  switch ((a.dh + 15) / 16) {  // Dh padded to a multiple of 16
    case 4:
      return launch_width<64>(a);
    case 5:
      return launch_width<80>(a);
    case 6:
      return launch_width<96>(a);
    case 7:
      return launch_width<112>(a);
    case 8:
      return launch_width<128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}
