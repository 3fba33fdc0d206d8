// Kernel B of the bf16 attention backward for Hopper (sm_90a): dk and dv,
// on wgmma fed by TMA, at every head width the port takes and any S. The
// formula, the rounding points and what bounds the pair are set out at the
// head of kernel A (attention_qkv_slab_bwd_dq.cu), which runs first on the
// same stream and leaves each query row's statistics (m, 1/l, rowsum(dp o
// p)) in an fp32 [B, H, S] x float4 scratch.
//
// One block per (64 keys, head, batch row): one warpgroup (four warps, 16
// keys each), whose thread 0 also issues the TMA loads, as kernel A's.
//   - K's and V's 64 rows come once by TMA (the maps and panels of kernel
//     A), then the query tiles stream through a ring:
//     a stage holds Q's and dO's 64 rows and their 64 statistics (a 4-D map
//     over the scratch, 1 KB boxes; rows past S arrive as zeros).
//   - Per query tile, in sub-tiles of kSub queries (32 up to Dh 80, 16
//     past it, which keeps dk's and dv's Dh-wide fp32 sums, two panels
//     each, in registers beside the sub-tile's without serialising the
//     wgmma): s^T = K . Q^T and dp^T = V . dO^T by
//     wgmma from shared memory (K-major, m64n{kSub}k16); p^T = exp(s^T *
//     scale + bias - m) * (1/l) and ds^T = p^T (dp^T - rowsum) in fp32
//     from the statistics of each query column, read from the stage; query
//     columns past S are set to 0 here (their statistics are not kernel A's);
//     p^T and ds^T rounded to bf16 into A fragments; dv += p^T . dO and
//     dk += ds^T . Q by wgmma with A from registers and B MN-major: the
//     same swizzled Q and dO rows serve both as K-major operands of s^T and
//     dp^T and as MN-major operands here. The last tile's queries past S
//     are taken too (their p^T and ds^T are exact zeros: a wgmma under a
//     branch is serialised by ptxas). Issuing the next sub-tile's s^T and
//     dp^T before this one's dv and dk was slower on an H100: ptxas cannot
//     see across the loop which group a partial wait retires, and
//     serialises the wgmma (C7514).
//   - The epilogue scales dk in fp32, stages dk and dv through the ring and
//     writes keys < S, columns < Dh, in 16-byte stores.
// Three ring stages at Dh = 64 (68 KB of shared memory a block: three
// blocks an SM), two of two panels past it (99 KB: two).

#include "wgmma_attention.cuh"

namespace {

constexpr int kStatsBytes = kTileKeys * 16;  // a tile's float4 statistics

template <int kDP>
__host__ __device__ constexpr int dkv_stages() {
  return kDP > 64 ? 2 : 3;
}

// Queries of a sub-tile (the N of s^T and dp^T): fewer as dk's and dv's
// fp32 sums grow, so that no instance spills under the two-block cap.
template <int kDP>
__host__ __device__ constexpr int dkv_sub() {
  return kDP > 80 ? 16 : 32;
}

// Bytes of one stage: Q's and dO's 64 rows, then their statistics.
template <int kDP>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 2 * ((kDP + 63) / 64) * kPanelBytes + kStatsBytes;
}

// Shared memory of kernel B: K's and V's tiles, the ring's stages, 2
// mbarriers a stage and K / V's, and 1 KB to align.
template <int kDP>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return 1024 + size_t(2 * ((kDP + 63) / 64) * kPanelBytes) +
         size_t(dkv_stages<kDP>()) * dkv_stage_bytes<kDP>() +
         (2 * dkv_stages<kDP>() + 1) * 8;
}

// Three blocks an SM at Dh 64, two past it (shared memory allows no more).
template <int kDP>
__global__ void __launch_bounds__(kConsumers, kDP == 64 ? 3 : 2)
slab_attention_bwd_wgmma_dkv_kernel(
    const __grid_constant__ CUtensorMap map_q,
    const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_stats,
    const float* __restrict__ key_bias, bf16* __restrict__ dqkv, int S,
    int H, int dh, float scale) {
  constexpr int kPanels = (kDP + 63) / 64;
  constexpr int kTile = kPanels * kPanelBytes;  // one operand's 64 rows
  constexpr int kStages = dkv_stages<kDP>();
  constexpr int kStage = dkv_stage_bytes<kDP>();
  constexpr int kSub = dkv_sub<kDP>();
  constexpr int kN1 = kDP - 64;  // the second panel's output columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + kTile;
  uint8_t* ring = v_s + kTile;  // stage j at j * kStage
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;
  uint64_t* kv_bar = empty + kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kQRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = (S + kTileKeys - 1) / kTileKeys;

  // query tile j's Q, dO and statistics, loaded by thread 0 into stage
  // j % kStages once the four warps released the stage's previous tile
  auto load = [&](int j) {
    const int st = j % kStages;
    uint8_t* stage = ring + st * kStage;
    if (j >= kStages) mbar_wait(&empty[st], (j / kStages - 1) & 1);
    mbar_expect_tx(&full[st], kStage);
    for (int p = 0; p < kPanels; ++p) {
      tma_load_4d(stage + p * kPanelBytes, &map_q, &full[st], 64 * p,
                  j * kTileKeys, h, b);
      tma_load_4d(stage + kTile + p * kPanelBytes, &map_do, &full[st],
                  64 * p, j * kTileKeys, h, b);
    }
    tma_load_4d(stage + 2 * kTile, &map_stats, &full[st], 0, j * kTileKeys,
                h, b);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(kv_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(kv_bar, 2 * kTile);
    for (int p = 0; p < kPanels; ++p) {
      tma_load_4d(k_s + p * kPanelBytes, &map_k, kv_bar, 64 * p, key0, h, b);
      tma_load_4d(v_s + p * kPanelBytes, &map_v, kv_bar, 64 * p, key0, h, b);
    }
    for (int j = 0; j < kStages && j < tiles; ++j) load(j);
  }
  __syncthreads();

  // this thread's keys (rows of s^T): gid and gid + 8 of the warp's 16;
  // keys past S score -inf (their dk and dv are not stored)
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 16 * warp + (lane >> 2) + 8 * r;
    kbias[r] = key < S ? __ldg(key_bias + (long long)b * S + key) : -INFINITY;
  }
  // (the first products overwrite them, as kernel A's dq)
  float dk0[32], dv0[32];
  float dk1[kN1 > 0 ? kN1 / 2 : 1], dv1[kN1 > 0 ? kN1 / 2 : 1];
  float s_t[kSub / 2], dp_t[kSub / 2];  // s^T, then p^T; dp^T, then ds^T
  uint32_t pa[kSub / 16][4], da[kSub / 16][4];
  mbar_wait(kv_bar, 0);

#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&full[st], (j / kStages) & 1);
    const uint8_t* q_t = ring + st * kStage;
    const uint8_t* g_t = q_t + kTile;
    const float4* sts = reinterpret_cast<const float4*>(q_t + 2 * kTile);
#pragma unroll
    for (int hh = 0; hh < kTileKeys / kSub; ++hh) {
      issue_abt<kDP, kSub>(s_t, k_s, q_t, hh * kSub);
      issue_abt<kDP, kSub>(dp_t, v_s, g_t, hh * kSub);
      wgmma_wait<0>();  // s^T, dp^T and the previous sub-tile's products
      acc_fence<kSub / 2>(s_t);
      acc_fence<kSub / 2>(dp_t);
      if (hh == 0 && j > 0) {
        release(&empty[(j - 1) % kStages], lane);
        if (threadIdx.x == 0 && j - 1 + kStages < tiles)
          load(j - 1 + kStages);
      }
#pragma unroll
      for (int i = 0; i < kSub / 2; ++i) {
        const int qc = hh * kSub + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const float4 sq = sts[qc];  // m, 1/l, rowsum(dp o p) of the query
        const float x = __fadd_rn(__fmul_rn(s_t[i], scale),
                                  kbias[(i >> 1) & 1]);
        const float p = __fmul_rn(expf(__fsub_rn(x, sq.x)), sq.y);
        const float ds = __fmul_rn(p, __fsub_rn(dp_t[i], sq.z));
        const bool in = j * kTileKeys + qc < S;
        s_t[i] = in ? p : 0.f;
        dp_t[i] = in ? ds : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kSub / 16; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[c][e] = pack_bf16(s_t[8 * c + 2 * e], s_t[8 * c + 2 * e + 1]);
          da[c][e] = pack_bf16(dp_t[8 * c + 2 * e], dp_t[8 * c + 2 * e + 1]);
        }
      // dv += p^T . dO, dk += ds^T . Q over the sub-tile's 16-query pieces
      // (16 queries are 2 KB of a panel: +128)
      acc_fence<32>(dk0);
      acc_fence<32>(dv0);
      if constexpr (kN1 > 0) {
        acc_fence<kN1 / 2>(dk1);
        acc_fence<kN1 / 2>(dv1);
      }
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kSub / 16; ++c) {
        const int kc = hh * (kSub / 16) + c;
        const int acc = j > 0 || kc > 0;
        wgmma_rs<1>(Width<64>{}, dv0, pa[c], smem_desc_mn(g_t) + 128 * kc,
                    acc);
        wgmma_rs<1>(Width<64>{}, dk0, da[c], smem_desc_mn(q_t) + 128 * kc,
                    acc);
        if constexpr (kN1 > 0) {
          wgmma_rs<1>(Width<kN1>{}, dv1, pa[c],
                      smem_desc_mn(g_t + kPanelBytes) + 128 * kc, acc);
          wgmma_rs<1>(Width<kN1>{}, dk1, da[c],
                      smem_desc_mn(q_t + kPanelBytes) + 128 * kc, acc);
        }
      }
      wgmma_commit();
      acc_fence<32>(dk0);
      acc_fence<32>(dv0);
      if constexpr (kN1 > 0) {
        acc_fence<kN1 / 2>(dk1);
        acc_fence<kN1 / 2>(dv1);
      }
    }
  }
  wgmma_wait<0>();
  acc_fence<32>(dk0);
  acc_fence<32>(dv0);
  if constexpr (kN1 > 0) {
    acc_fence<kN1 / 2>(dk1);
    acc_fence<kN1 / 2>(dv1);
  }

  // every consumer warp is past its last read of the ring: dk and dv
  // through it
  constexpr int kPitch = out_pitch<kDP>();
#pragma unroll
  for (int i = 0; i < 32; ++i) dk0[i] = __fmul_rn(dk0[i], scale);
  if constexpr (kN1 > 0) {
#pragma unroll
    for (int i = 0; i < kN1 / 2; ++i) dk1[i] = __fmul_rn(dk1[i], scale);
  }
  consumers_sync();
  bf16* dk_stage = reinterpret_cast<bf16*>(ring);
  bf16* dv_stage = dk_stage + kQRows * kPitch;
  stage_acc<64, bf16, kPitch>(dk_stage, dk0, 0, warp, lane);
  stage_acc<64, bf16, kPitch>(dv_stage, dv0, 0, warp, lane);
  if constexpr (kN1 > 0) {
    stage_acc<kN1, bf16, kPitch>(dk_stage, dk1, 64, warp, lane);
    stage_acc<kN1, bf16, kPitch>(dv_stage, dv1, 64, warp, lane);
  }
  consumers_sync();
  // the dk and dv lanes of the slab, rows 3 * H * dh apart
  store_rows<bf16, kPitch>(dk_stage, dqkv + (long long)H * dh, b, h, key0, S,
                           3 * H, dh, threadIdx.x);
  store_rows<bf16, kPitch>(dv_stage, dqkv + 2LL * H * dh, b, h, key0, S,
                           3 * H, dh, threadIdx.x);
}

template <int kDP>
cudaError_t launch_width(const keep_attn::BwdArgs& a) {
  constexpr size_t smem = dkv_smem_bytes<kDP>();
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr = allow_smem(
      slab_attention_bwd_wgmma_dkv_kernel<kDP>, int(smem), smem_allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_bwd_wgmma_dkv_kernel<kDP><<<grid, kConsumers, smem,
                                             a.stream>>>(
      a.q, a.k, a.v, a.dout, a.stats_map, a.key_bias, a.dqkv, a.S, a.H, a.dh,
      a.scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t keep_attn::launch_bwd_dkv(const BwdArgs& a) {
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
