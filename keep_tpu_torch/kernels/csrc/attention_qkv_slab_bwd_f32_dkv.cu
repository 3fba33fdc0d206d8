// Kernel B of the fp32 attention backward for Hopper (sm_90a): dk and dv,
// in split TF32 on wgmma fed by TMA, at every head width the port takes
// and any S. The formula, what bounds the pair and the split are set out
// at the head of kernel A (attention_qkv_slab_bwd_f32_dq.cu) and in
// tf32_attention.cuh; kernel A runs first on the same stream and leaves
// each query row's statistics (m, 1/l, rowsum(dp o p)) in an fp32
// [B, H, S] x float4 scratch.
//
// One block per (64 keys, head, batch row), one warpgroup (four warps, 16
// keys each), whose thread 0 also issues the TMA loads:
//   - K's and V's 64 rows come once by TMA and are split in place into hi
//     and a lo copy, the A operands of s^T and dp^T: at Dh 64 the hi parts
//     move into register fragments (F32Shape::kRegA) and their tiles'
//     space goes to the stage, past it both parts stay in shared memory.
//   - The 32-query tiles Q(j), dO(j) arrive through one stage. The threads
//     split both in place and write their lo parts beside them (the B
//     operands of s^T and dp^T) and Q(j)^T's two parts into the transposed
//     pair (dk's B operand).
//   - Per tile: s^T = K . Q^T and dp^T = V . dO^T (kDP / 8 k8 steps x 3
//     wgmma m64n32k8 each); the statistics of the thread's query columns
//     are loaded from the scratch (L2) while they run (in the stage they
//     would cost the second block an SM at Dh 64); p^T = exp(s^T * scale +
//     bias - m) * (1/l) and ds^T = p^T (dp^T - rowsum) in fp32, query
//     columns past S set to 0 (their statistics are not kernel A's); ds^T
//     split in registers into the A fragments of dk += ds^T . Q; then the
//     threads write dO(j)^T into the transposed pair (once dk has read
//     Q(j)^T), hand the stage to tile j + 1, and p^T's fragments give dv
//     += p^T . dO. One transposed pair, used twice, keeps Dh 128 within 227
//     KB.
//   - The epilogue scales dk in fp32, stages dk and dv through shared
//     memory and writes keys < S, columns < Dh, in 16-byte stores.
// Shared memory as kernel A's: 80 KB at Dh 64 (two blocks an SM), 168 and
// 224 KB at Dh 96 and 128 (one).

#include "tf32_attention.cuh"

namespace {

template <int kDP>
__global__ void __launch_bounds__(kConsumers, 1)
slab_attention_bwd_f32_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const __grid_constant__ CUtensorMap map_do,
                                  const float* __restrict__ key_bias,
                                  const float4* __restrict__ stats,
                                  float* __restrict__ dqkv, int S, int H,
                                  int dh, float scale) {
  using Sh = F32Shape<kDP>;
  using L = F32Layout<kDP>;
  constexpr int kT = kF32Tile;
  constexpr int kN = Sh::kN;
  constexpr int kRes = L::kRes;  // K's or V's 64 rows
  constexpr int kStr = L::kStr;  // a kT-row tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align1024(smem_raw);
  uint8_t* kl = base;  // K's and V's lo parts
  uint8_t* vl = kl + kRes;
  uint8_t* kh = base + L::kHi;  // their hi parts (or landing)
  uint8_t* vh = kh + kRes;
  uint8_t* stage = base + L::kStage;  // stage j: Q(j), dO(j), split in place
  uint8_t* ql = base + L::kLoStr;
  uint8_t* gl = ql + kStr;
  uint8_t* xth = gl + kStr;  // Q(j)^T, then dO(j)^T [kDP][kT queries]
  uint8_t* xtl = xth + kStr;
  uint64_t* full = f32_barriers(smem_raw, base, L::kTiles);
  uint64_t* kv_bar = full + 1;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kQRows;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tiles = (S + kT - 1) / kT;

  auto load = [&](int j) {
    mbar_expect_tx(full, 2 * kStr);
    load_rows<kDP>(stage, &map_q, full, kT, j * kT, h, b);
    load_rows<kDP>(stage + kStr, &map_do, full, kT, j * kT, h, b);
  };
  if (tid == 0) {
    mbar_init(full, 1);
    mbar_init(kv_bar, 1);
    mbar_init_fence();
    mbar_expect_tx(kv_bar, 2 * kRes);
    load_rows<kDP>(kh, &map_k, kv_bar, kQRows, key0, h, b);
    load_rows<kDP>(vh, &map_v, kv_bar, kQRows, key0, h, b);
    if (!Sh::kRegA) load(0);
  }
  __syncthreads();

  // this thread's keys (rows of s^T): g and g + 8 of the warp's 16; keys
  // past S score -inf (their dk and dv are not stored)
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 16 * warp + (lane >> 2) + 8 * r;
    kbias[r] = key < S ? __ldg(key_bias + (long long)b * S + key) : -INFINITY;
  }
  const float4* st = stats + ((long long)b * H + h) * S;
  mbar_wait(kv_bar, 0);
  split_tile<kDP, kQRows, false>(kh, kl, nullptr, nullptr, tid);
  split_tile<kDP, kQRows, false>(vh, vl, nullptr, nullptr, tid);
  uint32_t kf[kDP / 8][4], vf[kDP / 8][4];  // K's and V's hi (kRegA)
  if constexpr (Sh::kRegA) {
    consumers_sync();  // the split is done
    tile_fragments<kDP>(kf, kh, warp, lane);
    tile_fragments<kDP>(vf, vh, warp, lane);
    fence_proxy_async();
    consumers_sync();  // the stage may now take the landing area
    if (tid == 0) load(0);
  }

  // (the first products overwrite them, as kernel A's dq)
  float dk[kDP / kN][kN / 2], dv[kDP / kN][kN / 2];
  float s_t[kT / 2], dp_t[kT / 2];  // s^T, then p^T; dp^T, then ds^T
  float4 sq[kT / 4];                // the statistics of this thread's queries
  uint32_t ah[kT / 8][4], al[kT / 8][4];
#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    uint8_t* qs = stage;
    uint8_t* gs = stage + kStr;
    mbar_wait(full, j & 1);
    wgmma_wait<0>();  // the previous tile's dv has read dO^T
    split_tile<kDP, kT, true>(qs, ql, xth, xtl, tid);
    split_tile<kDP, kT, false>(gs, gl, nullptr, nullptr, tid);
    fence_proxy_async();
    consumers_sync();
    if constexpr (Sh::kRegA) {
      issue_abt_tf32<kDP>(s_t, kf, kl, qs, ql);
      issue_abt_tf32<kDP>(dp_t, vf, vl, gs, gl);
    } else {
      issue_abt_tf32<kDP>(s_t, kh, kl, qs, ql);
      issue_abt_tf32<kDP>(dp_t, vh, vl, gs, gl);
    }
    // element e: query column qc = 8 (e / 4) + 2 (lane % 4) + e % 2;
    // sq[2 (e / 4) + e % 2] its m, 1/l and rowsum(dp o p)
#pragma unroll
    for (int c = 0; c < kT / 4; ++c) {
      const int q = j * kT + 8 * (c >> 1) + 2 * (lane & 3) + (c & 1);
      sq[c] = q < S ? __ldg(st + q) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    wgmma_wait<0>();
    acc_fence<kT / 2>(s_t);
    acc_fence<kT / 2>(dp_t);
#pragma unroll
    for (int e = 0; e < kT / 2; ++e) {
      const int qc = 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
      const float4 q4 = sq[2 * (e >> 2) + (e & 1)];
      const float x = __fadd_rn(__fmul_rn(s_t[e], scale),
                                kbias[(e >> 1) & 1]);
      const float p = __fmul_rn(expf(__fsub_rn(x, q4.x)), q4.y);
      const float ds = __fmul_rn(p, __fsub_rn(dp_t[e], q4.z));
      const bool in = j * kT + qc < S;
      s_t[e] = in ? p : 0.f;
      dp_t[e] = in ? ds : 0.f;
    }
    // dk += ds^T . Q, B = Q(j)^T
    acc_fragments(dp_t, ah, al);
    issue_at_tf32<kDP, kN>(dk, ah, al, xth, xtl, j > 0);
    wgmma_wait<0>();
    // dO(j)^T into the pair dk has read; then the stage is free
    transpose_tile<kDP, kT>(gs, gl, xth, xtl, tid);
    fence_proxy_async();
    consumers_sync();
    if (tid == 0 && j + 1 < tiles) load(j + 1);
    // dv += p^T . dO, B = dO(j)^T
    acc_fragments(s_t, ah, al);
    issue_at_tf32<kDP, kN>(dv, ah, al, xth, xtl, j > 0);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c) {
    acc_fence<kN / 2>(dk[c]);
    acc_fence<kN / 2>(dv[c]);
  }

  // every warp is past its last read of the tiles: dk and dv through them
  constexpr int kPitch = out_pitch<kDP>();
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c)
#pragma unroll
    for (int e = 0; e < kN / 2; ++e) dk[c][e] = __fmul_rn(dk[c][e], scale);
  consumers_sync();
  float* dk_stage = reinterpret_cast<float*>(base);
  float* dv_stage = dk_stage + kQRows * kPitch;
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c) {
    stage_acc<kN, float, kPitch>(dk_stage, dk[c], kN * c, warp, lane);
    stage_acc<kN, float, kPitch>(dv_stage, dv[c], kN * c, warp, lane);
  }
  consumers_sync();
  // the dk and dv lanes of the slab, rows 3 * H * dh apart
  store_rows<float, kPitch>(dk_stage, dqkv + (long long)H * dh, b, h, key0,
                            S, 3 * H, dh, tid);
  store_rows<float, kPitch>(dv_stage, dqkv + 2LL * H * dh, b, h, key0, S,
                            3 * H, dh, tid);
}

template <int kDP>
cudaError_t launch_width(const keep_attn::BwdF32Args& a) {
  constexpr int smem = f32_smem_bytes(F32Layout<kDP>::kTiles);
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr = allow_smem(
      slab_attention_bwd_f32_dkv_kernel<kDP>, smem, smem_allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_bwd_f32_dkv_kernel<kDP><<<grid, kConsumers, smem,
                                           a.stream>>>(
      a.q, a.k, a.v, a.dout, a.key_bias, a.stats, a.dqkv, a.S, a.H, a.dh,
      a.scale);
  return cudaGetLastError();
}

}  // namespace

cudaError_t keep_attn::launch_bwd_f32_dkv(const BwdF32Args& a) {
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
