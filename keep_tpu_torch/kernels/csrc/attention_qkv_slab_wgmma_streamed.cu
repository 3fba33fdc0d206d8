// The streamed body of the bf16 attention forward (see
// attention_qkv_slab_wgmma.cu, whose entry point launches it through
// keep_attn::launch_streamed at every shape the one-pass body does not
// take).

#include "wgmma_attention.cuh"

namespace {

// ---- the streamed body: any Dh, any S ----------------------------------------------

// Ring stages of the streamed body, each one operand's 64-key tile: four
// at Dh > 64 (16 KB each, so that two blocks fit an SM), six at Dh = 64.
template <int kDP>
__host__ __device__ constexpr int ring_stages() {
  return kDP > 64 ? 4 : 6;
}

// Shared memory of the streamed body at padded width kDP: the Q tile and
// the ring's stages (one 64-column panel per 64 of kDP each), 2 mbarriers
// a stage and Q's, and 1 KB to align the tiles.
template <int kDP>
__host__ __device__ constexpr size_t streamed_smem_bytes() {
  constexpr int kPanels = (kDP + 63) / 64;
  return 1024 + size_t(kPanels) * kPanelBytes * (1 + ring_stages<kDP>()) +
         (2 * ring_stages<kDP>() + 1) * 8;
}

// Issues s = q . k^T for the 64 keys of the tile at k_tile (q: the tile
// at q_tile), kDP / 16 k16 steps over one or two 64-column panels, as one
// wgmma group; this thread's part, element i: row gid + 8 * ((i / 2) % 2),
// key 8 * (i / 4) + 2 * (lane & 3) + i % 2 of the tile (piece i / 8).
template <int kDP>
__device__ __forceinline__ void issue_scores(float (&s)[32],
                                             const uint8_t* q_tile,
                                             const uint8_t* k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) {
    const int panel = kk / 4;
    wgmma_ss(Width<64>{}, s,
             smem_desc(q_tile + panel * kPanelBytes) + 2 * (kk % 4),
             smem_desc(k_tile + panel * kPanelBytes) + 2 * (kk % 4), kk);
  }
  wgmma_commit();
}

// s = s * scale + key bias for the tile's keys from key0 (the reference's
// order); keys at or past S score -inf. Without a bias a full tile only
// scales (adding 0 changes no score but the sign of a zero, which no later
// step sees). Pieces from `pieces` on hold no key < S and are left as
// they are; no later step reads them.
__device__ __forceinline__ void scale_scores(float (&s)[32],
                                             const float* __restrict__ bias,
                                             int key0, int S, int pieces,
                                             float scale, int lane) {
  const int j0 = key0 + 2 * (lane & 3);
  if (bias == nullptr && key0 + kTileKeys <= S) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= pieces) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = 8 * c + e;
        const int j = j0 + 8 * (i >> 2) + (i & 1);
        const float bj = j < S ? (bias ? __ldg(bias + j) : 0.f) : -INFINITY;
        s[i] = __fadd_rn(__fmul_rn(s[i], scale), bj);
      }
    }
  }
}

// One tile of pass 1 over its first `pieces` pieces: m rises over the
// tile's scores (every tile holds a key < S, so it stays finite), each
// thread's sum is scaled by exp(old m - new m), then the tile's exp(s - m)
// are added in key order (the pieces left out would add exact zeros).
__device__ __forceinline__ void online_row_sum(const float (&s)[32],
                                               int pieces, float (&m)[2],
                                               float (&l)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (i / 8 < pieces) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    l[r] = __fmul_rn(l[r], expf(__fsub_rn(m[r], mx[r])));
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    if (i / 8 < pieces) l[r] = __fadd_rn(l[r], expf(__fsub_rn(s[i], m[r])));
  }
}

// p = exp(s - m) / l (div_rn, y = 1/l) rounded to bf16, as the A fragments
// of p . v: p[c] covers the tile's keys 16c .. 16c+15, c < pieces.
__device__ __forceinline__ void tile_p(const float (&s)[32], int pieces,
                                       const float (&m)[2],
                                       const float (&l)[2],
                                       const float (&y)[2],
                                       uint32_t (&p)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (c >= pieces) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = j & 1;
      p[c][j] = pack_bf16(
          div_rn(expf(__fsub_rn(s[8 * c + 2 * j], m[r])), l[r], y[r]),
          div_rn(expf(__fsub_rn(s[8 * c + 2 * j + 1], m[r])), l[r], y[r]));
    }
  }
}

// Two blocks share an SM (at Dh 128 ptxas spills some of the state under
// that cap; one block an SM, without the spill, was slower).
template <int kDP, typename TOut>
__global__ void __launch_bounds__(kConsumers + 32, 2)
slab_attention_wgmma_streamed_kernel(const __grid_constant__ CUtensorMap map_q,
                                     const __grid_constant__ CUtensorMap map_k,
                                     const __grid_constant__ CUtensorMap map_v,
                                     const float* __restrict__ key_bias,
                                     TOut* __restrict__ out, int S, int H,
                                     int dh, float scale) {
  constexpr int kPanels = (kDP + 63) / 64;
  constexpr int kTile = kPanels * kPanelBytes;  // one operand's 64 rows
  constexpr int kStages = ring_stages<kDP>();
  constexpr int kN1 = kDP - 64;  // the second panel's output columns
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* ring = q_s + kTile;  // stage i at i * kTile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kTile);
  uint64_t* empty = full + kStages;
  uint64_t* q_bar = empty + kStages;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kQRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles = (S + kTileKeys - 1) / kTileKeys;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: Q, then the ring's items in the order they are used,
    // K(0) .. K(T-1) for pass 1, then K(0), V(0), K(1), V(1), ... for pass
    // 2; each stage is refilled once its consumers released it
    if (lane == 0) {
      mbar_expect_tx(q_bar, kTile);
      for (int p = 0; p < kPanels; ++p)
        tma_load_4d(q_s + p * kPanelBytes, &map_q, q_bar, 64 * p, row0, h, b);
      for (int i = 0; i < 3 * tiles; ++i) {
        const int st = i % kStages;
        const bool v = i >= tiles && (i - tiles) % 2 == 1;
        const int key0 = (i < tiles ? i : (i - tiles) / 2) * kTileKeys;
        if (i >= kStages) mbar_wait(&empty[st], (i / kStages - 1) & 1);
        mbar_expect_tx(&full[st], kTile);
        for (int p = 0; p < kPanels; ++p)
          tma_load_4d(ring + st * kTile + p * kPanelBytes, v ? &map_v : &map_k,
                      &full[st], 64 * p, key0, h, b);
      }
    }
    return;
  }

  const float* bias = key_bias ? key_bias + (long long)b * S : nullptr;
  mbar_wait(q_bar, 0);
  // the 16-key pieces of the last tile that hold a key < S; the tiles
  // before it are full, and their steps below take all four pieces, which
  // the compiler knows, so that only the last tile's step tests them
  const int tail = (S - (tiles - 1) * kTileKeys + 15) / 16;
  // item i of the ring: its tile, its arrival, its release
  auto tile = [&](int i) { return ring + (i % kStages) * kTile; };
  auto arrived = [&](int i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);
  };
  auto done_with = [&](int i) { release(&empty[i % kStages], lane); };

  // Pass 1: the row max and sum, online tile by tile. Tile t + 1's
  // q . k^T runs on the tensor cores while tile t's softmax runs here (two
  // score sets in registers, taking turns).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float sa[32], sb[32];
  auto pass1 = [&](float (&cur)[32], float (&nxt)[32], int t, int pieces) {
    wgmma_wait<0>();  // tile t's scores
    acc_fence<32>(cur);
    done_with(t);
    if (t + 1 < tiles) {
      arrived(t + 1);
      issue_scores<kDP>(nxt, q_s, tile(t + 1));
    }
    scale_scores(cur, bias, t * kTileKeys, S, pieces, scale, lane);
    online_row_sum(cur, pieces, m, l);
  };
  arrived(0);
  issue_scores<kDP>(sa, q_s, tile(0));
#pragma unroll 1
  for (int t = 0; t + 1 < tiles; t += 2) {
    pass1(sa, sb, t, 4);
    if (t + 2 < tiles) pass1(sb, sa, t + 1, 4);
  }
  if ((tiles - 1) % 2)
    pass1(sb, sa, tiles - 1, tail);
  else
    pass1(sa, sb, tiles - 1, tail);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};

  // Pass 2: p = e / l rounded to bf16, o += p . v (K(t) and V(t) are
  // items T + 2t and T + 2t + 1 of the ring). Tile t + 1's q . k^T runs
  // while tile t's p is formed; p . v of tile t runs until the next
  // tile's wait.
  float o0[32];
  float o1[kN1 > 0 ? kN1 / 2 : 1];
  uint32_t p[4][4];
  auto pv_tile = [&](const uint8_t* v_tile, int t, int pieces) {
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 keys are 2 KB of a panel (+128)
      if (c >= pieces) break;
      wgmma_rs<1>(Width<64>{}, o0, p[c], smem_desc_mn(v_tile) + 128 * c,
                  t > 0 || c > 0);
      if constexpr (kN1 > 0)
        wgmma_rs<1>(Width<kN1>{}, o1, p[c],
                    smem_desc_mn(v_tile + kPanelBytes) + 128 * c,
                    t > 0 || c > 0);
    }
    wgmma_commit();
  };
  auto pass2 = [&](float (&cur)[32], float (&nxt)[32], int t, int pieces) {
    const int i = tiles + 2 * t;  // K(t); V(t) is i + 1
    wgmma_wait<0>();  // tile t's scores and tile t - 1's p . v
    acc_fence<32>(cur);
    acc_fence<32>(o0);
    if constexpr (kN1 > 0) acc_fence<kN1 / 2>(o1);
    if (t > 0) done_with(i - 1);
    done_with(i);
    if (t + 1 < tiles) {
      arrived(i + 2);
      issue_scores<kDP>(nxt, q_s, tile(i + 2));
    }
    scale_scores(cur, bias, t * kTileKeys, S, pieces, scale, lane);
    tile_p(cur, pieces, m, l, y, p);
    arrived(i + 1);
    pv_tile(tile(i + 1), t, pieces);
  };
  arrived(tiles);
  issue_scores<kDP>(sa, q_s, tile(tiles));
#pragma unroll 1
  for (int t = 0; t + 1 < tiles; t += 2) {
    pass2(sa, sb, t, 4);
    if (t + 2 < tiles) pass2(sb, sa, t + 1, 4);
  }
  if ((tiles - 1) % 2)
    pass2(sb, sa, tiles - 1, tail);
  else
    pass2(sa, sb, tiles - 1, tail);
  wgmma_wait<0>();
  acc_fence<32>(o0);
  if constexpr (kN1 > 0) acc_fence<kN1 / 2>(o1);

  // every consumer warp is past its last read of the ring: o through it
  constexpr int kPitch = out_pitch<kDP>();
  consumers_sync();
  TOut* stage = reinterpret_cast<TOut*>(ring);
  stage_acc<64, TOut, kPitch>(stage, o0, 0, warp, lane);
  if constexpr (kN1 > 0) stage_acc<kN1, TOut, kPitch>(stage, o1, 64, warp, lane);
  consumers_sync();
  store_rows<TOut, kPitch>(stage, out, b, h, row0, S, H, dh, threadIdx.x);
}

template <int kDP, typename TOut>
cudaError_t launch_width(const Args& a) {
  constexpr size_t smem = streamed_smem_bytes<kDP>();
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr = allow_smem(
      slab_attention_wgmma_streamed_kernel<kDP, TOut>, int(smem),
      smem_allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_wgmma_streamed_kernel<kDP, TOut><<<grid, kConsumers + 32,
                                                    smem, a.stream>>>(
      a.q, a.k, a.v, a.key_bias, static_cast<TOut*>(a.out), a.S, a.H, a.dh,
      a.scale);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t launch_padded(const Args& a) {
  switch ((a.dh + 15) / 16) {  // Dh padded to a multiple of 16
    case 4:
      return launch_width<64, TOut>(a);
    case 5:
      return launch_width<80, TOut>(a);
    case 6:
      return launch_width<96, TOut>(a);
    case 7:
      return launch_width<112, TOut>(a);
    case 8:
      return launch_width<128, TOut>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t keep_attn::launch_streamed(const Args& a) {
  return a.out_f32 ? launch_padded<float>(a) : launch_padded<bf16>(a);
}
