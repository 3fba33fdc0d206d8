// The bf16 attention forward for Hopper (sm_90a), on the tensor cores:
// wgmma fed by TMA, bf16 -> bf16 and bf16 -> fp32, at every head width the
// port takes (multiples of 8 from 64 to 128) and any S, over the slab,
// split q / k / v or [B, H, S, Dh] heads (one set of element strides).
//
// Replaces, with keep_attention (attention_qkv_slab.cu), which sends its
// dtype codes 1 and 2 here:
//   - keep_tpu/kernels/flash_attention.py `_sdpa` (:43-56) in the
//     pallas_calls of `attention_qkv_slab` (:190) and `attention_qkv_heads`
//     (:115): bf16 in, bf16 out;
//   - the attention inside keep_tpu/kernels/qblock.py, `_sdpa` and
//     `_sdpa_masked` (:36-44, :131-139), in the pallas_calls of
//     `quantized_attention_block` (:79) and `quantized_attention_block_postln`
//     (:182): bf16 in, fp32 out (the int8 blocks re-quantize o without a
//     bf16 round).
// Per batch row b and head h:
//   s = (q . k^T in fp32) * Dh^-0.5 (+ key_bias[b, :])
//   p = exp(s - rowmax(s)) / rowsum(...), rounded to bf16 after the division
//   o = p . v accumulated in fp32, stored cast to the output type into
//   out[B, S, H*Dh]
//
// What bounds it on this card: bytes at the towers' shapes (ViT-L B=128:
// the bf16 slab read once, 155 MB, and the bf16 output written once, 52 MB:
// 0.062 ms at 3.35 TB/s; the two products are 20 GFLOP, 0.021 ms at the
// bf16 peak). Two bodies, one warpgroup per (64 query rows, head, batch
// row), both with A (q, then p) 64 rows deep and the scores in registers:
//
// The one-pass body (Dh = 64, S <= 320; every KEEP tower at 224^2, and
// ViT-L/14's 257):
//   - one thread brings Q's rows and the whole K and V slices of the head
//     into shared memory by TMA (a 4-D map over each operand, [B, H, S, 64]
//     read through the caller's strides, boxes of 16 rows of 128 bytes with
//     the 128-byte swizzle), Q and K on one mbarrier and V on a second, so
//     that the scores run while V lands; rows past S arrive as zeros, and
//     boxes that hold no row < S are zero-filled by the threads instead;
//   - q . k^T on wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulators), A
//     (Q) from registers (ldmatrix) and B (K) from shared memory, K-major:
//     four k16 steps over Dh = 64, the keys rounded up to 16 and taken 64
//     at a time, the last 16, 32 or 48 with a narrower N. From S = 241 a
//     thread holds 128 scores and more (160 at S = 320), and A is read
//     from shared memory instead, which leaves them the 16 registers of
//     its fragments: no instance spills or has its wgmma serialised;
//   - the softmax without a second q . k^T and without an online rescale:
//     the scores are scaled, then biased (the reference's order), padded
//     keys get -inf; the exact row max (a row sits in one quad of lanes),
//     e = expf(s - m) (not __expf, which rounds differently), the row sum
//     in one fixed order (each thread its keys in order, then the quad's
//     butterfly), then p = e / l by division (the IEEE quotient, `div_rn`),
//     as the plain version's softmax, rounded to bf16 straight into wgmma A
//     fragments;
//   - p . v on wgmma m64n64k16 with A (p) from registers and B (V) from
//     shared memory, MN-major (the transpose bit of 16-bit operands): one
//     k16 step per 16 keys;
//   - the output tile is staged through shared memory (the freed Q, K, V
//     tiles) and written in 16-byte stores, rows < S only.
//   Three blocks share an SM up to S = 256 (at most 168 registers a
//   thread, 74 KB of shared memory at S = 256), two past it, so that one
//   block's loads overlap another's products and softmax.
//
// The streamed body (every other shape: Dh 72-128, and S past 320; in
// attention_qkv_slab_wgmma_streamed.cu, which nvcc builds beside this file):
//   - K and V stream through a ring of 64-key tiles in shared memory, so
//     that shared memory does not grow with S (81 KB at Dh > 64, 57 KB at
//     Dh = 64). A producer warp (the block's fifth) keeps the ring's loads
//     in flight, in the order the tiles are used: K(0) .. K(T-1) for pass
//     1, then K(0), V(0), K(1), V(1), ... for pass 2. One TMA map per
//     operand over [B, H, S, Dh], read through the caller's strides, boxes
//     of 64 rows of 64 columns with the 128-byte swizzle, so Dh > 64 takes
//     two boxes along Dh (a panel each); columns past Dh and rows past S
//     arrive as zeros. Each stage has a `full` mbarrier (TMA's bytes) and
//     an `empty` one (one arrival per consumer warp once its wgmma have
//     read the stage);
//   - pass 1 takes q . k^T per 64-key tile (A = Q and B = K from shared
//     memory, Dh padded to a multiple of 16 by the zero columns: Dh 88 and
//     104 take 6 and 7 k16 steps, and the zeros add exact zeros), scales
//     and biases it (keys past S score -inf) and keeps the row max and sum
//     with an online rescale: at each tile the max rises over the tile,
//     each thread's sum is scaled by exp(old - new max), then the tile's
//     exp(s - m) are added in key order; the quad's butterfly ends it;
//   - pass 2 takes s again, p = expf(s - m) / l (`div_rn`) rounded to bf16
//     into the A fragments, and o += p . v on wgmma with B (V) MN-major,
//     one wgmma a panel of 64 output columns and k16 step, the second
//     panel Dh - 64 rounded up to 16 wide. V's rows past S are zeros and
//     their p is 0, so no 0 * NaN from a stale stage reaches o;
//   - in both passes the next tile's q . k^T is issued before this tile's
//     softmax (two sets of scores in registers), meant to overlap the
//     tensor cores with the exponentials; ptxas serialises these wgmma
//     (C7515: it finds other instructions defining accumulators in flight),
//     which is open. The last tile takes only its 16-key pieces that hold a
//     key < S (the others would add exact zeros: 3-5% at S = 257, 577,
//     785). A row of one tile (Dh > 64, S <= 64: no preset's shape)
//     takes both passes as any other; up to S = 17 that is 0.4-2 us a
//     call slower than the retired mma.sync body (PERF.md §6);
//   - the epilogue stages o through the ring and writes 16-byte stores of
//     rows < S and columns < Dh.
//
// The tensor cores sum each k16 step's products in their own order, not
// in IEEE round-to-nearest steps, so o is not the plain version's bits: the
// bf16 forward is held to the bf16 gate (max |Delta| < 0.05) and the int8
// blocks to the JAX package's tolerance between two routes through the same
// int8 weights (tests/test_quant.py:297-300, 324-327), which the JAX kernel
// itself needs against the plain version. tests/card_attention_model.py
// models both bodies' order of sums on the CPU.

#include "wgmma_attention.cuh"

namespace {

constexpr int kBoxRows = 16;                     // rows of a one-pass TMA box
constexpr int kBoxBytes = kBoxRows * kRowBytes;  // 2048
// The most keys taken in one pass. Past 256 no preset runs but ViT-L/14's
// 257; the ViTs take any image size that is a multiple of the patch
// (272^2 at patch 16: S = 290). At S = 273-320 the streamed body took
// 0.127-0.133 ms (B = 32, H = 16, H100), slower than the retired mma.sync
// body's 0.120-0.123 and the one pass's 0.079-0.086 (PERF.md §6).
constexpr int kOnePass = 320;

// The one-pass body reads Q from shared memory (A by descriptor) from this
// many 16-key pieces on, and as register fragments (ldmatrix) below: from
// 128 scores on they need the A fragments' 16 registers, under which ptxas
// spilled and serialised the wgmma; below it the fragments were faster.
constexpr int kQSharedFrom = 16;

// s = (q . k^T) * scale + bias for the 16*NB keys of the tile at k_tile
// (q: qa, this warp's A fragments, or the 64 rows of the tile at q_tile
// from kQSharedFrom pieces on), this thread's part: piece c
// (s[8c .. 8c+7]) holds keys 16c .. 16c+15, element 4*half + e of it row
// gid + 8*(e >> 1) and key 16c + 8*half + 2*(lane & 3) + (e & 1). bias
// holds the tile's keys (-inf past S).
template <int NB>
__device__ __forceinline__ void scores(float (&s)[NB * 8],
                                       const uint32_t (&qa)[4][4],
                                       const uint8_t* q_tile,
                                       const uint8_t* k_tile,
                                       const float* bias, float scale,
                                       int lane) {
  const uint64_t qd = smem_desc(q_tile);
  const uint64_t kd = smem_desc(k_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // 64 keys are 8 KB of the tile (+512 on the descriptor), 16 dims 32
    // bytes (+2)
    if constexpr (NB >= kQSharedFrom) {
#pragma unroll
      for (int g = 0; g < NB / 4; ++g)
        wgmma_ss(Width<64>{}, s + 32 * g, qd + 2 * kk,
                 kd + 512 * g + 2 * kk, kk);
      if constexpr (NB % 4 != 0)
        wgmma_ss(Width<16 * (NB % 4)>{}, s + 32 * (NB / 4), qd + 2 * kk,
                 kd + 512 * (NB / 4) + 2 * kk, kk);
    } else {
#pragma unroll
      for (int g = 0; g < NB / 4; ++g)
        wgmma_rs<0>(Width<64>{}, s + 32 * g, qa[kk], kd + 512 * g + 2 * kk,
                    kk);
      if constexpr (NB % 4 != 0)
        wgmma_rs<0>(Width<16 * (NB % 4)>{}, s + 32 * (NB / 4), qa[kk],
                    kd + 512 * (NB / 4) + 2 * kk, kk);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<NB * 8>(s);
  const float* bq = bias + 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float2 bb =
          *reinterpret_cast<const float2*>(bq + 16 * c + 8 * half);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[8 * c + 4 * half + e];
        x = __fadd_rn(__fmul_rn(x, scale), (e & 1) ? bb.y : bb.x);
      }
    }
}

// Raises m (this thread's part of rows gid, gid + 8) to cover s.
template <int NB>
__device__ __forceinline__ void raise_row_max(const float (&s)[NB * 8],
                                              float (&m)[2]) {
#pragma unroll
  for (int i = 0; i < NB * 8; ++i)
    m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], s[i]);
}

// s = expf(s - m), added to l in the order of s.
template <int NB>
__device__ __forceinline__ void exp_sum(float (&s)[NB * 8],
                                        const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int i = 0; i < NB * 8; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = expf(__fsub_rn(s[i], m[r]));
    l[r] = __fadd_rn(l[r], s[i]);
  }
}

// p = e / l rounded to bf16, as the A fragments of p . v: p[c] covers
// keys 16c .. 16c+15 (elements 8c .. 8c+7 of e).
template <int NB>
__device__ __forceinline__ void normalise(const float (&e)[NB * 8],
                                          const float (&l)[2],
                                          uint32_t (&p)[NB][4]) {
  const float y[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = j & 1;
      p[c][j] = pack_bf16(div_rn(e[8 * c + 2 * j], l[r], y[r]),
                          div_rn(e[8 * c + 2 * j + 1], l[r], y[r]));
    }
}

// o = p . v over the 16*NB keys of the tile at v_tile.
template <int NB>
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&p)[NB][4],
                                   const uint8_t* v_tile) {
  const uint64_t desc = smem_desc_mn(v_tile);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c)  // 16 keys are 2 KB of the tile (+128)
    wgmma_rs<1>(Width<64>{}, o, p[c], desc + 128 * c, c > 0);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<32>(o);
}

// ---- the one-pass body: Dh = 64, S <= 320 --------------------------------------

// Shared memory of the body for `keys` padded keys: the Q tile and the K
// and V slices (after the products, the output tile staged for its
// stores), the key-bias row and two mbarriers; 1 KB more to start the
// tiles 1024-byte aligned.
__host__ __device__ constexpr size_t tiles_bytes(int keys) {
  return size_t(kQRows + 2 * keys) * kRowBytes >
                 size_t(kQRows) * out_pitch<kHeadDim>() * 4
             ? size_t(kQRows + 2 * keys) * kRowBytes
             : size_t(kQRows) * out_pitch<kHeadDim>() * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int keys) {
  return 1024 + tiles_bytes(keys) + size_t(keys) * 4 + 2 * 8;
}

__device__ __forceinline__ void zero16(uint8_t* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
}

// NB: 16-key pieces of the row (S rounded up to 16, at most 320). Three
// blocks share an SM up to 256 keys, two past it (at most 160 scores a
// thread).
template <int NB, typename TOut>
__global__ void __launch_bounds__(kConsumers, NB <= 16 ? 3 : 2)
slab_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const float* __restrict__ key_bias,
                            TOut* __restrict__ out, int S, int H,
                            float scale) {
  constexpr int kKeys = NB * 16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = q_s + kQRows * kRowBytes;
  uint8_t* v_s = k_s + kKeys * kRowBytes;
  float* bias_s = reinterpret_cast<float*>(q_s + tiles_bytes(kKeys));
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias_s + kKeys);  // QK, V

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kQRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // the boxes that hold a row < S come by TMA; the others are zeroed here
  const int q_boxes =
      min(kQRows / kBoxRows, (S - row0 + kBoxRows - 1) / kBoxRows);
  const int kv_boxes = (S + kBoxRows - 1) / kBoxRows;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
  }
  for (int i = q_boxes * kBoxBytes + 16 * threadIdx.x; i < kQRows * kRowBytes;
       i += 16 * kConsumers)
    zero16(q_s + i);
  for (int i = kv_boxes * kBoxBytes + 16 * threadIdx.x; i < kKeys * kRowBytes;
       i += 16 * kConsumers) {
    zero16(k_s + i);
    zero16(v_s + i);
  }
  fill_bias(bias_s, key_bias ? key_bias + (long long)b * S : nullptr, S,
            kKeys);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bars[0], (q_boxes + kv_boxes) * kBoxBytes);
    for (int i = 0; i < q_boxes; ++i)
      tma_load_4d(q_s + i * kBoxBytes, &map_q, &bars[0], 0,
                  row0 + i * kBoxRows, h, b);
    for (int i = 0; i < kv_boxes; ++i)
      tma_load_4d(k_s + i * kBoxBytes, &map_k, &bars[0], 0, i * kBoxRows, h,
                  b);
    mbar_expect_tx(&bars[1], kv_boxes * kBoxBytes);
    for (int i = 0; i < kv_boxes; ++i)
      tma_load_4d(v_s + i * kBoxBytes, &map_v, &bars[1], 0, i * kBoxRows, h,
                  b);
  }
  mbar_wait(&bars[0], 0);  // Q and K

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[32];
  {
    uint32_t qa[4][4];
    if constexpr (NB < kQSharedFrom)
      load_a_rows(qa, smem_u32(q_s), 16 * warp, lane);
    float s[NB * 8];
    scores<NB>(s, qa, q_s, k_s, bias_s, scale, lane);
    raise_row_max<NB>(s, m);
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
    exp_sum<NB>(s, m, l);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    uint32_t p[NB][4];
    normalise<NB>(s, l, p);
    mbar_wait(&bars[1], 0);  // V
    pv<NB>(o, p, v_s);
  }

  // the output tile through shared memory (every warp is past its
  // products, so the tiles are free), then 16-byte stores of rows < S
  constexpr int kPitch = out_pitch<kHeadDim>();
  __syncthreads();
  TOut* stage = reinterpret_cast<TOut*>(q_s);
  stage_acc<64, TOut, kPitch>(stage, o, 0, warp, lane);
  __syncthreads();
  store_rows<TOut, kPitch>(stage, out, b, h, row0, S, H, kHeadDim,
                           threadIdx.x);
}

// ---- launches ---------------------------------------------------------------------

template <int NB, typename TOut>
cudaError_t launch_one_pass(const Args& a) {
  constexpr size_t smem = smem_bytes(NB * 16);
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr = allow_smem(
      slab_attention_wgmma_kernel<NB, TOut>, int(smem), smem_allowed);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_wgmma_kernel<NB, TOut><<<grid, kConsumers, smem,
                                          a.stream>>>(
      a.q, a.k, a.v, a.key_bias, static_cast<TOut*>(a.out), a.S, a.H,
      a.scale);
  return cudaGetLastError();
}

// The instantiation for nb = ceil(S / 16) pieces (S <= 320).
template <int NB, typename TOut>
cudaError_t launch_pieces(int nb, const Args& a) {
  if constexpr (NB > kOnePass / 16) {
    return cudaErrorInvalidValue;
  } else {
    return nb == NB ? launch_one_pass<NB, TOut>(a)
                    : launch_pieces<NB + 1, TOut>(nb, a);
  }
}

}  // namespace

// Called by keep_attention (attention_qkv_slab.cu) for a bf16 q, k and v
// and a bf16 (out_f32 = 0) or fp32 (1) out, with its arguments (checked
// there) and the same contract; q, k and v must also be 16-byte aligned.
// Returns the cudaError_t of the launch (cudaErrorNotSupported when libcuda
// has no TMA encoder or refuses a map).
cudaError_t keep_attention_wgmma(const void* q, const void* k, const void* v,
                                 long long batch_stride,
                                 long long head_stride, long long row_stride,
                                 const float* key_bias, void* out,
                                 int out_f32, int B, int S, int H, int dh,
                                 float scale, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorInvalidValue;
  // the one-pass body's 16-row boxes load only rows it keeps; the ring's
  // stages are 64 rows
  const bool one_pass = dh == kHeadDim && S <= kOnePass;
  const int box_rows = one_pass ? kBoxRows : kTileKeys;
  Args a;
  if (!head_map(&a.q, q, batch_stride, head_stride, row_stride, B, S, H, dh,
                box_rows) ||
      !head_map(&a.k, k, batch_stride, head_stride, row_stride, B, S, H, dh,
                box_rows) ||
      !head_map(&a.v, v, batch_stride, head_stride, row_stride, B, S, H, dh,
                box_rows))
    return cudaErrorNotSupported;
  a.key_bias = key_bias;
  a.out = out;
  a.out_f32 = out_f32 != 0;
  a.B = B;
  a.S = S;
  a.H = H;
  a.dh = dh;
  a.scale = scale;
  a.stream = stream;
  if (!one_pass) return keep_attn::launch_streamed(a);
  const int pieces = (S + 15) / 16;
  return out_f32 ? launch_pieces<1, float>(pieces, a)
                 : launch_pieces<1, bf16>(pieces, a);
}
