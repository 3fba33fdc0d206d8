// The bf16 -> fp32 form of the slab attention for Hopper (sm_90a), on the
// tensor cores: wgmma fed by TMA, each query tile's scores held in
// registers, one pass over the keys.
//
// Replaces the attention inside two TPU kernels of keep_tpu/kernels/
// qblock.py, `_sdpa` and `_sdpa_masked` (:36-44, :131-139), in the
// pallas_calls of `quantized_attention_block` (:79) and
// `quantized_attention_block_postln` (:182). `keep_attention`
// (attention_qkv_slab.cu) sends its dtype code 2 here. Per batch row b and
// head h:
//   s = (q . k^T in fp32) * Dh^-0.5 (+ key_bias[b, :])
//   p = exp(s - rowmax(s)) / rowsum(...), rounded to bf16 after the division
//   o = p . v accumulated in fp32, stored in fp32 into out[B, S, H*64]
// The int8 blocks re-quantize o without a bf16 round.
//
// What bounds it on this card: bytes. The bf16 slab is read once and the
// fp32 output written once (ViT-L B=128: 155 MB and 103 MB, 0.077 ms at
// 3.35 TB/s); the two products are 20 GFLOP there, 0.021 ms at the bf16
// peak. Design:
//   - one warpgroup (128 threads) per (64 query rows, head, batch row);
//     one thread brings Q's rows and the whole K and V slices of the head
//     into shared memory by TMA (a 4-D map over each operand, [B, H, S, 64]
//     read through the caller's strides, boxes of 16 rows of 128 bytes with
//     the 128-byte swizzle), Q and K on one mbarrier and V on a second, so
//     that the scores run while V lands; rows past S arrive as zeros, and
//     boxes that hold no row < S are zero-filled by the threads instead;
//   - q . k^T on wgmma.mma_async m64nNk16 (bf16 in, fp32 accumulators), A
//     (Q) from registers (ldmatrix), B (K) from shared memory, K-major:
//     four k16 steps over Dh = 64, the keys rounded up to 16 and taken 64
//     at a time, the last 16, 32 or 48 with a narrower N. At S = 256 a
//     thread holds 128 scores;
//   - the softmax without a second q . k^T and without an online rescale:
//     the scores are scaled, then biased (the reference's order), padded
//     keys get -inf; the exact row max (a row sits in one quad of lanes),
//     e = expf(s - m) (not __expf, which rounds differently), the row sum
//     in one fixed order, then p = e / l by division (IEEE quotient), as
//     the plain version's softmax, rounded to bf16 straight into wgmma A
//     fragments;
//   - p . v on wgmma m64n64k16 with A (p) from registers and B (V) from
//     shared memory, MN-major (the transpose bit of 16-bit operands):
//     one k16 step per 16 keys;
//   - the output tile is staged through shared memory (the freed Q, K, V
//     tiles) and written in 16-byte stores, rows < S only.
// Three blocks share an SM (at most 168 registers a thread, 74 KB of
// shared memory at S = 256), so that one block's loads overlap another's
// products and softmax; at 240 < S <= 256 ptxas keeps 16 bytes of a
// thread's state in local memory (a two-block cap, which removes it, was
// 30% slower on an H100).
// At 256 < S <= 512 (untimed; the wrapper takes S <= 512) the keys are
// taken in four chunks of 128, and their scores three times: for the row
// max, for the row sum, and for p.
//
// The tensor cores sum each k16 step's products in their own order, not
// in IEEE round-to-nearest steps, so o is not the plain version's bits; the
// int8 blocks are held to the JAX package's tolerance between two routes
// through the same int8 weights (tests/test_quant.py:297-300, 324-327),
// which the JAX kernel itself needs against the plain version.

#include "hopper.cuh"
#include "slab_attention.cuh"

namespace {

constexpr int kQRows = 64;                       // query rows a block owns
constexpr int kBoxRows = 16;                     // rows of one TMA box
constexpr int kBoxBytes = kBoxRows * kRowBytes;  // 2048
constexpr int kOnePass = 256;   // the most keys taken in one pass
constexpr int kChunk = 128;     // keys a chunk of a longer row takes
constexpr int kOutPitch = kHeadDim + 8;  // floats of a staged output row

template <int N>
struct Width {};

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulators d (this thread's
// N/2), A from registers (a: the mma.sync A fragment of this warp's 16
// rows), B from shared memory by descriptor, K-major (kTransB = 0) or
// MN-major (1). d is overwritten when scale_d is 0. Element i of d is row
// 16*warp + lane/4 + 8*((i/2) % 2), column 8*(i/4) + 2*(lane % 4) + i % 2.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(Width<16>, float* d,
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(Width<32>, float* d,
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(Width<48>, float* d,
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(Width<64>, float* d,
                                         const uint32_t (&a)[4],
                                         uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d), "n"(kTransB));
}

// Keeps the compiler from moving accesses of accumulators across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void acc_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// s = (q . k^T) * scale + bias for the 16*NB keys of the tile at k_tile,
// this thread's part: piece c (s[8c .. 8c+7]) holds keys 16c .. 16c+15,
// element 4*half + e of it row gid + 8*(e >> 1) and key 16c + 8*half +
// 2*(lane & 3) + (e & 1). bias holds the tile's keys (-inf past S).
template <int NB>
__device__ __forceinline__ void scores(float (&s)[NB * 8],
                                       const uint32_t (&qa)[4][4],
                                       const uint8_t* k_tile,
                                       const float* bias, float scale,
                                       int lane) {
  const uint64_t desc = smem_desc(k_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // 64 keys are 8 KB of the tile (+512 on the descriptor), 16 dims 32
    // bytes (+2)
#pragma unroll
    for (int g = 0; g < NB / 4; ++g)
      wgmma_rs<0>(Width<64>{}, s + 32 * g, qa[kk], desc + 512 * g + 2 * kk,
                  kk);
    if constexpr (NB % 4 != 0)
      wgmma_rs<0>(Width<16 * (NB % 4)>{}, s + 32 * (NB / 4), qa[kk],
                  desc + 512 * (NB / 4) + 2 * kk, kk);
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

// e / l in IEEE round-to-nearest, from y = 1/l correctly rounded: the
// quotient q = e*y rounded is within an ulp of e / l, the remainder
// e - l*q is exact in one FMA, and q + remainder*y rounded is the correctly
// rounded quotient (Markstein). It gives div.rn's bits without its range
// checks and slow path per element, which took this body from 0.155 to
// 0.359 ms at BERT-base B=128 on an H100 (e in [0, 1], l in [1, 512]: no
// overflow; a quotient below 2^-126 may differ in its last subnormal bit).
__device__ __forceinline__ float div_rn(float e, float l, float y) {
  const float q = __fmul_rn(e, y);
  return __fmaf_rn(__fmaf_rn(-q, l, e), y, q);
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

// o (+)= p . v over the 16*NB keys of the tile at v_tile.
template <int NB>
__device__ __forceinline__ void pv(float (&o)[32], const uint32_t (&p)[NB][4],
                                   const uint8_t* v_tile, bool accumulate) {
  const uint64_t desc = smem_desc_mn(v_tile);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NB; ++c)  // 16 keys are 2 KB of the tile (+128)
    wgmma_rs<1>(Width<64>{}, o, p[c], desc + 128 * c, accumulate || c > 0);
  wgmma_commit();
  wgmma_wait<0>();
  acc_fence<32>(o);
}

// Shared memory of the body for `keys` padded keys: the Q tile and the K
// and V slices (after the products, the fp32 output tile staged for its
// stores), the key-bias row and two mbarriers; 1 KB more to start the
// tiles 1024-byte aligned.
__host__ __device__ constexpr size_t tiles_bytes(int keys) {
  return size_t(kQRows + 2 * keys) * kRowBytes > size_t(kQRows) * kOutPitch * 4
             ? size_t(kQRows + 2 * keys) * kRowBytes
             : size_t(kQRows) * kOutPitch * 4;
}
__host__ __device__ constexpr size_t smem_bytes(int keys) {
  return 1024 + tiles_bytes(keys) + size_t(keys) * 4 + 2 * 8;
}

__device__ __forceinline__ void zero16(uint8_t* p) {
  *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
}

// NB: 16-key pieces a chunk holds; NC: chunks (1 for S <= 256, else 4).
// The chunked form keeps a quarter of the scores, so that o and p fit
// beside them in registers.
template <int NB, int NC>
__global__ void __launch_bounds__(128, NC == 1 ? 3 : 1)
slab_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const float* __restrict__ key_bias,
                            float* __restrict__ out, int S, int H,
                            float scale) {
  constexpr int kKeys = NB * 16 * NC;  // S rounded up to 16, or 512
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
       i += 16 * 128)
    zero16(q_s + i);
  for (int i = kv_boxes * kBoxBytes + 16 * threadIdx.x; i < kKeys * kRowBytes;
       i += 16 * 128) {
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
  uint32_t qa[4][4];
  load_a_rows(qa, smem_u32(q_s), 16 * warp, lane);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[32];
  if constexpr (NC == 1) {
    float s[NB * 8];
    scores<NB>(s, qa, k_s, bias_s, scale, lane);
    raise_row_max<NB>(s, m);
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
    exp_sum<NB>(s, m, l);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    uint32_t p[NB][4];
    normalise<NB>(s, l, p);
    mbar_wait(&bars[1], 0);  // V
    pv<NB>(o, p, v_s, false);
  } else {
    constexpr int kChunkBytes = NB * 16 * kRowBytes;
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      float s[NB * 8];
      scores<NB>(s, qa, k_s + c * kChunkBytes, bias_s + c * NB * 16, scale,
                 lane);
      raise_row_max<NB>(s, m);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      float s[NB * 8];
      scores<NB>(s, qa, k_s + c * kChunkBytes, bias_s + c * NB * 16, scale,
                 lane);
      exp_sum<NB>(s, m, l);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
    mbar_wait(&bars[1], 0);  // V
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      float s[NB * 8], unused[2] = {0.f, 0.f};
      scores<NB>(s, qa, k_s + c * kChunkBytes, bias_s + c * NB * 16, scale,
                 lane);
      exp_sum<NB>(s, m, unused);
      uint32_t p[NB][4];
      normalise<NB>(s, l, p);
      pv<NB>(o, p, v_s + c * kChunkBytes, c > 0);
    }
  }

  // the output tile through shared memory (every warp is past its
  // products, so the tiles are free), then 16-byte stores of rows < S
  __syncthreads();
  float* stage = reinterpret_cast<float*>(q_s);
  const int r = 16 * warp + (lane >> 2);
  const int cq = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(stage + r * kOutPitch + 8 * j + cq) =
        make_float2(o[4 * j], o[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (r + 8) * kOutPitch + 8 * j + cq) =
        make_float2(o[4 * j + 2], o[4 * j + 3]);
  }
  __syncthreads();
  const int D = H * kHeadDim;
#pragma unroll 2
  for (int i = threadIdx.x; i < kQRows * kHeadDim / 4; i += 128) {
    const int rr = i / (kHeadDim / 4);
    const int c4 = i % (kHeadDim / 4);
    const int row = row0 + rr;
    if (row < S)
      *reinterpret_cast<float4*>(out + ((long long)b * S + row) * D +
                                 h * kHeadDim + 4 * c4) =
          *reinterpret_cast<const float4*>(stage + rr * kOutPitch + 4 * c4);
  }
}

// The TMA map of one operand, head h's 64-wide rows of batch row b read
// through the caller's element strides as a [B, H, S, 64] bf16 tensor, in
// boxes of 16 rows with the 128-byte swizzle; reads past S give zeros.
bool head_map(CUtensorMap* map, const void* base, long long batch_stride,
              long long head_stride, long long row_stride, int B, int S,
              int H) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(kHeadDim), cuuint64_t(S),
                              cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(row_stride) * 2,
                                 cuuint64_t(head_stride) * 2,
                                 cuuint64_t(batch_stride) * 2};
  const cuuint32_t box[4] = {kHeadDim, kBoxRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  CUtensorMap q, k, v;
  const float* key_bias;
  float* out;
  int B, S, H;
  float scale;
  cudaStream_t stream;
};

template <int NB, int NC>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = smem_bytes(NB * 16 * NC);
  static const cudaError_t attr = cudaFuncSetAttribute(
      slab_attention_wgmma_kernel<NB, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.S + kQRows - 1) / kQRows, a.H, a.B);
  slab_attention_wgmma_kernel<NB, NC><<<grid, 128, smem, a.stream>>>(
      a.q, a.k, a.v, a.key_bias, a.out, a.S, a.H, a.scale);
  return cudaGetLastError();
}

// The instantiation for nb = ceil(S / 16) pieces (S <= 256).
template <int NB>
cudaError_t launch_pieces(int nb, const Args& a) {
  if constexpr (NB > kOnePass / 16) {
    return cudaErrorInvalidValue;
  } else {
    return nb == NB ? launch<NB, 1>(a) : launch_pieces<NB + 1>(nb, a);
  }
}

}  // namespace

// Called by keep_attention (attention_qkv_slab.cu) for a bf16 q, k, v and
// an fp32 out, with its arguments (checked there) and the same contract;
// q, k and v must also be 16-byte aligned. Returns the cudaError_t of the
// launch (cudaErrorNotSupported when libcuda has no TMA encoder or refuses
// a map).
cudaError_t keep_attention_bf16_f32(const void* q, const void* k,
                                    const void* v, long long batch_stride,
                                    long long head_stride,
                                    long long row_stride,
                                    const float* key_bias, float* out, int B,
                                    int S, int H, float scale,
                                    cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return cudaErrorInvalidValue;
  Args a;
  if (!head_map(&a.q, q, batch_stride, head_stride, row_stride, B, S, H) ||
      !head_map(&a.k, k, batch_stride, head_stride, row_stride, B, S, H) ||
      !head_map(&a.v, v, batch_stride, head_stride, row_stride, B, S, H))
    return cudaErrorNotSupported;
  a.key_bias = key_bias;
  a.out = out;
  a.B = B;
  a.S = S;
  a.H = H;
  a.scale = scale;
  a.stream = stream;
  if (S <= kOnePass) return launch_pieces<1>((S + 15) / 16, a);
  return launch<kChunk / 16, kMaxSeq / kChunk>(a);
}
