// Pieces of the fp32 attention backward's split-TF32 wgmma kernels,
// attention_qkv_slab_bwd_f32_dq.cu (kernel A: the row statistics and dq)
// and attention_qkv_slab_bwd_f32_dkv.cu (kernel B: dk and dv), launched
// from attention_qkv_slab_bwd.cu: the arguments of a launch, the fp32 TMA
// map, the split of an fp32 value into two TF32 parts, the m64nNk8 TF32
// wgmma (A from shared memory or from registers) and the layout of the
// operand tiles.
//
// Split TF32: x = hi + lo with hi = cvt.rna.tf32(x) and lo =
// cvt.rna.tf32(x - hi) (x - hi is exact in fp32). A product a . b is
// taken as a_lo . b_hi + a_hi . b_lo + a_hi . b_hi, three TF32 wgmma into
// one fp32 accumulator, in that order at each k8 step; the dropped
// a_lo . b_lo and the parts' rounding leave ~2^-21 of each product, near
// fp32's own 2^-24 (CUTLASS's OpMultiplyAddFastF32 scheme). Every operand
// is rounded explicitly: a raw fp32 value fed to a TF32 wgmma would be
// truncated.
//
// Operand tiles in shared memory are K-major under the 128-byte swizzle,
// as TMA writes them: 32 fp32 columns a 128-byte row ("a panel"), panels
// rows * 128 bytes apart, 16-byte chunk c of row r at chunk c ^ (r % 8).
// A k8 step is 32 bytes of a row: +2 in the descriptor (smem_desc), and
// every fourth step the next panel. The B operands of dq = ds . K, dk =
// ds^T . Q and dv = p^T . dO are transposed tiles ([Dh rows][32 keys or
// queries], one panel) that the threads write while they split the tile:
// TF32 wgmma takes no transposed operand. Their A operand is the
// accumulator of the scores' product, in registers, with each k8 step's
// keys permuted so that a thread's accumulator elements are its A
// fragment (`kpos`).
#pragma once

#include "wgmma_attention.cuh"

namespace keep_attn {

// One launch of the fp32 backward: the maps of q, k and v (the slab's
// lanes) and of dout (fp32, boxes of 32 rows x 32 columns), the key bias,
// the row statistics [B, H, S] x float4 that kernel A writes and kernel B
// reads, dqkv and the shape.
struct BwdF32Args {
  CUtensorMap q, k, v, dout;
  const float* key_bias;
  float4* stats;
  float* dqkv;
  int B, S, H, dh;
  float scale;
  cudaStream_t stream;
};

cudaError_t launch_bwd_f32_dq(const BwdF32Args& a);
cudaError_t launch_bwd_f32_dkv(const BwdF32Args& a);

}  // namespace keep_attn

namespace {

constexpr int kPanelRow = 128;    // bytes of a swizzled row: 32 fp32 values

constexpr int kF32Tile = 32;  // keys (kernel A) or queries (kernel B) a tile

// The shape of one width's kernels: dq / dk / dv summed in chunks of kN
// columns, and kRegA: the resident operand's hi part (Q and dO in kernel
// A, K and V in kernel B) held as register A fragments instead of read
// from shared memory by two of every three wgmma. Two blocks an SM and
// shared memory's bandwidth set the shape. At Dh 64 a block takes 80 KB
// (two an SM) and the fragments 64 registers: ViT-L B = 128 2.45 -> 2.28
// ms on an H100; a second stage, 64-key tiles or both (128-192 KB, one
// block an SM) were slower, 2.95-3.44 ms. Dh 96 and 128 (168 and 224 KB,
// one block an SM) have no registers to spare for the fragments.
template <int kDP>
struct F32Shape {
  static constexpr bool kRegA = kDP == 64;
  static constexpr int kN = kDP == 96 ? 32 : 64;
};

// The layout of either kernel's tiles, in bytes from the first: the
// resident operands' lo parts (two [64][kDP] tiles), then their hi parts
// (two more; with kRegA only their landing area, which the stage and the
// streamed tiles' lo parts take over once the fragments are in
// registers), then the stage (two [32][kDP] tiles), the streamed tiles'
// lo parts and the transposed pair (four more): 80 KB at Dh 64, 1792 * kDP
// bytes (168 and 224 KB) past it.
template <int kDP>
struct F32Layout {
  static constexpr int kRes = 64 * kDP * 4;
  static constexpr int kStr = kF32Tile * kDP * 4;
  static constexpr int kHi = 2 * kRes;
  static constexpr int kStage = F32Shape<kDP>::kRegA ? kHi : kHi + 2 * kRes;
  static constexpr int kLoStr = F32Shape<kDP>::kRegA ? kHi + 2 * kStr
                                                     : kStage + 2 * kStr;
  static constexpr int kTiles = kLoStr + 4 * kStr;  // past the landing too
};

// The shared memory a kernel asks for: `tiles` bytes of tiles from a
// 1024-byte boundary and 1 KB to reach it. Its mbarriers (at most 8) sit
// in the bytes before that boundary when there are enough, else just past
// the tiles, inside the kilobyte the boundary did not take.
__host__ __device__ constexpr int f32_smem_bytes(int tiles) {
  return tiles + 1024;
}

__device__ __forceinline__ uint64_t* f32_barriers(uint8_t* raw,
                                                  uint8_t* aligned,
                                                  int tiles) {
  return reinterpret_cast<uint64_t*>(aligned - raw >= 64 ? raw
                                                         : aligned + tiles);
}

// Byte offset of element (r, c) of a K-major [rows][kDP] fp32 tile.
__device__ __forceinline__ uint32_t fofs(int r, int c, int rows) {
  return uint32_t((c >> 5) * rows * kPanelRow + r * kPanelRow +
                  ((((c & 31) >> 2) ^ (r & 7)) << 4) + ((c & 3) << 2));
}

// The k position of key (or query) kk of a tile in a transposed tile:
// within each k8 step, 2t + e sits at t + 4e, so that a thread's
// accumulator elements of the step, keys 8n + 2t + {0, 1} of rows g and
// g + 8, are the A fragment (rows g, g + 8; k positions t, t + 4).
__device__ __forceinline__ int kpos(int kk) {
  return (kk & ~7) | ((kk & 7) >> 1) | ((kk & 1) << 2);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value (its low 13 bits zero).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ float4 f4(uint32_t a, uint32_t b, uint32_t c,
                                     uint32_t d) {
  return make_float4(__uint_as_float(a), __uint_as_float(b),
                     __uint_as_float(c), __uint_as_float(d));
}

// wgmma.mma_async m64nNk8, TF32 in, fp32 accumulators d (this thread's
// N/2: element i is row 16*warp + lane/4 + 8*((i/2) % 2), column 8*(i/4)
// + 2*(lane % 4) + i % 2), A and B from shared memory by descriptor, both
// K-major (N = 32: s and dp over a tile's keys). d is overwritten when
// scale_d is 0.
__device__ __forceinline__ void wgmma_tf32_ss(Width<32>, float* d, uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same with A from registers (N = 32 or 64: s and dp, dq / dk / dv's
// chunks): a[0..3] are rows g, g + 8 at k position t, then rows g, g + 8
// at k position t + 4 (g = lane / 4, t = lane % 4, the warp's 16 rows from
// 16*warp).
__device__ __forceinline__ void wgmma_tf32_rs(Width<32>, float* d,
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_rs(Width<64>, float* d,
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a . b^T over kDP columns in split TF32: a the 64 rows of the
// [64][kDP] tile pair (a_hi, a_lo), b the 32 rows of the [32][kDP] pair
// (b_hi, b_lo); kDP / 8 k8 steps of three wgmma m64n32k8, one group. The
// columns past Dh are zeros in every part and add exact zeros.
template <int kDP>
__device__ __forceinline__ void issue_abt_tf32(float (&d)[kF32Tile / 2],
                                               const uint8_t* a_hi,
                                               const uint8_t* a_lo,
                                               const uint8_t* b_hi,
                                               const uint8_t* b_lo) {
  acc_fence<kF32Tile / 2>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDP / 8; ++kk) {
    const int pa = (kk >> 2) * 64 * kPanelRow;
    const int pb = (kk >> 2) * kF32Tile * kPanelRow;
    const int step = 2 * (kk & 3);
    const uint64_t ah = smem_desc(a_hi + pa) + step;
    const uint64_t bh = smem_desc(b_hi + pb) + step;
    wgmma_tf32_ss(Width<kF32Tile>{}, d, smem_desc(a_lo + pa) + step, bh, kk > 0);
    wgmma_tf32_ss(Width<kF32Tile>{}, d, ah, smem_desc(b_lo + pb) + step, 1);
    wgmma_tf32_ss(Width<kF32Tile>{}, d, ah, bh, 1);
  }
  wgmma_commit();
  acc_fence<kF32Tile / 2>(d);
}

// The hi part's A fragments of a split [64][kDP] tile: this warp's rows
// g, g + 8 at columns 8 kk + t, 8 kk + t + 4 of each k8 step kk.
template <int kDP>
__device__ __forceinline__ void tile_fragments(uint32_t (&f)[kDP / 8][4],
                                               const uint8_t* tile, int warp,
                                               int lane) {
  const int r = 16 * warp + (lane >> 2);
#pragma unroll
  for (int kk = 0; kk < kDP / 8; ++kk) {
    const int c = 8 * kk + (lane & 3);
    f[kk][0] = *reinterpret_cast<const uint32_t*>(tile + fofs(r, c, 64));
    f[kk][1] = *reinterpret_cast<const uint32_t*>(tile + fofs(r + 8, c, 64));
    f[kk][2] = *reinterpret_cast<const uint32_t*>(tile + fofs(r, c + 4, 64));
    f[kk][3] =
        *reinterpret_cast<const uint32_t*>(tile + fofs(r + 8, c + 4, 64));
  }
}

// issue_abt_tf32 with a's hi part from registers (`tile_fragments`): the
// a_lo . b_hi terms read a_lo from shared memory, the a_hi terms only b.
template <int kDP>
__device__ __forceinline__ void issue_abt_tf32(float (&d)[kF32Tile / 2],
                                               const uint32_t (&a_hi)[kDP / 8][4],
                                               const uint8_t* a_lo,
                                               const uint8_t* b_hi,
                                               const uint8_t* b_lo) {
  acc_fence<kF32Tile / 2>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDP / 8; ++kk) {
    const int pa = (kk >> 2) * 64 * kPanelRow;
    const int pb = (kk >> 2) * kF32Tile * kPanelRow;
    const int step = 2 * (kk & 3);
    const uint64_t bh = smem_desc(b_hi + pb) + step;
    wgmma_tf32_ss(Width<kF32Tile>{}, d, smem_desc(a_lo + pa) + step, bh, kk > 0);
    wgmma_tf32_rs(Width<kF32Tile>{}, d, a_hi[kk], smem_desc(b_lo + pb) + step, 1);
    wgmma_tf32_rs(Width<kF32Tile>{}, d, a_hi[kk], bh, 1);
  }
  wgmma_commit();
  acc_fence<kF32Tile / 2>(d);
}

// The A fragments of the k8 steps of an n32 accumulator x (keys or
// queries 8j..8j+7 of its tile, in `kpos` order), split into TF32 parts.
__device__ __forceinline__ void acc_fragments(const float (&x)[kF32Tile / 2],
                                              uint32_t (&hi)[kF32Tile / 8][4],
                                              uint32_t (&lo)[kF32Tile / 8][4]) {
#pragma unroll
  for (int j = 0; j < kF32Tile / 8; ++j) {
    split_tf32(x[4 * j], hi[j][0], lo[j][0]);
    split_tf32(x[4 * j + 2], hi[j][1], lo[j][1]);
    split_tf32(x[4 * j + 1], hi[j][2], lo[j][2]);
    split_tf32(x[4 * j + 3], hi[j][3], lo[j][3]);
  }
}

// acc[c] (+)= x . T over the 32 keys (queries) of the tile, for each
// kN-column chunk c of the transposed pair (t_hi, t_lo) ([kDP][32], one
// panel): x's fragments (hi, lo), four k8 steps of three wgmma a
// chunk, one group.
template <int kDP, int kN>
__device__ __forceinline__ void issue_at_tf32(float (&acc)[kDP / kN][kN / 2],
                                              const uint32_t (&hi)[kF32Tile / 8][4],
                                              const uint32_t (&lo)[kF32Tile / 8][4],
                                              const uint8_t* t_hi,
                                              const uint8_t* t_lo,
                                              int accumulate) {
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c) acc_fence<kN / 2>(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c)
#pragma unroll
    for (int j = 0; j < kF32Tile / 8; ++j) {
      const int o = c * kN * kPanelRow + (j >> 2) * kDP * kPanelRow;
      const uint64_t th = smem_desc(t_hi + o) + 2 * (j & 3);
      wgmma_tf32_rs(Width<kN>{}, acc[c], lo[j], th, accumulate || j > 0);
      wgmma_tf32_rs(Width<kN>{}, acc[c], hi[j],
                    smem_desc(t_lo + o) + 2 * (j & 3), 1);
      wgmma_tf32_rs(Width<kN>{}, acc[c], hi[j], th, 1);
    }
  wgmma_commit();
#pragma unroll
  for (int c = 0; c < kDP / kN; ++c) acc_fence<kN / 2>(acc[c]);
}

// Splits a [kRows][kDP] tile in place into its hi part and writes its lo
// part at the same offsets of `lo`; with a transposed pair (t_hi, t_lo)
// ([kDP][kRows]) also writes both parts there, element (row r, column c)
// at row c, k position kpos(r). 128 threads.
template <int kDP, int kRows, bool kTranspose>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* lo,
                                           uint8_t* t_hi, uint8_t* t_lo,
                                           int tid) {
  float4* x4 = reinterpret_cast<float4*>(tile);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int i = tid; i < kRows * kDP / 4; i += kConsumers) {
    const float4 x = x4[i];
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    x4[i] = f4(h[0], h[1], h[2], h[3]);
    l4[i] = f4(l[0], l[1], l[2], l[3]);
    if constexpr (kTranspose) {
      // chunk i: panel i / (8 kRows), row (i % (8 kRows)) / 8, swizzled
      // chunk i % 8
      const int r = (i % (8 * kRows)) >> 3;
      const int c0 = 32 * (i / (8 * kRows)) + 4 * ((i & 7) ^ (r & 7));
      const int kp = kpos(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t o = fofs(c0 + e, kp, kDP);
        *reinterpret_cast<uint32_t*>(t_hi + o) = h[e];
        *reinterpret_cast<uint32_t*>(t_lo + o) = l[e];
      }
    }
  }
}

// Writes the transposed pair of a split [kRows][kDP] tile (hi in `tile`,
// lo in `lo`): element (row r, column c) at row c, k position kpos(r).
template <int kDP, int kRows>
__device__ __forceinline__ void transpose_tile(const uint8_t* tile,
                                               const uint8_t* lo,
                                               uint8_t* t_hi, uint8_t* t_lo,
                                               int tid) {
  const uint4* x4 = reinterpret_cast<const uint4*>(tile);
  const uint4* l4 = reinterpret_cast<const uint4*>(lo);
  for (int i = tid; i < kRows * kDP / 4; i += kConsumers) {
    const uint4 h = x4[i];
    const uint4 l = l4[i];
    const int r = (i % (8 * kRows)) >> 3;
    const int c0 = 32 * (i / (8 * kRows)) + 4 * ((i & 7) ^ (r & 7));
    const int kp = kpos(r);
    const uint32_t hs[4] = {h.x, h.y, h.z, h.w};
    const uint32_t ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t o = fofs(c0 + e, kp, kDP);
      *reinterpret_cast<uint32_t*>(t_hi + o) = hs[e];
      *reinterpret_cast<uint32_t*>(t_lo + o) = ls[e];
    }
  }
}

// The TMA map of one fp32 operand, head h's dh-wide rows of batch row b
// read through the caller's element strides as a [B, H, S, dh] tensor, in
// boxes of 32 rows of 32 columns with the 128-byte swizzle; reads past S
// or past dh give zeros.
inline bool f32_head_map(CUtensorMap* map, const void* base,
                         long long batch_stride, long long head_stride,
                         long long row_stride, int B, int S, int H, int dh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(row_stride) * 4,
                                 cuuint64_t(head_stride) * 4,
                                 cuuint64_t(batch_stride) * 4};
  const cuuint32_t box[4] = {32, 32, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA loads of rows row0 .. row0 + rows - 1 of an operand (boxes of 32
// rows) into a [rows][kDP] tile, counted on `bar`.
template <int kDP>
__device__ __forceinline__ void load_rows(uint8_t* tile, const CUtensorMap* map,
                                          uint64_t* bar, int rows, int row0,
                                          int h, int b) {
  for (int p = 0; p < kDP / 32; ++p)
    for (int r = 0; r < rows; r += 32)
      tma_load_4d(tile + p * rows * kPanelRow + r * kPanelRow, map, bar,
                  32 * p, row0 + r, h, b);
}

}  // namespace
