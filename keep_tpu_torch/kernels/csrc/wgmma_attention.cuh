// Pieces shared by the bf16 attention's wgmma bodies, forward and
// backward: attention_qkv_slab_wgmma.cu (the forward's one-pass body and
// its entry point, which writes the arguments),
// attention_qkv_slab_wgmma_streamed.cu (the forward's streamed body) and
// the backward's two kernels, attention_qkv_slab_bwd_dq.cu and
// attention_qkv_slab_bwd_dkv.cu (launched from attention_qkv_slab_bwd.cu;
// the fp32 pair's own pieces are in tf32_attention.cuh),
// sources apart so that nvcc builds them side by side: the arguments of a
// launch, the TMA maps, the wgmma instructions (A from registers or shared
// memory), the ring's release, the softmax's quotient and the epilogue
// that stages an output tile through shared memory.
#pragma once

#include "hopper.cuh"
#include "slab_attention.cuh"

namespace keep_attn {

// One launch of a body: q, k and v's TMA maps, the key bias (or null),
// the output (bf16, or fp32 when out_f32) and the shape.
struct Args {
  CUtensorMap q, k, v;
  const float* key_bias;
  void* out;
  bool out_f32;
  int B, S, H, dh;
  float scale;
  cudaStream_t stream;
};

// The streamed body's launch (attention_qkv_slab_wgmma_streamed.cu), its
// maps in boxes of kTileKeys rows.
cudaError_t launch_streamed(const Args& a);

// One launch of the bf16 backward: the maps of q, k and v (the slab's
// lanes) and of dout, in boxes of kTileKeys rows; the map of the row
// statistics [B, H, S] x float4 (kernel A writes them through `stats`,
// kernel B reads them through the map); the key bias, dqkv and the shape.
struct BwdArgs {
  CUtensorMap q, k, v, dout, stats_map;
  const float* key_bias;
  float4* stats;
  __nv_bfloat16* dqkv;
  int B, S, H, dh;
  float scale;
  cudaStream_t stream;
};

// Kernel A (statistics and dq; attention_qkv_slab_bwd_dq.cu) and kernel B
// (dk and dv; attention_qkv_slab_bwd_dkv.cu), launched in that order on
// a.stream.
cudaError_t launch_bwd_dq(const BwdArgs& a);
cudaError_t launch_bwd_dkv(const BwdArgs& a);

}  // namespace keep_attn

namespace {

using keep_attn::Args;

constexpr int kQRows = 64;       // query rows a block owns
constexpr int kTileKeys = 64;    // keys a stage of the streamed body holds
constexpr int kPanelBytes = kTileKeys * kRowBytes;  // 64 rows x 64 columns
constexpr int kConsumers = 128;  // the warpgroup that computes

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

// The same with A from shared memory too (a: its descriptor), both
// operands K-major: q . k^T.
__device__ __forceinline__ void wgmma_ss(Width<16>, float* d, uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(Width<32>, float* d, uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(Width<48>, float* d, uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(Width<64>, float* d, uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving accesses of accumulators across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void acc_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = a . b^T over kDP columns (Dh padded to a multiple of 16; past 64 the
// second 64-column panel of each tile), one wgmma group: a the 64 rows of
// the tile at a_tile, b the N rows from row b_row0 of the tile at b_tile,
// both K-major (TMA's 128-byte swizzle). kDP / 16 k16 steps; the zero
// columns past Dh add exact zeros. This thread's part, element i: row
// 16*warp + lane/4 + 8*((i/2) % 2), column 8*(i/4) + 2*(lane % 4) + i % 2.
template <int kDP, int N>
__device__ __forceinline__ void issue_abt(float* d, const uint8_t* a_tile,
                                          const uint8_t* b_tile, int b_row0) {
  acc_fence<N / 2>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDP / 16; ++kk) {
    const int panel = kk / 4;
    wgmma_ss(Width<N>{}, d,
             smem_desc(a_tile + panel * kPanelBytes) + 2 * (kk % 4),
             smem_desc(b_tile + panel * kPanelBytes + b_row0 * kRowBytes) +
                 2 * (kk % 4),
             kk);
  }
  wgmma_commit();
  acc_fence<N / 2>(d);
}

// e / l in IEEE round-to-nearest, from y = 1/l correctly rounded: the
// quotient q = e*y rounded is within an ulp of e / l, the remainder
// e - l*q is exact in one FMA, and q + remainder*y rounded is the correctly
// rounded quotient (Markstein). It gives div.rn's bits without its range
// checks and slow path per element, which took this body from 0.155 to
// 0.359 ms at BERT-base B=128 on an H100 (e in [0, 1], l >= 1: no
// overflow; a quotient below 2^-126 may differ in its last subnormal bit).
__device__ __forceinline__ float div_rn(float e, float l, float y) {
  const float q = __fmul_rn(e, y);
  return __fmaf_rn(__fmaf_rn(-q, l, e), y, q);
}

// The first 1024-byte aligned byte of dynamic shared memory (the
// 128-byte swizzle's tiles start on 1024 bytes).
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// One consumer warp's release of a ring stage (its wgmma have read it).
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// The 128 consumer threads' barrier (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The TMA map of one operand, head h's dh-wide rows of batch row b read
// through the caller's element strides as a [B, H, S, dh] bf16 tensor, in
// boxes of `box_rows` rows of 64 columns with the 128-byte swizzle; reads
// past S or past dh give zeros.
inline bool head_map(CUtensorMap* map, const void* base,
                     long long batch_stride, long long head_stride,
                     long long row_stride, int B, int S, int H, int dh,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {cuuint64_t(dh), cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(row_stride) * 2,
                                 cuuint64_t(head_stride) * 2,
                                 cuuint64_t(batch_stride) * 2};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The TMA map of the backward's row statistics, an fp32 [B, H, S, 4]
// tensor, in boxes of kTileKeys rows (1 KB, no swizzle); rows past S
// arrive as zeros.
inline bool stats_map(CUtensorMap* map, const void* base, int B, int S,
                      int H) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {4, cuuint64_t(S), cuuint64_t(H),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {16, cuuint64_t(S) * 16,
                                 cuuint64_t(S) * cuuint64_t(H) * 16};
  const cuuint32_t box[4] = {4, cuuint32_t(kTileKeys), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- the epilogue, shared by the bodies -------------------------------------

// Elements of a staged output row: the padded head width and 8 more, so
// that the quads' stores of one fragment fall in distinct banks.
template <int kDP>
__host__ __device__ constexpr int out_pitch() {
  return kDP + 8;
}

// This thread's N/2 accumulators of an m64nN tile (columns col0 ..
// col0 + N - 1 of the output) into the staged tile, cast to TOut.
template <int N, typename TOut, int kPitch>
__device__ __forceinline__ void stage_acc(TOut* stage, const float* o,
                                          int col0, int warp, int lane) {
  const int r = 16 * warp + (lane >> 2);
  const int c = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    Elem<TOut>::store(stage + r * kPitch + 8 * j + c, o[4 * j], o[4 * j + 1]);
    Elem<TOut>::store(stage + (r + 8) * kPitch + 8 * j + c, o[4 * j + 2],
                      o[4 * j + 3]);
  }
}

// The staged tile's rows < S (of the block's 64 from row0), columns < dh,
// to out[b, row, h*dh ...] in 16-byte stores by the block's 128 consumer
// threads, rows H*dh apart (the backward's slab: 3H heads' worth, from
// its lane's first column).
template <typename TOut, int kPitch>
__device__ __forceinline__ void store_rows(const TOut* stage,
                                           TOut* __restrict__ out, int b,
                                           int h, int row0, int S, int H,
                                           int dh, int tid) {
  constexpr int kPer = 16 / int(sizeof(TOut));  // elements a store
  const int chunks = dh / kPer;
  const long long D = (long long)H * dh;
  for (int i = tid; i < kQRows * chunks; i += kConsumers) {
    const int rr = i / chunks;
    const int c = i - rr * chunks;
    const int row = row0 + rr;
    if (row < S)
      *reinterpret_cast<uint4*>(out + ((long long)b * S + row) * D +
                                (long long)h * dh + kPer * c) =
          *reinterpret_cast<const uint4*>(stage + rr * kPitch + kPer * c);
  }
}

}  // namespace
