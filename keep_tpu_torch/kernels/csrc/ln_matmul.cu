// LayerNorm fused into the matmul that follows it, for Hopper (sm_90a).
//
// Replaces the TPU kernel keep_tpu/kernels/ln_matmul.py `ln_matmul`
// (`_ln_mm_kernel`, pallas_call at :51), which the ViT runs under
// `fuse_ln=True` for the qkv projection after norm1 and fc1 after norm2
// (keep_tpu/models/vit.py:141-152, :173-184).
//
// What it computes, for x [M, K] (fp32 or bf16), the LayerNorm's g, b fp32
// [K], the weight W [N, K] (the torch layout, the transpose of the JAX
// kernel's w [K, N]) and bias fp32 [N]:
//   mu, rstd = the row's mean and 1/sqrt(var + eps), taken as quant_rows.cu
//              takes them: fp64 sums rounded once to fp32
//   y[m, k]  = ((x - mu)·rstd)·g + b in fp32 (kops::ln_apply), rounded to
//              W's dtype                  -- equal, bit for bit, to
//              keep_tpu_torch/kernels/_kops.py ln_rows_reference
//   out[m, n] = Σ_k y[m, k]·W[n, k] accumulated in fp32, + bias[n] in fp32,
//              cast to the output dtype (fp32 or bf16).
// Types: fp32 x with fp32 W (CUDA-core FMAs, never TF32), or bf16 x with
// bf16 W (tensor cores, fp32 accumulators; a product of two bf16 values is
// exact in fp32).
//
// What bounds it on this card: operations. At the ViT-L shapes (M = B·197,
// K = 1024, N = 3072 or 4096) the product does 2·M·K·N FLOP, 4.0–5.3·10^10
// at B = 32 and 1.6–2.1·10^11 at B = 128, against 19–266 MB of bytes, so the
// bf16 tensor-core rate sets the bound (0.040 / 0.053 ms at B = 32, 0.160 /
// 0.214 ms at B = 128, at 989 TFLOP/s). What the TPU kernel buys, and this
// one keeps, is that the normalised [M, K] never touches device memory:
// each stage of x is normalised in registers between its load and the
// product.
//
// Design:
//   1. `ln_stats_kernel`: one warp per row reads the row once with 16-byte
//      loads and holds it in registers (K ≤ 4096: 16 chunks a lane in bf16,
//      32 in fp32) for both sums, then writes (mu, rstd) to an fp32 [M, 2]
//      scratch.
//   2. bf16, `ln_matmul_wgmma_kernel`: one persistent block per SM walks
//      the 128 × 256 output tiles, along N within an M panel, so that the
//      blocks running together share W in the L2. Three warpgroups:
//        - a producer thread keeps a ring of 4 stages full, each 64 bf16 of
//          K (one 128-byte swizzle row) of x's 128 rows and W's 256 rows
//          (48 KB), brought by TMA with the 128-byte swizzle; rows past M
//          or N and columns past K arrive as zeros;
//        - two consumer warpgroups, 64 rows × 256 columns of the tile each.
//          Per stage a warp reads its 16 rows of x with ldmatrix (the
//          swizzle: chunk c of row r sits at chunk c ^ (r % 8)) straight
//          into the A fragment of wgmma, normalises it there with its rows'
//          mu, rstd and the columns' g, b (loaded before the stage's wait),
//          rounds it to bf16, and issues wgmma.mma_async m64n256k16 bf16 →
//          fp32 with A from registers and W from shared memory (K-major,
//          +2 on the descriptor per 32-byte k16 step), one k16 step at a
//          time as its fragment is ready; two fragment sets take even and
//          odd stages, one stage's products stay in flight while the next
//          is normalised, and each stage goes back to the producer once its
//          products are done. Columns past K are zeros in the fragment
//          (TMA's zero fill is not enough: ln_apply(0) = b − mu·rstd·g) and
//          g, b are never read there. 128 accumulators a thread; the
//          consumers take 240 registers, the producer's warpgroup 24;
//        - the epilogue adds the fp32 bias, rounds once and writes 128-byte
//          column strips of the warpgroup's rows into one of its two
//          swizzled output boxes in shared memory, which a TMA store copies
//          out (nothing past M or N is written) while the next strip fills
//          the other box.
//      The TMA maps are cached by pointer and shape, so that a call with
//      the same operands encodes none.
//   The fp32 form is a plain 64 × 64 tiled FMA loop with the same
//   normalisation as it stages x.
//
// What it leaves on the table (measured on the card): the epilogue does
// not overlap the products of the next tile, and after it the first
// normalised stages of that tile reach the tensor cores with nothing in
// flight; together the two cost about 40% of the GEMM's time, each alone
// little (scripts/torch_ln_matmul_parts.py). A ping-pong of the two
// consumer warpgroups over tiles would need a second 128-accumulator tile.
// Also the statistics pass, a launch of its own whose fp64 sums bound it,
// and every column tile normalising its x rows again (12–16 times a row at
// N = 3072–4096).

#include <mutex>

#include "hopper.cuh"
#include "kops.cuh"

namespace {

// ---- 1. row statistics ------------------------------------------------------

constexpr int kStatWarps = 8;

__device__ __forceinline__ double warp_sum_d(double x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The values of one 16-byte chunk as fp32: 8 bf16 or 4 fp32.
template <typename T>
struct Chunk;
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kValues = 8;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[kValues]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // the low half of a word is the element of the lower index
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Chunk<float> {
  static constexpr int kValues = 4;
  __device__ __forceinline__ static void unpack(const uint4& u,
                                                float (&f)[kValues]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

// stats[2m] = mean, stats[2m + 1] = 1/sqrt(var + eps) of row m: the mean
// first, then the mean of (x − mean)², both summed in fp64 and rounded once,
// as quant_rows.cu and _kops.ln_rows_reference take them. One warp per row;
// lane l holds the row's 16-byte chunks l, l + 32, … (kC of them at most),
// read once.
template <typename T, int kC>
__global__ void __launch_bounds__(kStatWarps * 32)
ln_stats_kernel(const T* __restrict__ x, float* __restrict__ stats, int M,
                int K, float eps) {
  using C = Chunk<T>;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kStatWarps + threadIdx.x / 32;
  if (row >= M) return;  // uniform across the warp; no block barrier follows
  const uint4* xr = reinterpret_cast<const uint4*>(x + (long long)row * K);
  const int chunks = K / C::kValues;
  uint4 v[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int i = lane + 32 * c;
    v[c] = i < chunks ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
  }
  double s = 0.0;  // the zeros past the row add nothing
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    float f[C::kValues];
    C::unpack(v[c], f);
#pragma unroll
    for (int e = 0; e < C::kValues; ++e) s += double(f[e]);
  }
  const double inv_n = 1.0 / double(K);
  const float mu = float(warp_sum_d(s) * inv_n);
  double q = 0.0;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    if (lane + 32 * c >= chunks) break;
    float f[C::kValues];
    C::unpack(v[c], f);
#pragma unroll
    for (int e = 0; e < C::kValues; ++e) {
      const double d = double(__fsub_rn(f[e], mu));
      q += d * d;
    }
  }
  const float var = float(warp_sum_d(q) * inv_n);
  if (lane == 0) {
    stats[2 * row] = mu;
    stats[2 * row + 1] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  }
}

template <typename T>
cudaError_t launch_stats(const void* x, void* stats, int M, int K, float eps,
                         cudaStream_t stream) {
  const int per_lane = (K / Chunk<T>::kValues + 31) / 32;
  const dim3 grid((M + kStatWarps - 1) / kStatWarps);
  const T* xx = static_cast<const T*>(x);
  float* st = static_cast<float*>(stats);
  if (per_lane <= 4)
    ln_stats_kernel<T, 4><<<grid, kStatWarps * 32, 0, stream>>>(xx, st, M, K,
                                                                 eps);
  else if (per_lane <= 8)
    ln_stats_kernel<T, 8><<<grid, kStatWarps * 32, 0, stream>>>(xx, st, M, K,
                                                                 eps);
  else if (per_lane <= 16)
    ln_stats_kernel<T, 16><<<grid, kStatWarps * 32, 0, stream>>>(xx, st, M,
                                                                  K, eps);
  else
    ln_stats_kernel<T, 32><<<grid, kStatWarps * 32, 0, stream>>>(xx, st, M,
                                                                  K, eps);
  return cudaGetLastError();
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* dst, float a,
                                                  float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* dst,
                                                          float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// ---- 2a. bf16: wgmma fed by TMA, x normalised into the A fragments ----------

constexpr int BM = 128;              // a tile's rows: two 64-row wgmma halves
constexpr int BN = 256;              // its columns: wgmma m64n256k16
constexpr int BK = 64;               // bf16 of K a stage: one swizzle row
constexpr int kRowBytes = BK * 2;    // 128
constexpr int kStages = 4;
constexpr int kABytes = BM * kRowBytes;                  // 16 KB of x
constexpr int kStageBytes = kABytes + BN * kRowBytes;    // + 32 KB of W
constexpr int kBoxBytes = 64 * 128;  // an output box: 64 rows of 128 bytes
constexpr int kThreads = 3 * 128;    // two consumer warpgroups, a producer
constexpr int kSmemBytes =
    1024 + kStages * kStageBytes + 4 * kBoxBytes + 2 * kStages * 8;

// d[64 rows × 256 columns of this warpgroup] (+)= A[64 × 16] · B[256 × 16]ᵀ:
// A bf16 from registers (a: the mma.sync m16n8k16 A fragment of this warp's
// 16 rows), B bf16 from shared memory by descriptor, K-major. d is
// overwritten when scale_d is 0. Element i of d is row 16·warp + lane/4 +
// 8·((i/2) % 2), column 8·(i/4) + 2·(lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving accesses of the accumulators, or reusing
// the registers of an A fragment, across the asynchronous wgmma.
__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void frag_fence(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// One arrival from each warp, after all its lanes got here.
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two consecutive values of x (a bf16 pair, the lower index in the low
// half) normalised with kops::ln_apply, as the plain version does, and
// rounded back to a bf16 pair.
__device__ __forceinline__ uint32_t ln_pair(uint32_t v, float mu, float rstd,
                                            float2 g, float2 b) {
  const __nv_bfloat162 y = __floats2bfloat162_rn(
      kops::ln_apply(__uint_as_float(v << 16), mu, rstd, g.x, b.x),
      kops::ln_apply(__uint_as_float(v & 0xffff0000u), mu, rstd, g.y, b.y));
  return *reinterpret_cast<const uint32_t*>(&y);
}

// g and b at the columns of this thread's A fragments in the stage at k0:
// gb[kk] = {g[k], g[k + 8], b[k], b[k + 8]} (pairs), k = k0 + 16·kk +
// 2·(lane % 4). Loaded before the stage's wait, so that their latency
// stays off the path from the stage's arrival to its products. Nothing is
// read past K (K is a multiple of 16: a k16 step is wholly in or out).
__device__ __forceinline__ void load_gb(float2 (&gb)[4][4], int k0, int K,
                                        int lane, const float* __restrict__ g,
                                        const float* __restrict__ b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = k0 + 16 * kk + 2 * (lane % 4);
    if (k0 + 16 * kk < K) {
      gb[kk][0] = __ldg(reinterpret_cast<const float2*>(g + k));
      gb[kk][1] = __ldg(reinterpret_cast<const float2*>(g + k + 8));
      gb[kk][2] = __ldg(reinterpret_cast<const float2*>(b + k));
      gb[kk][3] = __ldg(reinterpret_cast<const float2*>(b + k + 8));
    }
  }
}

// The products of one stage for this warpgroup: x's 16 rows of this warp
// from the stage (ldmatrix from the 128-byte swizzle: chunk c of row r sits
// at chunk c ^ (r % 8)), normalised in registers into `a`, and a wgmma
// m64n256k16 against the stage's W for each k16 step as soon as its
// fragment is ready. `a` must not be in use by a wgmma still in flight.
// Columns past K are zeros in `a` (TMA's zero fill is not enough:
// ln_apply(0) = b − mu·rstd·g).
__device__ __forceinline__ void stage_products(
    float (&acc)[128], uint32_t (&a)[4][4], const uint8_t* st, int ld_row,
    int lane, int k0, int K, const float (&mu)[2], const float (&rstd)[2],
    const float2 (&gb)[4][4], bool accumulate) {
  frag_fence(a);
  const uint32_t x_s = smem_u32(st) + ld_row * kRowBytes;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(a[kk], x_s + (((2 * kk + (lane >> 4)) ^ (ld_row & 7)) << 4));
  const uint64_t db = smem_desc(st + kABytes);
  acc_fence(acc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // a[kk][0..1] hold columns 2·(lane % 4) + {0, 1} of the k16 step,
    // a[kk][2..3] those 8 further on; [0], [2] row lane/4, [1], [3] 8 below
    if (k0 + 16 * kk < K) {
      a[kk][0] = ln_pair(a[kk][0], mu[0], rstd[0], gb[kk][0], gb[kk][2]);
      a[kk][1] = ln_pair(a[kk][1], mu[1], rstd[1], gb[kk][0], gb[kk][2]);
      a[kk][2] = ln_pair(a[kk][2], mu[0], rstd[0], gb[kk][1], gb[kk][3]);
      a[kk][3] = ln_pair(a[kk][3], mu[1], rstd[1], gb[kk][1], gb[kk][3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[kk][i] = 0u;
    }
    wgmma_fence();  // a[kk]'s writes, before the product reads it
    // 32 bytes of K: +2 on the descriptor
    wgmma_rs_n256(acc, a[kk], db + 2 * kk, accumulate || kk > 0);
  }
  wgmma_commit();
  acc_fence(acc);
  frag_fence(a);
}

template <typename TOut>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                       const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_out,
                       const float* __restrict__ stats,
                       const float* __restrict__ g,
                       const float* __restrict__ b,
                       const float* __restrict__ bias, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles start 1024-byte aligned
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* out_s = ring + kStages * kStageBytes;  // 2 output boxes each
  uint64_t* full = reinterpret_cast<uint64_t*>(out_s + 4 * kBoxBytes);
  uint64_t* empty = full + kStages;

  const int wg = threadIdx.x / 128;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * n_tiles;
  const int kt_count = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrival, with the bytes
      mbar_init(&empty[s], 8);  // each warp of the two consumers
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ------------------------
    // (its warpgroup gives registers to the consumers)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * BM;
        const int n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < kt_count; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first round passes
          uint8_t* st = ring + stage * kStageBytes;
          mbar_expect_tx(&full[stage], kStageBytes);
          tma_load_2d(st, &map_x, &full[stage], kt * BK, m0);
          tma_load_2d(st + kABytes, &map_w, &full[stage], kt * BK, n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows each of every tile of the block ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int t = threadIdx.x % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int row = 64 * wg + 16 * warp + lane / 4;  // its accumulator rows:
                                                   // row and row + 8
  const int ld_row = 64 * wg + 16 * warp + lane % 16;  // ldmatrix's row
  float acc[128];
  uint32_t a0[4][4] = {}, a1[4][4] = {};  // A fragments of even and odd
                                          // stages
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // the statistics of this thread's two rows of a tile (rows past M: 0,
  // their outputs are not stored), loaded a tile ahead
  float mu[2], rstd[2];
  auto load_stats = [&](int tile) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = (tile / n_tiles) * BM + row + 8 * h;
      const bool in = tile < tiles && m < M;
      mu[h] = in ? stats[2 * m] : 0.f;
      rstd[h] = in ? stats[2 * m + 1] : 0.f;
    }
  };
  load_stats(blockIdx.x);
  int pos = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / n_tiles) * BM;
    const int n0 = (tile % n_tiles) * BN;
    for (int kt = 0; kt < kt_count; ++kt, ++pos) {
      const int s = pos % kStages;
      float2 gb[4][4];
      load_gb(gb, kt * BK, K, lane, g, b);
      mbar_wait(&full[s], (pos / kStages) & 1);
      // even and odd stages take turns on two fragment sets: the one
      // written here was last read by the products of stage kt − 2, which
      // the wait below, one stage ago, saw complete
      if (kt % 2 == 0)
        stage_products(acc, a0, ring + s * kStageBytes, ld_row, lane, kt * BK,
                       K, mu, rstd, gb, kt > 0);
      else
        stage_products(acc, a1, ring + s * kStageBytes, ld_row, lane, kt * BK,
                       K, mu, rstd, gb, true);
      // the previous stage's products are done: its slot goes back
      wgmma_wait<1>();
      if (kt > 0) warp_arrive(&empty[(pos - 1) % kStages], lane);
    }
    wgmma_wait<0>();
    acc_fence(acc);
    frag_fence(a0);
    frag_fence(a1);
    warp_arrive(&empty[(pos - 1) % kStages], lane);
    load_stats(tile + gridDim.x);

    // Epilogue: + bias, one rounding, 128 bytes of columns a pass (64 bf16
    // or 32 fp32) of the warpgroup's 64 rows into one of its two output
    // boxes in shared memory (chunks swizzled as TMA reads them: the 8 rows
    // of a warp's store hit 8 distinct chunks), then a TMA store, which
    // writes nothing past M or N. The passes alternate between the boxes,
    // and a pass waits only for the store of the pass before the last to
    // have read its box; the other warpgroup has boxes of its own.
    constexpr int kE = sizeof(TOut);
    constexpr int kBoxCols = 128 / kE;
    const int m = m0 + 64 * wg;
#pragma unroll
    for (int pass = 0; pass < BN / kBoxCols; ++pass) {
      uint8_t* box = out_s + (2 * wg + pass % 2) * kBoxBytes;
      if (t == 0) bulk_wait_read<1>();
      bar_sync(1 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < kBoxCols / 8; ++jj) {
        const int j = pass * kBoxCols / 8 + jj;  // the pair's n8 block
        const int n = n0 + 8 * j + 2 * (lane % 4);
        const int byte = (8 * jj + 2 * (lane % 4)) * kE;  // in the box row
        const float bn0 = n < N ? __ldg(bias + n) : 0.f;
        const float bn1 = n < N ? __ldg(bias + n + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * warp + lane / 4 + 8 * h;  // row in the half
          uint8_t* p = box + r * 128
                       + ((((byte >> 4) ^ (r & 7)) << 4) | (byte & 15));
          store_pair<TOut>(reinterpret_cast<TOut*>(p),
                           __fadd_rn(acc[4 * j + 2 * h], bn0),
                           __fadd_rn(acc[4 * j + 2 * h + 1], bn1));
        }
      }
      fence_proxy_async();  // the generic writes, before TMA reads them
      bar_sync(1 + wg, 128);
      if (t == 0) {
        const int n = n0 + pass * kBoxCols;
        if (m < M && n < N) tma_store_2d(&map_out, box, n, m);
        bulk_commit();
      }
    }
  }
  // the block's shared memory outlives the last stores' reads of it
  if (t == 0) bulk_wait_read<0>();
}

// The TMA map of a row-major [rows, cols] matrix of `dtype` (elements of
// `elem` bytes) in boxes of box_rows × 128 bytes with the 128-byte swizzle;
// loads past the edges give zeros and stores there write nothing. Maps are
// kept by pointer and shape (a map is a function of these alone), so that
// the calls of a forward, whose weights stay put and whose activations the
// caching allocator hands out again, encode few.
bool tile_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType dtype,
              int elem, int rows, int cols, int box_rows) {
  struct Entry {
    const void* ptr;
    int dtype, rows, cols, box_rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.ptr == ptr && e.dtype == int(dtype) && e.rows == rows &&
        e.cols == cols && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, dtype, 2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  cache[next] = {ptr, int(dtype), rows, cols, box_rows, *map};
  next = (next + 1) % kEntries;
  if (used < kEntries) ++used;
  return true;
}

template <typename TOut>
cudaError_t launch_bf16(const void* x, const void* g, const void* b,
                        float eps, const void* w, const void* bias,
                        void* stats, void* out, int M, int N, int K,
                        cudaStream_t stream) {
  static std::atomic<int> smem_allowed[kMaxDevices];
  const cudaError_t attr =
      allow_smem(ln_matmul_wgmma_kernel<TOut>, kSmemBytes, smem_allowed);
  if (attr != cudaSuccess) return attr;
  constexpr bool kF32 = sizeof(TOut) == 4;
  CUtensorMap map_x, map_w, map_out;
  if (!tile_map(&map_x, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, BM) ||
      !tile_map(&map_w, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, N, K, BN) ||
      !tile_map(&map_out, out,
                kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                sizeof(TOut), M, N, 64))
    return cudaErrorNotSupported;  // before any launch
  const cudaError_t e =
      launch_stats<__nv_bfloat16>(x, stats, M, K, eps, stream);
  if (e != cudaSuccess) return e;
  const long long tiles =
      static_cast<long long>((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  ln_matmul_wgmma_kernel<TOut><<<grid, kThreads, kSmemBytes, stream>>>(
      map_x, map_w, map_out, static_cast<const float*>(stats),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const float*>(bias), M, N, K);
  return cudaGetLastError();
}

// ---- 2b. fp32: CUDA-core FMAs -------------------------------------------------

constexpr int FM = 64;
constexpr int FN = 64;
constexpr int FK = 16;
constexpr int kFThreads = 256;  // 16 × 16 threads, 4 × 4 outputs each

template <typename TOut>
__global__ void __launch_bounds__(kFThreads)
ln_matmul_f32_kernel(const float* __restrict__ X,
                     const float* __restrict__ stats,
                     const float* __restrict__ g, const float* __restrict__ b,
                     const float* __restrict__ W,
                     const float* __restrict__ bias, TOut* __restrict__ out,
                     int M, int N, int K) {
  __shared__ float As[FK][FM + 4];  // [k][m], normalised x
  __shared__ float Bs[FK][FN + 4];  // [k][n]
  __shared__ float mu_s[FM];
  __shared__ float rstd_s[FM];
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int i = threadIdx.x; i < FM; i += kFThreads) {
    const bool ok = m0 + i < M;
    mu_s[i] = ok ? stats[2 * (m0 + i)] : 0.f;
    rstd_s[i] = ok ? stats[2 * (m0 + i) + 1] : 0.f;
  }
  __syncthreads();

  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
#pragma unroll
    for (int it = 0; it < FM * FK / kFThreads; ++it) {
      const int idx = threadIdx.x + it * kFThreads;
      const int r = idx / FK;
      const int c = idx % FK;
      const int gk = k0 + c;
      const int gm = m0 + r;
      const int gn = n0 + r;
      As[c][r] = gm < M && gk < K
                     ? kops::ln_apply(X[(long long)gm * K + gk], mu_s[r],
                                      rstd_s[r], g[gk], b[gk])
                     : 0.f;
      Bs[c][r] = gn < N && gk < K ? W[(long long)gn * K + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = Bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;  // N is a multiple of 8, so n + 1 < N too
      store_pair<TOut>(out + (long long)m * N + n,
                       __fadd_rn(acc[i][j], bias[n]),
                       __fadd_rn(acc[i][j + 1], bias[n + 1]));
    }
  }
}

template <typename T, typename TOut>
cudaError_t launch(const void* x, const void* g, const void* b, float eps,
                   const void* w, const void* bias, void* stats, void* out,
                   int M, int N, int K, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_bf16<TOut>(x, g, b, eps, w, bias, stats, out, M, N, K,
                             stream);
  } else {
    const cudaError_t e = launch_stats<T>(x, stats, M, K, eps, stream);
    if (e != cudaSuccess) return e;
    const dim3 grid((N + FN - 1) / FN, (M + FM - 1) / FM);
    ln_matmul_f32_kernel<TOut><<<grid, kFThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(stats),
        static_cast<const float*>(g), static_cast<const float*>(b),
        static_cast<const float*>(w), static_cast<const float*>(bias),
        static_cast<TOut*>(out), M, N, K);
    return cudaGetLastError();
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. x [M, K] and w [N, K] of one
// dtype (0 = float32, 1 = bfloat16), ln_g, ln_b fp32 [K], bias fp32 [N],
// stats an fp32 [M, 2] scratch, out [M, N] (out_dtype: 0 = float32,
// 1 = bfloat16); all contiguous; x, w, ln_g, ln_b and out 16-byte aligned. K
// must be a multiple of 16 and at most 4096, N a multiple of 8. Returns the
// cudaError_t of the launches (cudaErrorInvalidValue for arguments it does
// not take, cudaErrorNotSupported when libcuda has no TMA encoder).
extern "C" int keep_ln_matmul(const void* x, const void* ln_g,
                              const void* ln_b, float eps, const void* w,
                              const void* bias, void* stats, void* out,
                              int dtype, int out_dtype, int M, int N, int K,
                              void* stream) {
  if (M < 1 || N < 1 || K < 16 || K > 4096 || K % 16 || N % 8 ||
      (M + FM - 1) / FM > 65535 || !aligned16(x) || !aligned16(w) ||
      !aligned16(ln_g) || !aligned16(ln_b) || !aligned16(out))
    return int(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return int(launch<float, float>(x, ln_g, ln_b, eps, w, bias, stats, out,
                                    M, N, K, st));
  if (dtype == 0 && out_dtype == 1)
    return int(launch<float, __nv_bfloat16>(x, ln_g, ln_b, eps, w, bias,
                                            stats, out, M, N, K, st));
  if (dtype == 1 && out_dtype == 0)
    return int(launch<__nv_bfloat16, float>(x, ln_g, ln_b, eps, w, bias,
                                            stats, out, M, N, K, st));
  if (dtype == 1 && out_dtype == 1)
    return int(launch<__nv_bfloat16, __nv_bfloat16>(
        x, ln_g, ln_b, eps, w, bias, stats, out, M, N, K, st));
  return int(cudaErrorInvalidValue);
}
