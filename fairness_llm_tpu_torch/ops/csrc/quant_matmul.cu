// int8 weight-only matrix product for Hopper (sm_90a):
// out = cast((x @ wq) * scale).
//
// Replaces: fairness_llm_tpu/ops/quant_matmul.py, `_quant_matmul_pallas` ->
// `_matmul_kernel` (the Pallas TPU kernel), which `QuantDense` reaches
// through `quant_matmul`. Same function: x [M,K] (bf16 or f32) times the int8
// weight wq [K,N] (flax [in, out] layout, N contiguous) with f32
// accumulation, then the per-output-channel f32 scale [N] applied once after
// the sum, then a cast to the output type (bf16, or f32 for lm_head and for
// float32 models). The weight is converted to the working type inside the
// kernel, a tile at a time; device memory only ever holds the int8 weight.
// int8 -> bf16 and int8 -> f32 are exact (|q| <= 127).
//
// Two regimes; the wrapper picks one from M.
//
// GEMV (M <= 64: the decode step, M = the batch), bf16 x: gemv_stream_tc,
// entry quant_matmul_stream. Bound by bytes: 2*M operations per weight byte,
// and the weight is read once, so the bound is K*N bytes over the H100 SXM's
// 3.35 TB/s at 700 W (gate/up of llama3-8b: 58.7 MB, ~17.5 us). One launch
// takes up to three weights that share x (q/k/v, gate/up) and computes all
// their outputs. The design:
// - A persistent grid of at most one block an SM. The weights' column tiles
//   (256 wide, or 128 where runs would be short: o_proj) times their 64-row
//   k tiles are one list of tile steps, cut into equal contiguous runs, one
//   a block (gemv_plan in ops/quant_matmul.py), so every SM streams the same
//   share of the bytes and no tail wave is left. A run crosses column tiles;
//   its piece of one column tile is a unit, and a column tile is split
//   across the blocks whose runs cover it.
// - A producer warp keeps a ring of 64 KB of weight (4 stages of 256
//   columns or 8 of 128; the weight tile by TMA, 128B-swizzled, x's tile by
//   cp.async) in flight across unit boundaries against full/empty
//   mbarriers, so short units do not drain it. Deeper rings, and L2
//   prefetches ahead of the ring, measured slower.
//   x rides in each stage (2-8 KB from L2): a unit's x range at M = 64 can
//   exceed shared memory, and the bytes that bound the kernel are the
//   weight's.
// - Eight consumer warps meet at no block-wide barrier per tile. Each owns 32
//   columns (at 128 columns, and half the tile's k rows: the two halves add
//   up in shared memory at a unit's end) and converts only the weight it
//   multiplies, straight from the swizzled int8 tile into mma.sync B
//   fragments in registers (the register route): no bf16 copy is written to
//   and read back from shared memory, and no barrier orders a conversion
//   against the products of another warp.
//   The conversion is what bounds the consumers: the integer pipe issues
//   at half the FP32 rate, and a first version spent ~70 integer ops on 16
//   weight bytes (PRMT, or LOP3 pairs that ptxas split). Now a byte takes
//   one LOP3 and one FADD, a bf16 pair one shift-add, 16 bytes 28 integer
//   ops.
//   The words a thread reads are the k rows its B fragment needs, so x's A
//   fragments come by ldmatrix in the natural order; each byte of a word is
//   a different n8 tile, and the epilogue maps columns back (gs_row).
// - The split-K reduce inside: a unit that covers part of a column tile
//   writes its f32 partial into a workspace slot and raises the tile's
//   arrival counter; the block that arrives last sums the partials in split
//   order (so repeated calls agree bit for bit), scales, casts, stores and
//   sets the counter back to 0. A tile one unit covers is stored directly.
// The plan caps a column tile's splits at about 8 (a weight as narrow as
// k/v alone then uses fewer blocks), since the last block reads them all.
// float32 x in this regime: f32_kernel, K split across blocks by
// quant_matmul_gemv, and splitk_reduce.
//
// quant_matmul_gemm (M > 64: prefill). Bound by operations (2*M*K*N; a
// no-prefix prefill of llama3-8b is ~200 TFLOP against 989 TFLOP/s bf16).
// bf16 x: wgmma m64n256k16 with f32 accumulation in registers, fed by TMA,
// on 128 x 256 output tiles, k tiles of 64 (wg_gemm_kernel). One producer
// thread keeps four stages of TMA copies (x tile 128B-swizzled, int8 weight
// tile as stored) in flight against full/empty mbarriers. Two consumer
// warpgroups each run 64 rows with one wgmma group in flight; while tile
// t's products run they convert tile t+1's weights to bf16 into a ring of
// three buffers, laid out as the MN-major B operand wgmma reads with the
// transpose bit set. Three, not two: tile t-1's products may still be in
// flight in either warpgroup, so tile t+1 takes the buffer of tile t-2,
// which both finished before they last met. The conversion and the products
// of the same tile are never ordered against each other by a barrier; only
// the two consumer warpgroups meet, once a tile. What bounds it: the TMA copies (32 KB a
// stage from L2), then the conversion, which adds shared-memory traffic
// (the bf16 tile is written once and read by both warpgroups) and whose
// latency is only partly hidden behind one tile's products. At small N
// (k/v: N = 1024) too few 256-wide column tiles fill 132 SMs.
//
// float32 x (float32 models) in either regime: the weight goes to f32, never
// TF32 or bf16, and the products are f32 FMAs on the CUDA cores. A block
// owns 128 columns, up to 64 rows and a slice of K; each lane owns 4
// neighbouring columns (one 32-bit word of a weight row) and up to 16 rows,
// the 8 warps split each tile's k rows (and the rows of x past 16), and
// their sums meet in shared memory in a fixed order.
//
// Ragged edges: rows of x past M, k past K and columns past N are
// zero-filled when staged (by cp.async, or by TMA's out-of-bounds fill) and
// never stored. The wrapper hands in N a multiple of 16 and 16-byte aligned
// rows (it pads where they are not).

#include <cuda.h>

#include "attention_common.cuh"
#include "mma_fragments.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using frag::i8x4_to_f32;  // exact int8 -> float (mma_fragments.cuh)

// ---------------------------------------------------------------------------
// float32 x: CUDA-core FMAs (both regimes)
// ---------------------------------------------------------------------------

constexpr int GV_BN = 128;  // columns per block: 32 lanes x 4
constexpr int GV_BK = 32;   // k rows per pipeline stage
constexpr int GV_STAGES = 4;

constexpr size_t gv_smem_bytes(int MP) {
  const size_t pipe = GV_STAGES * (size_t(GV_BK) * GV_BN + size_t(MP) * GV_BK * sizeof(float));
  const size_t red = size_t(MP) * GV_BN * sizeof(float);
  return pipe > red ? pipe : red;
}

// Block (column tile, K split, row chunk). MR rows of x per lane, MG warp
// groups over rows (MP = MR * MG rows per block); the kWarps / MG warps of a
// group split each tile's k rows. `partial` is null when the block applies
// the scale and writes `out` itself (one split), else [splits, M, N].
template <int MR, int MG>
__global__ void __launch_bounds__(kThreads)
f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ partial,
           int M, int K, int N, int ldx, int k_per_split) {
  constexpr int MP = MR * MG;
  constexpr int KG = kWarps / MG;
  constexpr int KR = GV_BK / KG;  // k rows per warp per stage
  constexpr int VE = 16 / sizeof(float);
  constexpr int W_BYTES = GV_BK * GV_BN;
  constexpr int STAGE = W_BYTES + MP * GV_BK * sizeof(float);
  static_assert(KR % 4 == 0, "each warp takes k rows four at a time");
  extern __shared__ __align__(16) unsigned char smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mg = warp % MG, kg = warp / MG;
  const int n0 = blockIdx.x * GV_BN;
  const int m0 = blockIdx.z * MP;
  const int kb = blockIdx.y * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int ntiles = ke > kb ? (ke - kb + GV_BK - 1) / GV_BK : 0;

  auto wtile = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * STAGE); };
  auto xtile = [&](int st) { return reinterpret_cast<float*>(smem + st * STAGE + W_BYTES); };

  auto stage = [&](int t) {
    const int k0 = kb + t * GV_BK;
    const int st = t % GV_STAGES;
    int8_t* wd = wtile(st);
    for (int i = threadIdx.x; i < GV_BK * (GV_BN / 16); i += kThreads) {
      const int r = i / (GV_BN / 16), c = (i % (GV_BN / 16)) * 16;
      const bool ok = k0 + r < ke && n0 + c < N;
      cp_async16(wd + r * GV_BN + c, ok ? w + (long long)(k0 + r) * N + n0 + c : w, ok);
    }
    float* xd = xtile(st);
    for (int i = threadIdx.x; i < MP * (GV_BK / VE); i += kThreads) {
      const int r = i / (GV_BK / VE), c = (i % (GV_BK / VE)) * VE;
      // A chunk that starts before ke ends before it, or runs into the
      // zero padding of a row past K.
      const bool ok = m0 + r < M && k0 + c < ke;
      cp_async16(xd + r * GV_BK + c, ok ? x + (long long)(m0 + r) * ldx + k0 + c : x, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < GV_STAGES - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<GV_STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + GV_STAGES - 1 < ntiles) stage(t + GV_STAGES - 1);
    cp_async_commit();

    const int8_t* wt = wtile(t % GV_STAGES) + kg * KR * GV_BN + lane * 4;
    const float* xt = xtile(t % GV_STAGES) + mg * MR * GV_BK + kg * KR;
#pragma unroll
    for (int kk = 0; kk < KR; kk += 4) {
      float wf[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(wt + (kk + e) * GV_BN), wf[e]);
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        // One address per warp: a broadcast.
        const float4 xv = *reinterpret_cast<const float4*>(xt + r * GV_BK + kk);
        const float xf[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xf[e], wf[e][c], acc[r][c]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the pipeline buffers are free: reuse them for the sum

  // The KG warps of each row group add their sums in a fixed order.
  float* red = reinterpret_cast<float*>(smem);  // [MP][GV_BN]
#pragma unroll 1
  for (int g = 0; g < KG; ++g) {
    if (kg == g) {
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        float4* p = reinterpret_cast<float4*>(red + (mg * MR + r) * GV_BN + lane * 4);
        float4 v = g == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : *p;
        v.x += acc[r][0];
        v.y += acc[r][1];
        v.z += acc[r][2];
        v.w += acc[r][3];
        *p = v;
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < MP * GV_BN; i += kThreads) {
    const int m = m0 + i / GV_BN, n = n0 + i % GV_BN;
    if (m >= M || n >= N) continue;
    if (partial != nullptr)
      partial[((long long)blockIdx.y * M + m) * N + n] = red[i];
    else
      out[(long long)m * N + n] = red[i] * scale[n];
  }
}

// out = scale * sum over splits of partial, in split order (float32 x).
__global__ void __launch_bounds__(kThreads)
splitk_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
              float* __restrict__ out, int M, int N, int splits) {
  const long long total = (long long)M * N;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * total + i];
    out[i] = s * scale[i % N];
  }
}

cudaError_t reduce_launch(const float* partial, const float* scale, void* out, int M, int N,
                          int splits, cudaStream_t stream) {
  const long long blocks = ((long long)M * N + kThreads - 1) / kThreads;
  splitk_reduce<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      partial, scale, static_cast<float*>(out), M, N, splits);
  return cudaGetLastError();
}

template <int MR, int MG>
cudaError_t f32_launch(const void* x, const void* w, const float* scale, void* out,
                       float* partial, int M, int K, int N, int ldx, int splits,
                       int k_per_split, int mchunks, cudaStream_t stream) {
  const size_t smem = gv_smem_bytes(MR * MG);
  auto kernel = f32_kernel<MR, MG>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + GV_BN - 1) / GV_BN, splits, mchunks);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<float*>(out), splits > 1 ? partial : nullptr, M, K, N, ldx, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_launch(partial, scale, out, M, N, splits, stream);
}

#define F32_ARGS x, w, scale, out, partial, M, K, N, ldx, splits, k_per_split, mchunks, stream

// Rows per block from M: the fewest accumulators that cover it; past 64
// rows, chunks of 64 (one split).
cudaError_t f32_dispatch(const void* x, const void* w, const float* scale, void* out,
                         float* partial, int M, int K, int N, int ldx, int splits,
                         int k_per_split, int mchunks, cudaStream_t stream) {
  if (mchunks > 1 || M > 32) return f32_launch<16, 4>(F32_ARGS);
  if (M > 16) return f32_launch<16, 2>(F32_ARGS);
  if (M > 8) return f32_launch<16, 1>(F32_ARGS);
  if (M > 4) return f32_launch<8, 1>(F32_ARGS);
  if (M > 1) return f32_launch<4, 1>(F32_ARGS);
  return f32_launch<1, 1>(F32_ARGS);
}

// ---------------------------------------------------------------------------
// Pieces shared by the GEMM and the GEMV stream kernel
// ---------------------------------------------------------------------------

using frag::ldsm_x4;
using frag::mma_bf16;
using frag::pack_bf16x2;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// GEMM regime, bf16 x: wgmma fed by TMA, the int8 -> bf16 conversion of the
// next tile overlapping the products of this one
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128;          // rows per block: two consumer warpgroups of 64
constexpr int WG_BN = 256;          // columns per block: one wgmma m64n256k16 a warpgroup
constexpr int WG_BK = 64;           // k per stage: one 128-byte bf16 row of x
constexpr int WG_RAW = 4;           // TMA stages of (x tile, int8 weight tile)
constexpr int WG_CONV = 3;          // converted bf16 weight tiles (see wg_gemm_kernel)
constexpr int WG_PRODUCER = 256;    // warp 8: the producer
constexpr int WG_THREADS = WG_PRODUCER + 32;
constexpr int WG_GROUP_M = 16;      // row tiles a column sweep covers (L2 reuse)
constexpr int X_TILE = WG_BM * WG_BK * 2;   // 16 KB, 128B-swizzled by TMA
constexpr int W_TILE = WG_BK * WG_BN;       // 16 KB int8, row-major [k][n]
constexpr int B_TILE = WG_BK * WG_BN * 2;   // 32 KB bf16, MN-major 128B-swizzled
constexpr int RAW_STAGE = X_TILE + W_TILE;  // a multiple of 1024
constexpr int WG_SMEM = 1024 /* alignment slack */ + WG_RAW * RAW_STAGE + WG_CONV * B_TILE +
                        2 * WG_RAW * 8;
static_assert(WG_SMEM <= 232448, "over the H100's opt-in shared memory a block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed. A wait
// past ~2^34 cycles (several seconds) traps, so a broken pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1LL << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// A 2-D TMA copy of the box at (c0 innermost, c1) into shared memory; its
// bytes count against `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading and stride byte offsets (all in 16-byte units), layout B128.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return uint64_t((smem_u32(p) >> 4) & 0x3FFF) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// acc += A (64 x 16, K-major, descriptor da) * B (16 x 256, MN-major, db), f32;
// scale_d 0 overwrites acc instead.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pins each accumulator register in place around a wgmma batch, so the
// compiler inserts no move that would make ptxas serialize the batch.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Converts 16-byte chunk i of an int8 weight tile [WG_BK][WG_BN] (row-major)
// to bf16 in dst, laid out as wgmma reads an MN-major B operand with the 128B
// swizzle: atoms of 8 k rows x 64 columns (1 KB), 16-byte chunk c of row r
// stored at chunk c ^ r; the 8 atoms down k are 1 KB apart, the 4 across N
// WG_BK * 128 bytes apart.
__device__ __forceinline__ void convert_chunk(const int8_t* wt, unsigned char* dst, int i) {
  const int k = i / (WG_BN / 16), c = i % (WG_BN / 16);
  const uint4 rw = *reinterpret_cast<const uint4*>(wt + k * WG_BN + c * 16);
  const uint32_t words[4] = {rw.x, rw.y, rw.z, rw.w};
  uint32_t packed[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float f[4];
    i8x4_to_f32(words[e], f);
    packed[2 * e] = pack_bf16x2(f[0], f[1]);
    packed[2 * e + 1] = pack_bf16x2(f[2], f[3]);
  }
  // Columns 16c .. 16c+15: atom c / 4, chunks 2 (c % 4) and +1 of row k % 8.
  const int r = k % 8, cc = (c % 4) * 2;
  unsigned char* row = dst + (c / 4) * (WG_BK * 128) + (k / 8) * 1024 + r * 128;
  *reinterpret_cast<uint4*>(row + ((cc ^ r) * 16)) =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
  *reinterpret_cast<uint4*>(row + (((cc + 1) ^ r) * 16)) =
      make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

// Warps 0-7 (the consumers) only.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Block = one 128 x 256 output tile, on 9 warps in two roles that meet at no
// block-wide barrier after setup:
// - warp 8, one thread: the producer. It keeps WG_RAW stages of TMA copies
//   in flight, each the x tile [128 rows][64 k] bf16 (128B-swizzled, the
//   K-major layout wgmma reads) and the weight tile [64 k][256 n] int8 as
//   stored, against full/empty mbarriers.
// - warps 0-7, two warpgroups: the consumers. Each runs wgmma m64n256k16
//   over its 64 rows, four per stage, with one group kept in flight. While
//   tile t's products run, the two warpgroups convert tile t+1's int8
//   weights to bf16 (exact), half each, into buffer (t+1) % 3 laid out as
//   wgmma reads an MN-major B operand (the transpose bit set), and meet at a
//   barrier of their own before tile t+1's products. A warpgroup's
//   wgmma_wait<1> in step t only retires its own tile t-1, and the other
//   warpgroup's tile t-1 may still read buffer (t-1) % 3; tile t-2's
//   products were retired by both before the barrier that ended step t-1,
//   so buffer (t-2) % 3 = (t+1) % 3 is free. A tile's stage goes back to
//   the producer once this warpgroup's products of it are done (two
//   arrivals free it).
// TMA zero-fills rows, k and columns past M, K and N. The epilogue scales
// each column once, casts and stores, masking rows past M and columns past
// N. Registers: ~165 a consumer thread (128 accumulators; ptxas -v gives
// the count), under the 224 that 288 threads leave, so no setmaxnreg is
// needed. Shared memory: 230,464 bytes of the 232,448 a block may opt in to.
template <typename TO>
__global__ void __launch_bounds__(WG_THREADS, 1)
wg_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ scale, TO* __restrict__ out, int M, int K, int N) {
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_dyn) + 1023) & ~uintptr_t(1023));
  auto raw = [&](int s) { return smem + s * RAW_STAGE; };
  auto bbuf = [&](int j) { return smem + WG_RAW * RAW_STAGE + j * B_TILE; };
  uint64_t* full_raw = reinterpret_cast<uint64_t*>(smem + WG_RAW * RAW_STAGE + WG_CONV * B_TILE);
  uint64_t* empty_raw = full_raw + WG_RAW;

  // Grouped order: WG_GROUP_M row tiles walk the column tiles together, so
  // their x rows stay in L2 and each weight tile is fetched once a group.
  const int num_m = (M + WG_BM - 1) / WG_BM, num_n = (N + WG_BN - 1) / WG_BN;
  const int per_group = WG_GROUP_M * num_n;
  const int first_m = (blockIdx.x / per_group) * WG_GROUP_M;
  const int gm = min(num_m - first_m, WG_GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * WG_BM;
  const int n0 = (in_group / gm) * WG_BN;
  const int ktiles = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_RAW; ++s) {
      mbar_init(&full_raw[s], 1);
      mbar_init(&empty_raw[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= WG_PRODUCER) {
    if (threadIdx.x == WG_PRODUCER) {
      for (int u = 0; u < ktiles; ++u) {
        const int s = u % WG_RAW;
        if (u >= WG_RAW) mbar_wait(&empty_raw[s], (u / WG_RAW - 1) & 1);
        mbar_expect_tx(&full_raw[s], RAW_STAGE);
        tma_load_2d(raw(s), &xmap, &full_raw[s], u * WG_BK, m0);
        tma_load_2d(raw(s) + X_TILE, &wmap, &full_raw[s], n0, u * WG_BK);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, tid = threadIdx.x % 128;
  constexpr int HALF = WG_BK * (WG_BN / 16) / 2;  // 16-byte chunks a warpgroup converts
  auto convert_half = [&](int t) {
    const int8_t* wt = reinterpret_cast<const int8_t*>(raw(t % WG_RAW) + X_TILE);
#pragma unroll
    for (int u = 0; u < HALF / 128; ++u)
      convert_chunk(wt, bbuf(t % WG_CONV), wg * HALF + tid + u * 128);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  };

  float acc[WG_BN / 2];  // written first by tile 0's wgmma with scale-d 0
  mbar_wait(&full_raw[0], 0);
  convert_half(0);
  consumers_sync();
  for (int t = 0; t < ktiles; ++t) {
    const unsigned char* xa = raw(t % WG_RAW) + wg * 64 * 128;
    const unsigned char* bb = bbuf(t % WG_CONV);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks)
      wgmma_m64n256k16(acc, gmma_desc(xa + ks * 32, 16, 1024),
                       gmma_desc(bb + ks * 2048, WG_BK * 128, 1024), t > 0 || ks > 0);
    wgmma_commit();
    fence_acc(acc);
    if (t + 1 < ktiles) mbar_wait(&full_raw[(t + 1) % WG_RAW], ((t + 1) / WG_RAW) & 1);
    wgmma_wait<1>();  // this warpgroup's tile t-1 products are done: its stage is free
    if (t > 0 && tid == 0) mbar_arrive(&empty_raw[(t - 1) % WG_RAW]);
    if (t + 1 < ktiles) convert_half(t + 1);  // into tile t-2's buffer, free in both
    consumers_sync();  // both halves of tile t+1 are in place
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Accumulator d[4j + e]: row (warp % 4) * 16 + lane / 4 (+8 for e >= 2),
  // columns 8j + 2 (lane % 4) + (e % 2).
  const int row = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int jn = 0; jn < WG_BN / 8; ++jn) {
    const int col = n0 + jn * 8 + (lane % 4) * 2;
    if (col >= N) continue;  // N is even, so col + 1 < N too
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = row + 8 * h;
      if (rr < M)
        store2(out + (long long)rr * N + col, acc[4 * jn + 2 * h] * s0,
               acc[4 * jn + 2 * h + 1] * s1);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime, so
// the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D row-major map: `cols` contiguous elements a row, `rows` rows
// `ld_bytes` apart, copied in boxes of box_cols x box_rows; out-of-bounds
// elements read as zero.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
              uint64_t rows, uint64_t ld_bytes, uint32_t box_cols, uint32_t box_rows,
              CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
cudaError_t wg_gemm(const void* x, const void* w, const float* scale, void* out, int M, int K,
                    int N, int ldx, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)ldx * 2, WG_BK,
                WG_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, WG_BN, WG_BK,
                CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  auto kernel = wg_gemm_kernel<TO>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((M + WG_BM - 1) / WG_BM) * ((N + WG_BN - 1) / WG_BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, WG_THREADS, WG_SMEM, stream>>>(xmap, wmap, scale,
                                                             static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

bool shapes_ok(int xdtype, const void* x, const void* w, int M, int K, int N, int ldx) {
  const int xsize = xdtype == 0 ? 4 : 2;
  return M > 0 && K > 0 && N > 0 && N % 16 == 0 && ldx >= K && (ldx * xsize) % 16 == 0 &&
         attn::aligned16(x) && attn::aligned16(w);
}

// ---------------------------------------------------------------------------
// GEMV regime, bf16 x: gemv_stream_tc, a persistent weight-streaming kernel
// with its split-K reduce inside
// ---------------------------------------------------------------------------

constexpr int GS_BK = 64;         // k rows a ring stage
constexpr int GS_BOX = 128;       // columns a TMA box: 128 bytes, the swizzle's width
constexpr int GS_BOX_BYTES = GS_BK * GS_BOX;  // 8 KB
constexpr int GS_CONSUMERS = 8;   // consumer warps; warp 8 is the producer
constexpr int GS_THREADS = GS_CONSUMERS * 32 + 32;
constexpr int GS_MAX_GROUP = 3;   // weights one launch takes
// Ring stages of 256-column tiles: 4 (64 KB of weight in flight an SM)
// measured faster than 6, 8 or the 12 that fit on the main path's weights
// (tools/torch_k4_variants.py). 128-column tiles take twice as many.
constexpr int GS_STAGES = 4;

// The ring of one row-tile height BM and column-tile width BN: its stages,
// each the weight tile (BN / 128 TMA boxes [64][128], 128B-swizzled) and the
// x tile [BM][64] bf16 (128 bytes a row, its 16-byte chunks swizzled the
// same way); at BN = 128 the scratch where the two k halves of a tile meet;
// then the barriers.
template <int BM, int BN>
struct GsRing {
  static constexpr int W_STAGE = GS_BK * BN;
  static constexpr int X_STAGE = BM * GS_BK * 2;
  static constexpr int STAGE = W_STAGE + X_STAGE;  // a multiple of 1024
  static constexpr int STAGES = GS_STAGES * 256 / BN;
  static constexpr int SCRATCH = BN == 256 ? 0 : 128 * (BM / 16) * 16 * 4;
  static constexpr int TAIL = 256;  // full and empty barriers, the last-arrival flag
  static constexpr int SMEM = 1024 /* alignment slack */ + STAGES * STAGE + SCRATCH + TAIL;
  static_assert(BN == 128 || BN == 256, "column tiles of 128 or 256");
  static_assert(2 * STAGES * 8 + 4 <= TAIL, "the barriers fit the tail");
  static_assert(SMEM <= 232448, "over the H100's opt-in shared memory a block");
};

// A group of weights that share K and x, set up once per group
// (quant_matmul_stream_prepare) and copied into every launch's parameters.
// Column tiles are numbered across the group: weight i owns tiles
// [tile_base[i], tile_base[i + 1]).
struct GsGroup {
  CUtensorMap wmap[GS_MAX_GROUP];  // wq [K][N] int8, boxes of 128 columns x 64 k
  const float* scale[GS_MAX_GROUP];
  int N[GS_MAX_GROUP];
  int tile_base[GS_MAX_GROUP + 1];
  int col[GS_MAX_GROUP];  // first column of weight i's output in the [M, total] buffer
  int ngroups, K, KT, total, blocks, bn;  // bn: the column tiles' width, 128 or 256
};

struct GsArgs {
  GsGroup grp;
  const __nv_bfloat16* x;
  void* out[GS_MAX_GROUP];
  float* ws;      // [2 * blocks][M][bn] f32 partials: a block's first and last unit
  int* counters;  // [tiles] arrivals a column tile, 0 between launches
  int M, ldx, ldo, blocks, work;  // ldo: the outputs' row stride, in elements
};

// Block b streams tile steps [gs_start(b), gs_start(b + 1)) of the `work`
// steps (column tile t, k tile kt) = (i / KT, i % KT); gs_block(i) is the
// block that holds step i. ops/quant_matmul.py's gemv_units mirrors both.
__device__ __forceinline__ int gs_start(int b, int work, int blocks) {
  return (int)((long long)b * work / blocks);
}
__device__ __forceinline__ int gs_block(int i, int work, int blocks) {
  return (int)(((long long)(i + 1) * blocks + work - 1) / work) - 1;
}

__device__ __forceinline__ int gs_weight(const GsGroup& grp, int t) {
  int g = 0;
  while (g + 1 < grp.ngroups && t >= grp.tile_base[g + 1]) ++g;
  return g;
}

// The barrier's phase waits for all of this thread's earlier cp.async
// copies; the arrival counts against the barrier's expected count.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// (a & b) ^ c in one LOP3 (ptxas splits the C expression in two when both
// constants are immediates).
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Exact int8 -> float in one LOP3 and one FADD: byte 0 of a weight word,
// its sign bit flipped (q + 128), goes into the low mantissa of 2^23 and
// 2^23 + 128 is subtracted. Byte 1 (bits 8-15) lands the same way as 256 q,
// exact too: the tiles it feeds are scaled by 2^-8 after the sum (gs_row).
// Bytes 2 and 3 are bytes 0 and 1 of the word shifted down by 16.
__device__ __forceinline__ float i8_byte0(uint32_t w) {
  return __uint_as_float(and_xor(w, 0xFFu, 0x4B000080u)) - 8388736.f;
}
__device__ __forceinline__ float i8_byte1_x256(uint32_t w) {
  return __uint_as_float(and_xor(w, 0xFF00u, 0x4B008000u)) - 8421376.f;
}

// The bf16 pair (lo, hi) of two floats that hold integers of at most 7
// significant bits (times a power of two): such a float's top half is its
// bf16, exactly, and its low 16 bits are zero, so one shift-add packs them.
__device__ __forceinline__ uint32_t pack_top(float lo, float hi) {
  return __float_as_uint(hi) + (__float_as_uint(lo) >> 16);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// Row m * 16 + g + 8h of a consumer thread's accumulators, its 8 columns in
// order (see gemv_stream_tc: n8 tile c holds columns 4j + c; tiles 1 and 3
// summed 256 q).
template <int MT>
__device__ __forceinline__ void gs_row(const float (&acc)[MT][4][4], int m, int h,
                                       float (&v)[8]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float s = c % 2 ? 0.00390625f : 1.f;
    v[c] = acc[m][c][2 * h] * s;
    v[4 + c] = acc[m][c][2 * h + 1] * s;
  }
}

// The end of a unit: the consumers' sums over k steps [unit start, i] of
// column tile t. A tile one unit covers whole is scaled, cast and stored.
// Otherwise the unit's f32 partial goes to its workspace slot (2b for block
// b's first unit, 2b + 1 for its last), then the tile's arrival counter is
// raised; the block that arrives last sums the tile's partials in split
// order (the blocks that hold it, first to last), so the result does not
// depend on the order blocks run in, scales, casts, stores, and sets the
// counter back to 0 for the next launch.
// At BN = 128 only the warps of the first k half (warps 0-3, which hold the
// tile's sums) store and load; the others take part in the barriers.
template <typename TO, int MT, int BN>
__device__ __forceinline__ void gs_epilogue(const GsArgs& p, const float (&acc)[MT][4][4], int t,
                                            bool block_first_unit, int* last_flag) {
  const GsGroup& grp = p.grp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool owner = warp < BN / 32;
  const int g8 = lane / 4, col = 32 * (warp % (BN / 32)) + 8 * (lane % 4);  // 8 columns
  const int w = gs_weight(grp, t);
  const int N = grp.N[w], M = p.M;
  const int n0 = (t - grp.tile_base[w]) * BN;
  const int KT = grp.KT;
  const int first = gs_block(t * KT, p.work, p.blocks);
  const int last = gs_block(t * KT + KT - 1, p.work, p.blocks);
  TO* out = static_cast<TO*>(p.out[w]) + n0 + col;
  const bool live = owner && n0 + col < N;  // N is a multiple of 16: all 8 columns or none
  float sc[8];
  if (live) {
#pragma unroll
    for (int e = 0; e < 8; ++e) sc[e] = grp.scale[w][n0 + col + e];
  }
  if (first == last) {
    if (!live) return;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 16 + g8 + 8 * h;
        if (row >= M) continue;
        float v[8];
        gs_row(acc, m, h, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] *= sc[e];
        store8(out + (long long)row * p.ldo, v);
      }
    return;
  }
  const long long slot_floats = (long long)M * BN;
  float* mine = p.ws + (2LL * blockIdx.x + (block_first_unit ? 0 : 1)) * slot_floats + col;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m * 16 + g8 + 8 * h;
      if (row >= M || !owner) continue;
      float v[8];
      gs_row(acc, m, h, v);
      store8(mine + row * BN, v);
    }
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) *last_flag = atomicAdd(&p.counters[t], 1) == last - first;
  consumers_sync();
  if (!*last_flag) return;
  __threadfence();
  if (live) {
    float sum[MT][2][8];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 8; ++e) sum[m][h][e] = 0.f;
    // G splits' partials are loaded before any is added, so their loads are
    // in flight together; then they are added in split order. (More than 16
    // float4 a thread at 48 or 64 rows cost the main loop registers.)
    constexpr int G = MT == 1 ? 6 : MT == 2 ? 2 : 1;
    for (int b0 = first; b0 <= last; b0 += G) {
      float4 part[G][MT][2][2];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int b = b0 + j;
        if (b > last) break;
        // The tile's piece in block b is b's first unit, except in the block
        // it starts in when that block started on an earlier tile.
        const bool later = b == first && gs_start(b, p.work, p.blocks) != t * KT;
        const float* src = p.ws + (2LL * b + (later ? 1 : 0)) * slot_floats + col;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m * 16 + g8 + 8 * h;
            if (row >= M) continue;
            part[j][m][h][0] = __ldcg(reinterpret_cast<const float4*>(src + row * BN));
            part[j][m][h][1] = __ldcg(reinterpret_cast<const float4*>(src + row * BN + 4));
          }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (b0 + j > last) break;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (m * 16 + g8 + 8 * h >= M) continue;
            const float4 lo = part[j][m][h][0], hi = part[j][m][h][1];
            sum[m][h][0] += lo.x;
            sum[m][h][1] += lo.y;
            sum[m][h][2] += lo.z;
            sum[m][h][3] += lo.w;
            sum[m][h][4] += hi.x;
            sum[m][h][5] += hi.y;
            sum[m][h][6] += hi.z;
            sum[m][h][7] += hi.w;
          }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m * 16 + g8 + 8 * h;
        if (row >= M) continue;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = sum[m][h][e] * sc[e];
        store8(out + (long long)row * p.ldo, v);
      }
  }
  if (threadIdx.x == 0) p.counters[t] = 0;
}

// One block an SM walks its run of tile steps, on 9 warps in two roles that
// meet at no block-wide barrier after setup:
// - warp 8, the producer, keeps the ring full across unit boundaries: lane 0
//   arms the stage's full barrier with the weight's bytes and issues the
//   two TMA boxes; all 32 lanes copy the x tile with cp.async (zero-filled
//   past M and K) and arrive on the same barrier when their copies land.
// - warps 0-7, the consumers, each own 32 columns of the tile and all its k
//   rows, so a warp converts only the weight it multiplies, straight into
//   mma B fragments in registers. Thread (g, q) reads one 32-bit word (4
//   columns) of each of the k rows 2q, 2q+1, 2q+8, 2q+9 of a k16 step, the
//   rows mma.sync's B fragment gives it, and byte c of those words is its
//   b0/b1 of n8 tile c, whose columns are 4j + c (j = 0..7). x's A fragments
//   come from the x tile by ldmatrix in the natural k order. Tile c's C
//   fragment then holds columns 8q + c and 8q + 4 + c, so a thread's four
//   tiles hold 8 neighbouring columns of rows g and g + 8, stored as one
//   vector. A warp releases a stage to the producer when its reads are done
//   (eight arrivals free it); the tile before the next stays in flight.
// TMA zero-fills weight rows past K and columns past N; those columns are
// never stored.
template <typename TO, int BM, int BN>
__global__ void __launch_bounds__(GS_THREADS, 1) gemv_stream_tc(const __grid_constant__ GsArgs p) {
  using R = GsRing<BM, BN>;
  constexpr int S = R::STAGES;
  constexpr int MT = BM / 16;
  constexpr int CG = BN / 32;                             // warps across the tile's columns
  constexpr int KSTEPS = GS_BK / 16 * CG / GS_CONSUMERS;  // k16 steps a warp a stage
  extern __shared__ unsigned char smem_dyn[];
  // Offsetting the shared array (not rounding a generic address) keeps the
  // ring in the shared space, so its reads compile to LDS, not generic LD.
  unsigned char* ring = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  float* scratch = reinterpret_cast<float*>(ring + S * R::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * R::STAGE + R::SCRATCH);
  uint64_t* empty = full + S;
  int* last_flag = reinterpret_cast<int*>(empty + S);
  const GsGroup& grp = p.grp;
  const int KT = grp.KT;
  const int start = gs_start(blockIdx.x, p.work, p.blocks);
  const int end = gs_start(blockIdx.x + 1, p.work, p.blocks);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 33);  // lane 0's expect_tx and the 32 lanes' x copies
      mbar_init(&empty[s], GS_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == GS_CONSUMERS) {
    const int M = p.M, K = grp.K;
    if (lane == 0)
      for (int g = 0; g < grp.ngroups; ++g)
        asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&grp.wmap[g]))
                     : "memory");
    int st = 0, li = 0;
    uint32_t phase = 0;
    for (int i = start; i < end;) {
      const int t = i / KT;
      const int w = gs_weight(grp, t);
      const int n0 = (t - grp.tile_base[w]) * BN;
      // A second box when the tile has one and it is not all past N.
      const bool two = BN > GS_BOX && n0 + GS_BOX < grp.N[w];
      const int bytes = two ? 2 * GS_BOX_BYTES : GS_BOX_BYTES;
      const int unit_end = min(end, (t + 1) * KT);
      for (int k0 = (i - t * KT) * GS_BK; i < unit_end; ++i, ++li, k0 += GS_BK) {
        if (li >= S) mbar_wait(&empty[st], phase ^ 1);
        unsigned char* wd = ring + st * R::STAGE;
        if (lane == 0) {
          mbar_expect_tx(&full[st], bytes);
          tma_load_2d(wd, &grp.wmap[w], &full[st], n0, k0);
          if (two) tma_load_2d(wd + GS_BOX_BYTES, &grp.wmap[w], &full[st], n0 + GS_BOX, k0);
        }
        unsigned char* xd = wd + R::W_STAGE;
#pragma unroll
        for (int c = lane; c < BM * 8; c += 32) {
          const int r = c / 8, ch = c % 8;
          // A chunk that starts before K ends before it or runs into x's
          // zero padding (K is a multiple of 8).
          const bool ok = r < M && k0 + ch * 8 < K;
          cp_async16(xd + r * 128 + ((ch ^ (r & 7)) << 4),
                     ok ? p.x + (long long)r * p.ldx + k0 + ch * 8 : p.x, ok);
        }
        cp_async_mbar_arrive(&full[st]);
        if (++st == S) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int g8 = lane / 4, q = lane % 4;
  const int cw = warp % CG, kg = warp / CG;  // column group; k half at BN = 128
  const int wbox = (cw / 4) * GS_BOX_BYTES;
  const int chunk = (cw % 4) * 2 + g8 / 4;  // 16-byte chunk of a box row holding the word
  const int sw0 = ((chunk ^ (2 * q)) << 4) + (g8 % 4) * 4;      // rows 2q (mod 8)
  const int sw1 = ((chunk ^ (2 * q + 1)) << 4) + (g8 % 4) * 4;  // rows 2q + 1 (mod 8)
  const int xr = lane % 16, xc = lane / 16;  // this lane's ldmatrix row and k half

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;

  int st = 0;
  uint32_t phase = 0;
  for (int i = start; i < end;) {
    const int t = i / KT;
    for (const int unit_end = min(end, (t + 1) * KT); i < unit_end; ++i) {
      mbar_wait(&full[st], phase);
      const unsigned char* wt = ring + st * R::STAGE + wbox;
      const unsigned char* xs = ring + st * R::STAGE + R::W_STAGE;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int ks = kg * KSTEPS + kk;
        const unsigned char* wr = wt + (ks * 16 + 2 * q) * 128;
        uint32_t wl[4];  // k rows 2q, 2q + 1, 2q + 8, 2q + 9
        wl[0] = *reinterpret_cast<const uint32_t*>(wr + sw0);
        wl[1] = *reinterpret_cast<const uint32_t*>(wr + 128 + sw1);
        wl[2] = *reinterpret_cast<const uint32_t*>(wr + 8 * 128 + sw0);
        wl[3] = *reinterpret_cast<const uint32_t*>(wr + 9 * 128 + sw1);
        float f[4][4];  // [k row][byte]
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t hi = wl[r] >> 16;
          f[r][0] = i8_byte0(wl[r]);
          f[r][1] = i8_byte1_x256(wl[r]);
          f[r][2] = i8_byte0(hi);
          f[r][3] = i8_byte1_x256(hi);
        }
        uint32_t b[4][2];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b[c][0] = pack_top(f[0][c], f[1][c]);
          b[c][1] = pack_top(f[2][c], f[3][c]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t a[4];
          ldsm_x4(a, xs + (m * 16 + xr) * 128 + (((ks * 2 + xc) ^ (xr & 7)) << 4));
#pragma unroll
          for (int c = 0; c < 4; ++c) mma_bf16(acc[m][c], a, b[c][0], b[c][1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        phase ^= 1;
      }
    }
    if (CG < GS_CONSUMERS) {
      // The second k half adds its sums to the first's, in that order.
      float4* mine = reinterpret_cast<float4*>(scratch) + (cw * 32 + lane) * MT * 4;
      if (kg == 1) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            mine[m * 4 + c] = make_float4(acc[m][c][0], acc[m][c][1], acc[m][c][2], acc[m][c][3]);
      }
      consumers_sync();
      if (kg == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float4 o = mine[m * 4 + c];
            acc[m][c][0] += o.x;
            acc[m][c][1] += o.y;
            acc[m][c][2] += o.z;
            acc[m][c][3] += o.w;
          }
      }
      consumers_sync();  // the scratch is free for the next unit
    }
    gs_epilogue<TO, MT, BN>(p, acc, t, t * KT <= start, last_flag);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;
  }
}

template <typename TO, int BM, int BN>
cudaError_t gs_launch(const GsArgs& a, cudaStream_t stream) {
  using R = GsRing<BM, BN>;
  // Once per kernel and process (one card).
  auto kernel = gemv_stream_tc<TO, BM, BN>;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<a.blocks, GS_THREADS, R::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// Rows a block's tile from M: the fewest m16 tiles that cover it.
template <typename TO, int BN>
cudaError_t gs_rows(const GsArgs& a, cudaStream_t stream) {
  if (a.M > 48) return gs_launch<TO, 64, BN>(a, stream);
  if (a.M > 32) return gs_launch<TO, 48, BN>(a, stream);
  if (a.M > 16) return gs_launch<TO, 32, BN>(a, stream);
  return gs_launch<TO, 16, BN>(a, stream);
}

template <typename TO>
cudaError_t gs_dispatch(const GsArgs& a, cudaStream_t stream) {
  return a.grp.bn == 128 ? gs_rows<TO, 128>(a, stream) : gs_rows<TO, 256>(a, stream);
}

}  // namespace

// Shared contract of both entry points. xdtype / odtype: 0 = float32,
// 1 = bfloat16; the pairs (bf16, bf16), (bf16, f32) and (f32, f32). x [M, ldx]
// (the first K columns used), wq [K, N] int8, scale [N] f32, out [M, N], all
// contiguous; x and wq 16-byte aligned, ldx * sizeof(x) a multiple of 16 and
// N a multiple of 16 (cudaErrorInvalidValue otherwise). Each returns the CUDA
// error code of its launches.

// M <= 64, float32 x only (bf16 x takes quant_matmul_stream). `partial` is
// [splits, M, N] f32 scratch when splits > 1 (else unused); split s sums k in
// [s * k_per_split, (s + 1) * k_per_split), and k_per_split is a multiple of
// 64; splitk_reduce sums the splits in order.
extern "C" int quant_matmul_gemv(int xdtype, int odtype, const void* x, const void* wq,
                                 const void* scale, void* out, void* partial, int M, int K,
                                 int N, int ldx, int splits, int k_per_split, void* stream) {
  if (!shapes_ok(xdtype, x, wq, M, K, N, ldx) || M > 64 || splits < 1 ||
      k_per_split % 64 != 0 || (long long)splits * k_per_split < K ||
      (splits > 1 && partial == nullptr) || xdtype != 0 || odtype != 0)
    return (int)cudaErrorInvalidValue;
  return (int)f32_dispatch(x, wq, static_cast<const float*>(scale), out,
                           static_cast<float*>(partial), M, K, N, ldx, splits, k_per_split, 1,
                           static_cast<cudaStream_t>(stream));
}

// Bytes of the group record quant_matmul_stream_prepare fills.
extern "C" int quant_matmul_stream_group_bytes() { return (int)sizeof(GsGroup); }

// Fills `group` (quant_matmul_stream_group_bytes() bytes, any alignment) for
// ngroups (1-3) int8 weights wq_i [K, N_i] with f32 scales [N_i], computed
// in column tiles of bn (128 or 256) by `blocks` persistent blocks
// (gemv_plan in ops/quant_matmul.py): each
// weight's TMA map is encoded here, once. Unused pointers may be null. Each
// wq_i 16-byte aligned and each N_i a multiple of 16. The outputs are the
// column ranges of one [M, N_0 + N_1 + N_2] buffer, in order.
extern "C" int quant_matmul_stream_prepare(int ngroups, int K, const void* w0, const void* w1,
                                           const void* w2, const void* s0, const void* s1,
                                           const void* s2, int N0, int N1, int N2, int bn,
                                           int blocks, void* group) {
  const void* w[GS_MAX_GROUP] = {w0, w1, w2};
  const void* sc[GS_MAX_GROUP] = {s0, s1, s2};
  const int N[GS_MAX_GROUP] = {N0, N1, N2};
  if (ngroups < 1 || ngroups > GS_MAX_GROUP || K <= 0 || group == nullptr ||
      (bn != 128 && bn != 256))
    return (int)cudaErrorInvalidValue;
  GsGroup g;
  memset(&g, 0, sizeof(g));
  g.ngroups = ngroups;
  g.K = K;
  g.KT = (K + GS_BK - 1) / GS_BK;
  g.blocks = blocks;
  g.bn = bn;
  int tiles = 0;
  for (int i = 0; i < ngroups; ++i) {
    if (N[i] <= 0 || N[i] % 16 != 0 || !attn::aligned16(w[i]) || sc[i] == nullptr ||
        !make_map(&g.wmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, w[i], N[i], K, N[i], GS_BOX,
                  GS_BK, CU_TENSOR_MAP_SWIZZLE_128B))
      return (int)cudaErrorInvalidValue;
    g.scale[i] = static_cast<const float*>(sc[i]);
    g.N[i] = N[i];
    g.tile_base[i] = tiles;
    g.col[i] = g.total;
    tiles += (N[i] + bn - 1) / bn;
    g.total += N[i];
  }
  g.tile_base[ngroups] = tiles;
  memcpy(group, &g, sizeof(g));
  return 0;
}

// bf16 x [M, ldx] (M <= 64, the first K columns used, 16-byte aligned, ldx a
// multiple of 8) times each weight of `group`, into out [M, total] (odtype 1
// = bf16, 0 = f32; 16-byte aligned, contiguous): one launch of the group's
// persistent blocks (at most its column tiles x k tiles). ws holds 2 *
// blocks * M * bn floats; counters one int a column tile, all 0, and left
// 0.
extern "C" int quant_matmul_stream(int odtype, const void* group, const void* x, int M, int ldx,
                                   void* out, void* ws, void* counters, void* stream) {
  GsArgs a;
  memcpy(&a.grp, group, sizeof(GsGroup));
  const int work = a.grp.tile_base[a.grp.ngroups] * a.grp.KT;
  if (M < 1 || M > 64 || ldx < a.grp.K || ldx % 8 != 0 || !attn::aligned16(x) ||
      !attn::aligned16(out) || ws == nullptr || counters == nullptr || a.grp.blocks < 1 ||
      a.grp.blocks > work || (odtype != 0 && odtype != 1))
    return (int)cudaErrorInvalidValue;
  const int item = odtype == 1 ? 2 : 4;
  for (int i = 0; i < GS_MAX_GROUP; ++i)
    a.out[i] = static_cast<char*>(out) + (long long)a.grp.col[i] * item;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.ldx = ldx;
  a.ldo = a.grp.total;
  a.blocks = a.grp.blocks;
  a.work = work;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(odtype == 1 ? gs_dispatch<__nv_bfloat16>(a, st) : gs_dispatch<float>(a, st));
}

// Any M. bf16 x: wgmma fed by TMA (wg_gemm_kernel); f32 x: CUDA-core FMAs over
// chunks of 64 rows.
extern "C" int quant_matmul_gemm(int xdtype, int odtype, const void* x, const void* wq,
                                 const void* scale, void* out, int M, int K, int N, int ldx,
                                 void* stream) {
  if (!shapes_ok(xdtype, x, wq, M, K, N, ldx)) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kps = (K + GV_BK - 1) / GV_BK * GV_BK;
  const int mchunks = (M + 63) / 64;
  cudaError_t err;
  if (xdtype == 1 && odtype == 1)
    err = wg_gemm<__nv_bfloat16>(x, wq, s, out, M, K, N, ldx, st);
  else if (xdtype == 1 && odtype == 0)
    err = wg_gemm<float>(x, wq, s, out, M, K, N, ldx, st);
  else if (xdtype == 0 && odtype == 0)
    err = mchunks > 65535 ? cudaErrorInvalidValue
                          : f32_dispatch(x, wq, s, out, nullptr, M, K, N, ldx, 1, kps, mchunks,
                                         st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
