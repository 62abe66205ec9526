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
// float32 x runs the same schedule as gemv_stream_tf32 (below).
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
// float32 x (float32 models) in either regime: two TF32 passes on the
// tensor cores, whose result is float32's. An int8 weight is exact in TF32
// (10 mantissa bits; |q| <= 127 needs 7), so x @ wq = x_hi @ wq + x_lo @ wq
// with x_hi = tf32(x) and x_lo = tf32(x - x_hi) (round to nearest, ties
// away: cvt.rna). x - x_hi is exact in float32, each TF32 x int8 product is
// exact in float32, and the one rounding left is x_lo's, at most 2^-22 |x|:
// float32's own level. It is "3xTF32" whose third term is zero, since the
// weight has no low part; the weight itself is never rounded. Two passes
// at 495 TFLOP/s dense TF32 reach ~247 TFLOP/s of float32-accurate work,
// against 67 on the f32 FMAs. It is not the card's best: an int8 weight is
// exact in bf16 too, and x in three bf16 parts keeps float32's bits, so
// three bf16 passes at 989 TFLOP/s would reach ~330 (the bound the rows are
// held to).
// - GEMV (M <= 64): gemv_stream_tf32, gemv_stream_tc's persistent stream
//   with mma.sync m16n8k8 .tf32 products and the roles swapped (the weight
//   as A, straight from the swizzled int8 tile by the register route; x as
//   B, split into x_hi and x_lo in registers, two products each), so at
//   M <= 8 a product is padded to 8 rows, not 16. Grouped calls (q/k/v,
//   gate/up) are one launch, the split-K reduce inside.
// - GEMM (M > 64): tf32_gemm_kernel computes out^T = wq^T x^T on wgmma
//   m64n64k8 .tf32. TF32 wgmma reads shared-memory operands K-major only
//   (32-bit types have no transpose bit); x [M, K] is K-major, wq [K, N]
//   is not. So the weight is the register-sourced A operand, converted
//   straight from the int8 tile, and x is the B operand in shared memory,
//   as TMA stored it: consumer warps overwrite each x tile with x_hi in
//   place and write x_lo beside it, while the previous tile's products
//   run. No converted weight is written to shared memory. The tensor
//   cores' own accumulation keeps fewer bits than float32 over long sums,
//   so each 32-k tile's products are added into float32 sums on the CUDA
//   cores. Output tiles too few to fill 132 SMs (k/v, short prefills)
//   split K across blocks, the last to arrive summing the partials in
//   split order.
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

using frag::i8x4_to_f32;  // exact int8 -> float (mma_fragments.cuh)

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

// x rounded to TF32 (to nearest, ties away from zero): a float whose low 13
// mantissa bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The two TF32 operands of float32 x: hi = tf32(x) and lo = tf32(x - hi).
// x - hi is exact in float32; lo drops at most 2^-22 |x| of it.
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a * b on one m16n8k8 TF32 tile, f32 accumulation (g = lane / 4,
// q = lane % 4): A 16x8 a0 (row g, k q), a1 (row g+8, k q), a2 (row g,
// k q+4), a3 (row g+8, k q+4); B 8x8 b0 (k q, col g), b1 (k q+4, col g);
// C as m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
// GEMV regime: gemv_stream_tc (bf16 x) and gemv_stream_tf32 (float32 x), a
// persistent weight-streaming kernel with its split-K reduce inside
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

// The ring of one row-tile height BM, column-tile width BN and x element
// size XB (2: bf16, 4: f32): its stages, each the weight tile (BN / 128 TMA
// boxes [64][128], 128B-swizzled) and the x tile [BM][64] (X_ROW bytes a
// row, its 16-byte chunks swizzled as gs_xchunk says); at BN = 128 the
// scratch where the two k halves of a tile meet; then the barriers.
template <int BM, int BN, int XB>
struct GsRing {
  static constexpr int W_STAGE = GS_BK * BN;
  static constexpr int X_ROW = GS_BK * XB;
  static constexpr int X_STAGE = BM * X_ROW;
  static constexpr int STAGE = W_STAGE + X_STAGE;  // a multiple of 1024
  static constexpr int STAGES = GS_STAGES * 256 / BN;
  static constexpr int SCRATCH = BN == 256 ? 0 : 128 * ((BM + 15) / 16) * 16 * 4;
  static constexpr int TAIL = 256;  // full and empty barriers, the last-arrival flag
  static constexpr int SMEM = 1024 /* alignment slack */ + STAGES * STAGE + SCRATCH + TAIL;
  static_assert(BN == 128 || BN == 256, "column tiles of 128 or 256");
  static_assert(BM % 16 == 0 || (BM == 8 && XB == 4), "m16 row tiles (float32 x: also 8 rows)");
  static_assert(2 * STAGES * 8 + 4 <= TAIL, "the barriers fit the tail");
  static_assert(SMEM <= 232448, "over the H100's opt-in shared memory a block");
};

// Where 16-byte chunk ch of x row r lies in its stage, in chunks. bf16 rows
// (8 chunks) take the 128B swizzle, so ldmatrix's eight rows hit eight
// bank groups. f32 rows (16 chunks) XOR the chunk with 2r mod 8: the TF32
// route's 8-byte A loads (rows g, k 2q and 2q+1 of a k8 step) then hit
// distinct banks in each half-warp.
template <int XB>
__device__ __forceinline__ int gs_xchunk(int ch, int r) {
  return XB == 2 ? ch ^ (r & 7) : ch ^ ((2 * r) & 7);
}

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
  const void* x;  // bf16 or f32
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

// gemv_stream_tf32's sums into gemv_stream_tc's layout, which the k-half
// merge and gs_epilogue read. The float32 route multiplies with the roles
// swapped (weight columns as mma's 16 rows, x rows as its 8 columns), so
// tile (j, p) of thread (g, q) holds columns 4g + 2p (c0, c1) and 4g + 2p +
// 1 (c2, c3) of x rows 8j + 2q and 8j + 2q + 1. acc[m][c][2h + s] is row
// 16m + 8h + g, column 8q + 4s + c: the thread (2q + s, g / 2) holds it, in
// tile (2m + h, c / 2), element 2 (c % 2) + g % 2. Rows past NT's tiles are 0.
template <int MT, int NT>
__device__ __forceinline__ void gs_unswap(const float (&sw)[NT][2][4], float (&acc)[MT][4][4]) {
  const int lane = threadIdx.x % 32, g8 = lane / 4, q = lane % 4;
  const int src = 8 * q + g8 / 2;  // lane (2q, g / 2); lane (2q + 1, g / 2) is src + 4
  const bool odd = g8 & 1;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * m + h;
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (j >= NT) {
            acc[m][c][2 * h + s] = 0.f;
            continue;
          }
          const float e0 = __shfl_sync(0xffffffffu, sw[j][c / 2][2 * (c % 2)], src + 4 * s);
          const float e1 = __shfl_sync(0xffffffffu, sw[j][c / 2][2 * (c % 2) + 1], src + 4 * s);
          acc[m][c][2 * h + s] = odd ? e1 : e0;
        }
    }
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
// - float32 x (XB = 4, gemv_stream_tf32): the k8 steps of m16n8k8 .tf32
//   with the roles swapped, out^T = wq^T x^T: the weight is the A operand
//   (16 columns as mma's rows) and x the B operand (8 x rows as its
//   columns), so a product is padding only past M in 8-row, not 16-row,
//   tiles: at M <= 8 half the products of x as A. Each k8 step runs in the
//   order (k 0, 2, 4, 6, 1, 3, 5, 7): logical k q is the step's row 2q and
//   q + 4 its row 2q + 1, so a thread reads the words of rows 2q and 2q + 1
//   (the bf16 route's banks); bytes 2p and 2p + 1 of a word are A rows g
//   and g + 8 of tile p (columns 4g + 2p and 4g + 2p + 1), and x's floats
//   2q and 2q + 1 of row 8j + g, one 8-byte load, are tile j's b0 and b1.
//   Each B value is split into x_hi and x_lo in registers and both multiply
//   the same A fragments, into one stage's sums, which are then added into
//   the float32 sums (the tensor cores' own adds keep fewer bits,
//   tf32_gemm_kernel says more). gs_unswap puts a unit's sums back into the
//   bf16 route's layout for the merge and the epilogue.
// TMA zero-fills weight rows past K and columns past N; those columns are
// never stored.
template <typename TO, int XB, int BM, int BN>
__device__ __forceinline__ void gemv_stream_body(const GsArgs& p) {
  using R = GsRing<BM, BN, XB>;
  constexpr int S = R::STAGES;
  constexpr int MT = (BM + 15) / 16;  // m16 tiles of rows (the epilogue's layout)
  constexpr int NT = BM / 8;          // n8 tiles of rows (float32 x)
  constexpr int CG = BN / 32;  // warps across the tile's columns
  // k steps (k16 for bf16, k8 for f32) a warp a stage
  constexpr int KSTEPS = GS_BK / (XB == 2 ? 16 : 8) * CG / GS_CONSUMERS;
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
    constexpr int XCH = R::X_ROW / 16;  // 16-byte chunks of an x row a stage
    constexpr int XE = 16 / XB;         // x elements a chunk
    const int M = p.M, K = grp.K;
    const unsigned char* xg = static_cast<const unsigned char*>(p.x);
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
        for (int c = lane; c < BM * XCH; c += 32) {
          const int r = c / XCH, ch = c % XCH;
          // A chunk that starts before K ends before it or runs into x's
          // zero padding (the wrapper pads rows to 16 bytes).
          const bool ok = r < M && k0 + ch * XE < K;
          cp_async16(xd + r * R::X_ROW + (gs_xchunk<XB>(ch, r) << 4),
                     ok ? xg + ((long long)r * p.ldx + k0 + ch * XE) * XB : xg, ok);
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

  // bf16 x sums into acc; float32 x into sw, which gs_unswap copies into
  // acc at a unit's end.
  float acc[MT][4][4];
  float sw[XB == 4 ? NT : 1][2][4];
  if constexpr (XB == 2) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < (XB == 4 ? NT : 1); ++j)
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) sw[j][p][e] = 0.f;

  int st = 0;
  uint32_t phase = 0;
  for (int i = start; i < end;) {
    const int t = i / KT;
    for (const int unit_end = min(end, (t + 1) * KT); i < unit_end; ++i) {
      mbar_wait(&full[st], phase);
      const unsigned char* wt = ring + st * R::STAGE + wbox;
      const unsigned char* xs = ring + st * R::STAGE + R::W_STAGE;
      if constexpr (XB == 2) {
        const int xr = lane % 16, xc = lane / 16;  // this lane's ldmatrix row and k half
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
      } else {
        // x row g's chunk holding floats 2q and 2q + 1 of k8 step ks, as
        // gs_xchunk<4> stored it (rows 8j + g share the swizzle)
        const int xsw = (2 * g8) & 7;
        // The stage's products go to sums of their own, added into the
        // float32 sums after it (tf32_gemm_kernel says why): the tensor
        // cores' chains are 64 k long, whatever K.
        float part[NT][2][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][p][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const int ks = kg * KSTEPS + kk;
          const unsigned char* wr = wt + (ks * 8 + 2 * q) * 128;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + sw0);        // row 2q
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + 128 + sw1);  // 2q + 1
          const uint32_t h0 = w0 >> 16, h1 = w1 >> 16;
          // Tile p's A: bytes 2p (rows g) and 2p + 1 (rows g + 8, as 256 q)
          // of the words of k rows 2q (a0, a1) and 2q + 1 (a2, a3): exact
          // integers, so exact in TF32.
          uint32_t a[2][4];
          a[0][0] = __float_as_uint(i8_byte0(w0));
          a[0][1] = __float_as_uint(i8_byte1_x256(w0));
          a[0][2] = __float_as_uint(i8_byte0(w1));
          a[0][3] = __float_as_uint(i8_byte1_x256(w1));
          a[1][0] = __float_as_uint(i8_byte0(h0));
          a[1][1] = __float_as_uint(i8_byte1_x256(h0));
          a[1][2] = __float_as_uint(i8_byte0(h1));
          a[1][3] = __float_as_uint(i8_byte1_x256(h1));
          const int xo = (((2 * ks + (q >> 1)) ^ xsw) << 4) + (q & 1) * 8;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const float2 v = *reinterpret_cast<const float2*>(xs + (8 * j + g8) * R::X_ROW + xo);
            uint32_t hi0, lo0, hi1, lo1;
            tf32_split(v.x, hi0, lo0);
            tf32_split(v.y, hi1, lo1);
            // No product waits on the one just issued (1% faster at M = 16 on
            // the H100).
            mma_tf32(part[j][0], a[0], hi0, hi1);
            mma_tf32(part[j][1], a[1], hi0, hi1);
            mma_tf32(part[j][0], a[0], lo0, lo1);
            mma_tf32(part[j][1], a[1], lo0, lo1);
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) sw[j][p][e] += part[j][p][e];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == S) {
        st = 0;
        phase ^= 1;
      }
    }
    if constexpr (XB == 4) {
      gs_unswap<MT, NT>(sw, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int e = 0; e < 4; ++e) sw[j][p][e] = 0.f;
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
    if constexpr (XB == 2) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][c][e] = 0.f;
    }
  }
}

// bf16 x.
template <typename TO, int BM, int BN>
__global__ void __launch_bounds__(GS_THREADS, 1) gemv_stream_tc(const __grid_constant__ GsArgs p) {
  gemv_stream_body<TO, 2, BM, BN>(p);
}

// float32 x (float32 out): two TF32 passes.
template <int BM, int BN>
__global__ void __launch_bounds__(GS_THREADS, 1)
    gemv_stream_tf32(const __grid_constant__ GsArgs p) {
  gemv_stream_body<float, 4, BM, BN>(p);
}

template <typename TO, int XB, int BM, int BN>
cudaError_t gs_launch(const GsArgs& a, cudaStream_t stream) {
  using R = GsRing<BM, BN, XB>;
  void (*kernel)(GsArgs);
  if constexpr (XB == 2)
    kernel = gemv_stream_tc<TO, BM, BN>;
  else
    kernel = gemv_stream_tf32<BM, BN>;
  // Once per kernel and process (one card).
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (attr != cudaSuccess) return attr;
  kernel<<<a.blocks, GS_THREADS, R::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// Rows a block's tile from M: the fewest m16 tiles that cover it (float32
// x: 8 rows at M <= 8).
template <typename TO, int XB, int BN>
cudaError_t gs_rows(const GsArgs& a, cudaStream_t stream) {
  if (a.M > 48) return gs_launch<TO, XB, 64, BN>(a, stream);
  if (a.M > 32) return gs_launch<TO, XB, 48, BN>(a, stream);
  if (a.M > 16) return gs_launch<TO, XB, 32, BN>(a, stream);
  if constexpr (XB == 4)  // x rows are mma's n8 columns on the float32 route
    if (a.M <= 8) return gs_launch<TO, XB, 8, BN>(a, stream);
  return gs_launch<TO, XB, 16, BN>(a, stream);
}

template <typename TO, int XB>
cudaError_t gs_dispatch(const GsArgs& a, cudaStream_t stream) {
  return a.grp.bn == 128 ? gs_rows<TO, XB, 128>(a, stream) : gs_rows<TO, XB, 256>(a, stream);
}

// ---------------------------------------------------------------------------
// GEMM regime, float32 x: out^T = wq^T x^T on TF32 wgmma, two passes
// ---------------------------------------------------------------------------

constexpr int TG_BM = 64;   // x rows a block: the wgmma's N
constexpr int TG_BN = 256;  // weight columns a block: 128 a consumer warpgroup
constexpr int TG_BK = 32;   // k a stage: one 128-byte float32 row of x
constexpr int TG_STAGES = 8;
constexpr int TG_LO = 2;                  // x_lo tiles (see tf32_gemm_kernel)
constexpr int TG_X = TG_BM * TG_BK * 4;   // 8 KB, 128B-swizzled by TMA
constexpr int TG_WBOX = TG_BK * 128;      // 4 KB: a box [32 k][128 n] int8, 128B-swizzled
constexpr int TG_STAGE = TG_X + 2 * TG_WBOX;  // a multiple of 1024
constexpr int TG_SMEM = 1024 /* alignment slack */ + TG_STAGES * TG_STAGE + TG_LO * TG_X + 256;
constexpr int TG_THREADS = 384;  // two consumer warpgroups, then the producer's
constexpr int TG_MAX_SPLITS = 8;
static_assert(TG_SMEM <= 232448, "over the H100's opt-in shared memory a block");
static_assert(2 * TG_STAGES * 8 + 4 <= 256, "the barriers fit the tail");

// d (+)= A (64 x 8 TF32, in registers: a0 (row g, k q), a1 (row g+8, k q),
// a2 (row g, k q+4), a3 (row g+8, k q+4) of the warp's 16 rows) * B (8 x
// 64, K-major, descriptor db), f32; scale_d 0 overwrites d instead.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Block = one 64 (x rows) x 256 (weight columns) output tile over its
// split's k tiles, on three warpgroups in two roles that meet at no
// block-wide barrier after setup:
// - warpgroup 2, one thread: the producer. It keeps TG_STAGES stages of TMA
//   copies in flight, each the x tile [64 rows][32 k] f32 (128B-swizzled,
//   the K-major layout wgmma reads as B) and the weight tile [32 k][256 n]
//   int8 as two 128-column boxes (128B-swizzled), against full/empty
//   mbarriers. It gives its registers up (setmaxnreg) to the consumers.
// - warpgroups 0-1: the consumers. Warpgroup wg owns weight columns
//   128 wg .. 128 wg + 127 as the A rows of two m64 blocks; thread (g, q)
//   of warp w reads one 32-bit word (4 columns, 128 wg + 32 w + 4g) of each
//   of the k rows 2q and 2q + 1 of a k8 step, and bytes 0 and 1 are block
//   0's A rows 16w + g and 16w + g + 8, bytes 2 and 3 block 1's (the
//   register route of gemv_stream_tc: bytes 1 and 3 come as 256 q, scaled
//   back in the epilogue). Each k8 step is taken in the order (k 0, 2, 4,
//   6, 1, 3, 5, 7), so logical k q is row 2q and q + 4 row 2q + 1: the words
//   of a warp's lanes then fall in distinct banks. Per k8 step a
//   warpgroup issues four wgmma m64n64k8: each block times x_hi, then times
//   x_lo. While tile t's products run the two warpgroups split tile t+1,
//   half each: each k8 group of a row is read from the x tile, put in the
//   step's order, and written back as x_hi in place and as x_lo into
//   buffer (t+1) % 2. Every warpgroup has waited for its tile t-1 products
//   before the barrier that ended step t-1, so that buffer is free; the
//   barrier after the split makes both halves visible to wgmma (behind
//   fence.proxy.async). A stage goes back to the producer once both
//   warpgroups' products of it are done.
// The tensor cores add each k8 step's products into their accumulators
// with fewer bits than float32 rounding keeps (over K = 14,336 the sums
// drifted by ~3e-4 of the value, on an H100). So a tile's products go to
// accumulators of their own (the first wgmma of the tile overwrites them)
// and are added into float32 sums on the CUDA cores once the tile is done:
// the tensor cores' chains are 32 k long, whatever K.
// TMA zero-fills rows past M, k past K and columns past N; the epilogue
// scales each column once and stores 4 neighbouring columns of an x row as
// one vector, masking rows past M and columns past N. With splits, each
// block writes its partial tile to the workspace and the block that
// arrives last sums the tile's partials in split order, scales and stores,
// and sets the tile's counter back to 0.
__global__ void __launch_bounds__(TG_THREADS, 1)
tf32_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ ws,
                 int* __restrict__ counters, int M, int K, int N, int k_per_split) {
  extern __shared__ unsigned char smem_dyn[];
  unsigned char* smem = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  auto stage = [&](int s) { return smem + s * TG_STAGE; };
  auto lobuf = [&](int j) { return smem + TG_STAGES * TG_STAGE + j * TG_X; };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + TG_STAGES * TG_STAGE + TG_LO * TG_X);
  uint64_t* empty = full + TG_STAGES;
  int* last_flag = reinterpret_cast<int*>(empty + TG_STAGES);

  // Grouped order, as wg_gemm_kernel's: WG_GROUP_M row tiles walk the
  // column tiles together.
  const int num_m = (M + TG_BM - 1) / TG_BM, num_n = (N + TG_BN - 1) / TG_BN;
  const int per_group = WG_GROUP_M * num_n;
  const int first_m = (blockIdx.x / per_group) * WG_GROUP_M;
  const int gm = min(num_m - first_m, WG_GROUP_M);
  const int in_group = blockIdx.x % per_group;
  const int m0 = (first_m + in_group % gm) * TG_BM;
  const int n0 = (in_group / gm) * TG_BN;
  const int kt0 = blockIdx.y * (k_per_split / TG_BK);
  const int ktiles = min((K + TG_BK - 1) / TG_BK - kt0, k_per_split / TG_BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      // The second weight box when it is not all past N (its columns are
      // then never stored, whatever the stage holds).
      const bool two = n0 + 128 < N;
      const uint32_t bytes = TG_X + (two ? 2 : 1) * TG_WBOX;
      for (int u = 0; u < ktiles; ++u) {
        const int s = u % TG_STAGES;
        if (u >= TG_STAGES) mbar_wait(&empty[s], (u / TG_STAGES - 1) & 1);
        const int k0 = (kt0 + u) * TG_BK;
        mbar_expect_tx(&full[s], bytes);
        tma_load_2d(stage(s), &xmap, &full[s], k0, m0);
        tma_load_2d(stage(s) + TG_X, &wmap, &full[s], n0, k0);
        if (two) tma_load_2d(stage(s) + TG_X + TG_WBOX, &wmap, &full[s], n0 + 128, k0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, w4 = warp % 4, tid = threadIdx.x % 128;
  const int g = lane / 4, q = lane % 4;
  const int chunk = 2 * w4 + g / 4;  // 16-byte chunk of a box row holding the word
  const int sw0 = ((chunk ^ (2 * q)) << 4) + (g % 4) * 4;      // k rows 2q (mod 8)
  const int sw1 = ((chunk ^ (2 * q + 1)) << 4) + (g % 4) * 4;  // k rows 2q + 1 (mod 8)

  // x_hi in place and x_lo into its buffer, for this warpgroup's 32 rows
  // of tile t. Row r's k8 group j is the 16-byte chunks 2j and 2j + 1, at
  // chunks 2j ^ (r % 8) and (2j + 1) ^ (r % 8) (TMA's 128B swizzle); it is
  // written back as (k 0, 2, 4, 6) and (1, 3, 5, 7) of the group.
  auto split = [&](int t) {
    unsigned char* xt = stage(t % TG_STAGES);
    unsigned char* lo = lobuf(t % TG_LO);
    const int i = wg * 128 + tid;
    const int r = i / 4, j = i % 4;
    const int o0 = r * 128 + (((2 * j) ^ (r & 7)) << 4);
    const int o1 = r * 128 + (((2 * j + 1) ^ (r & 7)) << 4);
    const float4 a = *reinterpret_cast<const float4*>(xt + o0);  // k 8j .. 8j + 3
    const float4 b = *reinterpret_cast<const float4*>(xt + o1);  // k 8j + 4 .. 8j + 7
    const float v[8] = {a.x, a.z, b.x, b.z, a.y, a.w, b.y, b.w};
    uint32_t hi[8], lw[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tf32_split(v[e], hi[e], lw[e]);
    *reinterpret_cast<uint4*>(xt + o0) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xt + o1) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    *reinterpret_cast<uint4*>(lo + o0) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
    *reinterpret_cast<uint4*>(lo + o1) = make_uint4(lw[4], lw[5], lw[6], lw[7]);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
  };

  float acc[2][32];  // float32 sums of the tiles so far
  float tc[2][32];   // the tensor cores' sums of one tile
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[b][e] = tc[b][e] = 0.f;

  mbar_wait(&full[0], 0);
  split(0);
  consumers_sync();
  for (int t = 0; t < ktiles; ++t) {
    const int s = t % TG_STAGES;
    const unsigned char* xt = stage(s);
    const unsigned char* lo = lobuf(t % TG_LO);
    const unsigned char* wt = stage(s) + TG_X + wg * TG_WBOX;
    uint32_t a[TG_BK / 8][2][4];  // live until the products of the tile are done
#pragma unroll
    for (int ks = 0; ks < TG_BK / 8; ++ks) {
      const unsigned char* wr = wt + (ks * 8 + 2 * q) * 128;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wr + sw0);        // row 2q
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wr + 128 + sw1);  // row 2q + 1
      const uint32_t h0 = w0 >> 16, h1 = w1 >> 16;
      a[ks][0][0] = __float_as_uint(i8_byte0(w0));
      a[ks][0][1] = __float_as_uint(i8_byte1_x256(w0));
      a[ks][0][2] = __float_as_uint(i8_byte0(w1));
      a[ks][0][3] = __float_as_uint(i8_byte1_x256(w1));
      a[ks][1][0] = __float_as_uint(i8_byte0(h0));
      a[ks][1][1] = __float_as_uint(i8_byte1_x256(h0));
      a[ks][1][2] = __float_as_uint(i8_byte0(h1));
      a[ks][1][3] = __float_as_uint(i8_byte1_x256(h1));
    }
    fence_acc(tc[0]);
    fence_acc(tc[1]);
    wgmma_fence();  // the A fragments and accumulators are written
#pragma unroll
    for (int ks = 0; ks < TG_BK / 8; ++ks) {
      const uint64_t dh = gmma_desc(xt + ks * 32, 16, 1024);
      const uint64_t dl = gmma_desc(lo + ks * 32, 16, 1024);
      wgmma_m64n64k8_tf32(tc[0], a[ks][0], dh, ks > 0);
      wgmma_m64n64k8_tf32(tc[1], a[ks][1], dh, ks > 0);
      wgmma_m64n64k8_tf32(tc[0], a[ks][0], dl, 1);
      wgmma_m64n64k8_tf32(tc[1], a[ks][1], dl, 1);
    }
    wgmma_commit();
    fence_acc(tc[0]);
    fence_acc(tc[1]);
    if (t + 1 < ktiles) {
      mbar_wait(&full[(t + 1) % TG_STAGES], ((t + 1) / TG_STAGES) & 1);
      split(t + 1);  // while tile t's products run
    }
    wgmma_wait<0>();
    fence_acc(tc[0]);
    fence_acc(tc[1]);
#pragma unroll
    for (int ks = 0; ks < TG_BK / 8; ++ks)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[ks][b][e])::"memory");
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[b][e] += tc[b][e];
    if (tid == 0) mbar_arrive(&empty[s]);
    consumers_sync();  // both halves of tile t+1 are split; tile t's buffers are free
  }

  // acc[b][4j + e]: A row 16 w4 + g + 8 (e / 2) of block b, x row
  // m0 + 8j + 2q + (e % 2). A row 16 w4 + g + 8h of block b is weight column
  // col + 2b + h (its sum 256x for h = 1).
  const int col = n0 + wg * 128 + w4 * 32 + 4 * g;
  const bool live = col < N;  // N is a multiple of 16: all four columns or none
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] = scale[col + e];
  }
  auto sums = [&](int j, int h) {
    return make_float4(acc[0][4 * j + h], acc[0][4 * j + 2 + h] * 0.00390625f,
                       acc[1][4 * j + h], acc[1][4 * j + 2 + h] * 0.00390625f);
  };
  auto store = [&](int m, float4 v) {
    *reinterpret_cast<float4*>(out + (long long)m * N + col) =
        make_float4(v.x * sc[0], v.y * sc[1], v.z * sc[2], v.w * sc[3]);
  };
  if (gridDim.y == 1) {
    if (!live) return;
#pragma unroll
    for (int j = 0; j < TG_BM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * q + h;
        if (m < M) store(m, sums(j, h));
      }
    return;
  }
  const long long plane = (long long)M * N;
  if (live) {
    float* mine = ws + blockIdx.y * plane + col;
#pragma unroll
    for (int j = 0; j < TG_BM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * q + h;
        if (m < M) *reinterpret_cast<float4*>(mine + (long long)m * N) = sums(j, h);
      }
  }
  __threadfence();
  consumers_sync();
  if (threadIdx.x == 0) *last_flag = atomicAdd(&counters[blockIdx.x], 1) == (int)gridDim.y - 1;
  consumers_sync();
  if (!*last_flag) return;
  __threadfence();
  if (live) {
#pragma unroll 1
    for (int j = 0; j < TG_BM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * q + h;
        if (m >= M) continue;
        const float* src = ws + (long long)m * N + col;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int sp = 0; sp < (int)gridDim.y; ++sp) {
          const float4 o = __ldcg(reinterpret_cast<const float4*>(src + sp * plane));
          v.x += o.x;
          v.y += o.y;
          v.z += o.z;
          v.w += o.w;
        }
        store(m, v);
      }
  }
  if (threadIdx.x == 0) counters[blockIdx.x] = 0;
}

// splits blocks a 64 x 256 tile; split s sums k tiles [s, s + 1) * k_per_split / TG_BK
// (k_per_split a multiple of TG_BK, every split non-empty); ws [splits, M, N]
// and counters (a tile each, 0) when splits > 1.
cudaError_t tf32_gemm(const void* x, const void* w, const float* scale, void* out, float* ws,
                      int* counters, int M, int K, int N, int ldx, int splits, int k_per_split,
                      cudaStream_t stream) {
  if (splits < 1 || splits > TG_MAX_SPLITS || k_per_split <= 0 || k_per_split % TG_BK != 0 ||
      (long long)(splits - 1) * k_per_split >= K || (long long)splits * k_per_split < K ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, K, M, (uint64_t)ldx * 4, TG_BK,
                TG_BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, N, 128, TG_BK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tf32_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
  if (attr != cudaSuccess) return attr;
  const long long tiles = (long long)((M + TG_BM - 1) / TG_BM) * ((N + TG_BN - 1) / TG_BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  tf32_gemm_kernel<<<dim3((unsigned)tiles, splits), TG_THREADS, TG_SMEM, stream>>>(
      xmap, wmap, scale, static_cast<float*>(out), ws, counters, M, K, N, k_per_split);
  return cudaGetLastError();
}

}  // namespace

// Shared contract of the entry points. xdtype / odtype: 0 = float32,
// 1 = bfloat16; the pairs (bf16, bf16), (bf16, f32) and (f32, f32). x [M, ldx]
// (the first K columns used), wq [K, N] int8, scale [N] f32, out [M, N], all
// contiguous; x and wq 16-byte aligned, ldx * sizeof(x) a multiple of 16 and
// N a multiple of 16 (cudaErrorInvalidValue otherwise). Each returns the CUDA
// error code of its launch and sets *kernel to the kernel it launched:
// 0 = gemv_stream_tc, 1 = wg_gemm_kernel, 2 = gemv_stream_tf32,
// 3 = tf32_gemm_kernel, -1 = none.

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

// x [M, ldx] (M <= 64, the first K columns used, 16-byte aligned, ldx *
// sizeof(x) a multiple of 16) times each weight of `group`, into out [M,
// total] (16-byte aligned, contiguous): one launch of the group's
// persistent blocks (at most its column tiles x k tiles), gemv_stream_tc
// for bf16 x, gemv_stream_tf32 for float32 x (float32 out). ws holds 2 *
// blocks * M * bn floats; counters one int a column tile, all 0, and left 0.
extern "C" int quant_matmul_stream(int xdtype, int odtype, const void* group, const void* x,
                                   int M, int ldx, void* out, void* ws, void* counters,
                                   void* stream, int* kernel) {
  *kernel = -1;
  GsArgs a;
  memcpy(&a.grp, group, sizeof(GsGroup));
  const int work = a.grp.tile_base[a.grp.ngroups] * a.grp.KT;
  const bool f32 = xdtype == 0;
  if (M < 1 || M > 64 || ldx < a.grp.K || ldx % (f32 ? 4 : 8) != 0 || !attn::aligned16(x) ||
      !attn::aligned16(out) || ws == nullptr || counters == nullptr || a.grp.blocks < 1 ||
      a.grp.blocks > work || (xdtype != 0 && xdtype != 1) || (odtype != 0 && odtype != 1) ||
      (f32 && odtype != 0))
    return (int)cudaErrorInvalidValue;
  const int item = odtype == 1 ? 2 : 4;
  for (int i = 0; i < GS_MAX_GROUP; ++i)
    a.out[i] = static_cast<char*>(out) + (long long)a.grp.col[i] * item;
  a.x = x;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.ldx = ldx;
  a.ldo = a.grp.total;
  a.blocks = a.grp.blocks;
  a.work = work;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = f32            ? gs_dispatch<float, 4>(a, st)
                          : odtype == 1 ? gs_dispatch<__nv_bfloat16, 2>(a, st)
                                        : gs_dispatch<float, 2>(a, st);
  if (err == cudaSuccess) *kernel = f32 ? 2 : 0;
  return (int)err;
}

// Any M. bf16 x: wgmma fed by TMA (wg_gemm_kernel; splits 1). float32 x:
// the two-pass TF32 wgmma (tf32_gemm_kernel) over `splits` K splits of
// k_per_split (a multiple of 32, every split non-empty); when splits > 1,
// ws holds splits * M * N floats and counters one int a 64 x 256 output
// tile, all 0, and left 0.
extern "C" int quant_matmul_gemm(int xdtype, int odtype, const void* x, const void* wq,
                                 const void* scale, void* out, int M, int K, int N, int ldx,
                                 int splits, int k_per_split, void* ws, void* counters,
                                 void* stream, int* kernel) {
  *kernel = -1;
  if (!shapes_ok(xdtype, x, wq, M, K, N, ldx)) return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int launched;
  if (xdtype == 1 && (odtype == 0 || odtype == 1) && splits == 1) {
    err = odtype == 1 ? wg_gemm<__nv_bfloat16>(x, wq, s, out, M, K, N, ldx, st)
                      : wg_gemm<float>(x, wq, s, out, M, K, N, ldx, st);
    launched = 1;
  } else if (xdtype == 0 && odtype == 0) {
    err = tf32_gemm(x, wq, s, out, static_cast<float*>(ws), static_cast<int*>(counters), M, K,
                    N, ldx, splits, k_per_split, st);
    launched = 3;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) *kernel = launched;
  return (int)err;
}
