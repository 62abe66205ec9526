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
// quant_matmul_gemv (M <= 64: the decode step, M = the batch). Bound by
// bytes: 2*M operations per weight byte, and the weight is read once, so the
// bound is K*N bytes over the H100 SXM's 3.35 TB/s at 700 W (gate/up of
// llama3-8b: 58.7 MB, ~17.5 us). A block owns 128 columns and a slice of K:
// where N alone gives too few blocks (k/v_proj: N = 1024, 8 column tiles on
// a 132-SM card), K is split across blocks, each split writes an f32
// partial [M,N], and a second kernel sums the splits in order, applies the
// scale and casts, so the result does not depend on the order blocks run
// in. The products run on the tensor cores as in the GEMM regime below,
// with tiles of 16, 32 or 64 rows and k tiles of 64, on 8 warps side by
// side, each 16 columns wide. A first
// version did the products as f32 FMAs on the CUDA cores, ~23 instructions
// per weight byte, and was bound by instruction throughput at 5.7x the byte
// bound (gate/up 101 us on an H100 80GB HBM3 at 700 W); converting the tile
// once and handing it to mma leaves ~3.
//
// quant_matmul_gemm (M > 64: prefill). Bound by operations (2*M*K*N; a
// no-prefix prefill of llama3-8b is ~200 TFLOP): mma.sync m16n8k16 bf16
// with f32 accumulation on 128x128 output tiles, 8 warps of 64x32, k tiles
// of 32.
//
// Both bf16 paths: x tiles (bf16) and int8 weight tiles stream through a
// four-stage cp.async pipeline with 16-byte loads; each weight tile is
// converted once to bf16 in shared memory and read as the B operand with
// ldmatrix.trans (the N-contiguous layout is the transpose of what mma
// wants). Rows are padded by 16 bytes so ldmatrix reads are free of bank
// conflicts.
//
// float32 x (float32 models) in either regime: the weight goes to f32, never
// TF32 or bf16, and the products are f32 FMAs on the CUDA cores. A block
// owns 128 columns, up to 64 rows and a slice of K; each lane owns 4
// neighbouring columns (one 32-bit word of a weight row) and up to 16 rows,
// the 8 warps split each tile's k rows (and the rows of x past 16), and
// their sums meet in shared memory in a fixed order.
//
// Ragged edges: rows of x past M, k past K and columns past N are
// zero-filled when staged and never stored. The wrapper hands in N a
// multiple of 16 and 16-byte aligned rows (it pads where they are not).
// wgmma, TMA and a persistent schedule come later.

#include <string.h>

#include "attention_common.cuh"

namespace {

using attn::cp_async16;
using attn::cp_async_commit;
using attn::cp_async_wait;
using attn::from_f;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Four signed bytes -> four exact floats: the byte b + 128 goes into the
// mantissa of 2^23, and 2^23 + 128 is subtracted again.
__device__ __forceinline__ void i8x4_to_f32(uint32_t packed, float (&f)[4]) {
  const uint32_t u = packed ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

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

// out = cast(scale * sum over splits of partial), in split order.
template <typename TO>
__global__ void __launch_bounds__(kThreads)
splitk_reduce(const float* __restrict__ partial, const float* __restrict__ scale,
              TO* __restrict__ out, int M, int N, int splits) {
  const long long total = (long long)M * N;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += partial[p * total + i];
    out[i] = from_f<TO>(s * scale[i % N]);
  }
}

template <typename TO>
cudaError_t reduce_launch(const float* partial, const float* scale, void* out, int M, int N,
                          int splits, cudaStream_t stream) {
  const long long blocks = ((long long)M * N + kThreads - 1) / kThreads;
  splitk_reduce<TO><<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      partial, scale, static_cast<TO*>(out), M, N, splits);
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
  return reduce_launch<float>(partial, scale, out, M, N, splits, stream);
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
// Tensor-core kernel (bf16 x): the GEMM regime, and the GEMV regime's bf16 path
// ---------------------------------------------------------------------------

constexpr int TC_BN = 128;  // columns per block
constexpr int TC_STAGES = 4;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Shared memory of one tile shape: TC_STAGES x (x tile [BM][BK + 8] bf16,
// weight tile [BK][TC_BN] int8), then the converted tile [BK][TC_BN + 8]
// bf16. The 8 spare elements a row (16 bytes) put the 8 rows one ldmatrix
// reads in distinct banks.
template <int BM, int BK>
struct TcTile {
  static constexpr int XS = BK + 8;
  static constexpr int BS = TC_BN + 8;
  static constexpr int X_BYTES = BM * XS * 2;
  static constexpr int W_BYTES = BK * TC_BN;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int SMEM = TC_STAGES * STAGE + BK * BS * 2;
};

// Block (column tile, row tile, K split): output [BM, TC_BN] on WM x WN
// warps, each warp a (BM / WM) x (TC_BN / WN) tile of m16n8 products.
// Split s sums k in [s * k_per_split, ...); `partial` is null when the block
// applies the scale and writes `out` itself (one split), else [splits, M, N].
template <typename TO, int BM, int BK, int WM, int WN>
__global__ void __launch_bounds__(kThreads)
tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, TO* __restrict__ out, float* __restrict__ partial,
          int M, int K, int N, int ldx, int k_per_split) {
  using T = TcTile<BM, BK>;
  constexpr int MT = BM / WM / 16;    // m16 tiles a warp
  constexpr int NT = TC_BN / WN / 8;  // n8 tiles a warp
  static_assert(WM * WN == kWarps && MT >= 1 && NT % 2 == 0, "warp layout");
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % WM, wn = warp / WM;
  const int n0 = blockIdx.x * TC_BN, m0 = blockIdx.y * BM;
  const int kb = blockIdx.z * k_per_split;
  const int ke = min(K, kb + k_per_split);
  const int ntiles = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  auto xtile = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * T::STAGE); };
  auto wtile = [&](int st) { return reinterpret_cast<int8_t*>(smem + st * T::STAGE + T::X_BYTES); };
  __nv_bfloat16* bconv = reinterpret_cast<__nv_bfloat16*>(smem + TC_STAGES * T::STAGE);

  auto stage = [&](int t) {
    const int k0 = kb + t * BK, st = t % TC_STAGES;
    __nv_bfloat16* xd = xtile(st);
    for (int i = threadIdx.x; i < BM * (BK / 8); i += kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      // A chunk that starts before ke ends before it, or runs into the zero
      // padding of a row past K.
      const bool ok = m0 + r < M && k0 + c < ke;
      cp_async16(xd + r * T::XS + c, ok ? x + (long long)(m0 + r) * ldx + k0 + c : x, ok);
    }
    int8_t* wd = wtile(st);
    for (int i = threadIdx.x; i < BK * (TC_BN / 16); i += kThreads) {
      const int r = i / (TC_BN / 16), c = (i % (TC_BN / 16)) * 16;
      const bool ok = k0 + r < ke && n0 + c < N;
      cp_async16(wd + r * TC_BN + c, ok ? w + (long long)(k0 + r) * N + n0 + c : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1 and bconv
    if (t + TC_STAGES - 1 < ntiles) stage(t + TC_STAGES - 1);
    cp_async_commit();

    // The weight tile to bf16, 16 values per thread and pass.
    const int8_t* wt = wtile(t % TC_STAGES);
#pragma unroll
    for (int i = threadIdx.x; i < BK * (TC_BN / 16); i += kThreads) {
      const int r = i / (TC_BN / 16), c = (i % (TC_BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(wt + r * TC_BN + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t packed[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[4];
        i8x4_to_f32(words[q], f);
        packed[2 * q] = pack_bf16x2(f[0], f[1]);
        packed[2 * q + 1] = pack_bf16x2(f[2], f[3]);
      }
      uint4* dst = reinterpret_cast<uint4*>(bconv + r * T::BS + c);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();

    const __nv_bfloat16* xs = xtile(t % TC_STAGES);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], xs + ((wm * MT + i) * 16 + lane % 16) * T::XS + ks + (lane / 16) * 8);
      // One x4.trans load: rows k (8 + 8), columns n (8 + 8) = two n8 B fragments.
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj) {
        uint32_t r[4];
        ldsm_x4_trans(r, bconv + (ks + lane % 8 + ((lane / 8) % 2) * 8) * T::BS +
                             (wn * NT + 2 * jj) * 8 + (lane / 16) * 8);
        b[2 * jj][0] = r[0];
        b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2];
        b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // Accumulator fragment: c0, c1 at (row g, cols 2q, 2q+1); c2, c3 at row g + 8.
  const int g = lane / 4, q2 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = n0 + (wn * NT + j) * 8 + q2;
    if (col >= N) continue;  // N is even, so col + 1 < N too
    const float s0 = scale[col], s1 = scale[col + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + (wm * MT + i) * 16 + g + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (partial != nullptr)
          store2(partial + ((long long)blockIdx.z * M + row) * N + col, v0, v1);
        else
          store2(out + (long long)row * N + col, v0 * s0, v1 * s1);
      }
    }
  }
}

template <typename TO, int BM, int BK, int WM, int WN>
cudaError_t tc_launch(const void* x, const void* w, const float* scale, void* out,
                      float* partial, int M, int K, int N, int ldx, int splits,
                      int k_per_split, cudaStream_t stream) {
  using T = TcTile<BM, BK>;
  auto kernel = tc_kernel<TO, BM, BK, WM, WN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TC_BN - 1) / TC_BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, T::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w), scale,
      static_cast<TO*>(out), splits > 1 ? partial : nullptr, M, K, N, ldx, k_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return reduce_launch<TO>(partial, scale, out, M, N, splits, stream);
}

// GEMV regime, bf16 x: BM = 16, 32 or 64 rows on 8 warps side by side, each
// 16 columns wide and all rows deep, over k tiles of 64.
template <typename TO>
cudaError_t tc_gemv_dispatch(const void* x, const void* w, const float* scale, void* out,
                             float* partial, int M, int K, int N, int ldx, int splits,
                             int k_per_split, cudaStream_t stream) {
  if (M > 32)
    return tc_launch<TO, 64, 64, 1, 8>(x, w, scale, out, partial, M, K, N, ldx, splits,
                                       k_per_split, stream);
  if (M > 16)
    return tc_launch<TO, 32, 64, 1, 8>(x, w, scale, out, partial, M, K, N, ldx, splits,
                                       k_per_split, stream);
  return tc_launch<TO, 16, 64, 1, 8>(x, w, scale, out, partial, M, K, N, ldx, splits,
                                     k_per_split, stream);
}

// GEMM regime, bf16 x: 128 x 128 output tiles on 2 x 4 warps of 64 x 32, k tiles of 32.
template <typename TO>
cudaError_t tc_gemm(const void* x, const void* w, const float* scale, void* out, int M,
                    int K, int N, int ldx, cudaStream_t stream) {
  const int kps = (K + 31) / 32 * 32;
  return tc_launch<TO, 128, 32, 2, 4>(x, w, scale, out, nullptr, M, K, N, ldx, 1, kps,
                                      stream);
}

bool shapes_ok(int xdtype, const void* x, const void* w, int M, int K, int N, int ldx) {
  const int xsize = xdtype == 0 ? 4 : 2;
  return M > 0 && K > 0 && N > 0 && N % 16 == 0 && ldx >= K && (ldx * xsize) % 16 == 0 &&
         attn::aligned16(x) && attn::aligned16(w);
}

}  // namespace

// Shared contract of both entry points. xdtype / odtype: 0 = float32,
// 1 = bfloat16; the pairs (bf16, bf16), (bf16, f32) and (f32, f32). x [M, ldx]
// (the first K columns used), wq [K, N] int8, scale [N] f32, out [M, N], all
// contiguous; x and wq 16-byte aligned, ldx * sizeof(x) a multiple of 16 and
// N a multiple of 16 (cudaErrorInvalidValue otherwise). Each returns the CUDA
// error code of its launches.

// M <= 64. `partial` is [splits, M, N] f32 scratch when splits > 1 (else
// unused); split s sums k in [s * k_per_split, (s + 1) * k_per_split), and
// k_per_split is a multiple of 64. bf16 x: tensor cores; f32 x: CUDA-core FMAs.
extern "C" int quant_matmul_gemv(int xdtype, int odtype, const void* x, const void* wq,
                                 const void* scale, void* out, void* partial, int M, int K,
                                 int N, int ldx, int splits, int k_per_split, void* stream) {
  if (!shapes_ok(xdtype, x, wq, M, K, N, ldx) || M > 64 || splits < 1 ||
      k_per_split % 64 != 0 || (long long)splits * k_per_split < K ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (xdtype == 1 && odtype == 1)
    err = tc_gemv_dispatch<__nv_bfloat16>(x, wq, s, out, p, M, K, N, ldx, splits, k_per_split,
                                          st);
  else if (xdtype == 1 && odtype == 0)
    err = tc_gemv_dispatch<float>(x, wq, s, out, p, M, K, N, ldx, splits, k_per_split, st);
  else if (xdtype == 0 && odtype == 0)
    err = f32_dispatch(x, wq, s, out, p, M, K, N, ldx, splits, k_per_split, 1, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Any M. bf16 x: tensor cores; f32 x: CUDA-core FMAs over chunks of 64 rows.
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
    err = tc_gemm<__nv_bfloat16>(x, wq, s, out, M, K, N, ldx, st);
  else if (xdtype == 1 && odtype == 0)
    err = tc_gemm<float>(x, wq, s, out, M, K, N, ldx, st);
  else if (xdtype == 0 && odtype == 0)
    err = mchunks > 65535 ? cudaErrorInvalidValue
                          : f32_dispatch(x, wq, s, out, nullptr, M, K, N, ldx, 1, kps, mchunks,
                                         st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
