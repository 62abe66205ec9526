// Causal GQA prefill attention over a left-padded batch, for Hopper (sm_90a).
//
// Replaces: fairness_llm_tpu/ops/flash_attention.py, `flash_attention` ->
// `_kernel` (the Pallas TPU kernel). Same function: q [B,H,S,D] against
// k/v [B,Hkv,S,D]; row b's valid keys are S-lengths[b] ..< S; a key past the
// query is masked when `causal`; an optional window keeps q_idx - k_idx <
// window; online softmax in f32; the output is acc / max(l, 1e-30), so an
// all-masked query row (a left-pad row) comes out 0.
//
// What bounds it on the H100: at the engine's shapes (S of several hundred,
// D = 128) the causal score and PV products are ~2*S*S*D operations per
// (b, head) against ~2*S*D*(2 + 2/rep) bytes, so the card's bound sits
// near the line between bytes and operations; only the tensor cores come
// near it.
//
// bf16 (flash_fwd_tc), FlashAttention-2's layout on mma.sync m16n8k16: one
// block per (64-row query tile, q head, batch row), 4 warps of 16 query
// rows, three blocks to an SM. Each warp loads its q rows once (ldmatrix)
// into A fragments that stay in registers for the whole key loop; the q
// tile lands in the second stage's buffer, so it costs no shared memory of
// its own. K and V tiles of 64 keys (32 at D = 256) stream through a
// two-stage cp.async ring of 16-byte copies, rows padded by 16 bytes so
// that ldmatrix reads are free of bank conflicts.
// S = Q.K^T runs with K as the B operand (plain ldmatrix: a key row is
// contiguous along the contraction), the softmax scale times log2(e) is
// applied to the f32 scores once and exp2f does the rest. The online
// softmax runs on the C fragments: a row lives on a quad of 4 lanes, so its
// max takes two shuffles and its sum stays per lane until the end. P never
// touches shared memory: the C fragments of S, packed to bf16, are the A
// fragments of P.V, whose B operand V is read with ldmatrix.trans (a V row
// is contiguous along N). P goes in as two bf16 terms, its rounding and the
// remainder, two products with each V fragment: one term (the design until
// a mistral-7b prefill parted from the plain version at an output near
// cancellation, ROADMAP C8) moved outputs by up to 2^-9 of the largest |v|
// averaged; two carry P to about 2^-17, so the kernel parts from the f32
// plain version by summation order and its final rounding. Masks are
// applied only on tiles that cross
// the diagonal, the first valid key, the end of S or the window's edge;
// tiles wholly masked are never loaded, and a query tile wholly inside the
// left padding writes zeros without loading anything. Widths 64, 128 and
// 256 are instantiated; the wrapper pads D with zero columns to the next.
// What bounds this version: mma.sync reaches a fraction of the 989 TFLOP/s
// that wgmma can, and with 16 query rows a warp each K or V fragment read
// from shared memory feeds two products only; the loads and the softmax
// overlap the products only across the 12 warps of an SM. Tried on the
// card: 8 warps of 16 rows (registers spill), 32-key tiles (no faster).
//
// float32 (flash_fwd): full f32 products on scalar FMAs (no TF32; 3xTF32
// on mma.sync was not taken: the study's prefill and scoring shapes, head
// width 32 and 128-640 rows, are a few tiles a block, bound by latency and
// the launch rather than by the FMAs, and the float32 gates want the exact
// f32 products). A block takes R = 16, 32 or 64 query rows, planned by the
// wrapper (flash_f32_rows) from the shape and the SM count, so that a
// prefill of one short row (the study's prefix, 1 x 4 heads x 128) still
// spreads over the card: 32 blocks of 16 rows where 64-row tiles made 8.
// Eight warps of 8 query rows each: R / 8 row groups times KG = 64 / R key
// groups. A step stages KG key tiles of 32 keys (k and v) through a
// two-stage cp.async ring, and key group g computes the step's tile g for
// its row group, so a row of T tiles is walked in T / KG steps; the key
// groups' (m, l, acc) are folded in shared memory at the end in key-group
// order (deterministic). The plan weighs the grid's waves against the
// longest block's steps (flash_f32_rows), so the key groups spread a long
// row's keys across warps (phase 2's listwise query, S = 640, runs in
// blocks of 16 rows), and a grid of many short rows keeps 64-row blocks. A
// query tile wholly in the left padding writes zeros and loads nothing; a
// warp whose rows see none of a tile's keys skips it. A warp runs its 8 rows in the quad layout
// (attention_common.cuh's quad_tile): lane 4r + g holds row r's query,
// scaled into log2 units, and its accumulator for a quarter of the columns
// in registers; a tile's scores are reduced, and its weights gathered,
// over the row's four lanes with 50 shuffles (one key a lane, each weight
// shuffled to every lane, takes 296), so P never goes through shared
// memory. The wrapper pads D to 32, 64, 128 or 256.
//
// Both: key tiles before the first valid key (left pads, window) and after
// the tile's last query (causal) are never loaded; GQA reads kv head
// h / rep directly; strides are passed in, so q/k/v/o may be head-major
// views of a [B,S,H,D] tensor without a copy. The wrapper copies k/v whose
// rows do not start on a 16-byte boundary, zero-padded, before the launch.

#include "attention_common.cuh"
#include "mma_fragments.cuh"

namespace {

using namespace attn;

constexpr int kBlockK = 32;  // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRows = 8;     // query rows a warp
constexpr int kStages = 2;

struct Strides {
  long long b, h, s;
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// One staged k (or v) tile of 32 float rows.
__host__ __device__ __forceinline__ size_t tile_bytes(int D) {
  return align16(sizeof(float) * kBlockK * staged_stride<float>(D));
}

// Shared memory of a block of R query rows: kStages steps of KG = 64 / R
// (k tile, v tile) pairs. The fold of the key groups at the end reuses it.
// The wrapper's flash_f32_smem.
size_t smem_bytes(int R, int D) {
  const int KG = kWarps * kRows / R;
  return kStages * KG * 2 * tile_bytes(D);
}

// float32 only (bf16 goes to flash_fwd_tc); see the note at the top of the
// file. DW: the head width (the wrapper pads D to 32, 64, 128 or 256), a
// lane holding DW / 4 columns of its row (quad_tile). R: query rows a block
// (16, 32 or 64). sl: the softmax scale times log2(e).
template <int DW>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          const int* __restrict__ lengths, int H, int Hkv, int S, int R, Strides qst,
          Strides kst, Strides vst, Strides ost, int causal, int window, float sl) {
  constexpr int DP = DW / 4;  // columns a lane
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DS = DW + 4;  // staged_stride<float>(DW)
  const size_t tb = tile_bytes(DW);
  const int RG = R / kRows, KG = kWarps / RG;  // row groups, key groups
  auto ktile = [&](int st, int g) {
    return reinterpret_cast<float*>(smem + (2 * (st * KG + g)) * tb);
  };
  auto vtile = [&](int st, int g) {
    return reinterpret_cast<float*>(smem + (2 * (st * KG + g) + 1) * tb);
  };

  const int q0 = blockIdx.x * R;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp % RG, kg = warp / RG;  // this warp's row group and key group
  const int pad_start = S - lengths[b];

  const float* qb = q + b * qst.b + h * qst.h;
  const float* kb = k + b * kst.b + hk * kst.h;
  const float* vb = v + b * vst.b + hk * vst.h;
  float* ob = o + b * ost.b + h * ost.h;

  const int q_last = min(q0 + R, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  int k_begin = max(pad_start, 0);
  if (window > 0) k_begin = max(k_begin, q0 - window + 1);
  const int kt_begin = (k_begin / kBlockK) * kBlockK;
  const int ntiles = k_end > kt_begin ? (k_end - kt_begin + kBlockK - 1) / kBlockK : 0;
  const int nsteps = (ntiles + KG - 1) / KG;
  if (ntiles == 0) {
    // No query row of the tile sees a key (a tile inside the left padding):
    // every row is 0, and nothing is loaded.
    for (int i = threadIdx.x; i < R * DW; i += blockDim.x) {
      const int r = q0 + i / DW;
      if (r < S) ob[r * ost.s + i % DW] = 0.f;
    }
    return;
  }

  // Step s: tiles s * KG + g into ring stage s % kStages, one for each key group g.
  auto stage = [&](int s) {
    const int st = s % kStages;
    for (int g = 0; g < KG; ++g) {
      const int kt = kt_begin + (s * KG + g) * kBlockK;
      if (s * KG + g >= ntiles) break;
      stage_rows<float>(ktile(st, g), kBlockK, DW, kb, [&](int j) -> const float* {
        return kt + j < S ? kb + (kt + j) * kst.s : nullptr;
      });
      stage_rows<float>(vtile(st, g), kBlockK, DW, vb, [&](int j) -> const float* {
        return kt + j < S ? vb + (kt + j) * vst.s : nullptr;
      });
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) stage(s);
    cp_async_commit();
  }

  // This lane's query row (zeros past S) and columns, scaled into log2
  // units, straight into registers.
  const int qi = q0 + rg * kRows + lane / 4;  // this lane's query row
  const int c0 = (lane & 3) * 4;              // and its first column (quad_tile's layout)
  float qr[DP], acc[DP];
  {
    const float4* src = reinterpret_cast<const float4*>(qb + (long long)qi * qst.s + c0);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 x = qi < S ? src[4 * d4] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * d4] = x.x * sl;
      qr[4 * d4 + 1] = x.y * sl;
      qr[4 * d4 + 2] = x.z * sl;
      qr[4 * d4 + 3] = x.w * sl;
    }
  }
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;  // l: this lane's keys; summed over the quad at the end

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + kStages - 1 < nsteps) stage(s + kStages - 1);
    cp_async_commit();

    const int t = s * KG + kg;
    if (t >= ntiles) continue;  // warp-uniform: this key group has no tile in the last step
    const int kt = kt_begin + t * kBlockK;
    // A row group none of whose rows sees a key of the tile skips it (the
    // tile would leave its state as it is): its rows all past S, all in the
    // left padding or before the tile (causal), or the tile before the
    // window of its first row.
    const int rfirst = q0 + rg * kRows, rlast = rfirst + kRows - 1;
    if (rfirst >= S || (causal && (rlast < pad_start || kt > rlast)) ||
        (window > 0 && kt + kBlockK - 1 <= rfirst - window))
      continue;
    quad_tile<DP>(qr, ktile(s % kStages, kg), vtile(s % kStages, kg), DS,
                  [&](int j) {
                    const int kidx = kt + j;
                    bool ok = kidx < S && kidx >= pad_start;
                    if (causal) ok = ok && kidx <= qi;
                    if (window > 0) ok = ok && qi - kidx < window;
                    return ok;
                  },
                  m, l, acc);
  }
  cp_async_wait<0>();
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  if (KG > 1) {
    // Fold the key groups in shared memory, in key-group order: acc
    // [KG][R][DW], then m [KG][R] and l [KG][R], over the ring.
    __syncthreads();  // every warp is done with the ring
    float* facc = reinterpret_cast<float*>(smem);
    float* fm = facc + KG * R * DW;
    float* fl = fm + KG * R;
    const int row = rg * kRows + lane / 4;  // this lane's row in the block
    float4* dst = reinterpret_cast<float4*>(facc + (kg * R + row) * DW + c0);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4)
      dst[4 * d4] = make_float4(acc[4 * d4], acc[4 * d4 + 1], acc[4 * d4 + 2], acc[4 * d4 + 3]);
    if ((lane & 3) == 0) {
      fm[kg * R + row] = m;
      fl[kg * R + row] = l;
    }
    __syncthreads();
    if (kg != 0) return;
    float mx = kNegInf;
    for (int g = 0; g < KG; ++g) mx = fmaxf(mx, fm[g * R + row]);
    float lsum = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) acc[d] = 0.f;
    for (int g = 0; g < KG; ++g) {
      const float w = exp2f(fm[g * R + row] - mx);  // 1 for every group of a row with no key
      lsum += w * fl[g * R + row];
      const float4* src = reinterpret_cast<const float4*>(facc + (g * R + row) * DW + c0);
#pragma unroll
      for (int d4 = 0; d4 < DP / 4; ++d4) {
        const float4 x = src[4 * d4];
        acc[4 * d4] += w * x.x;
        acc[4 * d4 + 1] += w * x.y;
        acc[4 * d4 + 2] += w * x.z;
        acc[4 * d4 + 3] += w * x.w;
      }
    }
    l = lsum;
  }

  if (qi < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* orow = ob + (long long)qi * ost.s + c0;
#pragma unroll
    for (int d = 0; d < DP; ++d) orow[16 * (d / 4) + d % 4] = acc[d] * inv;
  }
}

template <int DW>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, int B, int H, int Hkv, int S, int R,
                   Strides qst, Strides kst, Strides vst, Strides ost, int causal,
                   int window, float scale, cudaStream_t stream) {
  if (R != 16 && R != 32 && R != 64) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R, DW);
  auto kernel = flash_fwd<DW>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + R - 1) / R, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lengths, H, Hkv, S, R, qst, kst,
      vst, ost, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcBlockQ = 16 * kTcWarps;  // 16 query rows per warp

// Tile shape of one instantiated width DP: keys per tile BK, and the row
// stride of staged tiles (DP + 8 elements: 16 spare bytes a row, so the 8
// rows one ldmatrix reads start in distinct banks).
template <int DP>
struct TcShape {
  static constexpr int BK = DP >= 256 ? 32 : 64;
  static constexpr int STR = DP + 8;
  static constexpr int Q_ELEMS = kTcBlockQ * STR;
  static constexpr int KV_ELEMS = BK * STR;
  // Two stages of (k tile, v tile); the q tile first lands in stage 1.
  static constexpr int SMEM = 2 * 2 * KV_ELEMS * 2;
  static_assert(Q_ELEMS <= 2 * KV_ELEMS, "the q tile fits in one stage");
};

// DP: the head width (the wrapper pads D to it). One block per (64-row
// query tile, q head, batch row); see the note at the top of the file.
template <int DP>
__global__ void __launch_bounds__(kTcWarps * 32, 3)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o,
             const int* __restrict__ lengths, int H, int Hkv, int S, Strides qst,
             Strides kst, Strides vst, Strides ost, int causal, int window, float scale) {
  using Sh = TcShape<DP>;
  constexpr int BK = Sh::BK, STR = Sh::STR;
  constexpr int NS = BK / 8;   // n8 score tiles a warp holds
  constexpr int ND = DP / 8;   // n8 output tiles a warp holds
  constexpr int KD = DP / 16;  // k16 steps over D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* tiles = reinterpret_cast<bf16*>(smem);
  auto ktile = [&](int st) { return tiles + (2 * st) * Sh::KV_ELEMS; };
  auto vtile = [&](int st) { return tiles + (2 * st + 1) * Sh::KV_ELEMS; };
  // The q tile is read into registers once, before stage 1 is first filled.
  bf16* qs = ktile(1);

  const int q0 = blockIdx.x * kTcBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q2 = (lane % 4) * 2;
  const int pad_start = S - lengths[b];

  const bf16* qb = q + b * qst.b + h * qst.h;
  const bf16* kb = k + b * kst.b + hk * kst.h;
  const bf16* vb = v + b * vst.b + hk * vst.h;
  bf16* ob = o + b * ost.b + h * ost.h;

  const int q_last = min(q0 + kTcBlockQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  int k_begin = max(pad_start, 0);
  if (window > 0) k_begin = max(k_begin, q0 - window + 1);
  const int kt_begin = (k_begin / BK) * BK;
  const int ntiles = k_end > kt_begin ? (k_end - kt_begin + BK - 1) / BK : 0;

  const int r0 = q0 + warp * 16 + g;  // this lane's rows: r0 and r0 + 8
  if (ntiles == 0) {
    // No query row of the tile sees a key (a tile inside the left padding):
    // every row is 0.
    for (int i = threadIdx.x; i < kTcBlockQ * (DP / 2); i += blockDim.x) {
      const int r = q0 + i / (DP / 2), d = (i % (DP / 2)) * 2;
      if (r < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + r * ost.s + d) = __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }

  auto stage = [&](int t) {
    const int kt = kt_begin + t * BK;
    const int st = t % 2;
    stage_rows<bf16>(ktile(st), BK, DP, kb, [&](int j) -> const bf16* {
      return kt + j < S ? kb + (kt + j) * kst.s : nullptr;
    });
    stage_rows<bf16>(vtile(st), BK, DP, vb, [&](int j) -> const bf16* {
      return kt + j < S ? vb + (kt + j) * vst.s : nullptr;
    });
  };

  // Group 0: the q tile and key tile 0.
  stage_rows<bf16>(qs, kTcBlockQ, DP, qb, [&](int j) -> const bf16* {
    return q0 + j < S ? qb + (q0 + j) * qst.s : nullptr;
  });
  stage(0);
  cp_async_commit();

  const float sl = scale * kLog2e;
  uint32_t qf[KD][4];
  float acc[ND][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KD; ++ks)
        frag::ldsm_x4(qf[ks], qs + (warp * 16 + lane % 16) * STR + ks * 16 + (lane / 16) * 8);
      __syncthreads();  // every warp holds its q rows: stage 1 is free
    }
    if (t + 1 < ntiles) stage(t + 1);
    cp_async_commit();
    const bf16* ks_ = ktile(t % 2);
    const bf16* vs_ = vtile(t % 2);
    const int kt = kt_begin + t * BK;

    // S = Q K^T: 16 rows x BK keys a warp.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KD; ++ks) {
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        uint32_t r[4];
        frag::ldsm_x4(r, ks_ + (jj * 16 + lane % 8 + (lane / 16) * 8) * STR + ks * 16 +
                             ((lane / 8) % 2) * 8);
        frag::mma_bf16(s[2 * jj], qf[ks], r[0], r[1]);
        frag::mma_bf16(s[2 * jj + 1], qf[ks], r[2], r[3]);
      }
    }

    // Scores in log2 units; masked only where the tile crosses an edge.
    const bool edge = kt < pad_start || kt + BK > S || (causal && kt + BK - 1 > q0) ||
                      (window > 0 && kt <= q_last - window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl;
        if (edge) {
          const int kidx = kt + j * 8 + q2 + (e & 1);
          const int qi = r0 + (e >> 1) * 8;
          bool ok = kidx < S && kidx >= pad_start;
          if (causal) ok = ok && kidx <= qi;
          if (window > 0) ok = ok && qi - kidx < window;
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }

    // Online softmax on the C fragments: row r0 holds e = 0, 1, row r0 + 8
    // e = 2, 3; a row's four lanes are a quad.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m[hr];
#pragma unroll
      for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // A row with no valid key yet keeps kNegInf; subtracting 0 then
      // sends its masked scores to exp2f(-1e30) = 0.
      const float mu = mx == kNegInf ? 0.f : mx;
      const float alpha = exp2f(m[hr] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - mu);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - mu);
        sum += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l[hr] = l[hr] * alpha + sum;  // this lane's share; the quad sums at the end
      m[hr] = mx;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][2 * hr] *= alpha;
        acc[j][2 * hr + 1] *= alpha;
      }
    }

    // O += P V, P straight from the score fragments as two bf16 terms (its
    // rounding pa and the remainder pl, split_bf16x2), each a product with
    // the same V fragment: one term moved an output by up to 2^-9 of the
    // largest |v| it averages, which an output near cancellation does not
    // absorb (ROADMAP C8); two carry P to about 2^-17.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4], pl[4];
      frag::split_bf16x2(s[2 * kk][0], s[2 * kk][1], pa[0], pl[0]);
      frag::split_bf16x2(s[2 * kk][2], s[2 * kk][3], pa[1], pl[1]);
      frag::split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2], pl[2]);
      frag::split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < DP / 16; ++dd) {
        uint32_t r[4];
        frag::ldsm_x4_trans(r, vs_ + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * STR +
                                   dd * 16 + (lane / 16) * 8);
        frag::mma_bf16(acc[2 * dd], pa, r[0], r[1]);
        frag::mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
        frag::mma_bf16(acc[2 * dd], pl, r[0], r[1]);
        frag::mma_bf16(acc[2 * dd + 1], pl, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qi = r0 + hr * 8;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* orow = ob + qi * ost.s + q2;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * hr] * inv, acc[j][2 * hr + 1] * inv);
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const int* lengths, int B, int H, int Hkv, int S, Strides qst,
                      Strides kst, Strides vst, Strides ost, int causal, int window,
                      float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_tc<DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         TcShape<DP>::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kTcBlockQ - 1) / kTcBlockQ, H, B);
  kernel<<<grid, kTcWarps * 32, TcShape<DP>::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lengths, H, Hkv, S, qst, kst, vst, ost, causal, window, scale);
  return cudaGetLastError();
}

bool strides_aligned(const Strides& s, long long ve) {
  return s.b % ve == 0 && s.h % ve == 0 && s.s % ve == 0;
}

// bf16: D must be an instantiated width and q, k, v rows 16-byte aligned;
// anything else is refused (the wrapper pads), never sent elsewhere.
cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o,
                        const int* lengths, int B, int H, int Hkv, int S, int D, Strides qst,
                        Strides kst, Strides vst, Strides ost, int causal, int window,
                        float scale, cudaStream_t stream) {
  const long long ve = Vec<bf16>::kElems;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && strides_aligned(qst, ve) &&
        strides_aligned(kst, ve) && strides_aligned(vst, ve) && ost.s % 2 == 0 &&
        (reinterpret_cast<uintptr_t>(o) & 3) == 0))
    return cudaErrorInvalidValue;
#define FLASH_TC(DP)                                                                      \
  return launch_tc<DP>(q, k, v, o, lengths, B, H, Hkv, S, qst, kst, vst, ost, causal, \
                       window, scale, stream)
  if (D == 64) FLASH_TC(64);
  if (D == 128) FLASH_TC(128);
  if (D == 256) FLASH_TC(256);
#undef FLASH_TC
  return cudaErrorInvalidValue;
}

// float32: D one of the instantiated widths, and every q/k/v row 16-byte
// aligned (16-byte staging, and a lane's q columns loaded as 16-byte
// vectors); anything else is refused (the wrapper pads), never sent
// elsewhere.
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         const int* lengths, int B, int H, int Hkv, int S, int D, int R,
                         Strides qst, Strides kst, Strides vst, Strides ost, int causal,
                         int window, float scale, cudaStream_t stream) {
  const long long ve = Vec<float>::kElems;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && strides_aligned(qst, ve) &&
        strides_aligned(kst, ve) && strides_aligned(vst, ve)))
    return cudaErrorInvalidValue;
#define FLASH_LAUNCH(DW)                                                                  \
  return launch<DW>(q, k, v, o, lengths, B, H, Hkv, S, R, qst, kst, vst, ost, causal, \
                    window, scale, stream)
  if (D == 32) FLASH_LAUNCH(32);
  if (D == 64) FLASH_LAUNCH(64);
  if (D == 128) FLASH_LAUNCH(128);
  if (D == 256) FLASH_LAUNCH(256);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).
// Strides are in elements, for the b, h and s dimensions of q, k, v and o in
// that order; the d dimension is contiguous. window <= 0 means no window.
// float32: D one of 32, 64, 128, 256, q/k/v rows 16-byte aligned, rows
// (query rows a block) 16, 32 or 64, its shared memory within a block's 227
// KB.
// bfloat16 (rows ignored): D one of 64, 128, 256, q/k/v rows 16-byte
// aligned, o rows 4-byte aligned.
// Anything else returns cudaErrorInvalidValue; otherwise the CUDA error code
// of the launch. *kernel is set to the kernel launched: 0 = flash_fwd,
// 1 = flash_fwd_tc, -1 = none.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* lengths, int B, int H, int Hkv,
                                   int S, int D, int rows, long long qsb, long long qsh,
                                   long long qss, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh,
                                   long long oss, int causal, int window, float scale,
                                   void* stream, int* kernel) {
  *kernel = -1;
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qst{qsb, qsh, qss}, kst{ksb, ksh, kss}, vst{vsb, vsh, vss},
      ost{osb, osh, oss};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  int launched;
  if (dtype == 0) {
    err = dispatch_f32(q, k, v, o, len, B, H, Hkv, S, D, rows, qst, kst, vst, ost, causal,
                       window, scale, st);
    launched = 0;  // flash_fwd
  } else if (dtype == 1) {
    err = dispatch_tc(q, k, v, o, len, B, H, Hkv, S, D, qst, kst, vst, ost, causal, window,
                      scale, st);
    launched = 1;  // flash_fwd_tc
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) *kernel = launched;
  return (int)err;
}
