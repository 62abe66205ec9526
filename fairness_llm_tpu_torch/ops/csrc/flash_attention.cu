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
// is contiguous along N). Rounding P to bf16 is the one numerical change
// against the f32 plain version. Masks are applied only on tiles that cross
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
// float32 (flash_fwd): full f32 products (no TF32), on scalar FMAs. Key and
// value tiles of 32 rows (one key per lane for the scores) stream through a
// two-stage cp.async pipeline; the q tile is scaled once into shared memory
// as f32; each of the 8 warps owns 8 query rows and keeps their running
// max, normaliser and accumulator (lanes split D) in registers.
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

constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 32;   // keys per tile: one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBlockQ / kWarps;  // query rows per warp
constexpr int kStages = 2;

struct Strides {
  long long b, h, s;
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory layout: kStages x (k tile, v tile), then q, then p.
__host__ __device__ __forceinline__ size_t tile_bytes(int D) {
  return align16(sizeof(float) * kBlockK * staged_stride<float>(D));
}

size_t smem_bytes(int D) {
  return 2 * kStages * tile_bytes(D) + align16(sizeof(float) * kBlockQ * D) +
         sizeof(float) * kWarps * kRows * kBlockK;
}

// float32 only (bf16 goes to flash_fwd_tc). NCH: how many 32-wide chunks of
// D each lane accumulates (D <= 32 * NCH).
template <int NCH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          const int* __restrict__ lengths, int H, int Hkv, int S, int D, Strides qst,
          Strides kst, Strides vst, Strides ost, int causal, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DS = staged_stride<float>(D);
  const size_t tb = tile_bytes(D);
  float* qs = reinterpret_cast<float*>(smem + 2 * kStages * tb);  // [kBlockQ][D]
  float* ps = qs + align16(sizeof(float) * kBlockQ * D) / sizeof(float);
  auto ktile = [&](int st) { return reinterpret_cast<float*>(smem + (2 * st) * tb); };
  auto vtile = [&](int st) { return reinterpret_cast<float*>(smem + (2 * st + 1) * tb); };

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pad_start = S - lengths[b];

  const float* qb = q + b * qst.b + h * qst.h;
  const float* kb = k + b * kst.b + hk * kst.h;
  const float* vb = v + b * vst.b + hk * vst.h;
  float* ob = o + b * ost.b + h * ost.h;

  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  int k_begin = max(pad_start, 0);
  if (window > 0) k_begin = max(k_begin, q0 - window + 1);
  const int kt_begin = (k_begin / kBlockK) * kBlockK;
  const int ntiles = k_end > kt_begin ? (k_end - kt_begin + kBlockK - 1) / kBlockK : 0;

  auto stage = [&](int t) {
    const int kt = kt_begin + t * kBlockK;
    const int st = t % kStages;
    stage_rows<float>(ktile(st), kBlockK, D, kb, [&](int j) -> const float* {
      return kt + j < S ? kb + (kt + j) * kst.s : nullptr;
    });
    stage_rows<float>(vtile(st), kBlockK, D, vb, [&](int j) -> const float* {
      return kt + j < S ? vb + (kt + j) * vst.s : nullptr;
    });
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  for (int i = threadIdx.x; i < kBlockQ * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D, s = q0 + r;
    qs[i] = s < S ? qb[s * qst.s + d] * scale : 0.f;
  }

  const int r0 = warp * kRows;
  const float* qrow[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) qrow[r] = qs + (r0 + r) * D;
  float m[kRows], l[kRows], acc[kRows][NCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + kStages - 1 < ntiles) stage(t + kStages - 1);
    cp_async_commit();

    const float* ks = ktile(t % kStages);
    const float* vs = vtile(t % kStages);
    const int kidx = kt_begin + t * kBlockK + lane;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    row_dots<float, kRows>(s, qrow, ks + lane * DS, D);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + r0 + r;
      bool ok = kidx < S && kidx >= pad_start;
      if (causal) ok = ok && kidx <= qi;
      if (window > 0) ok = ok && (qi - kidx) < window;
      const float sv = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float p = ok ? expf(sv - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      ps[(r0 + r) * kBlockK + lane] = p;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < kBlockK; ++j) {
      float vv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vs[j * DS + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = ps[(r0 + r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] += p * vv[c];
      }
    }
    __syncwarp();  // p of this tile fully read before the next tile rewrites it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[qi * ost.s + d] = acc[r][c] * inv;
    }
  }
}

template <int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, int B, int H, int Hkv, int S, int D,
                   Strides qst, Strides kst, Strides vst, Strides ost, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_fwd<NCH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lengths, H, Hkv, S, D, qst, kst,
      vst, ost, causal, window, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcWarps = 4;
constexpr int kTcBlockQ = 16 * kTcWarps;  // 16 query rows per warp
constexpr float kLog2e = 1.4426950408889634f;

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

    // O += P V, P straight from the score fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {frag::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                              frag::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                              frag::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              frag::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dd = 0; dd < DP / 16; ++dd) {
        uint32_t r[4];
        frag::ldsm_x4_trans(r, vs_ + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * STR +
                                   dd * 16 + (lane / 16) * 8);
        frag::mma_bf16(acc[2 * dd], pa, r[0], r[1]);
        frag::mma_bf16(acc[2 * dd + 1], pa, r[2], r[3]);
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

// float32: 16-byte staging needs every k/v row to start on a 16-byte boundary.
cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o,
                         const int* lengths, int B, int H, int Hkv, int S, int D, Strides qst,
                         Strides kst, Strides vst, Strides ost, int causal, int window,
                         float scale, cudaStream_t stream) {
  const long long ve = Vec<float>::kElems;
  if (!(D % ve == 0 && aligned16(k) && aligned16(v) && strides_aligned(kst, ve) &&
        strides_aligned(vst, ve)))
    return cudaErrorInvalidValue;
#define FLASH_LAUNCH(NCH)                                                             \
  return launch<NCH>(q, k, v, o, lengths, B, H, Hkv, S, D, qst, kst, vst, ost, causal, \
                     window, scale, stream)
  if (D <= 32) FLASH_LAUNCH(1);
  if (D <= 64) FLASH_LAUNCH(2);
  if (D <= 128) FLASH_LAUNCH(4);
  if (D <= 256) FLASH_LAUNCH(8);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel).
// Strides are in elements, for the b, h and s dimensions of q, k, v and o in
// that order; the d dimension is contiguous. window <= 0 means no window.
// float32: D a multiple of 16 bytes, k/v rows 16-byte aligned. bfloat16: D
// one of 64, 128, 256, q/k/v rows 16-byte aligned, o rows 4-byte aligned.
// Anything else returns cudaErrorInvalidValue; otherwise the CUDA error code
// of the launch. *kernel is set to the kernel launched: 0 = flash_fwd,
// 1 = flash_fwd_tc, -1 = none.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* lengths, int B, int H, int Hkv,
                                   int S, int D, long long qsb, long long qsh,
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
    err = dispatch_f32(q, k, v, o, len, B, H, Hkv, S, D, qst, kst, vst, ost, causal, window,
                       scale, st);
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
