// Decode attention over each row's own KV cache, seeded by a prompt prefix
// shared by every row, for Hopper (sm_90a): one query per row, or a
// speculative verify window of Q queries per row, over a float or an int8
// cache.
//
// Replaces: fairness_llm_tpu/ops/decode_attention.py, `decode_attention`
// (the Pallas TPU kernels): 3-D q -> `_kernel`, float cache (K2) and its
// `quant=True` branch (K2q); 4-D q -> `_kernel_multi`, float and int8 cache
// (K3). Same function: q [B,Q,H,D] (Q = 1 for 3-D q) against the shared
// prefix k/v [P,Hkv,D] (always visible) followed by the row's cache k/v
// [B,L,Hkv,D] under valid [B,L]; for Q > 1 query i of row b sees cache slot
// j only where j <= q_offsets[b] + i. One joint online softmax in f32; scale
// D^-0.5; head h reads kv head h / rep; the output is acc / max(l, 1e-30).
// With an int8 cache (scales ks/vs [B,L,Hkv] f32) the k-scale multiplies
// the score before the mask and the max, the normaliser l sums the unscaled
// p, and PV takes p * v-scale; the prefix stays float.
//
// What bounds it on the H100: one query per row does ~4*D operations for
// every 2*2*D bytes of k/v it reads, about one operation per byte, so K2 is
// bound by the bytes of the cache and the prefix over 3.35 TB/s. A verify
// window of Q queries does Q times the operations on the same bytes (~18
// operations per byte for llama3-8b's 36 query rows per kv head); on
// scalar f32 FMAs that is closer to the FMA rate than to the byte rate.
//
// Design: one block per (kv head, batch row, chunk of query rows). The
// block handles the rep * Q query rows of that kv head (one query per row:
// all rep rows, at most 32; a verify window: chunks of at most 12 over
// grid.z), so each k/v tile is read from device memory once per chunk, not
// once per query head. It reads the cache in its native [B,L,Hkv,D] layout.
// Tiles of 32 keys (one key per lane) stream through a cp.async pipeline of
// four stages (two for a verify window), so the next tiles' loads are in
// flight while the block computes on the current one. Each warp owns up to
// RPW query rows and keeps their running max, normaliser and accumulator
// (lanes split D) in registers. A float cache walks P + L "virtual" keys,
// where a tile may straddle the end of the prefix; an int8 cache walks the
// prefix tiles (float) and then the cache tiles (int8, with their 32 k and
// v scales staged beside them), so a stage holds one row type. Any B, L,
// P, Q <= 64, D <= 256: the wrapper pads D to a multiple of 16 bytes (16
// elements for an int8 cache) before the launch. The products run on scalar
// f32 FMAs, every warp re-reading its q rows from shared memory for each
// key chunk; tensor-core tiles for the verify window (mma.sync, with q in
// registers), splitting L across blocks, wgmma and TMA come later.

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kBlockK = 32;  // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kStages = 4;
constexpr int kMaxRows = 32;  // query rows per block at most (kWarps * the largest RPW)
// The verify window is bound by its shared-memory loads and instruction
// latency, not by device memory: two pipeline stages and at most 12 rows a
// block put more warps on each SM (the fastest of the settings tried on an
// H100 80GB HBM3 at 700 W; see PERF.md).
constexpr int kStagesMulti = 2;
constexpr int kMultiRows = 12;

template <bool MULTI>
__host__ __device__ constexpr int stages() { return MULTI ? kStagesMulti : kStages; }

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// One staged k (or v) tile. Rows of T are the widest a stage holds: an int8
// cache tile (D + 16 bytes a row) always fits in a T tile's room.
template <typename T>
__host__ __device__ __forceinline__ size_t tile_bytes(int D) {
  return align16(sizeof(T) * kBlockK * staged_stride<T>(D));
}

// One stage: the k tile, the v tile, and (int8 cache) 32 k and 32 v scales.
template <typename T, bool QUANT>
__host__ __device__ __forceinline__ size_t stage_bytes(int D) {
  return 2 * tile_bytes<T>(D) + (QUANT ? 2 * kBlockK * sizeof(float) : 0);
}

// Shared memory: the pipeline's stages, then q (f32) and p for the block's rows.
template <typename T, bool QUANT, bool MULTI>
size_t smem_bytes(int rows, int D) {
  return stages<MULTI>() * stage_bytes<T, QUANT>(D) + align16(sizeof(float) * rows * D) +
         sizeof(float) * rows * kBlockK;
}

// T: type of q, the prefix and the output. KT: the cache's type (T, or
// int8_t with scales). MULTI: a verify window with q_offsets. RPW: query
// rows per warp (rows per block <= kWarps * RPW). NCH: 32-wide chunks of D
// per lane (D <= 32 * NCH).
template <typename T, typename KT, bool MULTI, int RPW, int NCH>
__global__ void __launch_bounds__(kWarps * 32)
decode_fwd(const T* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
           const uint8_t* __restrict__ valid, const T* __restrict__ sk,
           const T* __restrict__ sv, const float* __restrict__ ksc,
           const float* __restrict__ vsc, const int* __restrict__ qoff, T* __restrict__ o,
           int Q, int H, int Hkv, int L, int D, int P, int rows_per_block, float scale) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  constexpr int NS = stages<MULTI>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / Hkv;
  const int DS = staged_stride<T>(D);
  const int DS8 = staged_stride<int8_t>(D);
  const size_t tb = tile_bytes<T>(D);
  const size_t sb = stage_bytes<T, QUANT>(D);
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * rows_per_block;
  const int nrows = min(rows_per_block, rep * Q - row0);
  float* qs = reinterpret_cast<float*>(smem + NS * sb);  // [nrows][D]
  float* ps = qs + align16(sizeof(float) * nrows * D) / sizeof(float);  // [nrows][kBlockK]
  auto ktile = [&](int st) { return smem + st * sb; };
  auto vtile = [&](int st) { return smem + st * sb + tb; };
  auto kscale = [&](int st) { return reinterpret_cast<float*>(smem + st * sb + 2 * tb); };
  auto vscale = [&](int st) { return kscale(st) + kBlockK; };

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // An int8 cache walks ntp prefix tiles and then ntc cache tiles; a float
  // cache walks P + L virtual keys (ntp unused).
  const int ntp = QUANT ? (P + kBlockK - 1) / kBlockK : 0;
  const int N = P + L;
  const int ntiles = QUANT ? ntp + (L + kBlockK - 1) / kBlockK : (N + kBlockK - 1) / kBlockK;
  const long long row_stride = (long long)Hkv * D;  // between slots, in elements
  const KT* kc = k + (long long)b * L * row_stride + (long long)hk * D;
  const KT* vc = v + (long long)b * L * row_stride + (long long)hk * D;
  const T* skh = sk == nullptr ? nullptr : sk + (long long)hk * D;
  const T* svh = sv == nullptr ? nullptr : sv + (long long)hk * D;
  const long long scale_base = (long long)b * L * Hkv + hk;  // + slot * Hkv

  auto stage = [&](int t) {
    const int st = t % NS;
    if constexpr (QUANT) {
      if (t < ntp) {
        const int n0 = t * kBlockK;
        stage_rows<T>(reinterpret_cast<T*>(ktile(st)), kBlockK, D, skh, [&](int j) -> const T* {
          return n0 + j < P ? skh + (n0 + j) * row_stride : nullptr;
        });
        stage_rows<T>(reinterpret_cast<T*>(vtile(st)), kBlockK, D, svh, [&](int j) -> const T* {
          return n0 + j < P ? svh + (n0 + j) * row_stride : nullptr;
        });
      } else {
        const int j0 = (t - ntp) * kBlockK;
        stage_rows<int8_t>(reinterpret_cast<int8_t*>(ktile(st)), kBlockK, D, kc,
                           [&](int j) -> const int8_t* {
                             return j0 + j < L ? kc + (j0 + j) * row_stride : nullptr;
                           });
        stage_rows<int8_t>(reinterpret_cast<int8_t*>(vtile(st)), kBlockK, D, vc,
                           [&](int j) -> const int8_t* {
                             return j0 + j < L ? vc + (j0 + j) * row_stride : nullptr;
                           });
        if (threadIdx.x < 2 * kBlockK) {
          const int j = threadIdx.x % kBlockK;
          const bool in = j0 + j < L;
          const float* src = (threadIdx.x < kBlockK ? ksc : vsc) +
                             (in ? scale_base + (long long)(j0 + j) * Hkv : 0);
          float* dst = (threadIdx.x < kBlockK ? kscale(st) : vscale(st)) + j;
          cp_async4(dst, src, in);
        }
      }
    } else {
      const int kt = t * kBlockK;
      stage_rows<T>(reinterpret_cast<T*>(ktile(st)), kBlockK, D, kc, [&](int j) -> const T* {
        const int n = kt + j;
        return n < P ? skh + n * row_stride : (n < N ? kc + (n - P) * row_stride : nullptr);
      });
      stage_rows<T>(reinterpret_cast<T*>(vtile(st)), kBlockK, D, vc, [&](int j) -> const T* {
        const int n = kt + j;
        return n < P ? svh + n * row_stride : (n < N ? vc + (n - P) * row_stride : nullptr);
      });
    }
  };

#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  // Block row r is query row g = row0 + r of this kv head: query i = g / rep
  // of q head hk * rep + g % rep.
  auto qoffset = [&](int r) {
    const int g = row0 + r;
    return (((long long)b * Q + g / rep) * H + (long long)hk * rep + g % rep) * D;
  };
  for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
    const int r = i / D;
    qs[i] = to_f(q[qoffset(r) + (i - r * D)]) * scale;
  }

  // This warp's rows are warp + kWarps * r for r < nr. Rows past nrows
  // point at row 0; their results are never used.
  const int nr = nrows > warp ? (nrows - warp + kWarps - 1) / kWarps : 0;
  const float* qrow[RPW];
  int lim[RPW];  // MULTI: the last own-cache slot each row may see
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + kWarps * r;
    qrow[r] = qs + (row < nrows ? row : 0) * D;
    lim[r] = 0;
    if constexpr (MULTI) {
      if (row < nrows) lim[r] = qoff[b] + (row0 + row) / rep;
    }
  }
  float m[RPW], l[RPW], acc[RPW][NCH];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;
  }
  // Rows computed in the dot products: a warp's valid rows for a verify
  // window, all RPW otherwise (the one-query dispatch fills them).
  const int nr_dots = MULTI ? nr : RPW;

  const uint8_t* vrow = valid + (long long)b * L;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + NS - 1 < ntiles) stage(t + NS - 1);
    cp_async_commit();

    const int st = t % NS;
    // pre: a tile of prefix keys, float rows (always, for a float cache).
    const bool pre = !QUANT || t < ntp;
    // slot: the lane's own-cache slot (< 0 for a prefix key); ok: the key
    // exists and, in the cache, is valid.
    int slot;
    bool ok;
    if constexpr (QUANT) {
      slot = pre ? -1 : (t - ntp) * kBlockK + lane;
      ok = pre ? t * kBlockK + lane < P : (slot < L && vrow[slot] != 0);
    } else {
      const int n = t * kBlockK + lane;
      slot = n - P;
      ok = n < P || (n < N && vrow[slot] != 0);
    }
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    float vs_lane = 1.f;
    if (pre) {
      row_dots<T, RPW>(s, qrow, reinterpret_cast<const T*>(ktile(st)) + lane * DS, D, nr_dots);
    } else {
      row_dots<int8_t, RPW>(s, qrow, reinterpret_cast<const int8_t*>(ktile(st)) + lane * DS8, D,
                            nr_dots);
      const float ks_lane = kscale(st)[lane];
      vs_lane = vscale(st)[lane];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] *= ks_lane;
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (r >= nr) break;  // warp-uniform
      const int row = warp + kWarps * r;
      bool okr = ok;
      if constexpr (MULTI) okr = ok && (slot < 0 || slot <= lim[r]);
      const float sv_ = okr ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv_));
      const float p = okr ? expf(sv_ - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);  // the normaliser sums the unscaled p
      m[r] = m_new;
      ps[row * kBlockK + lane] = p * vs_lane;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < kBlockK; ++j) {
      float vv[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int d = lane + 32 * c;
        if (d >= D)
          vv[c] = 0.f;
        else if (pre)
          vv[c] = to_f(reinterpret_cast<const T*>(vtile(st))[j * DS + d]);
        else
          vv[c] = to_f(reinterpret_cast<const int8_t*>(vtile(st))[j * DS8 + d]);
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        if (r >= nr) break;
        const float p = ps[(warp + kWarps * r) * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] += p * vv[c];
      }
    }
    __syncwarp();  // p of this tile fully read before the next tile rewrites it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (r >= nr) break;
    const int row = warp + kWarps * r;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = o + qoffset(row);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const uint8_t* valid;
  const void *sk, *sv;
  const float *ks, *vs;
  const int* qoff;
  void* o;
  int B, Q, H, Hkv, L, D, P;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KT, bool MULTI, int RPW, int NCH>
cudaError_t launch(const Args& a) {
  constexpr bool QUANT = std::is_same<KT, int8_t>::value;
  // Query rows of one kv head, in chunks over grid.z of at most kWarps * RPW
  // rows (and at most kMultiRows for a verify window).
  const int rows = (a.H / a.Hkv) * a.Q;
  const int cap = MULTI && kMultiRows < kWarps * RPW ? kMultiRows : kWarps * RPW;
  const int nz = (rows + cap - 1) / cap;
  const int rows_per_block = (rows + nz - 1) / nz;
  const size_t smem = smem_bytes<T, QUANT, MULTI>(rows_per_block, a.D);
  auto kernel = decode_fwd<T, KT, MULTI, RPW, NCH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv, a.B, nz);
  kernel<<<grid, kWarps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KT*>(a.k), static_cast<const KT*>(a.v),
      a.valid, static_cast<const T*>(a.sk), static_cast<const T*>(a.sv), a.ks, a.vs, a.qoff,
      static_cast<T*>(a.o), a.Q, a.H, a.Hkv, a.L, a.D, a.P, rows_per_block, a.scale);
  return cudaGetLastError();
}

template <typename T, typename KT, bool MULTI, int RPW>
cudaError_t dispatch_d(const Args& a) {
  if (a.D <= 32) return launch<T, KT, MULTI, RPW, 1>(a);
  if (a.D <= 64) return launch<T, KT, MULTI, RPW, 2>(a);
  if (a.D <= 128) return launch<T, KT, MULTI, RPW, 4>(a);
  if (a.D <= 256) return launch<T, KT, MULTI, RPW, 8>(a);
  return cudaErrorInvalidValue;
}

template <typename T, typename KT, bool MULTI>
cudaError_t dispatch_rows(const Args& a) {
  const int rows = (a.H / a.Hkv) * a.Q;
  static_assert(kMaxRows == 8 * kWarps, "the largest RPW fills kMaxRows");
  if constexpr (MULTI) {
    // Two widths keep the build short: a warp's unused rows skip the
    // products, so a wider RPW costs registers, not work.
    if (rows <= 2 * kWarps) return dispatch_d<T, KT, MULTI, 2>(a);
    return dispatch_d<T, KT, MULTI, 8>(a);
  } else {
    if (rows <= kWarps) return dispatch_d<T, KT, MULTI, 1>(a);
    if (rows <= 2 * kWarps) return dispatch_d<T, KT, MULTI, 2>(a);
    if (rows <= 4 * kWarps) return dispatch_d<T, KT, MULTI, 4>(a);
    return dispatch_d<T, KT, MULTI, 8>(a);
  }
}

template <typename T, typename KT>
cudaError_t dispatch(const Args& a) {
  // 16-byte staging needs every k/v row (of the cache and of the prefix) to
  // start on a 16-byte boundary and hold a multiple of 16 bytes.
  const bool vec = a.D % Vec<T>::kElems == 0 && a.D % Vec<KT>::kElems == 0 &&
                   aligned16(a.k) && aligned16(a.v) &&
                   (a.P == 0 || (aligned16(a.sk) && aligned16(a.sv)));
  if (!vec) return cudaErrorInvalidValue;
  if (a.qoff != nullptr) return dispatch_rows<T, KT, true>(a);
  if (a.H / a.Hkv > kMaxRows) return cudaErrorInvalidValue;
  return dispatch_rows<T, KT, false>(a);
}

template <typename T>
cudaError_t dispatch_cache(const Args& a, bool kv_int8) {
  return kv_int8 ? dispatch<T, int8_t>(a) : dispatch<T, T>(a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, the prefix, a float cache, the
// output). kv_int8: the cache k/v are int8 with scales ks/vs [B,L,Hkv] f32.
// q [B,Q,H,D] (Q = 1: one query per row; q_offsets is then ignored and may
// be null), k/v [B,L,Hkv,D], valid [B,L] (one byte per slot), sk/sv
// [P,Hkv,D] (ignored when P == 0), q_offsets [B] int32 (required for Q > 1),
// o like q; all contiguous, 16-byte aligned, D a multiple of 16 bytes of
// each row type (cudaErrorInvalidValue otherwise). Returns the CUDA error
// code of the launch.
extern "C" int decode_attention_fwd(int dtype, int kv_int8, const void* q, const void* k,
                                    const void* v, const void* valid, const void* sk,
                                    const void* sv, const void* ks, const void* vs,
                                    const void* q_offsets, void* o, int B, int Q, int H,
                                    int Hkv, int L, int D, int P, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || L < 0 || P < 0 || P + L <= 0 || Q < 1 || Q > 64)
    return (int)cudaErrorInvalidValue;
  if ((Q > 1 && q_offsets == nullptr) || (kv_int8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{q,    k,    v,    static_cast<const uint8_t*>(valid),
         P ? sk : nullptr, P ? sv : nullptr,
         static_cast<const float*>(ks), static_cast<const float*>(vs),
         Q > 1 ? static_cast<const int*>(q_offsets) : nullptr,
         o,    B,    Q,    H,    Hkv, L, D, P, scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_cache<float>(a, kv_int8 != 0);
  else if (dtype == 1)
    err = dispatch_cache<__nv_bfloat16>(a, kv_int8 != 0);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
