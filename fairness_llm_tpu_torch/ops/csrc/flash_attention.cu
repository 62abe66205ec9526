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
// near the line between bytes and operations. This version does the
// arithmetic with scalar f32 FMAs out of shared memory, not with tensor
// cores, so it runs far from the 989 TFLOP/s bf16 bound; mma/wgmma tiles
// are the next step.
//
// Design: one block per (64-row query tile, q head, batch row). The q tile
// is scaled once into shared memory as f32. Key/value tiles of 32 rows (one
// key per lane for the scores) stream through a two-stage cp.async pipeline
// in their own dtype, so the next tile's load overlaps this tile's math.
// Each of the 8 warps owns 8 query rows and keeps their running max,
// normaliser and f32 accumulator (lanes split D) in registers; a lane reads
// its key row 16 bytes at a time against 16-byte broadcasts of q. Key tiles
// before the first valid key (left pads, window) and after the tile's last
// query (causal) are never loaded. GQA reads kv head h / rep directly.
// Strides are passed in, so q/k/v/o may be head-major views of a
// [B,S,H,D] tensor without a copy. Any S and any D <= 256: the wrapper pads
// D to a multiple of 16 bytes, and copies k/v whose rows do not start on a
// 16-byte boundary, before the launch.

#include "attention_common.cuh"

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

// Shared memory layout: kStages x (k tile, v tile) in T, then q (f32), then p.
template <typename T>
__host__ __device__ __forceinline__ size_t tile_bytes(int D) {
  return align16(sizeof(T) * kBlockK * staged_stride<T>(D));
}

template <typename T>
size_t smem_bytes(int D) {
  return 2 * kStages * tile_bytes<T>(D) + align16(sizeof(float) * kBlockQ * D) +
         sizeof(float) * kWarps * kRows * kBlockK;
}

// NCH: how many 32-wide chunks of D each lane accumulates (D <= 32 * NCH).
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, const int* __restrict__ lengths, int H, int Hkv, int S,
          int D, Strides qst, Strides kst, Strides vst, Strides ost, int causal,
          int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DS = staged_stride<T>(D);
  const size_t tb = tile_bytes<T>(D);
  float* qs = reinterpret_cast<float*>(smem + 2 * kStages * tb);  // [kBlockQ][D]
  float* ps = qs + align16(sizeof(float) * kBlockQ * D) / sizeof(float);
  auto ktile = [&](int st) { return reinterpret_cast<T*>(smem + (2 * st) * tb); };
  auto vtile = [&](int st) { return reinterpret_cast<T*>(smem + (2 * st + 1) * tb); };

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int pad_start = S - lengths[b];

  const T* qb = q + b * qst.b + h * qst.h;
  const T* kb = k + b * kst.b + hk * kst.h;
  const T* vb = v + b * vst.b + hk * vst.h;
  T* ob = o + b * ost.b + h * ost.h;

  const int q_last = min(q0 + kBlockQ, S) - 1;
  const int k_end = causal ? q_last + 1 : S;  // exclusive
  int k_begin = max(pad_start, 0);
  if (window > 0) k_begin = max(k_begin, q0 - window + 1);
  const int kt_begin = (k_begin / kBlockK) * kBlockK;
  const int ntiles = k_end > kt_begin ? (k_end - kt_begin + kBlockK - 1) / kBlockK : 0;

  auto stage = [&](int t) {
    const int kt = kt_begin + t * kBlockK;
    const int st = t % kStages;
    stage_rows<T>(ktile(st), kBlockK, D, kb, [&](int j) -> const T* {
      return kt + j < S ? kb + (kt + j) * kst.s : nullptr;
    });
    stage_rows<T>(vtile(st), kBlockK, D, vb, [&](int j) -> const T* {
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
    qs[i] = s < S ? to_f(qb[s * qst.s + d]) * scale : 0.f;
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

    const T* ks = ktile(t % kStages);
    const T* vs = vtile(t % kStages);
    const int kidx = kt_begin + t * kBlockK + lane;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    row_dots<T, kRows>(s, qrow, ks + lane * DS, D);

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
        vv[c] = d < D ? to_f(vs[j * DS + d]) : 0.f;
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
      if (d < D) ob[qi * ost.s + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, int B, int H, int Hkv, int S, int D,
                   Strides qst, Strides kst, Strides vst, Strides ost, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  auto kernel = flash_fwd<T, NCH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lengths, H, Hkv, S, D, qst, kst, vst, ost, causal, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     const int* lengths, int B, int H, int Hkv, int S, int D, Strides qst,
                     Strides kst, Strides vst, Strides ost, int causal, int window,
                     float scale, cudaStream_t stream) {
  // 16-byte staging needs every k/v row to start on a 16-byte boundary.
  const long long ve = Vec<T>::kElems;
  const bool vec = D % ve == 0 && aligned16(k) && aligned16(v) && kst.b % ve == 0 &&
                   kst.h % ve == 0 && kst.s % ve == 0 && vst.b % ve == 0 &&
                   vst.h % ve == 0 && vst.s % ve == 0;
  if (!vec) return cudaErrorInvalidValue;
#define FLASH_LAUNCH(NCH)                                                                \
  return launch<T, NCH>(q, k, v, o, lengths, B, H, Hkv, S, D, qst, kst, vst, ost, causal, \
                        window, scale, stream)
  if (D <= 32) FLASH_LAUNCH(1);
  if (D <= 64) FLASH_LAUNCH(2);
  if (D <= 128) FLASH_LAUNCH(4);
  if (D <= 256) FLASH_LAUNCH(8);
#undef FLASH_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, for the b, h and
// s dimensions of q, k, v and o in that order; the d dimension is contiguous.
// window <= 0 means no window. D must be a multiple of 16 bytes and k/v rows
// must start 16-byte aligned (cudaErrorInvalidValue otherwise). Returns the
// CUDA error code of the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const void* lengths, int B, int H, int Hkv,
                                   int S, int D, long long qsb, long long qsh,
                                   long long qss, long long ksb, long long ksh,
                                   long long kss, long long vsb, long long vsh,
                                   long long vss, long long osb, long long osh,
                                   long long oss, int causal, int window, float scale,
                                   void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Strides qst{qsb, qsh, qss}, kst{ksb, ksh, kss}, vst{vsb, vsh, vss},
      ost{osb, osh, oss};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, len, B, H, Hkv, S, D, qst, kst, vst, ost, causal,
                          window, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, len, B, H, Hkv, S, D, qst, kst, vst, ost,
                                  causal, window, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
