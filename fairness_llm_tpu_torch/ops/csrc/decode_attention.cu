// Single-token decode attention over each row's own KV cache, seeded by a
// prompt prefix shared by every row, for Hopper (sm_90a).
//
// Replaces: fairness_llm_tpu/ops/decode_attention.py, `decode_attention`
// with 3-D q -> `_kernel`, non-quantised branch (the Pallas TPU kernel). Same
// function: q [B,H,D] against the shared prefix k/v [P,Hkv,D] (always
// visible) followed by the row's cache k/v [B,L,Hkv,D] under valid [B,L];
// one joint online softmax in f32; scale D^-0.5; head h reads kv head
// h / rep; the output is acc / max(l, 1e-30).
//
// What bounds it on the H100: one query per row does ~4*D operations for
// every 2*2*D bytes of k/v it reads, about one operation per byte, so the
// bound is the bytes of the cache and the prefix over 3.35 TB/s.
//
// Design: one block per (kv head, batch row). The block handles all rep q
// heads of that kv head, so each k/v tile is read from device memory once,
// not rep times. It reads the cache in its native [B,L,Hkv,D] layout; the
// TPU kernel's per-step head-major transposes, which its own record names as
// that kernel's cost, are gone. The block walks P + L "virtual" keys in
// tiles of 32 (one key per lane): keys below P come from the shared prefix,
// which needs no padding, the rest from the row's cache under `valid`.
// Tiles stream through a four-stage cp.async pipeline, so three tiles' loads
// are in flight while the block computes on the fourth; that is what hides
// device-memory latency with only B * Hkv blocks. Each warp owns rep/4 q
// heads and keeps their running max, normaliser and accumulator (lanes split
// D) in registers. Any B, any L, any P, any D <= 256: the wrapper pads D to
// a multiple of 16 bytes before the launch. Splitting L across blocks (for
// small B * Hkv), wgmma and TMA come later.

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int kBlockK = 32;  // keys per tile: one per lane
constexpr int kWarps = 4;
constexpr int kStages = 4;

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Shared memory layout: kStages x (k tile, v tile) in T, then q (f32), then p.
template <typename T>
__host__ __device__ __forceinline__ size_t tile_bytes(int D) {
  return align16(sizeof(T) * kBlockK * staged_stride<T>(D));
}

template <typename T>
size_t smem_bytes(int rep, int D) {
  return 2 * kStages * tile_bytes<T>(D) + align16(sizeof(float) * rep * D) +
         sizeof(float) * rep * kBlockK;
}

// RPW: q heads per warp (rep <= kWarps * RPW). NCH: 32-wide chunks of D per
// lane (D <= 32 * NCH).
template <typename T, int RPW, int NCH>
__global__ void __launch_bounds__(kWarps * 32)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const uint8_t* __restrict__ valid, const T* __restrict__ sk,
           const T* __restrict__ sv, T* __restrict__ o, int H, int Hkv, int L, int D,
           int P, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rep = H / Hkv;
  const int DS = staged_stride<T>(D);
  const size_t tb = tile_bytes<T>(D);
  float* qs = reinterpret_cast<float*>(smem + 2 * kStages * tb);  // [rep][D]
  float* ps = qs + align16(sizeof(float) * rep * D) / sizeof(float);  // [rep][kBlockK]
  auto ktile = [&](int st) { return reinterpret_cast<T*>(smem + (2 * st) * tb); };
  auto vtile = [&](int st) { return reinterpret_cast<T*>(smem + (2 * st + 1) * tb); };

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int N = P + L;
  const int ntiles = (N + kBlockK - 1) / kBlockK;
  const long long row_stride = (long long)Hkv * D;  // between slots, in elements
  const T* kc = k + (long long)b * L * row_stride + (long long)hk * D;
  const T* vc = v + (long long)b * L * row_stride + (long long)hk * D;
  const T* skh = sk == nullptr ? nullptr : sk + (long long)hk * D;
  const T* svh = sv == nullptr ? nullptr : sv + (long long)hk * D;

  auto stage = [&](int t) {
    const int kt = t * kBlockK;
    const int st = t % kStages;
    stage_rows<T>(ktile(st), kBlockK, D, kc, [&](int j) -> const T* {
      const int n = kt + j;
      return n < P ? skh + n * row_stride : (n < N ? kc + (n - P) * row_stride : nullptr);
    });
    stage_rows<T>(vtile(st), kBlockK, D, vc, [&](int j) -> const T* {
      const int n = kt + j;
      return n < P ? svh + n * row_stride : (n < N ? vc + (n - P) * row_stride : nullptr);
    });
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) stage(s);
    cp_async_commit();
  }

  const T* qb = q + ((long long)b * H + (long long)hk * rep) * D;
  for (int i = threadIdx.x; i < rep * D; i += blockDim.x) qs[i] = to_f(qb[i]) * scale;

  // Rows past rep point at row 0; their results are never used.
  const float* qrow[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + kWarps * r;
    qrow[r] = qs + (row < rep ? row : 0) * D;
  }
  float m[RPW], l[RPW], acc[RPW][NCH];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;
  }

  const uint8_t* vrow = valid + (long long)b * L;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + kStages - 1 < ntiles) stage(t + kStages - 1);
    cp_async_commit();

    const T* ks = ktile(t % kStages);
    const T* vs = vtile(t % kStages);
    const int n = t * kBlockK + lane;
    const bool ok = n < P || (n < N && vrow[n - P] != 0);
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    row_dots<T, RPW>(s, qrow, ks + lane * DS, D);

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = warp + kWarps * r;
      if (row >= rep) break;  // warp-uniform
      const float sv_ = ok ? s[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv_));
      const float p = ok ? expf(sv_ - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      ps[row * kBlockK + lane] = p;
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
      for (int r = 0; r < RPW; ++r) {
        const int row = warp + kWarps * r;
        if (row >= rep) break;
        const float p = ps[row * kBlockK + j];
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] += p * vv[c];
      }
    }
    __syncwarp();  // p of this tile fully read before the next tile rewrites it
  }
  cp_async_wait<0>();

  T* ob = o + ((long long)b * H + (long long)hk * rep) * D;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = warp + kWarps * r;
    if (row >= rep) break;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[row * D + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <typename T, int RPW, int NCH>
cudaError_t launch(const void* q, const void* k, const void* v, const uint8_t* valid,
                   const void* sk, const void* sv, void* o, int B, int H, int Hkv, int L,
                   int D, int P, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(H / Hkv, D);
  auto kernel = decode_fwd<T, RPW, NCH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
      static_cast<const T*>(sk), static_cast<const T*>(sv), static_cast<T*>(o), H, Hkv, L,
      D, P, scale);
  return cudaGetLastError();
}

#define DECODE_ARGS q, k, v, valid, sk, sv, o, B, H, Hkv, L, D, P, scale, stream
#define DECODE_PARAMS                                                                 \
  const void *q, const void *k, const void *v, const uint8_t *valid, const void *sk, \
      const void *sv, void *o, int B, int H, int Hkv, int L, int D, int P, float scale, \
      cudaStream_t stream

template <typename T, int RPW>
cudaError_t dispatch_d(DECODE_PARAMS) {
  if (D <= 32) return launch<T, RPW, 1>(DECODE_ARGS);
  if (D <= 64) return launch<T, RPW, 2>(DECODE_ARGS);
  if (D <= 128) return launch<T, RPW, 4>(DECODE_ARGS);
  if (D <= 256) return launch<T, RPW, 8>(DECODE_ARGS);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(DECODE_PARAMS) {
  // 16-byte staging needs every k/v row (of the cache and of the prefix) to
  // start on a 16-byte boundary.
  const bool vec = D % Vec<T>::kElems == 0 && aligned16(k) && aligned16(v) &&
                   (P == 0 || (aligned16(sk) && aligned16(sv)));
  if (!vec) return cudaErrorInvalidValue;
  const int rep = H / Hkv;
  if (rep <= kWarps) return dispatch_d<T, 1>(DECODE_ARGS);
  if (rep <= 2 * kWarps) return dispatch_d<T, 2>(DECODE_ARGS);
  if (rep <= 4 * kWarps) return dispatch_d<T, 4>(DECODE_ARGS);
  if (rep <= 8 * kWarps) return dispatch_d<T, 8>(DECODE_ARGS);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q [B,H,D], k/v [B,L,Hkv,D], valid [B,L]
// (one byte per slot), sk/sv [P,Hkv,D] (ignored when P == 0), o [B,H,D], all
// contiguous, 16-byte aligned, with D a multiple of 16 bytes
// (cudaErrorInvalidValue otherwise). Returns the CUDA error code of the launch.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                    const void* valid, const void* sk, const void* sv,
                                    void* o, int B, int H, int Hkv, int L, int D, int P,
                                    float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || L < 0 || P < 0 || P + L <= 0)
    return (int)cudaErrorInvalidValue;
  if (P == 0) sk = sv = nullptr;
  const uint8_t* val = static_cast<const uint8_t*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, val, sk, sv, o, B, H, Hkv, L, D, P, scale, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, val, sk, sv, o, B, H, Hkv, L, D, P, scale, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
