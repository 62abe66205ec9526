// Pieces shared by the port's attention kernels (flash_attention.cu,
// decode_attention.cu, decode_attention_f32.cu, decode_verify_f32.cu):
// element conversion, warp reductions, and a multi-stage pipeline that
// stages k/v tiles into shared memory with cp.async, so the loads of the
// next tiles are in flight while the block computes on the current one.
// Staged rows may be float, bf16 or int8 (the quantised KV cache).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Elements of T in one 16-byte vector.
template <typename T>
struct Vec {
  static constexpr int kElems = 16 / sizeof(T);
};

// Row stride of a staged tile, in elements: one spare 16-byte chunk per row,
// so 32 lanes reading 16 bytes each from 32 different rows hit distinct
// banks (row stride = 4 words mod 32).
template <typename T>
__host__ __device__ __forceinline__ int staged_stride(int D) {
  return D + Vec<T>::kElems;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n));
}

// A 4-byte copy (a per-slot scale); pred false zero-fills it.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage `rows` rows of D elements into dst (row stride staged_stride<T>(D))
// with 16-byte cp.async copies: D * sizeof(T) must be a multiple of 16 and
// every row must start on a 16-byte boundary (the wrappers see to both).
// row_ptr(j) returns row j's first element in global memory, or nullptr for
// a row past the end, which is zero-filled.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int D, const T* any_valid,
                                           RowPtr row_ptr) {
  const int DS = staged_stride<T>(D);
  constexpr int VE = Vec<T>::kElems;
  const int cpr = D / VE;
  for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
    const int j = i / cpr, c = i - j * cpr;
    const T* src = row_ptr(j);
    cp_async16(dst + j * DS + c * VE, src ? src + c * VE : any_valid, src != nullptr);
  }
}

// Whether a pointer starts on a 16-byte boundary.
__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// VE = Vec<T>::kElems elements of a staged row (16 bytes, 16-byte aligned)
// as floats; an int8 row gives the raw int8 values.
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[Vec<T>::kElems]) {
  constexpr int VE = Vec<T>::kElems;
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  if constexpr (sizeof(T) == 1) {
    const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int e = 0; e < VE / 4; ++e) {
      f[4 * e] = static_cast<float>(c[e].x);
      f[4 * e + 1] = static_cast<float>(c[e].y);
      f[4 * e + 2] = static_cast<float>(c[e].z);
      f[4 * e + 3] = static_cast<float>(c[e].w);
    }
  } else if constexpr (sizeof(T) == 2) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < VE / 2; ++e) {
      const float2 x = __bfloat1622float2(h[e]);
      f[2 * e] = x.x;
      f[2 * e + 1] = x.y;
    }
  } else {
    const float* x = reinterpret_cast<const float*>(&raw);
#pragma unroll
    for (int e = 0; e < VE; ++e) f[e] = x[e];
  }
}

// acc[r] += dot(q row r (f32, shared, the rows D floats apart from q),
// staged key row (T, shared)) over D for r < nr (warp-uniform); D is a
// multiple of Vec<T>::kElems, so q rows start 16-byte aligned. An int8 row
// gives the dot of q with the raw int8 values.
template <typename T, int R>
__device__ __forceinline__ void strided_row_dots(float (&acc)[R], const float* q, const T* krow,
                                                 int D, int nr) {
  constexpr int VE = Vec<T>::kElems;
  for (int d0 = 0; d0 < D; d0 += VE) {
    float kf[VE];
    load_vec<T>(krow + d0, kf);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;  // warp-uniform
      const float4* q4 = reinterpret_cast<const float4*>(q + r * D + d0);
#pragma unroll
      for (int e4 = 0; e4 < VE / 4; ++e4) {
        const float4 qv = q4[e4];
        acc[r] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] + qv.z * kf[4 * e4 + 2] +
                  qv.w * kf[4 * e4 + 3];
      }
    }
  }
}

// The quad layout of eight query rows a warp on scalar f32 FMAs (float32
// prefill and a decode prefix block): lane 4 * r + g holds row r's query
// and accumulator for DP of the columns of the head width D = 4 * DP, in
// registers: the 16-byte chunks g, g + 4, g + 8, ... (element 4 * d4 + e of
// the lane's arrays is column 4 * g + 16 * d4 + e), so that the quad's four
// lanes read 64 contiguous bytes of a staged row, free of bank conflicts
// (contiguous quarters put the four lanes on one bank at D = 128). A
// 32-key tile then costs a lane 32 * DP FMAs for the scores and as many for
// P.V, and 50 shuffles, where one key a lane shuffles each row's 32 weights
// to every lane (256 for eight rows):
// - the lane's partial scores over its columns for all 32 keys, from the
//   staged key rows (16-byte loads, rows DS floats apart);
// - a reduce-scatter over the row's four lanes (16 then 8 shuffles): lane g
//   ends with the full scores of keys 8g ..< 8g + 8;
// - the row's max over the quad (2 shuffles), the weights, the normaliser's
//   share of this lane (summed over the quad at the end);
// - an all-gather of the row's 32 weights over the quad (8 then 16
//   shuffles), and acc += P.V from the staged value rows.
// Scores are in log2 units (q scaled by the softmax scale times log2(e));
// ok(j) says whether key j of the tile is visible to this lane's row; a
// row with no visible key yet keeps m = kNegInf, and its weights are 0.
template <int DP, typename Ok>
__device__ __forceinline__ void quad_tile(const float (&qr)[DP], const float* kt, const float* vt,
                                          int DS, Ok ok, float& m, float& l,
                                          float (&acc)[DP]) {
  static_assert(DP % 4 == 0, "a lane's columns are whole 16-byte vectors");
  const int g = threadIdx.x & 3;
  const bool hi1 = g & 1, hi2 = g & 2;
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float4* kr = reinterpret_cast<const float4*>(kt + j * DS + 4 * g);
    float x = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 kv = kr[4 * d4];
      x += qr[4 * d4] * kv.x + qr[4 * d4 + 1] * kv.y + qr[4 * d4 + 2] * kv.z +
           qr[4 * d4 + 3] * kv.w;
    }
    s[j] = x;
  }
  // Reduce-scatter over the quad: lanes g and g ^ 2 split the 32 keys in
  // halves, then lanes g and g ^ 1 the halves in quarters.
  float h[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float send = hi2 ? s[i] : s[16 + i];
    h[i] = (hi2 ? s[16 + i] : s[i]) + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  float e[8];
  bool vis[8];
  float mx = m;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float send = hi1 ? h[i] : h[8 + i];
    e[i] = (hi1 ? h[8 + i] : h[i]) + __shfl_xor_sync(0xffffffffu, send, 1);
    vis[i] = ok(8 * g + i);
    if (vis[i]) mx = fmaxf(mx, e[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float alpha = exp2f(m - mx);  // 1 while the row has seen no key
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    e[i] = vis[i] ? exp2f(e[i] - mx) : 0.f;
    sum += e[i];
  }
  l = l * alpha + sum;
  m = mx;
  // All-gather the row's weights: keys 8g' + i from lane g' of the quad.
  float p16[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float other = __shfl_xor_sync(0xffffffffu, e[i], 1);
    p16[i] = hi1 ? other : e[i];
    p16[8 + i] = hi1 ? e[i] : other;
  }
  float p[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float other = __shfl_xor_sync(0xffffffffu, p16[i], 2);
    p[i] = hi2 ? other : p16[i];
    p[16 + i] = hi2 ? p16[i] : other;
  }
#pragma unroll
  for (int d = 0; d < DP; ++d) acc[d] *= alpha;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float4* vr = reinterpret_cast<const float4*>(vt + j * DS + 4 * g);
#pragma unroll
    for (int d4 = 0; d4 < DP / 4; ++d4) {
      const float4 vv = vr[4 * d4];
      acc[4 * d4] += p[j] * vv.x;
      acc[4 * d4 + 1] += p[j] * vv.y;
      acc[4 * d4 + 2] += p[j] * vv.z;
      acc[4 * d4 + 3] += p[j] * vv.w;
    }
  }
}

}  // namespace attn
