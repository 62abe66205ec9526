// Pieces shared by the port's attention kernels (flash_attention.cu,
// decode_attention.cu): element conversion, warp reductions, and a
// multi-stage pipeline that stages k/v tiles into shared memory with
// cp.async, so the loads of the next tiles are in flight while the block
// computes on the current one. Staged rows may be float, bf16 or int8 (the
// quantised KV cache).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -1e30f;

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

// acc += dot(q row (f32, shared), staged key row (T, shared)) over D, for
// the first nr of R query rows (nr is warp-uniform; the default computes
// all R); D is a multiple of Vec<T>::kElems, so q rows start 16-byte
// aligned. An int8 row gives the dot of q with the raw int8 values.
template <typename T, int R>
__device__ __forceinline__ void row_dots(float (&acc)[R], const float* const* q,
                                         const T* krow, int D, int nr = R) {
  constexpr int VE = Vec<T>::kElems;
  for (int d0 = 0; d0 < D; d0 += VE) {
    float kf[VE];
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + d0);
    if constexpr (sizeof(T) == 1) {
      const char4* c = reinterpret_cast<const char4*>(&raw);
#pragma unroll
      for (int e = 0; e < VE / 4; ++e) {
        kf[4 * e] = static_cast<float>(c[e].x);
        kf[4 * e + 1] = static_cast<float>(c[e].y);
        kf[4 * e + 2] = static_cast<float>(c[e].z);
        kf[4 * e + 3] = static_cast<float>(c[e].w);
      }
    } else if constexpr (sizeof(T) == 2) {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < VE / 2; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
    } else {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int e = 0; e < VE; ++e) kf[e] = f[e];
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= nr) break;  // warp-uniform; never taken when nr == R
      const float4* q4 = reinterpret_cast<const float4*>(q[r] + d0);
#pragma unroll
      for (int e4 = 0; e4 < VE / 4; ++e4) {
        const float4 qv = q4[e4];
        acc[r] += qv.x * kf[4 * e4] + qv.y * kf[4 * e4 + 1] + qv.z * kf[4 * e4 + 2] +
                  qv.w * kf[4 * e4 + 3];
      }
    }
  }
}

}  // namespace attn
