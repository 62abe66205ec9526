// The fold of the split decode kernels' partials (decode_attention.cu's
// decode_split_tc and decode_verify_tc, decode_attention_f32.cu's
// decode_split_f32, decode_verify_f32.cu's verify_split_f32): each key split of a call writes its f32 partials (m in
// log2 units, l, acc) to a workspace, and combine_splits, the call's second
// launch, folds them in split order, so repeated calls agree bit for bit.

#pragma once

#include <type_traits>

#include "attention_common.cuh"
#include "mma_fragments.cuh"

namespace attn {

// Folds the partials of nsplit key splits into nrows output rows of width D
// (a multiple of 4): acc [nsplit][nrows][D] f32 at ws, then (m, l)
// [nsplit][nrows] with m in log2 units. In split order, out = sum_s w_s
// acc_s / max(sum_s w_s l_s, 1e-30) with w_s = 2^(m_s - max m); a split in
// which the row saw no key (l_s = 0) is skipped. One thread per 4 columns.
// Any kernel that writes this layout can use it (decode_split_tc writes it
// with Q = 1).
template <typename T>
__global__ void __launch_bounds__(256)
combine_splits(const float* __restrict__ ws, T* __restrict__ o, int nsplit, long long nrows,
               int D) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int cpr = D / 4;
  if (i >= nrows * cpr) return;
  const long long r = i / cpr;
  const int c = static_cast<int>(i - r * cpr) * 4;
  const float2* ml = reinterpret_cast<const float2*>(ws + nsplit * nrows * D);
  // Eight splits' loads in flight at a time; the sums keep split order.
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float2 p = ml[s * nrows + r];
    if (p.y > 0.f) mx = fmaxf(mx, p.x);
  }
  float lsum = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int s = 0; s < nsplit; ++s) {
    const float2 p = ml[s * nrows + r];
    const float4 v = *reinterpret_cast<const float4*>(ws + (s * nrows + r) * D + c);
    if (p.y <= 0.f) continue;
    const float w = exp2f(p.x - mx);
    lsum += w * p.y;
    a[0] += w * v.x;
    a[1] += w * v.y;
    a[2] += w * v.z;
    a[3] += w * v.w;
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  T* out = o + r * D + c;
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float4*>(out) = make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
  } else {
    *reinterpret_cast<uint2*>(out) = make_uint2(frag::pack_bf16x2(a[0] * inv, a[1] * inv),
                                                frag::pack_bf16x2(a[2] * inv, a[3] * inv));
  }
}

template <typename T>
cudaError_t launch_combine(const float* ws, T* o, int nsplit, long long nrows, int D,
                           cudaStream_t stream) {
  const long long threads = nrows * (D / 4);
  combine_splits<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(ws, o, nsplit, nrows, D);
  return cudaGetLastError();
}

}  // namespace attn
