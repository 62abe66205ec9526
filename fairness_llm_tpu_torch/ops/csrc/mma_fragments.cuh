// mma.sync / ldmatrix fragment helpers shared by the port's tensor-core
// kernels (flash_attention.cu, decode_attention.cu, quant_matmul.cu): bf16
// m16n8k16 products with f32 accumulation, the ldmatrix loads that fill
// their operands from shared memory, and the exact int8 -> float conversion
// of the int8 tiles (weights, KV cache) they convert before the products.
//
// Fragment layout of mma.sync.m16n8k16 (g = lane / 4, q = lane % 4):
//   A 16x16: a0 (row g, cols 2q, 2q+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2q+8, 2q+9), a3 (row g+8, cols 2q+8, 2q+9);
//   B 16x8:  b0 (k rows 2q, 2q+1, col g), b1 (k rows 2q+8, 2q+9, col g);
//   C 16x8:  c0, c1 (row g, cols 2q, 2q+1), c2, c3 (row g+8, same cols).
// So the C fragments of two neighbouring n8 tiles, packed to bf16 pairs,
// are exactly the A fragment of one k16 step over those 16 columns.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

namespace frag {

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i (row lane / 4, cols 2 * (lane % 4)).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The same, each matrix transposed on the way (register i receives matrix
// i's rows 2 * (lane % 4), +1 at column lane / 4).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a * b on one m16n8k16 bf16 tile, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair (lo in the low half), round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// Two floats to a bf16 pair (as pack_bf16x2) and the pair of what that
// rounding dropped, itself rounded to bf16: hi + lo carries each value to
// about 2^-17 of itself (the difference a - hi is exact in float32).
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  memcpy(&hi, &h, 4);
  lo = pack_bf16x2(a - f.x, b - f.y);
}

// Four signed bytes -> four exact floats: the byte b + 128 goes into the
// mantissa of 2^23, and 2^23 + 128 is subtracted again.
__device__ __forceinline__ void i8x4_to_f32(uint32_t packed, float (&f)[4]) {
  const uint32_t u = packed ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

}  // namespace frag
