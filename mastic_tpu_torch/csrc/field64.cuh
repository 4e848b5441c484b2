// Field64 arithmetic on whole 64-bit words as device code, shared by
// level.cu (kernel K3's payload correction) and keccak.cu (kernel K1's
// payload check).  Each function equals the JAX package's limb code
// (mastic_tpu/ops/field_jax.py FieldSpec.add / sub) bit for bit on every
// 64-bit input, including inputs >= p.
#pragma once
#include <cstdint>

namespace mtk {

constexpr uint64_t F64_P = 0xFFFFFFFF00000001ull;  // 2^64 - 2^32 + 1

// The 65-bit sum, one conditional subtraction of p, the low 64 bits.
__device__ __forceinline__ uint64_t f64_add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  const bool carry = s < a;
  return (carry || s >= F64_P) ? s - F64_P : s;
}

// a - b, plus p (mod 2^64) on a borrow.
__device__ __forceinline__ uint64_t f64_sub(uint64_t a, uint64_t b) {
  const uint64_t d = a - b;
  return a < b ? d + F64_P : d;
}

// Four 16-bit limbs (int32 carriers, little-endian) as one word.
__device__ __forceinline__ uint64_t limbs64(int4 l) {
  return static_cast<uint64_t>(l.x & 0xFFFF) | (static_cast<uint64_t>(l.y & 0xFFFF) << 16) |
         (static_cast<uint64_t>(l.z & 0xFFFF) << 32) | (static_cast<uint64_t>(l.w & 0xFFFF) << 48);
}

// One 64-bit word as four 16-bit limbs (int32 carriers, little-endian).
__device__ __forceinline__ int4 limbs_of(uint64_t v) {
  int4 out;
  out.x = static_cast<int32_t>(v & 0xFFFF);
  out.y = static_cast<int32_t>((v >> 16) & 0xFFFF);
  out.z = static_cast<int32_t>((v >> 32) & 0xFFFF);
  out.w = static_cast<int32_t>(v >> 48);
  return out;
}

}  // namespace mtk
