// Field64 arithmetic on whole 64-bit words as device code, shared by
// level.cu (kernel K3's payload correction), keccak.cu (kernel K1's
// payload check) and field.cu (the field kernel).  Each function equals the
// JAX package's limb code (mastic_tpu/ops/field_jax.py FieldSpec.add / sub /
// mul) bit for bit on every 64-bit input, including inputs >= p.
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

// -p^-1 mod 2^64, the REDC quotient constant for R = 2^64.
constexpr uint64_t F64_PINV_NEG = 0xFFFFFFFEFFFFFFFFull;

// The Montgomery product a b / 2^64 mod p.  The limb code reduces 16 bits at
// a time, but the quotient m = -ab p^-1 mod R is unique, so one REDC on the
// whole word gives the same (ab + mp) / R < R + p, and the same single
// conditional subtraction of p on that 65-bit value gives the same bits on
// every input, values >= p included.
__device__ __forceinline__ uint64_t f64_mont_mul(uint64_t a, uint64_t b) {
  const uint64_t t_lo = a * b;
  const uint64_t t_hi = __umul64hi(a, b);
  const uint64_t m = t_lo * F64_PINV_NEG;
  const uint64_t mp_hi = __umul64hi(m, F64_P);
  // t_lo + m p mod 2^64 is 0: a carry out of the low word unless t_lo is 0.
  const uint64_t h = t_hi + mp_hi;
  const uint64_t r = h + (t_lo != 0 ? 1ull : 0ull);
  const bool top = h < t_hi || r < h;
  return (top || r >= F64_P) ? r - F64_P : r;
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
