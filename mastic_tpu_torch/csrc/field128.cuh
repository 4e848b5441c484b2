// Field128 arithmetic on two 64-bit halves as device code, shared by
// level.cu (kernel K3's payload correction) and keccak.cu (kernel K1's
// payload check).  Each function equals the JAX package's limb code
// (mastic_tpu/ops/field_jax.py FieldSpec.add / sub, and the port's
// mastic_tpu_torch/ops/field.py) bit for bit on every 128-bit input,
// including inputs >= p: the level step stores a converted value as it is
// where its in-range mask fails and then adds w_cw to it, and the payload
// check takes differences of such carried values.
#pragma once
#include <cstdint>

#include "field64.cuh"

namespace mtk {

struct u128 {
  uint64_t lo, hi;
};

// p = 2^128 - 7 * 2^66 + 1.
constexpr uint64_t F128_P_LO = 1ull;
constexpr uint64_t F128_P_HI = 0xFFFFFFFFFFFFFFE4ull;

// a < p.
__device__ __forceinline__ bool f128_lt_p(u128 a) {
  return a.hi < F128_P_HI || (a.hi == F128_P_HI && a.lo < F128_P_LO);
}

// a - p mod 2^128.
__device__ __forceinline__ u128 f128_minus_p(u128 a) {
  return {a.lo - F128_P_LO, a.hi - F128_P_HI - (a.lo < F128_P_LO ? 1ull : 0ull)};
}

// The 129-bit sum, one conditional subtraction of p, the low 128 bits.
__device__ __forceinline__ u128 f128_add(u128 a, u128 b) {
  u128 s;
  s.lo = a.lo + b.lo;
  const uint64_t c0 = s.lo < a.lo ? 1ull : 0ull;
  const uint64_t h = a.hi + b.hi;
  s.hi = h + c0;
  const bool carry = h < a.hi || s.hi < h;
  return (carry || !f128_lt_p(s)) ? f128_minus_p(s) : s;
}

// a - b, plus p (mod 2^128) on a borrow.
__device__ __forceinline__ u128 f128_sub(u128 a, u128 b) {
  const uint64_t br = a.lo < b.lo ? 1ull : 0ull;
  u128 d{a.lo - b.lo, a.hi - b.hi - br};
  const bool borrow = a.hi < b.hi || (a.hi == b.hi && br);
  if (borrow) {
    const uint64_t lo = d.lo + F128_P_LO;
    d.hi += F128_P_HI + (lo < d.lo ? 1ull : 0ull);
    d.lo = lo;
  }
  return d;
}

// Eight 16-bit limbs (int32 carriers, little-endian) as two halves.
__device__ __forceinline__ u128 limbs128(int4 l, int4 h) {
  return {limbs64(l), limbs64(h)};
}

}  // namespace mtk
