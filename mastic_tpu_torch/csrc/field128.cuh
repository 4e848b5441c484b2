// Field128 arithmetic on two 64-bit halves as device code, shared by
// level.cu (kernel K3's payload correction), keccak.cu (kernel K1's payload
// check) and field.cu (the field kernel).  Each function equals the JAX
// package's limb code (mastic_tpu/ops/field_jax.py FieldSpec.add / sub / mul,
// and the port's mastic_tpu_torch/ops/field.py) bit for bit on every 128-bit
// input,
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

// -p^-1 mod 2^128 (p^-1 = 1 + 7 * 2^66), the REDC quotient constant for
// R = 2^128.
constexpr uint64_t F128_PINV_NEG_LO = 0xFFFFFFFFFFFFFFFFull;
constexpr uint64_t F128_PINV_NEG_HI = 0xFFFFFFFFFFFFFFE3ull;

// w[i + j] += x y + carry over 64-bit words, the carry out returned: x y +
// carry + w[i + j] < 2^128, so nothing is lost.
__device__ __forceinline__ uint64_t mac64(uint64_t& w, uint64_t x, uint64_t y, uint64_t carry) {
  uint64_t lo = x * y;
  uint64_t hi = __umul64hi(x, y);
  lo += carry;
  hi += lo < carry ? 1ull : 0ull;
  w += lo;
  return hi + (w < lo ? 1ull : 0ull);
}

// The 256-bit product a b as four words, low first.
__device__ __forceinline__ void f128_mul_wide(u128 a, u128 b, uint64_t w[4]) {
  w[0] = w[1] = 0;
  w[2] = mac64(w[1], a.lo, b.hi, mac64(w[0], a.lo, b.lo, 0));
  w[3] = mac64(w[2], a.hi, b.hi, mac64(w[1], a.hi, b.lo, 0));
}

// The Montgomery product a b / 2^128 mod p.  As f64_mont_mul: the quotient
// m = -ab p^-1 mod 2^128 is unique, so one REDC on 64-bit words gives the
// limb code's (ab + mp) / R < R + p, and one conditional subtraction of p on
// that 129-bit value its bits, on every input, values >= p included.
__device__ __forceinline__ u128 f128_mont_mul(u128 a, u128 b) {
  uint64_t t[4];
  f128_mul_wide(a, b, t);
  // m = t mod 2^128 times -p^-1, mod 2^128.
  u128 m;
  m.lo = t[0] * F128_PINV_NEG_LO;
  m.hi = __umul64hi(t[0], F128_PINV_NEG_LO) + t[0] * F128_PINV_NEG_HI + t[1] * F128_PINV_NEG_LO;
  uint64_t u[4];
  f128_mul_wide(m, u128{F128_P_LO, F128_P_HI}, u);
  // t + u: the low two words sum to 0 mod 2^128; keep the carries.
  uint64_t carry = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint64_t s = t[i] + u[i];
    const uint64_t c1 = s < t[i] ? 1ull : 0ull;
    t[i] = s + carry;
    carry = c1 | (t[i] < s ? 1ull : 0ull);
  }
  const u128 r{t[2], t[3]};
  return (carry || !f128_lt_p(r)) ? f128_minus_p(r) : r;
}

// Eight 16-bit limbs (int32 carriers, little-endian) as two halves.
__device__ __forceinline__ u128 limbs128(int4 l, int4 h) {
  return {limbs64(l), limbs64(h)};
}

}  // namespace mtk
