// Keccak-p[1600] as device code, shared by keccak.cu (kernel K1's
// permutation and binder sponge) and level.cu (kernel K3's node proofs);
// the in-place sponge's split form is keccak_pair.cuh.
//
// One thread holds one 1600-bit state as 25 uint64_t lanes in registers
// (lane index x + 5*y, as in mastic_tpu/keccak.py).  Every lane index is
// a compile-time constant after unrolling, so the state never touches
// local memory; the 64-bit rotations compile to funnel shifts.
#pragma once
#include <cstdint>

namespace mtk {

constexpr int KECCAK_RATE = 168;  // TurboSHAKE128 rate: 21 lanes

// Round constants of Keccak-f[1600]; Keccak-p[1600, n] runs the last n.
__device__ __constant__ uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return n == 0 ? x : ((x << n) | (x >> (64 - n)));
}

// Keccak-p[1600, num_rounds]: rounds 24 - num_rounds .. 23.
__device__ __forceinline__ void keccak_p1600(uint64_t a[25], int num_rounds) {
#pragma unroll 1
  for (int r = 24 - num_rounds; r < 24; ++r) {
    // theta
    const uint64_t c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
    const uint64_t c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
    const uint64_t c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
    const uint64_t c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
    const uint64_t c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
    const uint64_t d[5] = {c4 ^ rotl64(c1, 1), c0 ^ rotl64(c2, 1),
                           c1 ^ rotl64(c3, 1), c2 ^ rotl64(c4, 1),
                           c3 ^ rotl64(c0, 1)};
#pragma unroll
    for (int i = 0; i < 25; ++i) a[i] ^= d[i % 5];
    // rho + pi: b[y + 5*((2x + 3y) % 5)] = rotl(a[x + 5y], rho[x][y])
    uint64_t b[25];
    b[0] = a[0];
    b[16] = rotl64(a[5], 36);
    b[7] = rotl64(a[10], 3);
    b[23] = rotl64(a[15], 41);
    b[14] = rotl64(a[20], 18);
    b[10] = rotl64(a[1], 1);
    b[1] = rotl64(a[6], 44);
    b[17] = rotl64(a[11], 10);
    b[8] = rotl64(a[16], 45);
    b[24] = rotl64(a[21], 2);
    b[20] = rotl64(a[2], 62);
    b[11] = rotl64(a[7], 6);
    b[2] = rotl64(a[12], 43);
    b[18] = rotl64(a[17], 15);
    b[9] = rotl64(a[22], 61);
    b[5] = rotl64(a[3], 28);
    b[21] = rotl64(a[8], 55);
    b[12] = rotl64(a[13], 25);
    b[3] = rotl64(a[18], 21);
    b[19] = rotl64(a[23], 56);
    b[15] = rotl64(a[4], 27);
    b[6] = rotl64(a[9], 20);
    b[22] = rotl64(a[14], 39);
    b[13] = rotl64(a[19], 8);
    b[4] = rotl64(a[24], 14);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    // iota
    a[0] ^= KECCAK_RC[r];
  }
}

// A read-only 64-bit load (__ldg's overload is the unsigned long long one).
__device__ __forceinline__ uint64_t ldg64(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

}  // namespace mtk
