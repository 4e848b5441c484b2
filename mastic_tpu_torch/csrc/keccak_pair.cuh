// Keccak-p[1600] with one state split over a pair of threads: lanes 2s and
// 2s + 1 of a warp hold the low and the high 32-bit halves of the same 25
// lanes (keccak.cu's turboshake_kernel).
//
// Why halves: a Keccak round needs every lane's other half only where a
// 64-bit rotation mixes them, so a round exchanges 29 words a thread by
// shuffle (5 for theta's rotation of the column parities, 24 for rho) and
// issues ~96 integer instructions a thread: the pair issues about what one
// thread holding the whole state issues (keccak.cuh::keccak_p1600, 194 a
// round as compiled), and the shuffles (one warp instruction a clock an SM)
// stay under the integer pipes (two clocks a warp instruction on each
// sub-partition).  A split by columns, five threads a state, moves pi's
// lanes and chi's rows between threads: 40 shared accesses and 4 shuffles
// a thread a round, at 2.5 times the threads; built and timed, it was
// slower wherever the two differed (keccak.cu's header).  Every lane
// index and rotation is a compile-time constant after unrolling, so the
// halves stay in registers.
#pragma once
#include <cstdint>

#include "keccak.cuh"

namespace mtk {

__device__ __forceinline__ uint32_t pair_half(uint32_t v) {
  return __shfl_xor_sync(0xffffffffu, v, 1);
}

// This thread's half of rotl64(lane, N), from its half and the other one.
// The same expression serves both halves: the low half of a rotation by
// N < 32 is the top word of (lo:hi) << N, the high half that of (hi:lo) << N.
template <int N>
__device__ __forceinline__ uint32_t rotl_half(uint32_t own, uint32_t other) {
  if constexpr (N == 0) {
    return own;
  } else if constexpr (N < 32) {
    return __funnelshift_l(other, own, N);
  } else {
    return __funnelshift_l(own, other, N - 32);
  }
}

template <int N>
__device__ __forceinline__ uint32_t rho_half(uint32_t own) {
  return rotl_half<N>(own, pair_half(own));
}

// Keccak-p[1600, num_rounds] on this thread's halves a[25] (lane index
// x + 5*y); `high` says which half.  Every thread of the warp must call it
// (the shuffles take the whole warp).
__device__ __forceinline__ void keccak_p1600_pair(uint32_t a[25], bool high,
                                                  int num_rounds) {
#pragma unroll 1
  for (int r = 24 - num_rounds; r < 24; ++r) {
    uint32_t c[5], o[5];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) o[x] = pair_half(c[x]);
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint32_t d = c[(x + 4) % 5] ^ rotl_half<1>(c[(x + 1) % 5], o[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[y + x] ^= d;
    }
    // rho + pi: b[y + 5*((2x + 3y) % 5)] = rotl(a[x + 5y], rho[x][y])
    uint32_t b[25];
    b[0] = a[0];
    b[16] = rho_half<36>(a[5]);
    b[7] = rho_half<3>(a[10]);
    b[23] = rho_half<41>(a[15]);
    b[14] = rho_half<18>(a[20]);
    b[10] = rho_half<1>(a[1]);
    b[1] = rho_half<44>(a[6]);
    b[17] = rho_half<10>(a[11]);
    b[8] = rho_half<45>(a[16]);
    b[24] = rho_half<2>(a[21]);
    b[20] = rho_half<62>(a[2]);
    b[11] = rho_half<6>(a[7]);
    b[2] = rho_half<43>(a[12]);
    b[18] = rho_half<15>(a[17]);
    b[9] = rho_half<61>(a[22]);
    b[5] = rho_half<28>(a[3]);
    b[21] = rho_half<55>(a[8]);
    b[12] = rho_half<25>(a[13]);
    b[3] = rho_half<21>(a[18]);
    b[19] = rho_half<56>(a[23]);
    b[15] = rho_half<27>(a[4]);
    b[6] = rho_half<20>(a[9]);
    b[22] = rho_half<39>(a[14]);
    b[13] = rho_half<8>(a[19]);
    b[4] = rho_half<14>(a[24]);
    // chi
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
#pragma unroll
      for (int x = 0; x < 5; ++x)
        a[y + x] = b[y + x] ^ (~b[y + (x + 1) % 5] & b[y + (x + 2) % 5]);
    }
    // iota
    const uint64_t rc = KECCAK_RC[r];
    a[0] ^= high ? static_cast<uint32_t>(rc >> 32) : static_cast<uint32_t>(rc);
  }
}

}  // namespace mtk
