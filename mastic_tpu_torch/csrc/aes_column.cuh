// Bitsliced AES-128 with one AES state for 32 reports split across four
// threads, one AES column each: device code of kernels K2 (aes.cu) and K3
// (level.cu).
//
// The four threads of a group are adjacent lanes (t = lane & 3).  Thread t
// holds the 32 bit planes of state bytes 4t .. 4t+3 (column t):
// s[8 * q + b] is the plane of bit b of byte 4t + q, bit j of each word
// belonging to report 32 * w + j (the plane layout of
// mastic_tpu_torch/ops/aes.py:bitslice_pack, cut by column).  Seen as one
// little-endian word per report, s[k] is the plane of bit k of the thread's
// word.  Report-major inputs (round keys, seeds) stay so in device memory:
// the thread loads one 32-bit word per report and a 32 x 32 bit transpose
// turns them into its planes, so no packed copy is made in front of the
// kernel.  SubBytes is the tower-field circuit of sbox_tower.cuh on each of
// the thread's four bytes; ShiftRows moves row q of column (t + q) % 4 to
// column t, 24 warp shuffles per round; MixColumns works inside the column.
// No table and no data-dependent branch or address: constant-time.  (One
// thread holding all 128 planes, K2's first design, needed 255 registers and
// spilled.)
#pragma once
#include <cstdint>

#include "sbox_tower.cuh"

namespace mtk {

constexpr unsigned FULL_WARP = 0xFFFFFFFFu;

__device__ __forceinline__ void col_sub_bytes(uint32_t s[32]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    sbox_tower(s[8 * q], s[8 * q + 1], s[8 * q + 2], s[8 * q + 3], s[8 * q + 4],
               s[8 * q + 5], s[8 * q + 6], s[8 * q + 7]);
}

// ShiftRows: new byte 4c + q is old byte 4((c + q) % 4) + q.  Every lane of
// the warp must take part (the shuffles name the whole warp).
__device__ __forceinline__ void col_shift_rows(uint32_t s[32], int t) {
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    const int src = (t + q) & 3;
#pragma unroll
    for (int b = 0; b < 8; ++b) s[8 * q + b] = __shfl_sync(FULL_WARP, s[8 * q + b], src, 4);
  }
}

// MixColumns on the thread's column: out[r] = xtime(a[r] ^ a[r+1]) ^ a[r+1]
// ^ a[r+2] ^ a[r+3], xtime shifting the planes up one and folding plane 7
// into planes 0, 1, 3 and 4 (the 0x1B reduction).
__device__ __forceinline__ void col_mix_column(uint32_t s[32]) {
  uint32_t out[32];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int r1 = (r + 1) % 4, r2 = (r + 2) % 4, r3 = (r + 3) % 4;
    uint32_t x[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) x[b] = s[8 * r + b] ^ s[8 * r1 + b];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      uint32_t xt = b == 0 ? x[7] : x[b - 1];
      if (b == 1 || b == 3 || b == 4) xt ^= x[7];
      out[8 * r + b] = xt ^ s[8 * r1 + b] ^ s[8 * r2 + b] ^ s[8 * r3 + b];
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = out[i];
}

// One stage of the transpose below: swap the off-diagonal J x J blocks
// of every 2J x 2J block (M selects the low J bits of every 2J).
template <int J, uint32_t M>
__device__ __forceinline__ void transpose_stage(uint32_t a[32]) {
#pragma unroll
  for (int k0 = 0; k0 < 32; k0 += 2 * J) {
#pragma unroll
    for (int k = k0; k < k0 + J; ++k) {
      const uint32_t x = ((a[k] >> J) ^ a[k + J]) & M;
      a[k + J] ^= x;
      a[k] ^= x << J;
    }
  }
}

// Transpose a 32 x 32 bit matrix in place: afterwards bit i of a[j] is what
// bit j of a[i] was.  Turns the thread's 32 planes (row 8q + b) into one
// little-endian word of bytes 4t .. 4t+3 per report j.  The stages are
// spelled out so that every index is a constant and a[] stays in registers.
__device__ __forceinline__ void transpose32(uint32_t a[32]) {
  transpose_stage<16, 0x0000FFFFu>(a);
  transpose_stage<8, 0x00FF00FFu>(a);
  transpose_stage<4, 0x0F0F0F0Fu>(a);
  transpose_stage<2, 0x33333333u>(a);
  transpose_stage<1, 0x55555555u>(a);
}

// The thread's 32 planes of a 16-byte row per report (bytes 4t .. 4t+3),
// for the 32 reports 32w .. 32w+31 whose rows sit `stride` bytes apart from
// `rows`; reports past R read as zeros.
__device__ __forceinline__ void load_planes(uint32_t s[32], const uint8_t* __restrict__ rows,
                                            size_t stride, int R, int w, int t) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = 32 * w + j;
    s[j] = r < R ? __ldg(reinterpret_cast<const uint32_t*>(rows + r * stride + 4 * t)) : 0u;
  }
  transpose32(s);
}

// XOR the thread's column of round key `round` from the report-major key
// schedules (R, 11, 16) bytes.
__device__ __forceinline__ void col_add_key(uint32_t s[32], const uint8_t* __restrict__ keys,
                                            int round, int R, int w, int t) {
  uint32_t k[32];
  load_planes(k, keys + 16 * round, 11 * 16, R, w, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] ^= k[i];
}

// AES-128: whitening, 9 full rounds, the final round without MixColumns.
// add_key(s, round) XORs the thread's column of that round key.  Every lane
// of the warp must call it (ShiftRows shuffles).
template <class AddKey>
__device__ __forceinline__ void col_aes_rounds(uint32_t s[32], int t, AddKey add_key) {
  add_key(s, 0);
#pragma unroll 1
  for (int r = 1; r < 10; ++r) {
    col_sub_bytes(s);
    col_shift_rows(s, t);
    col_mix_column(s);
    add_key(s, r);
  }
  col_sub_bytes(s);
  col_shift_rows(s, t);
  add_key(s, 10);
}

// AES-128 under the report-major key schedules (R, 11, 16) bytes.
__device__ __forceinline__ void col_aes_encrypt(uint32_t s[32], const uint8_t* __restrict__ keys,
                                                int R, int w, int t) {
  col_aes_rounds(s, t, [&](uint32_t x[32], int round) { col_add_key(x, keys, round, R, w, t); });
}

}  // namespace mtk
