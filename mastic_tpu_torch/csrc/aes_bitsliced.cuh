// Bitsliced AES-128 encryption as device code for aes.cu (kernel K2); K3
// splits the same state across four threads (aes_column.cuh).
//
// One thread holds one AES state for 32 reports: s[b * 16 + k] is the bit
// plane of bit b of state byte k, bit j of each word belonging to report
// 32*w + j (the layout of mastic_tpu_torch/ops/aes.py:bitslice_pack).
// SubBytes is the tower-field circuit of sbox_tower.cuh (XOR, AND and NOT
// only), ShiftRows is a renaming of registers, MixColumns is XORs across
// planes: no table and no data-dependent branch or address anywhere, so the
// code is constant-time.
#pragma once
#include <cstdint>

#include "sbox_tower.cuh"

namespace mtk {

__device__ __forceinline__ void aes_sub_bytes(uint32_t s[128]) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    sbox_tower(s[k], s[16 + k], s[32 + k], s[48 + k], s[64 + k], s[80 + k],
               s[96 + k], s[112 + k]);
}

// ShiftRows: new byte i comes from old byte (i + 4 * (i % 4)) % 16
// (column-major state, byte k = 4 * column + row).
__device__ __forceinline__ void aes_shift_rows(uint32_t s[128]) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    uint32_t t[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) t[i] = s[b * 16 + (i + 4 * (i % 4)) % 16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[b * 16 + i] = t[i];
  }
}

// MixColumns on planes: out[r] = xtime(a[r] ^ a[r+1]) ^ a[r+1] ^ a[r+2] ^ a[r+3]
// per column, where xtime shifts the planes up one and folds plane 7 into
// planes 0, 1, 3 and 4 (the 0x1B reduction).
__device__ __forceinline__ void aes_mix_columns(uint32_t s[128]) {
#pragma unroll
  for (int col = 0; col < 4; ++col) {
    uint32_t out[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k0 = 4 * col + r;
      const int k1 = 4 * col + (r + 1) % 4;
      const int k2 = 4 * col + (r + 2) % 4;
      const int k3 = 4 * col + (r + 3) % 4;
      uint32_t x[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) x[b] = s[b * 16 + k0] ^ s[b * 16 + k1];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        uint32_t xt = b == 0 ? x[7] : x[b - 1];
        if (b == 1 || b == 3 || b == 4) xt ^= x[7];
        out[r][b] = xt ^ s[b * 16 + k1] ^ s[b * 16 + k2] ^ s[b * 16 + k3];
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int b = 0; b < 8; ++b) s[b * 16 + 4 * col + r] = out[r][b];
    }
  }
}

// XOR round key `round` of a key-plane array laid out (11 * 128, W): plane i
// of round r for packed word w at key[(r * 128 + i) * W + w].
__device__ __forceinline__ void aes_add_key(uint32_t s[128],
                                            const uint32_t* __restrict__ key,
                                            int round, int W, int w) {
  const uint32_t* k = key + static_cast<size_t>(round) * 128 * W + w;
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] ^= __ldg(k + static_cast<size_t>(i) * W);
}

// AES-128: whitening, 9 full rounds, the final round without MixColumns.
__device__ __forceinline__ void aes_encrypt_planes(uint32_t s[128],
                                                   const uint32_t* __restrict__ key,
                                                   int W, int w) {
  aes_add_key(s, key, 0, W, w);
#pragma unroll 1
  for (int r = 1; r < 10; ++r) {
    aes_sub_bytes(s);
    aes_shift_rows(s);
    aes_mix_columns(s);
    aes_add_key(s, key, r, W, w);
  }
  aes_sub_bytes(s);
  aes_shift_rows(s);
  aes_add_key(s, key, 10, W, w);
}

}  // namespace mtk
