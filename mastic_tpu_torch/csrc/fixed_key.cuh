// XofFixedKeyAes128's block function on the four-thread AES of
// aes_column.cuh: device code of kernels K2 (aes.cu) and K3 (level.cu).
//
// Block i of a seed x is AES_k(sigma(x ^ le128(i))) ^ sigma(x ^ le128(i)),
// sigma(lo || hi) = hi || (hi ^ lo).  sigma is linear, so the kernels load
// sigma(x) once, as planes, and fold le128(i) in per block: x ^ le128(i)
// changes bytes 0..3 of x for i < 2^32, which sigma moves to bytes 8..11,
// the word of thread t = 2; there plane k flips where bit k of i is set.
// sigma(x) waits in shared memory between the AES input and the
// feed-forward: held in registers beside the state and the round-key
// transposes it pushed K3 into spills.
#pragma once
#include <cstdint>

#include "aes_column.cuh"

namespace mtk {

// The thread's 32 planes of sigma(x) for the 16-byte rows x of the reports
// 32w .. 32w+31, `stride` bytes apart from `rows`; reports past R read as
// zeros.  Byte k < 8 of sigma(x) is x[k + 8], byte k >= 8 is x[k] ^ x[k - 8]:
// as 32-bit words, word t | 2, XORed with word t & 1 for t >= 2 (the
// transpose is linear).
__device__ __forceinline__ void load_sigma_planes(uint32_t s[32], const uint8_t* __restrict__ rows,
                                                  size_t stride, int R, int w, int t) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = 32 * w + j;
    uint32_t v = 0;
    if (r < R) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(rows + r * stride);
      v = __ldg(row + (t | 2));
      if (t >= 2) v ^= __ldg(row + (t & 1));
    }
    s[j] = v;
  }
  transpose32(s);
}

// sigma(x ^ le128(blk)) into s from the planes of sigma(x) in shared memory
// (sigma[i][threadIdx.x]); with `into`, XORed into s (the feed-forward).
template <int THREADS>
__device__ __forceinline__ void dm_input(uint32_t s[32], const uint32_t (*sigma)[THREADS],
                                         uint32_t blk, int t, bool into) {
  const uint32_t flip = t == 2 ? blk : 0u;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t v = sigma[i][threadIdx.x] ^ (0u - ((flip >> i) & 1u));
    s[i] = into ? s[i] ^ v : v;
  }
}

// Block `blk` of the fixed-key XOF into s: the thread's column as planes.
template <int THREADS>
__device__ __forceinline__ void fixed_key_block(uint32_t s[32], const uint32_t (*sigma)[THREADS],
                                                const uint8_t* __restrict__ keys, uint32_t blk,
                                                int R, int w, int t) {
  dm_input<THREADS>(s, sigma, blk, t, false);
  col_aes_encrypt(s, keys, R, w, t);
  dm_input<THREADS>(s, sigma, blk, t, true);
}

}  // namespace mtk
