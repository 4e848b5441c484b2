// Kernel K3: one whole VIDPF tree level (Field64 payloads) in one launch.
//
// Replaces the TPU kernel mastic_tpu/ops/level_pallas.py:level_step_pallas
// (the 39-stage fused level over a (report tile x parent tile) grid).  Per
// parent and 32 reports it computes what mastic_tpu/backend/vidpf_jax.py
// level_core plus the node-proof sponge compute:
//   extend: 2 Davies-Meyer fixed-key AES blocks per parent (K2's round code);
//   correct: ctrl-bit extraction, seed and ctrl correction by packed masks;
//   convert: `convert_blocks` AES blocks per child -> next seed, payload limbs
//     with the in-range mask and w_cw added mod p where the child holds ctrl;
//   node proof: one-block TurboSHAKE128 over prefix | next seed | binder (K1's
//     permutation), XORed with proof_cw where the child holds ctrl.
// Unlike the TPU kernel, the binder length is a runtime argument, so the
// incremental round (whose binder grows with the level) goes through it too.
//
// Design: a block of LEVEL_THREADS threads owns LEVEL_THREADS (packed word w,
// parent p) pairs.  Phase 1, one thread per pair: the six AES blocks in
// bitsliced form (one child at a time; the corrected child seed waits in
// shared memory while its convert blocks run), and the bit transposes that
// write next seed, ctrl, payload and ok straight into the report-major
// outputs.  Phase 2, after __syncthreads: the block's 64 * LEVEL_THREADS node
// proofs, one thread per (report, child) per pair, reading the next seeds the
// block just wrote.  Sigma, the AES planes and the Keccak state stay in
// registers and shared memory.
//
// What bounds it on the H100: integer issue.  Per 32 reports and one parent:
// 6 bitsliced AES columns (~18.8k instructions each) plus 64 Keccak-p
// permutations (~2.2k each), ~0.25M instructions for 64 node evals, against
// ~150 bytes of input and output per node eval: compute-bound by two orders
// of magnitude.  At 4096 reports x 64 parents the grid is 8192 pairs, 128
// blocks of 64 threads: one block per SM, so this first version runs at low
// occupancy and leans on instruction-level parallelism.  Registers are the
// other limit: ptxas (CUDA 12.8, -Xptxas -v) reports 255 registers, a
// 4008-byte stack frame and 4676 bytes of spill stores per thread.
#include <cuda_runtime.h>

#include "aes_bitsliced.cuh"
#include "keccak.cuh"

using namespace mtk;

constexpr int LEVEL_THREADS = 64;
constexpr uint64_t F64_P = 0xFFFFFFFF00000001ull;  // 2^64 - 2^32 + 1

// sigma(x) for x = seed ^ le128(blk), on planes: sigma(lo || hi) = hi || hi ^ lo.
// le128(blk) for blk < 256 only touches byte 0, which lands in sigma byte 8.
// Plane i of the seed is seed[i * stride].  With `into`, XOR sigma into s
// (the Davies-Meyer feed-forward) instead of writing it.
__device__ __forceinline__ void dm_sigma(uint32_t s[128], const uint32_t* seed,
                                         size_t stride, int blk, bool into) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const uint32_t flip = ((blk >> b) & 1) ? 0xFFFFFFFFu : 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t lo = seed[(b * 16 + j) * stride];
      const uint32_t hi = seed[(b * 16 + 8 + j) * stride];
      const uint32_t mixed = hi ^ lo ^ (j == 0 ? flip : 0u);
      if (into) {
        s[b * 16 + j] ^= hi;
        s[b * 16 + 8 + j] ^= mixed;
      } else {
        s[b * 16 + j] = hi;
        s[b * 16 + 8 + j] = mixed;
      }
    }
  }
}

// Byte k (bits from planes b * 16 + k) of report j out of 32.
__device__ __forceinline__ uint32_t plane_byte(const uint32_t s[128], int k, int j) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 8; ++b) v |= ((s[b * 16 + k] >> j) & 1u) << b;
  return v;
}

__device__ __forceinline__ uint64_t limbs_value(const int32_t* l) {
  return static_cast<uint64_t>(l[0] & 0xFFFF) |
         (static_cast<uint64_t>(l[1] & 0xFFFF) << 16) |
         (static_cast<uint64_t>(l[2] & 0xFFFF) << 32) |
         (static_cast<uint64_t>(l[3] & 0xFFFF) << 48);
}

// FieldSpec.add as the JAX package computes it: the 65-bit sum, one
// conditional subtraction of p, the low 64 bits (also for inputs >= p).
__device__ __forceinline__ uint64_t f64_add(uint64_t a, uint64_t b) {
  const uint64_t s = a + b;
  const bool carry = s < a;
  return (carry || s >= F64_P) ? s - F64_P : s;
}

__global__ void __launch_bounds__(LEVEL_THREADS)
level_kernel(const uint32_t* __restrict__ ekp, const uint32_t* __restrict__ ckp,
             const uint32_t* __restrict__ pseed, const uint32_t* __restrict__ pctrl,
             const uint32_t* __restrict__ cwsd, const uint32_t* __restrict__ cwct,
             const int32_t* __restrict__ wcw, const uint8_t* __restrict__ pcw,
             const uint8_t* __restrict__ prefix, int prefix_len,
             const uint8_t* __restrict__ binder, int binder_stride, int binder_len,
             uint8_t* __restrict__ next_seed, uint8_t* __restrict__ ct,
             int32_t* __restrict__ w_out, uint8_t* __restrict__ ok,
             uint8_t* __restrict__ proof, int W, int N, int convert_blocks,
             int value_len) {
  __shared__ uint32_t child_seed[128 * LEVEL_THREADS];
  const int tid = threadIdx.x;
  const long long pairs = static_cast<long long>(W) * N;
  const long long pair = static_cast<long long>(blockIdx.x) * LEVEL_THREADS + tid;
  const int n2 = 2 * N;

  // -- phase 1: extend, correct, convert for pair (w, p) ------------------
  if (pair < pairs) {
    const int w = static_cast<int>(pair % W);
    const int p = static_cast<int>(pair / W);
    const uint32_t pc = pctrl[static_cast<size_t>(p) * W + w];
    const uint32_t* seed_planes = pseed + static_cast<size_t>(p) * 128 * W + w;
    uint32_t* mine = child_seed + tid;
    for (int c = 0; c < 2; ++c) {
      uint32_t s[128];
      dm_sigma(s, seed_planes, W, c, false);
      aes_encrypt_planes(s, ekp, W, w);
      dm_sigma(s, seed_planes, W, c, true);
      // Control bit: plane (bit 0, byte 0); cleared in the seed.  Corrections
      // are mask ANDs: where the parent holds ctrl, XOR the correction words.
      uint32_t t = s[0];
      s[0] = 0;
#pragma unroll
      for (int i = 0; i < 128; ++i)
        s[i] ^= cwsd[static_cast<size_t>(i) * W + w] & pc;
      t ^= pc & cwct[static_cast<size_t>(c) * W + w];
#pragma unroll
      for (int i = 0; i < 128; ++i) mine[i * LEVEL_THREADS] = s[i];
      const int node = 2 * p + c;
      for (int j = 0; j < 32; ++j)
        ct[(static_cast<size_t>(32 * w + j)) * n2 + node] = (t >> j) & 1u;

      uint32_t okmask = 0xFFFFFFFFu;
      for (int blk = 0; blk < convert_blocks; ++blk) {
        dm_sigma(s, mine, LEVEL_THREADS, blk, false);
        aes_encrypt_planes(s, ckp, W, w);
        dm_sigma(s, mine, LEVEL_THREADS, blk, true);
        if (blk == 0) {
          for (int j = 0; j < 32; ++j) {
            uint32_t word[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              word[q] = plane_byte(s, 4 * q, j) | (plane_byte(s, 4 * q + 1, j) << 8) |
                        (plane_byte(s, 4 * q + 2, j) << 16) |
                        (plane_byte(s, 4 * q + 3, j) << 24);
            uint32_t* dst = reinterpret_cast<uint32_t*>(
                next_seed + (static_cast<size_t>(32 * w + j) * n2 + node) * 16);
#pragma unroll
            for (int q = 0; q < 4; ++q) dst[q] = word[q];
          }
          continue;
        }
        // Payload: this block holds elements 2 * (blk - 1) and 2 * (blk - 1) + 1.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * (blk - 1) + h;
          if (e >= value_len) continue;
          for (int j = 0; j < 32; ++j) {
            uint64_t v = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q)
              v |= static_cast<uint64_t>(plane_byte(s, 8 * h + q, j)) << (8 * q);
            if (v >= F64_P) okmask &= ~(1u << j);
            const size_t r = static_cast<size_t>(32 * w + j);
            if ((t >> j) & 1u)
              v = f64_add(v, limbs_value(wcw + (r * value_len + e) * 4));
            int32_t* dst = w_out + ((r * n2 + node) * value_len + e) * 4;
#pragma unroll
            for (int l = 0; l < 4; ++l)
              dst[l] = static_cast<int32_t>((v >> (16 * l)) & 0xFFFF);
          }
        }
      }
      for (int j = 0; j < 32; ++j)
        ok[(static_cast<size_t>(32 * w + j)) * n2 + node] = (okmask >> j) & 1u;
    }
  }
  __syncthreads();

  // -- phase 2: node proofs, one thread per (report, child) per pair ------
  const int j = tid >> 1;
  const int c = tid & 1;
  const int msg_len = prefix_len + 16 + binder_len;
  for (int k = 0; k < LEVEL_THREADS; ++k) {
    const long long pk = static_cast<long long>(blockIdx.x) * LEVEL_THREADS + k;
    if (pk >= pairs) break;
    const int w = static_cast<int>(pk % W);
    const int node = 2 * static_cast<int>(pk / W) + c;
    const size_t r = static_cast<size_t>(32 * w + j);
    const size_t slot = r * n2 + node;
    const uint8_t* seed = next_seed + slot * 16;
    const uint8_t* bnd = binder + static_cast<size_t>(node) * binder_stride;
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; ++l) a[l] = 0;
#pragma unroll
    for (int l = 0; l < 21; ++l) {
      uint64_t v = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int pos = 8 * l + q;
        uint32_t byte = 0;
        if (pos < prefix_len)
          byte = prefix[pos];
        else if (pos < prefix_len + 16)
          byte = seed[pos - prefix_len];
        else if (pos < msg_len)
          byte = bnd[pos - prefix_len - 16];
        if (pos == msg_len) byte ^= 0x01u;  // TurboSHAKE domain byte 1
        if (pos == KECCAK_RATE - 1) byte ^= 0x80u;
        v |= static_cast<uint64_t>(byte) << (8 * q);
      }
      a[l] = v;
    }
    keccak_p1600(a, 12);
    const bool corr = ct[slot] != 0;
    uint8_t* dst = proof + slot * 32;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint8_t byte = static_cast<uint8_t>(a[l] >> (8 * q));
        if (corr) byte ^= pcw[r * 32 + 8 * l + q];
        dst[8 * l + q] = byte;
      }
    }
  }
}

extern "C" int level_step(const void* ekp, const void* ckp, const void* pseed,
                          const void* pctrl, const void* cwsd, const void* cwct,
                          const void* wcw, const void* pcw, const void* prefix,
                          int prefix_len, const void* binder, int binder_stride,
                          int binder_len, void* next_seed, void* ct, void* w_out,
                          void* ok, void* proof, int W, int N, int convert_blocks,
                          int value_len, void* stream) {
  const long long pairs = static_cast<long long>(W) * N;
  const int blocks = static_cast<int>((pairs + LEVEL_THREADS - 1) / LEVEL_THREADS);
  level_kernel<<<blocks, LEVEL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(ekp), static_cast<const uint32_t*>(ckp),
      static_cast<const uint32_t*>(pseed), static_cast<const uint32_t*>(pctrl),
      static_cast<const uint32_t*>(cwsd), static_cast<const uint32_t*>(cwct),
      static_cast<const int32_t*>(wcw), static_cast<const uint8_t*>(pcw),
      static_cast<const uint8_t*>(prefix), prefix_len,
      static_cast<const uint8_t*>(binder), binder_stride, binder_len,
      static_cast<uint8_t*>(next_seed), static_cast<uint8_t*>(ct),
      static_cast<int32_t*>(w_out), static_cast<uint8_t*>(ok),
      static_cast<uint8_t*>(proof), W, N, convert_blocks, value_len);
  return static_cast<int>(cudaGetLastError());
}
