// Kernel K2: bitsliced AES-128, 32 reports per uint32 word, four threads per
// AES state (aes_column.cuh).  Two entry points:
//
// fixed_key_blocks: the whole of XofFixedKeyAes128's output,
//   mastic_tpu_torch/backend/xof.py:fixed_key_blocks.  Round keys (R, 11, 16)
//   and seeds (R, S, 16) bytes in, report-major; (R, S, num_blocks * 16) bytes
//   out, block i of seed x being AES_k(sigma(x ^ le128(i))) ^ sigma(x ^
//   le128(i)).  Every extend and convert of the client's VIDPF key generation
//   is one launch of it.
// aes_bitsliced: the direct counterpart of the TPU kernel
//   mastic_tpu/ops/aes_pallas.py:aes128_encrypt_bitsliced_pallas (whitening,
//   nine rounds and the final round without MixColumns over (128, M, W) plane
//   blocks with per-word key planes (11 * 128, W)), planes in and planes out.
//
// What bounds it on the H100: integer issue.  One bitsliced column of 32
// blocks is ~18.8k instructions of AES (chip_smoke.py AES_BLOCK_OPS) against
// 32 x 16 bytes of seed in and of block out: compute-bound by a wide margin.
// At the client shard's shape (4096 reports x 2 seeds x 2 blocks: 512
// columns) the work is one column per four threads, 2048 threads in all, so
// the floor is one thread's dependent chain (~10k instructions with the
// round-key transposes), not the card's issue rate.
//
// Design.  Four adjacent lanes own one (packed word w, seed, block)
// column, one AES column of the state each: 32 planes per thread in
// registers (the first K2 held all 128 planes in one thread: 255 registers,
// 104 bytes of spill, and 4 blocks of 128 threads at the shard's shape).
// fixed_key_blocks reads the seeds and round keys report-major and transposes
// them in the thread (fixed_key.cuh, shared with K3), so no packing, block
// index or feed-forward runs outside the kernel.  Blocks run fastest, then
// seeds, so the groups of a warp load the same key rows and seed rows, and a
// warp's stores of one report fill contiguous bytes.  64 threads a block:
// at the shard's shape its 64 warps spread over 32 SMs, two a SM, each on
// its own scheduler; with 128 they would sit four a SM on 16 SMs, where each
// SM's one pipe for shuffles, shared memory and loads (24 shuffles, 32
// shared-memory words and 32 key loads a round per thread) serves four
// warps instead of two.  At wide shapes the finer blocks also even out over
// the 132 SMs.  Groups past the end run on a copy of the last one and store
// nothing: every lane has to reach the shuffles.
#include <cuda_runtime.h>

#include "fixed_key.cuh"

using namespace mtk;

constexpr int AES_THREADS = 64;

__global__ void __launch_bounds__(AES_THREADS)
fixed_key_kernel(const uint8_t* __restrict__ keys, const uint8_t* __restrict__ seeds,
                 long long report_stride, long long seed_stride, uint8_t* __restrict__ out,
                 int R, int S, int nb) {
  const int t = threadIdx.x & 3;
  const int W = (R + 31) / 32;
  const long long groups = static_cast<long long>(W) * S * nb;
  long long g = (static_cast<long long>(blockIdx.x) * AES_THREADS + threadIdx.x) >> 2;
  const bool live = g < groups;
  if (!live) g = groups - 1;
  const int blk = static_cast<int>(g % nb);
  const int seed = static_cast<int>((g / nb) % S);
  const int w = static_cast<int>(g / nb / S);

  __shared__ uint32_t sigma[32][AES_THREADS];
  uint32_t s[32];
  load_sigma_planes(s, seeds + seed * seed_stride, static_cast<size_t>(report_stride), R, w, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) sigma[i][threadIdx.x] = s[i];
  fixed_key_block<AES_THREADS>(s, sigma, keys, blk, R, w, t);
  transpose32(s);  // s[j]: bytes 4t .. 4t+3 of the block for report 32w + j
  if (live) {
    const size_t row = static_cast<size_t>(nb) * 16;
    uint8_t* dst = out + (static_cast<size_t>(32 * w) * S + seed) * row + 16 * blk + 4 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (32 * w + j < R) *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(j) * S * row) = s[j];
    }
  }
}

// Planes (8, 16, M, W) in and out, key planes (11, 8, 16, W): plane (b, k) of
// column (m, w) at planes[(16 b + k) * M * W + m * W + w].  Words run
// fastest, so a warp's loads of one plane are contiguous.
__global__ void __launch_bounds__(AES_THREADS)
aes_planes_kernel(const uint32_t* __restrict__ key, const uint32_t* __restrict__ planes,
                  uint32_t* __restrict__ out, int M, int W) {
  const int t = threadIdx.x & 3;
  const long long groups = static_cast<long long>(M) * W;
  long long g = (static_cast<long long>(blockIdx.x) * AES_THREADS + threadIdx.x) >> 2;
  const bool live = g < groups;
  if (!live) g = groups - 1;
  const int w = static_cast<int>(g % W);
  const size_t plane_stride = static_cast<size_t>(groups);
  // The thread's plane 8q + b is plane (b, 4t + q) of the stack.
  auto index = [&](int i) { return static_cast<size_t>(16 * (i & 7) + 4 * t + (i >> 3)); };
  uint32_t s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = __ldg(planes + index(i) * plane_stride + g);
  col_aes_rounds(s, t, [&](uint32_t x[32], int round) {
    const uint32_t* k = key + static_cast<size_t>(round) * 128 * W + w;
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] ^= __ldg(k + index(i) * W);
  });
  if (live) {
#pragma unroll
    for (int i = 0; i < 32; ++i) out[index(i) * plane_stride + g] = s[i];
  }
}

extern "C" int fixed_key_blocks(const void* keys, const void* seeds, long long report_stride,
                                long long seed_stride, void* out, int R, int S, int nb,
                                void* stream) {
  const long long threads = 4LL * ((R + 31) / 32) * S * nb;
  fixed_key_kernel<<<static_cast<int>((threads + AES_THREADS - 1) / AES_THREADS), AES_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(keys), static_cast<const uint8_t*>(seeds), report_stride,
      seed_stride, static_cast<uint8_t*>(out), R, S, nb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aes_bitsliced(const void* key, const void* planes, void* out, int M, int W,
                             void* stream) {
  const long long threads = 4LL * M * W;
  aes_planes_kernel<<<static_cast<int>((threads + AES_THREADS - 1) / AES_THREADS), AES_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(planes),
      static_cast<uint32_t*>(out), M, W);
  return static_cast<int>(cudaGetLastError());
}
