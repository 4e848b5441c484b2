// Kernel K2: bitsliced AES-128 encryption, 32 reports per uint32 word.
//
// Replaces the TPU kernel
// mastic_tpu/ops/aes_pallas.py:aes128_encrypt_bitsliced_pallas (whitening,
// nine rounds and the final round without MixColumns over (128, M, W) plane
// blocks with per-word key planes (1408, 1, W)).  Here one thread encrypts
// one (block m, packed word w) column of the (128, M, W) plane stack:
// threads run along W, so every plane load and store is coalesced, and the
// key planes (11 * 128, W) are shared by all M blocks of a word.
//
// What bounds it on the H100: integer issue.  One bitsliced column is about
// 10 * 16 * 195 S-box gates + 9 * 16 * 35 MixColumns XORs + 11 * 128 key
// XORs ~ 37.6k 2-input gates, at least ~18.8k instructions with two gates
// per LOP3, for 32 blocks of 16 bytes (~37 instructions per byte), against
// 128 * 4 * 2 bytes moved per column: compute-bound by a wide margin.  The 128 state words plus the S-box temporaries sit at the edge of
// the 255-register limit: ptxas (CUDA 12.8, -Xptxas -v, printed by
// chip_smoke.py) reports 255 registers and 104 bytes of spill stores and
// loads (a 112-byte stack frame) for this first version.
#include <cuda_runtime.h>

#include "aes_bitsliced.cuh"

using namespace mtk;

__global__ void __launch_bounds__(128)
aes_bitsliced_kernel(const uint32_t* __restrict__ key,
                     const uint32_t* __restrict__ planes,
                     uint32_t* __restrict__ out, int M, int W) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (idx >= static_cast<long long>(M) * W) return;
  const int w = static_cast<int>(idx % W);
  const size_t plane_stride = static_cast<size_t>(M) * W;
  uint32_t s[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) s[i] = planes[i * plane_stride + idx];
  aes_encrypt_planes(s, key, W, w);
#pragma unroll
  for (int i = 0; i < 128; ++i) out[i * plane_stride + idx] = s[i];
}

extern "C" int aes_bitsliced(const void* key, const void* planes, void* out,
                             int M, int W, void* stream) {
  const int threads = 128;
  const long long total = static_cast<long long>(M) * W;
  const int blocks = static_cast<int>((total + threads - 1) / threads);
  aes_bitsliced_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(planes),
      static_cast<uint32_t*>(out), M, W);
  return static_cast<int>(cudaGetLastError());
}
