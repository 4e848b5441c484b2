// Kernel K1: Keccak-p[1600, 12] and the TurboSHAKE128 sponge.
//
// Replaces the TPU kernel mastic_tpu/ops/keccak_pallas.py:keccak_p1600_pallas
// (the Pallas permutation over (50, B) uint32 lane planes).  Two entry points:
//   keccak_permute: the bare permutation, one thread per state (lanes as
//     uint32 halves in, (..., 25) lo/hi, as the JAX package lays them out);
//   turboshake: the whole sponge, one thread per message: absorbs a runtime
//     number of rate blocks in one launch (pad10*1 at a runtime `length`
//     shared by the batch) and squeezes out_len bytes.  The message is a
//     short prefix shared by the batch followed by each row of msg, which
//     is read in place, so the binder sponges, whose messages grow with the
//     tree depth (about 2 KiB per level per report at a 64-node frontier),
//     never build a padded copy or a copy behind their dst prefix.
//
// What bounds it on the H100: integer issue.  A 12-round permutation is about
// 2160 32-bit instructions as issued (180 per round: LOP3s for theta and chi,
// two funnel shifts per 64-bit rotate) for 168 bytes absorbed, ~13
// instructions per byte, above the ~5 per byte at which HBM would bind.  Each sponge is sequential, so
// parallelism is the batch: a short batch (4096 reports) fills only a few
// warps per SM and the long deep-level binders run latency-bound.  The design
// keeps the whole state in registers (no shared memory, no local memory) and
// reads the message with 8-byte loads where the rows are 8-byte aligned.
#include <cuda_runtime.h>

#include "keccak.cuh"

using namespace mtk;

__global__ void __launch_bounds__(128)
keccak_permute_kernel(const uint32_t* __restrict__ lo_in,
                      const uint32_t* __restrict__ hi_in,
                      uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
                      int batch, int num_rounds) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= batch) return;
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l)
    a[l] = static_cast<uint64_t>(lo_in[i * 25 + l]) |
           (static_cast<uint64_t>(hi_in[i * 25 + l]) << 32);
  keccak_p1600(a, num_rounds);
#pragma unroll
  for (int l = 0; l < 25; ++l) {
    lo_out[i * 25 + l] = static_cast<uint32_t>(a[l]);
    hi_out[i * 25 + l] = static_cast<uint32_t>(a[l] >> 32);
  }
}

__global__ void __launch_bounds__(128)
turboshake_kernel(const uint8_t* __restrict__ pre, int plen,
                  const uint8_t* __restrict__ msg, long long stride,
                  long long length, int domain, uint8_t* __restrict__ out,
                  int out_len, int batch, int aligned) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= batch) return;
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) a[l] = 0;
  turboshake_absorb(a, pre, plen, msg + i * stride, length, domain, aligned != 0);
  turboshake_squeeze(a, out + i * out_len, out_len);
}

extern "C" int keccak_permute(const void* lo, const void* hi, void* lo_out,
                              void* hi_out, int batch, int num_rounds,
                              void* stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  keccak_permute_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<uint32_t*>(lo_out), static_cast<uint32_t*>(hi_out), batch,
      num_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int turboshake(const void* pre, int plen, const void* msg,
                          long long stride, long long length, int domain,
                          void* out, int out_len, int batch, int aligned,
                          void* stream) {
  const int threads = 128;
  const int blocks = (batch + threads - 1) / threads;
  turboshake_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pre), plen, static_cast<const uint8_t*>(msg),
      stride, length, domain,
      static_cast<uint8_t*>(out), out_len, batch, aligned);
  return static_cast<int>(cudaGetLastError());
}
