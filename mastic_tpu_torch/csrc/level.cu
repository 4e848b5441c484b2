// Kernel K3: one whole VIDPF tree level (Field64 or Field128 payloads of any
// length), two kernels behind one launch function.
//
// Replaces the TPU kernel mastic_tpu/ops/level_pallas.py:level_step_pallas
// (the 39-stage fused level over a (report tile x parent tile) grid).  Per
// parent and 32 reports it computes what mastic_tpu/backend/vidpf_jax.py
// level_core plus the node-proof sponge compute:
//   extend: 2 Davies-Meyer fixed-key AES blocks per parent;
//   correct: ctrl-bit extraction, seed and ctrl correction by packed masks;
//   convert: `convert_blocks` AES blocks per child -> next seed, payload limbs
//     with the in-range mask and w_cw added mod p where the child holds ctrl;
//   node proof: TurboSHAKE128 over prefix | next seed | binder, over as many
//     rate blocks as the message needs, XORed with proof_cw where the child
//     holds ctrl.
// Unlike the TPU kernel, the binder length, the prefix length and the number
// of convert blocks are runtime arguments, so the incremental round (whose
// binder grows with the level), any ctx and any payload go through it (the
// TPU kernel's limit of 8 convert blocks was its VMEM envelope's).
//
// What bounds it on the H100: integer issue.  Per 32 reports and one parent:
// 6 bitsliced AES columns (~18.8k instructions each) plus 64 Keccak-p
// permutations (~2.2k each), ~0.25M instructions for 64 node evals, against
// ~150 bytes of input and output per node eval: compute-bound by two orders
// of magnitude.
//
// Design.  level_kernel: four adjacent lanes own one (child node, packed
// word w) pair, one AES column each (aes_column.cuh; the fixed-key block,
// fixed_key.cuh, is K2's too): 32 state planes per
// thread in registers and its 32 sigma planes in shared memory, so nothing
// spills (the earlier one-thread-per-pair form held all 128 planes plus the
// S-box temporaries: 255 registers and 4676 bytes of spill stores).  The group
// runs the child's extend block, the correction, then its convert blocks,
// keeping the corrected child seed only as its sigma.  Inputs and outputs
// stay report-major (the layouts of the JAX package's level step): 32 x 32
// bit transposes in the thread turn each report's 32-bit word into the
// thread's planes and back, so the wrapper packs nothing (in PyTorch the
// packing took ~5 ms a call, 20 times the kernel).  The payload step is a
// template on the limb count: the two halves of a Field64 element meet by one
// shuffle; a Field128 element is a whole block, its four words in the four
// threads, gathered by a 4 x 4 exchange of shuffles.  The convert loop is not
// unrolled, so registers do not grow with the payload: a long payload (1026
// blocks for SumVec(1024)) is one long chain per group, not a larger kernel.  The round keys are transposed anew
// for each AES round: no room to keep 11 x 32 planes per thread.  At 4096
// reports x 32 parents that is 8192 groups, 256 blocks of 128 threads: all
// 132 SMs, about eight warps each.
// node_proof_kernel: one thread per (report, child), reading the seed that
// level_kernel wrote.  The public part of every message (prefix, binder,
// padding) arrives as a per-node template of rate-block lanes that the
// wrapper builds once per call; the thread XORs its 16-byte seed into the
// template lanes it straddles and absorbs block by block.
#include <cuda_runtime.h>

#include "field128.cuh"
#include "fixed_key.cuh"
#include "keccak.cuh"

using namespace mtk;

constexpr int LEVEL_THREADS = 128;

// The 32-bit mask of a per-report flag (bool bytes `stride` apart) over the
// reports 32w .. 32w+31: each of the four threads reads 8, shuffles merge.
__device__ __forceinline__ uint32_t load_mask(const uint8_t* __restrict__ flags, size_t stride,
                                              int R, int w, int t) {
  uint32_t m = 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = 8 * t + jj;
    const int r = 32 * w + j;
    if (r < R && flags[r * stride]) m |= 1u << j;
  }
  m |= __shfl_xor_sync(FULL_WARP, m, 1, 4);
  return m | __shfl_xor_sync(FULL_WARP, m, 2, 4);
}

// One convert block of Field64 payload, s[j] holding word t of the block for
// report 32w + j.  Element e = 2 (blk - 1) + (t >> 1): its low word in thread
// 2h, its high word in thread 2h + 1, which meet by one shuffle; each of the
// two takes 16 of the 32 reports.  With an odd VALUE_LEN the last block's
// second element is past the payload and is dropped by the e < value_len
// guard.
__device__ __forceinline__ void payload_f64(const uint32_t s[32], uint32_t& okmask, uint32_t tb,
                                            const int32_t* __restrict__ wcw,
                                            int32_t* __restrict__ w_out, bool live, int R, int w,
                                            int t, int n2, int node, int blk, int value_len) {
  const int odd = t & 1;
  const int e = 2 * (blk - 1) + (t >> 1);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t got = __shfl_xor_sync(FULL_WARP, odd ? s[2 * i] : s[2 * i + 1], 1, 4);
    const uint32_t mine = odd ? s[2 * i + 1] : s[2 * i];
    uint64_t v = odd ? (static_cast<uint64_t>(mine) << 32) | got
                     : (static_cast<uint64_t>(got) << 32) | mine;
    const int j = 2 * i + odd;
    const size_t r = static_cast<size_t>(32 * w + j);
    if (live && e < value_len && r < static_cast<size_t>(R)) {
      if (v >= F64_P) okmask &= ~(1u << j);
      if ((tb >> j) & 1u)
        v = f64_add(v, limbs64(__ldg(reinterpret_cast<const int4*>(wcw + (r * value_len + e) * 4))));
      *reinterpret_cast<int4*>(w_out + ((r * n2 + node) * value_len + e) * 4) = limbs_of(v);
    }
  }
}

// a, b, c or d by k in 0..3, with the four in registers.
__device__ __forceinline__ uint32_t pick4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, int k) {
  return (k & 2) ? ((k & 1) ? d : c) : ((k & 1) ? b : a);
}

// One convert block of Field128 payload: the block is element e = blk - 1,
// whose four words sit in the four threads of the group.  A 4 x 4 exchange
// (three xor shuffles per report, the sent word picked by a select so that
// no register array is indexed at run time) gives thread t the whole
// element of the reports 32w + 8t .. 32w + 8t + 7: in round d it sends word
// t of report 8 (t ^ d) + i and receives word t ^ d of report 8t + i.
__device__ __forceinline__ void payload_f128(const uint32_t s[32], uint32_t& okmask, uint32_t tb,
                                             const int32_t* __restrict__ wcw,
                                             int32_t* __restrict__ w_out, bool live, int R,
                                             int w, int t, int n2, int node, int blk,
                                             int value_len) {
  const int e = blk - 1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t got[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint32_t send = pick4(s[i], s[8 + i], s[16 + i], s[24 + i], t ^ d);
      got[d] = d ? __shfl_xor_sync(FULL_WARP, send, d, 4) : send;
    }
    // got[d] is word t ^ d, so word k is got[k ^ t].
    const uint32_t w0 = pick4(got[0], got[1], got[2], got[3], t);
    const uint32_t w1 = pick4(got[0], got[1], got[2], got[3], t ^ 1);
    const uint32_t w2 = pick4(got[0], got[1], got[2], got[3], t ^ 2);
    const uint32_t w3 = pick4(got[0], got[1], got[2], got[3], t ^ 3);
    u128 v{static_cast<uint64_t>(w0) | (static_cast<uint64_t>(w1) << 32),
           static_cast<uint64_t>(w2) | (static_cast<uint64_t>(w3) << 32)};
    const int j = 8 * t + i;
    const size_t r = static_cast<size_t>(32 * w + j);
    if (live && e < value_len && r < static_cast<size_t>(R)) {
      if (!f128_lt_p(v)) okmask &= ~(1u << j);
      if ((tb >> j) & 1u) {
        const int4* c = reinterpret_cast<const int4*>(wcw + (r * value_len + e) * 8);
        v = f128_add(v, limbs128(__ldg(c), __ldg(c + 1)));
      }
      int4* out = reinterpret_cast<int4*>(w_out + ((r * n2 + node) * value_len + e) * 8);
      out[0] = limbs_of(v.lo);
      out[1] = limbs_of(v.hi);
    }
  }
}

template <int NL>
__global__ void __launch_bounds__(LEVEL_THREADS)
level_kernel(const uint8_t* __restrict__ ext_rk, const uint8_t* __restrict__ conv_rk,
             const uint8_t* __restrict__ pseed, const uint8_t* __restrict__ pctrl,
             const uint8_t* __restrict__ seed_cw, const uint8_t* __restrict__ ctrl_cw,
             const int32_t* __restrict__ wcw, uint8_t* __restrict__ next_seed,
             uint8_t* __restrict__ ct, int32_t* __restrict__ w_out,
             uint8_t* __restrict__ ok, int R, int N, int convert_blocks, int value_len) {
  const int t = threadIdx.x & 3;
  const int W = (R + 31) / 32;
  const int n2 = 2 * N;
  const long long groups = static_cast<long long>(n2) * W;
  long long g = (static_cast<long long>(blockIdx.x) * LEVEL_THREADS + threadIdx.x) >> 2;
  // Groups past the end run on a copy of the last one and store nothing:
  // every lane has to reach the shuffles.
  const bool live = g < groups;
  if (!live) g = groups - 1;
  // Nodes run fastest, so the groups of a warp share their reports' rows.
  const int w = static_cast<int>(g / n2);
  const int node = static_cast<int>(g % n2);
  const int p = node >> 1;
  const int c = node & 1;

  __shared__ uint32_t sigma[32][LEVEL_THREADS];
  uint32_t planes[32];
  load_sigma_planes(planes, pseed + static_cast<size_t>(p) * 16, static_cast<size_t>(N) * 16, R, w,
                    t);
#pragma unroll
  for (int i = 0; i < 32; ++i) sigma[i][threadIdx.x] = planes[i];

  // -- extend child c, correct ---------------------------------------------
  uint32_t s[32];
  fixed_key_block<LEVEL_THREADS>(s, sigma, ext_rk, c, R, w, t);
  // Control bit: plane (bit 0, byte 0), thread 0's s[0]; cleared in the seed.
  // Corrections are mask ANDs: where the parent holds ctrl, XOR the words.
  const uint32_t pc = load_mask(pctrl + p, N, R, w, t);
  uint32_t tb = __shfl_sync(FULL_WARP, s[0], 0, 4);
  if (t == 0) s[0] = 0;
  load_planes(planes, seed_cw, 16, R, w, t);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] ^= planes[i] & pc;
  tb ^= pc & load_mask(ctrl_cw + c, 2, R, w, t);
  if (live) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * t + jj;
      if (32 * w + j < R) ct[static_cast<size_t>(32 * w + j) * n2 + node] = (tb >> j) & 1u;
    }
  }

  // sigma of the corrected child seed: the partner column t ^ 2 holds the
  // other half.
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const uint32_t other = __shfl_xor_sync(FULL_WARP, s[i], 2, 4);
    sigma[i][threadIdx.x] = t >= 2 ? other ^ s[i] : other;
  }

  // -- convert ---------------------------------------------------------------
  uint32_t okmask = 0xFFFFFFFFu;
#pragma unroll 1
  for (int blk = 0; blk < convert_blocks; ++blk) {
    fixed_key_block<LEVEL_THREADS>(s, sigma, conv_rk, blk, R, w, t);
    transpose32(s);  // s[j]: bytes 4t .. 4t+3 of this block for report j
    if (blk == 0) {
      if (live) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          if (32 * w + j < R)
            *reinterpret_cast<uint32_t*>(
                next_seed + (static_cast<size_t>(32 * w + j) * n2 + node) * 16 + 4 * t) = s[j];
        }
      }
      continue;
    }
    if constexpr (NL == 4)
      payload_f64(s, okmask, tb, wcw, w_out, live, R, w, t, n2, node, blk, value_len);
    else
      payload_f128(s, okmask, tb, wcw, w_out, live, R, w, t, n2, node, blk, value_len);
  }
  okmask &= __shfl_xor_sync(FULL_WARP, okmask, 1, 4);
  okmask &= __shfl_xor_sync(FULL_WARP, okmask, 2, 4);
  if (live) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * t + jj;
      if (32 * w + j < R) ok[static_cast<size_t>(32 * w + j) * n2 + node] = (okmask >> j) & 1u;
    }
  }
}

// One thread per (report, child) slot: TurboSHAKE128 (domain 1) over the
// template lanes of the slot's node, nb rate blocks of 21 lanes, with the
// 16-byte next seed XORed in at byte offset plen; the first 32 bytes out,
// XORed with proof_cw where the child holds ctrl.
__global__ void __launch_bounds__(128)
node_proof_kernel(const uint8_t* __restrict__ next_seed, const uint8_t* __restrict__ ct,
                  const uint8_t* __restrict__ pcw, const uint64_t* __restrict__ tmpl,
                  int nb, int plen, uint8_t* __restrict__ proof, int n2, long long slots) {
  const long long slot = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (slot >= slots) return;
  const int node = static_cast<int>(slot % n2);
  const long long r = slot / n2;
  const uint4 sd = *reinterpret_cast<const uint4*>(next_seed + slot * 16);
  const uint64_t s0 = static_cast<uint64_t>(sd.x) | (static_cast<uint64_t>(sd.y) << 32);
  const uint64_t s1 = static_cast<uint64_t>(sd.z) | (static_cast<uint64_t>(sd.w) << 32);
  // The seed's bytes land in lanes L0, L0 + 1 and, unless plen % 8 == 0, L0 + 2.
  const int l0 = plen >> 3;
  const int sh = 8 * (plen & 7);
  const uint64_t x0 = s0 << sh;
  const uint64_t x1 = sh ? (s0 >> (64 - sh)) | (s1 << sh) : s1;
  const uint64_t x2 = sh ? s1 >> (64 - sh) : 0;
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) a[l] = 0;
  const uint64_t* tl = tmpl + static_cast<size_t>(node) * nb * 21;
  for (int blk = 0; blk < nb; ++blk) {
#pragma unroll
    for (int l = 0; l < 21; ++l) {
      const int j = 21 * blk + l - l0;
      a[l] ^= ldg64(tl + 21 * blk + l) ^ (j == 0 ? x0 : j == 1 ? x1 : j == 2 ? x2 : 0);
    }
    keccak_p1600(a, 12);
  }
  const bool corr = ct[slot] != 0;
  const uint64_t* cw = reinterpret_cast<const uint64_t*>(pcw + r * 32);
  uint64_t* dst = reinterpret_cast<uint64_t*>(proof + slot * 32);
#pragma unroll
  for (int l = 0; l < 4; ++l) dst[l] = corr ? a[l] ^ ldg64(cw + l) : a[l];
}

extern "C" int level_step(const void* ext_rk, const void* conv_rk, const void* pseed,
                          const void* pctrl, const void* seed_cw, const void* ctrl_cw,
                          const void* wcw, const void* pcw, const void* tmpl, int nb,
                          int plen, void* next_seed, void* ct, void* w_out, void* ok,
                          void* proof, int R, int N, int convert_blocks, int value_len,
                          int num_limbs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long threads = 4LL * 2 * N * ((R + 31) / 32);  // four per (child, word)
  const int blocks = static_cast<int>((threads + LEVEL_THREADS - 1) / LEVEL_THREADS);
  auto kernel = num_limbs == 8 ? level_kernel<8> : level_kernel<4>;
  kernel<<<blocks, LEVEL_THREADS, 0, st>>>(
      static_cast<const uint8_t*>(ext_rk), static_cast<const uint8_t*>(conv_rk),
      static_cast<const uint8_t*>(pseed), static_cast<const uint8_t*>(pctrl),
      static_cast<const uint8_t*>(seed_cw), static_cast<const uint8_t*>(ctrl_cw),
      static_cast<const int32_t*>(wcw), static_cast<uint8_t*>(next_seed),
      static_cast<uint8_t*>(ct), static_cast<int32_t*>(w_out),
      static_cast<uint8_t*>(ok), R, N, convert_blocks, value_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = static_cast<long long>(R) * 2 * N;
  node_proof_kernel<<<static_cast<int>((slots + 127) / 128), 128, 0, st>>>(
      static_cast<const uint8_t*>(next_seed), static_cast<const uint8_t*>(ct),
      static_cast<const uint8_t*>(pcw), static_cast<const uint64_t*>(tmpl), nb, plen,
      static_cast<uint8_t*>(proof), 2 * N, slots);
  return static_cast<int>(cudaGetLastError());
}
