// Kernel K1: Keccak-p[1600, 12] and the TurboSHAKE128 sponge.
//
// Replaces the TPU kernel mastic_tpu/ops/keccak_pallas.py:keccak_p1600_pallas
// (the Pallas permutation over (50, B) uint32 lane planes).  Three entry points:
//   keccak_permute: the bare permutation (lanes as uint32 halves in, (..., 25)
//     lo/hi, as the JAX package lays them out);
//   turboshake: the whole sponge over a batch of messages that share a
//     prefix, a length and a domain byte: absorbs every rate block in one
//     launch and squeezes out_len bytes.  The rows of msg are read in place;
//   binder_sponge: the eval proof's onehot and payload checks, straight from
//     the carried tree (below).
//
// What bounds it on the H100: integer issue.  A 12-round permutation is
// about 2300 32-bit instructions as issued (194 a round as keccak.cuh's
// keccak_p1600 compiles: LOP3s for theta and chi, two funnel shifts a 64-bit
// rotate) for 168 bytes absorbed, ~14 instructions a byte, above the ~5 a
// byte at which HBM would bind.  A sub-partition's integer pipes take a warp
// instruction every two clocks, so the card reaches that rate only with a
// warp on each of its 528 sub-partitions.
//
// turboshake_kernel: a sponge is sequential, so the batch is its only
// parallelism, and the paths launch it over 4096-8192 messages: one thread a
// message would put 128-256 warps on the 528 sub-partitions, and a warp
// issues at most every other clock.  So each state is split over a pair of
// threads, one 32-bit half of every lane each (keccak_pair.cuh), which
// doubles the warps at the same instruction count.  A wider split was built
// and timed against it: five threads a state, a column each, with pi and
// chi's rows through a bank-conflict-free shared exchange (its source and
// the comparison: five_thread.cu and probe_forms.py under artifacts/), 683
// warps at 4096 messages.  It moves about four times the words a round
// between threads (40 shared accesses and 4 shuffles a thread against 29
// shuffles) and was slower at every shape the paths launch but the long
// squeeze, where the two overlap (0.0648 against 0.0505 ms at 4096 x 25
// rate blocks), so the pair stays.  A block of 64 threads
// holds 32 messages.  Their rate blocks come through shared memory: the block
// copies each message's 168-byte window with 16-byte cp.async copies
// (consecutive threads on consecutive chunks of a row, whatever the row's
// alignment: the window is widened to 16-byte bounds and every copied chunk
// holds a byte of the message), double-buffered, so that block k + 1 arrives
// while block k is permuted.  Each thread assembles its 21 half-lanes a block
// from two aligned shared words by one funnel shift, with no byte loop.  The
// shared prefix, the domain byte and pad10*1 come from a per-call template
// (ops/keccak.py::sponge_template): for the blocks that hold prefix bytes and
// for the final one, lane words to XOR and masks that keep only the message's
// bytes; every other block is message bytes only.  The squeeze stores 32-bit
// words where out_len is a multiple of 4, else bytes.
//
// keccak_permute_kernel: one thread a state (at a million states the card is
// full), the block's 128 states staged through shared memory by coalesced
// 16-byte loads and stores (the (..., 25) layout puts a thread's lanes 100
// bytes from its neighbour's), each thread reading its lanes at a stride of
// 25 words, which no two threads of a warp share a bank at.
//
// binder_sponge computes, per aggregator a and report r, TurboSHAKE128
// (domain 1, 32 bytes) over
//   onehot:  prefix || proof[a][r, onehot_idx[k]]            (32-byte rows)
//   payload: prefix || le(sub(w[par_k, e], add(w[left_k, e], w[right_k, e])))
//            for each row k and element e < value_len (8 bytes a Field64
//            element, 16 a Field128 one: the kernel is a template on the
//            element's limbs, and a Field128 difference yields two words)
// (mastic_tpu/backend/incremental.py IncrementalMastic._eval_proof), reading
// the rows where they lie in the (R, BITS * W, ...) carry: no gathered copy,
// no limb temporaries and no serialised message exist in device memory.
// Both checks of both aggregators go in one launch (4R messages at two
// aggregators), so a deep level's binder work fills the card's
// sub-partitions rather than a quarter of them.  The message's 64-bit words
// sit at a byte offset of plen = len(prefix) in the rate lanes; when plen % 8
// is not 0 each lane is a funnel shift over two consecutive words.  Interior
// onehot blocks load the six 32-byte rows of the next block (16-byte loads)
// before the permutation of the current one, so the loads overlap it.
#include <cuda_runtime.h>

#include "field128.cuh"
#include "keccak.cuh"
#include "keccak_pair.cuh"

using namespace mtk;

constexpr int PERM_THREADS = 128;

// src[0:words] -> dst[0:words] by the whole block, 16 bytes a thread where
// both sides are 16-byte aligned.
__device__ __forceinline__ void block_copy(uint32_t* __restrict__ dst,
                                           const uint32_t* __restrict__ src, int words) {
  int done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    done = words & ~3;
    for (int w = 4 * threadIdx.x; w < done; w += 4 * blockDim.x)
      *reinterpret_cast<uint4*>(dst + w) = *reinterpret_cast<const uint4*>(src + w);
  }
  for (int w = done + threadIdx.x; w < words; w += blockDim.x) dst[w] = src[w];
}

__global__ void __launch_bounds__(PERM_THREADS)
keccak_permute_kernel(const uint32_t* __restrict__ lo_in,
                      const uint32_t* __restrict__ hi_in,
                      uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
                      int batch, int num_rounds) {
  __shared__ __align__(16) uint32_t lo[PERM_THREADS * 25];
  __shared__ __align__(16) uint32_t hi[PERM_THREADS * 25];
  const long long first = static_cast<long long>(blockIdx.x) * PERM_THREADS;
  const int n = static_cast<int>(min(static_cast<long long>(PERM_THREADS), batch - first));
  const long long base = first * 25;
  block_copy(lo, lo_in + base, 25 * n);
  block_copy(hi, hi_in + base, 25 * n);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < n) {
    uint64_t a[25];
#pragma unroll
    for (int l = 0; l < 25; ++l)
      a[l] = static_cast<uint64_t>(lo[25 * t + l]) | (static_cast<uint64_t>(hi[25 * t + l]) << 32);
    keccak_p1600(a, num_rounds);
#pragma unroll
    for (int l = 0; l < 25; ++l) {
      lo[25 * t + l] = static_cast<uint32_t>(a[l]);
      hi[25 * t + l] = static_cast<uint32_t>(a[l] >> 32);
    }
  }
  __syncthreads();
  block_copy(lo_out + base, lo, 25 * n);
  block_copy(hi_out + base, hi, 25 * n);
}

constexpr int SPONGE_MSGS = 32;                 // messages a block
constexpr int SPONGE_THREADS = 2 * SPONGE_MSGS;
constexpr int SPONGE_CHUNKS = 12;               // 16-byte chunks covering a 168-byte window
constexpr int SPONGE_SLOT = 52;                 // words a message's window takes in shared memory
constexpr int RATE_WORDS = KECCAK_RATE / 4;     // 42

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The cp.async copies of one thread, the same (message m, chunk c) pairs at
// every rate block.  Rate block k of a message is its bytes v .. v + 167 in
// row coordinates, v = 168 k - plen; its window in shared memory is the 12
// chunks of 16 bytes from round_down(row + v, 16), so chunk c starts at row
// byte v - s + 16 c, s = (row + v) % 16 = (s0 + 8 k) % 16.
constexpr int SPONGE_COPIES = SPONGE_MSGS * SPONGE_CHUNKS / SPONGE_THREADS;  // 6

struct Stager {
  const uint8_t* row[SPONGE_COPIES];
  int dst[SPONGE_COPIES];  // the chunk's word in a buffer, -1 past the batch
  int c16[SPONGE_COPIES];  // 16 c
  int s0[SPONGE_COPIES];   // (row - plen) % 16

  __device__ __forceinline__ Stager(const uint8_t* msg, long long first, long long stride,
                                    int plen, int nmsg) {
#pragma unroll
    for (int n = 0; n < SPONGE_COPIES; ++n) {
      const int idx = threadIdx.x + SPONGE_THREADS * n;
      const int m = idx / SPONGE_CHUNKS;
      const int c = idx - SPONGE_CHUNKS * m;
      row[n] = msg + (first + min(m, nmsg - 1)) * stride;
      dst[n] = m < nmsg ? SPONGE_SLOT * m + 4 * c : -1;
      c16[n] = 16 * c;
      s0[n] = static_cast<int>((reinterpret_cast<uintptr_t>(row[n]) - plen) & 15);
    }
  }

  // Issue the copies of rate block k into buf.  A chunk is copied only if
  // it holds a byte of the row's [0, length), so no copy reads outside the
  // tensor; the window's other bytes are masked by the block's template.
  __device__ __forceinline__ void stage(uint32_t* buf, int k, int plen, int length) const {
    const int v = KECCAK_RATE * k - plen;
    const int lo_b = max(0, v);
    const int hi_b = min(length, v + KECCAK_RATE);
#pragma unroll
    for (int n = 0; n < SPONGE_COPIES; ++n) {
      const int off = v - ((s0[n] + 8 * k) & 15) + c16[n];
      if (dst[n] >= 0 && off < hi_b && off + 16 > lo_b) cp_async16(buf + dst[n], row[n] + off);
    }
  }
};

// tmpl: nt template blocks of RATE_WORDS lane words, then nt of masks;
// template block j < head is rate block j (it holds prefix bytes), block
// head the final rate block when that holds no prefix byte.
__global__ void __launch_bounds__(SPONGE_THREADS)
turboshake_kernel(const uint32_t* __restrict__ tmpl, int head, int nt,
                  const uint8_t* __restrict__ msg, long long stride, int plen,
                  int length, uint8_t* __restrict__ out, int out_len, int batch) {
  __shared__ __align__(16) uint32_t raw[2][SPONGE_MSGS * SPONGE_SLOT];
  const int t = threadIdx.x;
  const bool high = t & 1;
  const int slot = t >> 1;
  const long long first = static_cast<long long>(blockIdx.x) * SPONGE_MSGS;
  const long long i = first + slot;
  const bool live = i < batch;
  const int nmsg = static_cast<int>(min(static_cast<long long>(SPONGE_MSGS), batch - first));
  const Stager stager(msg, first, stride, plen, nmsg);
  // This thread's message: its window starts s = (s_own + 8 k) % 16 bytes
  // before block k's first byte.
  const int s_own = static_cast<int>(
      (reinterpret_cast<uintptr_t>(msg + (live ? i : first) * stride) - plen) & 15);
  const int nblk = (plen + length) / KECCAK_RATE + 1;
  uint32_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) a[l] = 0;
  stager.stage(raw[0], 0, plen, length);
  cp_async_commit();
  for (int k = 0; k < nblk; ++k) {
    if (k + 1 < nblk) stager.stage(raw[(k + 1) & 1], k + 1, plen, length);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    // This thread's half-lanes of block k: the word at block byte 8l + 4h
    // is window bytes s + 8l + 4h .. + 3.
    const int s = (s_own + 8 * k) & 15;
    const uint32_t* w = raw[k & 1] + SPONGE_SLOT * slot + (s >> 2) + high;
    const int sh = 8 * (s & 3);
    const int j = k < head ? k : (k == nblk - 1 ? head : -1);
    if (j < 0) {
#pragma unroll
      for (int l = 0; l < 21; ++l) a[l] ^= __funnelshift_r(w[2 * l], w[2 * l + 1], sh);
    } else {
      const uint32_t* tw = tmpl + RATE_WORDS * j + high;
      const uint32_t* mw = tw + RATE_WORDS * nt;
#pragma unroll
      for (int l = 0; l < 21; ++l)
        a[l] ^= (__funnelshift_r(w[2 * l], w[2 * l + 1], sh) & __ldg(mw + 2 * l)) ^ __ldg(tw + 2 * l);
    }
    __syncthreads();
    keccak_p1600_pair(a, high, 12);
  }
  uint8_t* dst = out + (live ? i : 0) * out_len;
  for (int produced = 0; produced < out_len; produced += KECCAK_RATE) {
    if (produced > 0) keccak_p1600_pair(a, high, 12);
    if (!live) continue;
    const int n = out_len - produced;
#pragma unroll
    for (int l = 0; l < 21; ++l) {
      const int p = 8 * l + 4 * high;
      uint8_t* o = dst + produced + p;
      if ((out_len & 3) == 0 && p + 4 <= n) {
        *reinterpret_cast<uint32_t*>(o) = a[l];
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (p + b < n) o[b] = static_cast<uint8_t>(a[l] >> (8 * b));
      }
    }
  }
}

// The message body of one binder check as a stream of 64-bit words, in
// order, 0 past its end.
struct OnehotWords {
  const uint8_t* base;  // proof rows of report r: base + row * 32
  const long long* idx;
  long long nbody, u, k;
  int q;
  __device__ __forceinline__ uint64_t next() {
    if (u >= nbody) return 0;
    const uint64_t v = *reinterpret_cast<const uint64_t*>(base + __ldg(idx + k) * 32 + 8 * q);
    ++u;
    if (++q == 4) {
      q = 0;
      ++k;
    }
    return v;
  }
};

// The payload check's words: per row k and element e the difference
// sub(w[par_k, e], add(w[left_k, e], w[right_k, e])), little-endian, as one
// word for a Field64 element (NL = 4 limbs) and two, low half then high half,
// for a Field128 one (NL = 8), as FieldSpec.plain_to_le_bytes orders them.
template <int NL>
struct PayloadWords {
  const int32_t* base;  // payload rows of report r: base + (row * vl + e) * NL
  const long long *par, *left, *right;
  long long nbody, u, k;
  int e, vl;
  uint64_t high;  // Field128: the high half of the difference just begun
  bool odd;       // Field128: the next word is `high`
  __device__ __forceinline__ const int4* at(const long long* idx) const {
    return reinterpret_cast<const int4*>(base + (__ldg(idx + k) * vl + e) * NL);
  }
  __device__ __forceinline__ void advance() {
    if (++e == vl) {
      e = 0;
      ++k;
    }
  }
  __device__ __forceinline__ uint64_t next() {
    if (u >= nbody) return 0;
    ++u;
    if constexpr (NL == 4) {
      const uint64_t v =
          f64_sub(limbs64(__ldg(at(par))), f64_add(limbs64(__ldg(at(left))), limbs64(__ldg(at(right)))));
      advance();
      return v;
    } else {
      if (odd) {
        odd = false;
        advance();
        return high;
      }
      const int4 *p = at(par), *l = at(left), *r = at(right);
      const u128 d = f128_sub(limbs128(__ldg(p), __ldg(p + 1)),
                              f128_add(limbs128(__ldg(l), __ldg(l + 1)),
                                       limbs128(__ldg(r), __ldg(r + 1))));
      high = d.hi;
      odd = true;
      return d.lo;
    }
  }
};

// Rate lane from the word that ends in it (prev) and the one that starts in
// it (cur), the message words sitting sh = 8 * (plen % 8) bits up.
__device__ __forceinline__ uint64_t shifted_lane(uint64_t prev, uint64_t cur, int sh) {
  return (cur << sh) | ((prev >> 1) >> (63 - sh));
}

// One rate block whose lanes may hold prefix bytes, the end of the body,
// the domain byte or the final 0x80: lane by lane from the word stream.
template <class Words>
__device__ __forceinline__ void absorb_general(uint64_t a[25], Words& words, uint64_t& prev,
                                               const uint64_t* __restrict__ pre, int p0,
                                               int sh, long long blk, long long lane_end,
                                               bool last) {
#pragma unroll
  for (int l = 0; l < 21; ++l) {
    const long long j = 21 * blk + l;
    uint64_t lane;
    if (j < p0) {
      lane = ldg64(pre + j);
    } else {
      const uint64_t cur = words.next();
      lane = shifted_lane(prev, cur, sh);
      prev = cur;
    }
    if (j == lane_end) lane ^= 1ull << sh;  // domain byte 0x01 at byte L
    a[l] ^= lane;
  }
  if (last) a[20] ^= 0x80ull << 56;
  keccak_p1600(a, 12);
}

// An interior onehot block from the six rows in fb (words Q0 .. Q0 + 20).
template <int Q0>
__device__ __forceinline__ void absorb_rows(uint64_t a[25], const uint64_t fb[24],
                                            uint64_t& prev, int sh) {
#pragma unroll
  for (int l = 0; l < 21; ++l) a[l] ^= shifted_lane(l ? fb[Q0 + l - 1] : prev, fb[Q0 + l], sh);
  prev = fb[Q0 + 20];
}

__device__ __forceinline__ void load_rows(uint64_t fb[24], const uint8_t* base,
                                          const long long* idx, long long k) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const ulonglong2* row = reinterpret_cast<const ulonglong2*>(base + __ldg(idx + k + i) * 32);
    const ulonglong2 lo = row[0];
    const ulonglong2 hi = row[1];
    fb[4 * i] = lo.x;
    fb[4 * i + 1] = lo.y;
    fb[4 * i + 2] = hi.x;
    fb[4 * i + 3] = hi.y;
  }
}

// blockIdx.y: 0 .. A-1 the onehot checks of aggregator y, A .. 2A-1 the
// payload checks of aggregator y - A.  out is (2, A, R, 32).  NL: the limbs
// of a payload element, 4 (Field64) or 8 (Field128).
template <int NL>
__global__ void __launch_bounds__(128)
binder_sponge_kernel(const uint8_t* __restrict__ proof0, const uint8_t* __restrict__ proof1,
                     const int32_t* __restrict__ w0, const int32_t* __restrict__ w1,
                     long long rows, int vl, const long long* __restrict__ onehot_idx,
                     long long onehot_rows, const long long* __restrict__ par,
                     const long long* __restrict__ left, const long long* __restrict__ right,
                     long long payload_rows, const uint64_t* __restrict__ pre_onehot,
                     const uint64_t* __restrict__ pre_payload, int plen,
                     uint8_t* __restrict__ out, int R, int A) {
  const long long r = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (r >= R) return;
  const int y = blockIdx.y;
  const bool onehot = y < A;
  const int agg = onehot ? y : y - A;
  const int p0 = plen >> 3;
  const int sh = 8 * (plen & 7);
  const long long nbody = onehot ? 4 * onehot_rows : (NL / 4) * vl * payload_rows;
  const long long lane_end = p0 + nbody;  // the lane of byte L = plen + 8 nbody
  const long long nblk = (plen + 8 * nbody) / 168 + 1;
  const uint64_t* pre = onehot ? pre_onehot : pre_payload;
  // The partial prefix lane as the word "before" body word 0.
  uint64_t prev = sh ? ldg64(pre + p0) << (64 - sh) : 0;
  uint64_t a[25];
#pragma unroll
  for (int l = 0; l < 25; ++l) a[l] = 0;
  // Blocks [bf0, bf1) hold body words only, all before the end.
  const long long bf0 = (p0 + 20) / 21;
  long long bf1 = onehot ? (nbody + p0) / 21 : 0;
  if (bf1 < bf0) bf1 = bf0;

  if (onehot) {
    OnehotWords words{(agg ? proof1 : proof0) + r * rows * 32, onehot_idx, nbody, 0, 0, 0};
    for (long long blk = 0; blk < bf0 && blk < nblk; ++blk)
      absorb_general(a, words, prev, pre, p0, sh, blk, lane_end, blk == nblk - 1);
    if (bf0 < bf1) {
      uint64_t fb[24];
      load_rows(fb, words.base, onehot_idx, (21 * bf0 - p0) >> 2);
      for (long long blk = bf0; blk < bf1; ++blk) {
        switch ((21 * blk - p0) & 3) {
          case 0: absorb_rows<0>(a, fb, prev, sh); break;
          case 1: absorb_rows<1>(a, fb, prev, sh); break;
          case 2: absorb_rows<2>(a, fb, prev, sh); break;
          default: absorb_rows<3>(a, fb, prev, sh); break;
        }
        if (blk + 1 < bf1) load_rows(fb, words.base, onehot_idx, (21 * (blk + 1) - p0) >> 2);
        keccak_p1600(a, 12);
      }
      words.u = 21 * bf1 - p0;
      words.k = words.u >> 2;
      words.q = static_cast<int>(words.u & 3);
    }
    for (long long blk = bf1; blk < nblk; ++blk)
      absorb_general(a, words, prev, pre, p0, sh, blk, lane_end, blk == nblk - 1);
  } else {
    PayloadWords<NL> words{(agg ? w1 : w0) + r * rows * vl * NL, par, left, right, nbody, 0, 0, 0,
                           vl, 0, false};
    for (long long blk = 0; blk < nblk; ++blk)
      absorb_general(a, words, prev, pre, p0, sh, blk, lane_end, blk == nblk - 1);
  }
  uint64_t* dst = reinterpret_cast<uint64_t*>(out + ((static_cast<long long>(y) * R) + r) * 32);
#pragma unroll
  for (int l = 0; l < 4; ++l) dst[l] = a[l];
}

extern "C" int keccak_permute(const void* lo, const void* hi, void* lo_out,
                              void* hi_out, int batch, int num_rounds,
                              void* stream) {
  const int blocks = (batch + PERM_THREADS - 1) / PERM_THREADS;
  keccak_permute_kernel<<<blocks, PERM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
      static_cast<uint32_t*>(lo_out), static_cast<uint32_t*>(hi_out), batch,
      num_rounds);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int turboshake(const void* tmpl, int head, int nt, const void* msg,
                          long long stride, int plen, int length,
                          void* out, int out_len, int batch, void* stream) {
  const int blocks = (batch + SPONGE_MSGS - 1) / SPONGE_MSGS;
  turboshake_kernel<<<blocks, SPONGE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tmpl), head, nt, static_cast<const uint8_t*>(msg),
      stride, plen, length, static_cast<uint8_t*>(out), out_len, batch);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int binder_sponge(const void* proof0, const void* proof1, const void* w0,
                             const void* w1, long long rows, int vl, int nl,
                             const void* onehot_idx,
                             long long onehot_rows, const void* par, const void* left,
                             const void* right, long long payload_rows,
                             const void* pre_onehot, const void* pre_payload, int plen,
                             void* out, int R, int A, void* stream) {
  const int threads = 128;
  const dim3 grid((R + threads - 1) / threads, 2 * A);
  auto kernel = nl == 8 ? binder_sponge_kernel<8> : binder_sponge_kernel<4>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(proof0), static_cast<const uint8_t*>(proof1),
      static_cast<const int32_t*>(w0), static_cast<const int32_t*>(w1), rows, vl,
      static_cast<const long long*>(onehot_idx), onehot_rows,
      static_cast<const long long*>(par), static_cast<const long long*>(left),
      static_cast<const long long*>(right), payload_rows,
      static_cast<const uint64_t*>(pre_onehot), static_cast<const uint64_t*>(pre_payload),
      plen, static_cast<uint8_t*>(out), R, A);
  return static_cast<int>(cudaGetLastError());
}
