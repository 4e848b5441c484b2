// Kernel K1: Keccak-p[1600, 12] and the TurboSHAKE128 sponge.
//
// Replaces the TPU kernel mastic_tpu/ops/keccak_pallas.py:keccak_p1600_pallas
// (the Pallas permutation over (50, B) uint32 lane planes).  Three entry points:
//   keccak_permute: the bare permutation, one thread per state (lanes as
//     uint32 halves in, (..., 25) lo/hi, as the JAX package lays them out);
//   turboshake: the whole sponge, one thread per message: absorbs a runtime
//     number of rate blocks in one launch (pad10*1 at a runtime `length`
//     shared by the batch) and squeezes out_len bytes.  The message is a
//     short prefix shared by the batch followed by each row of msg, which
//     is read in place;
//   binder_sponge: the eval proof's onehot and payload checks, straight from
//     the carried tree (below).
//
// What bounds it on the H100: integer issue.  A 12-round permutation is about
// 2160 32-bit instructions as issued (180 per round: LOP3s for theta and chi,
// two funnel shifts per 64-bit rotate) for 168 bytes absorbed, ~13
// instructions per byte, above the ~5 per byte at which HBM would bind.  Each
// sponge is sequential, so parallelism is the batch of messages: one thread
// per message, each warp issuing on one SM sub-partition.  The design keeps
// the whole state in registers (no shared memory, no local memory).
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
