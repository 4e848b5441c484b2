// K1's in-place sponge with one state over five threads, one column each:
// the form that artifacts/torch_port_pr12/probe_forms.py timed against the
// pair form (csrc/keccak_pair.cuh) and that lost at every path shape, kept
// here so that the comparison can be run again.  It is the measured source:
// keccak_col.cuh's permutation, then keccak.cu's cp.async staging and the
// five-thread sponge kernel with its C entry `turboshake_col` (the pair
// form's `turboshake` signature).  Built by the probe alone:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v -I mastic_tpu_torch/csrc
//        -o libfive.so artifacts/torch_port_pr12/five_thread.cu
//
// Keccak-p[1600] with one state over five threads, one column each
// (turboshake_col_kernel below).
//
// Lanes 5s .. 5s + 4 of a warp hold state s < 6, lane 5s + x its column
// x: A[x + 5y] for y = 0..4 as 32-bit halves lo[y], hi[y].  Lanes 30 and
// 31 mirror lanes 0 and 1 (state 0, columns 0 and 1) and store nothing,
// so every shuffle and shared load of the warp stays in step.  A round:
//   theta: the column parity is the thread's own, its two neighbours'
//     come by four shuffles;
//   rho: the thread's five rotation amounts are fixed by its column, so
//     each lane is two funnel shifts by a register amount; whether the
//     amount exceeds 31 only swaps the two results, and that swap is
//     folded into where they are stored;
//   pi: each thread stores its five rotated lanes at their pi positions in
//     a shared exchange of two planes (lo and hi), word 30 Y + 5 s + X of
//     lane (X, Y) of state s.  Every store of the round (one y of each of
//     the 30 threads) and every load (one row Y and column offset of each)
//     then falls on 30 distinct banks, whichever plane each thread's
//     result goes to (the planes start 160 words apart);
//   chi: after a __syncwarp each thread loads, for each row Y, lanes X,
//     X + 1 and X + 2 and keeps its column X: the state ends the round in
//     the layout it began it in.
// The exchange alternates between two buffers from round to round, so a
// round needs one __syncwarp.  A round is ~50 integer instructions, 4
// shuffles and 40 shared accesses a thread: about 1.4 times the integer
// work of one thread holding the state (keccak.cuh::keccak_p1600), spread
// over five times the threads.
#include <cuda_runtime.h>

#include <cstdint>

#include "keccak.cuh"

namespace mtk {

constexpr int COL_STATES = 6;        // states a warp
// A plane holds 5 rows x 6 states x 5 words; 160 keeps both planes and
// both buffers on the same banks.
constexpr int COL_PLANE = 160;
constexpr int COL_BUF = 2 * COL_PLANE;
constexpr int COL_EXCHANGE = 2 * COL_BUF;  // words of a warp's exchange
constexpr unsigned COL_FULL = 0xffffffffu;

// rho offsets r[x + 5y].
__device__ __constant__ int KECCAK_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55,
                                              20, 3,  10, 43, 25, 39, 41, 45, 15,
                                              21, 8,  18, 2,  61, 56, 14};

// What a thread needs to run its column of a round: fixed for a launch.
struct ColThread {
  int x;         // column
  int s;         // state within the warp
  bool on;       // a lane of its own (not one of the mirrored lanes 30, 31)
  int left, right;         // lanes holding columns x - 1 and x + 1
  int rot[5];              // rho amount mod 32 of lane (x, y)
  int store_a[5], store_b[5];  // words of the two funnel results of lane y
  int load[3];             // word of lane (x + k, 0), k = 0, 1, 2
  uint32_t iota;           // all ones in column 0

  __device__ __forceinline__ explicit ColThread(int lane) {
    const int g = lane / 5;
    on = g < COL_STATES;
    s = on ? g : 0;
    x = on ? lane - 5 * g : lane - 5 * COL_STATES;
    left = 5 * s + (x + 4) % 5;
    right = 5 * s + (x + 1) % 5;
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      const int n = KECCAK_RHO[x + 5 * y];
      rot[y] = n & 31;
      // Lane (x, y) goes to (y, 2x + 3y).  F(lo, hi, n) is the rotated
      // lane's high half for n < 32, its low half past that.
      const int w = 30 * ((2 * x + 3 * y) % 5) + 5 * s + y;
      store_a[y] = w + (n < 32 ? COL_PLANE : 0);
      store_b[y] = w + (n < 32 ? 0 : COL_PLANE);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) load[k] = 5 * s + (x + k) % 5;
    iota = x == 0 ? 0xffffffffu : 0u;
  }
};

// One round on buffer B of the warp's exchange ex.
template <int B>
__device__ __forceinline__ void col_round(uint32_t lo[5], uint32_t hi[5], const ColThread& t,
                                          uint32_t* __restrict__ ex, uint64_t rc) {
  uint32_t* buf = ex + B * COL_BUF;
  // theta
  const uint32_t clo = lo[0] ^ lo[1] ^ lo[2] ^ lo[3] ^ lo[4];
  const uint32_t chi = hi[0] ^ hi[1] ^ hi[2] ^ hi[3] ^ hi[4];
  const uint32_t llo = __shfl_sync(COL_FULL, clo, t.left);
  const uint32_t lhi = __shfl_sync(COL_FULL, chi, t.left);
  const uint32_t rlo = __shfl_sync(COL_FULL, clo, t.right);
  const uint32_t rhi = __shfl_sync(COL_FULL, chi, t.right);
  const uint32_t dlo = llo ^ __funnelshift_l(rhi, rlo, 1);
  const uint32_t dhi = lhi ^ __funnelshift_l(rlo, rhi, 1);
  // rho, pi
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const uint32_t l = lo[y] ^ dlo;
    const uint32_t h = hi[y] ^ dhi;
    const uint32_t a = __funnelshift_l(l, h, t.rot[y]);
    const uint32_t b = __funnelshift_l(h, l, t.rot[y]);
    if (t.on) {
      buf[t.store_a[y]] = a;
      buf[t.store_b[y]] = b;
    }
  }
  __syncwarp();
  // chi
#pragma unroll
  for (int y = 0; y < 5; ++y) {
    const uint32_t* row = buf + 30 * y;
    lo[y] = row[t.load[0]] ^ (~row[t.load[1]] & row[t.load[2]]);
    hi[y] = row[COL_PLANE + t.load[0]] ^
            (~row[COL_PLANE + t.load[1]] & row[COL_PLANE + t.load[2]]);
  }
  // iota
  lo[0] ^= static_cast<uint32_t>(rc) & t.iota;
  hi[0] ^= static_cast<uint32_t>(rc >> 32) & t.iota;
}

// Keccak-p[1600, 12] on this thread's column.  Every lane of the warp
// must call it.
__device__ __forceinline__ void keccak_p1600_col(uint32_t lo[5], uint32_t hi[5],
                                                 const ColThread& t, uint32_t* ex) {
#pragma unroll 1
  for (int r = 12; r < 24; r += 2) {
    col_round<0>(lo, hi, t, ex, KECCAK_RC[r]);
    col_round<1>(lo, hi, t, ex, KECCAK_RC[r + 1]);
  }
}

}  // namespace mtk

using namespace mtk;

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
// every rate block, for a block of THREADS threads that holds MSGS
// messages.  Rate block k of a message is its bytes v .. v + 167 in row
// coordinates, v = 168 k - plen; its window in shared memory is the 12
// chunks of 16 bytes from round_down(row + v, 16), so chunk c starts at row
// byte v - s + 16 c, s = (row + v) % 16 = (s0 + 8 k) % 16.
template <int MSGS, int THREADS>
struct Stager {
  static constexpr int COPIES = (MSGS * SPONGE_CHUNKS + THREADS - 1) / THREADS;
  const uint8_t* row[COPIES];
  int dst[COPIES];  // the chunk's word in a buffer, -1 past the batch
  int c16[COPIES];  // 16 c
  int s0[COPIES];   // (row - plen) % 16

  __device__ __forceinline__ Stager(const uint8_t* msg, long long first, long long stride,
                                    int plen, int nmsg) {
#pragma unroll
    for (int n = 0; n < COPIES; ++n) {
      const int idx = threadIdx.x + THREADS * n;
      const int m = min(idx / SPONGE_CHUNKS, MSGS - 1);
      const int c = idx - SPONGE_CHUNKS * (idx / SPONGE_CHUNKS);
      row[n] = msg + (first + min(m, nmsg - 1)) * stride;
      dst[n] = idx < MSGS * SPONGE_CHUNKS && m < nmsg ? SPONGE_SLOT * m + 4 * c : -1;
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
    for (int n = 0; n < COPIES; ++n) {
      const int off = v - ((s0[n] + 8 * k) & 15) + c16[n];
      if (dst[n] >= 0 && off < hi_b && off + 16 > lo_b) cp_async16(buf + dst[n], row[n] + off);
    }
  }
};

// The same sponge with a state over five threads (keccak_col.cuh): a warp
// a block, six messages a warp.  tmpl, head and nt as turboshake_kernel's.
__global__ void __launch_bounds__(32)
turboshake_col_kernel(const uint32_t* __restrict__ tmpl, int head, int nt,
                      const uint8_t* __restrict__ msg, long long stride, int plen,
                      int length, uint8_t* __restrict__ out, int out_len, int batch) {
  __shared__ __align__(16) uint32_t raw[2][COL_STATES * SPONGE_SLOT];
  __shared__ uint32_t ex[COL_EXCHANGE];
  const ColThread t(threadIdx.x);
  const long long first = static_cast<long long>(blockIdx.x) * COL_STATES;
  const long long i = first + t.s;
  const bool live = t.on && i < batch;
  const int nmsg = static_cast<int>(min(static_cast<long long>(COL_STATES), batch - first));
  const Stager<COL_STATES, 32> stager(msg, first, stride, plen, nmsg);
  const int s_own = static_cast<int>(
      (reinterpret_cast<uintptr_t>(msg + min(i, static_cast<long long>(batch) - 1) * stride) -
       plen) & 15);
  const int nblk = (plen + length) / KECCAK_RATE + 1;
  uint32_t lo[5], hi[5];
#pragma unroll
  for (int y = 0; y < 5; ++y) lo[y] = hi[y] = 0;
  stager.stage(raw[0], 0, plen, length);
  cp_async_commit();
  for (int k = 0; k < nblk; ++k) {
    if (k + 1 < nblk) stager.stage(raw[(k + 1) & 1], k + 1, plen, length);
    cp_async_commit();
    cp_async_wait_prior();
    __syncwarp();
    // Lane x + 5y of block k is window bytes s + 8 (x + 5y) .. + 7.
    const int s = (s_own + 8 * k) & 15;
    const uint32_t* w = raw[k & 1] + SPONGE_SLOT * t.s + (s >> 2) + 2 * t.x;
    const int sh = 8 * (s & 3);
    const int j = k < head ? k : (k == nblk - 1 ? head : -1);
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      if (y == 4 && t.x != 0) break;  // lanes 21-24: capacity
      uint32_t ml = __funnelshift_r(w[10 * y], w[10 * y + 1], sh);
      uint32_t mh = __funnelshift_r(w[10 * y + 1], w[10 * y + 2], sh);
      if (j >= 0) {
        const uint32_t* tw = tmpl + RATE_WORDS * j + 2 * (t.x + 5 * y);
        const uint32_t* mw = tw + RATE_WORDS * nt;
        ml = (ml & __ldg(mw)) ^ __ldg(tw);
        mh = (mh & __ldg(mw + 1)) ^ __ldg(tw + 1);
      }
      lo[y] ^= ml;
      hi[y] ^= mh;
    }
    keccak_p1600_col(lo, hi, t, ex);
  }
  uint8_t* dst = out + (live ? i : 0) * out_len;
  for (int produced = 0; produced < out_len; produced += KECCAK_RATE) {
    if (produced > 0) keccak_p1600_col(lo, hi, t, ex);
    if (!live) continue;
    const int n = out_len - produced;
#pragma unroll
    for (int y = 0; y < 5; ++y) {
      const int p = 8 * (t.x + 5 * y);
      if (p >= KECCAK_RATE || p >= n) break;
      uint8_t* o = dst + produced + p;
      if ((out_len & 3) == 0) {
        *reinterpret_cast<uint32_t*>(o) = lo[y];
        if (p + 4 < n) *reinterpret_cast<uint32_t*>(o + 4) = hi[y];
      } else {
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (p + b < n) o[b] = static_cast<uint8_t>((b < 4 ? lo[y] : hi[y]) >> (8 * (b & 3)));
      }
    }
  }
}

extern "C" int turboshake_col(const void* tmpl, int head, int nt, const void* msg,
                              long long stride, int plen, int length,
                              void* out, int out_len, int batch, void* stream) {
  const int blocks = (batch + COL_STATES - 1) / COL_STATES;
  turboshake_col_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tmpl), head, nt, static_cast<const uint8_t*>(msg),
      stride, plen, length, static_cast<uint8_t*>(out), out_len, batch);
  return static_cast<int>(cudaGetLastError());
}

