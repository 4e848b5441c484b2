// The field kernel: one elementwise Field64 or Field128 operation (add, sub or
// the Montgomery product) over two operands of 16-bit limbs, in one launch.
//
// It replaces no TPU kernel.  The JAX package's field arithmetic
// (mastic_tpu/ops/field_jax.py) is XLA code over uint32 limbs, which XLA fused
// into the programs around it.  The port ran the same limb chains as eager
// PyTorch int64 operations, 130 to 820 launches a field operation
// (ops/field.py keeps them as the plain version, FieldSpec.plain), so the FLP
// weight check launched ~39 000 kernels a prep and the host's launching set
// the pace.  This kernel makes each field operation one launch.
//
// What bounds it on the H100: bytes.  An element reads two operand rows of
// n int32 limbs and writes one, 3 x 4n bytes (48 for Field64, 96 for
// Field128).  At 3.35 TB/s and 16.7 T 32-bit instructions/s an element may
// spend ~240 (Field64) or ~480 (Field128) instructions before the
// instructions bind; a Field128 Montgomery product is three 128 x 128-bit
// products of four 64-bit multiplies (~150 instructions with the carries) and
// the index arithmetic at most a 64-bit division a merged batch dimension.
//
// Design.  One thread an element.  The port's carrier is read as it lies: 16-bit
// limbs in int32, (..., n), little-endian, from the strides the wrapper
// passes for each operand over the broadcast batch shape (a stride of 0 where
// an operand is broadcast: a host constant, Horner's expanded point; the
// NTT's halves and the gadget's 0::2 rows as the strided views they are), so
// nothing is copied or cast before the launch.  Where every row is 16-byte
// aligned with contiguous limbs the thread loads its row by 16-byte loads
// (one for Field64, two for Field128), else limb by limb.  The limbs become
// one 64-bit word or two (field64.cuh, field128.cuh), the operation runs on
// them (f64_add / f64_sub / f64_mont_mul, f128_add / f128_sub /
// f128_mont_mul), and the result is stored as int32 limbs into a fresh
// contiguous output by 16-byte stores.  The wrapper merges batch dimensions
// that both operands step through alike, so most launches index one or two
// dimensions.
#include <cuda_runtime.h>

#include "field128.cuh"

using namespace mtk;

constexpr int FIELD_THREADS = 256;
constexpr int FIELD_MAX_DIMS = 8;

enum FieldOp { FIELD_ADD = 0, FIELD_SUB = 1, FIELD_MUL = 2 };

// The broadcast batch shape (outermost first) and each operand's element
// strides over it, in int32 units; la and lb are the limb strides.
struct FieldIndex {
  long long count;
  long long shape[FIELD_MAX_DIMS];
  long long sa[FIELD_MAX_DIMS];
  long long sb[FIELD_MAX_DIMS];
  long long la, lb;
  int ndim;
};

// Limbs 4q .. 4q + 3 of the row at p: one 16-byte load, or four at stride ls.
template <bool VEC>
__device__ __forceinline__ int4 load_quad(const int32_t* __restrict__ p, long long ls, int q) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const int4*>(p) + q);
  const int32_t* r = p + 4 * q * ls;
  return make_int4(__ldg(r), __ldg(r + ls), __ldg(r + 2 * ls), __ldg(r + 3 * ls));
}

template <int N, int OP>
__device__ __forceinline__ void apply(const int4* x, const int4* y, int4* out) {
  if constexpr (N == 4) {
    const uint64_t a = limbs64(x[0]);
    const uint64_t b = limbs64(y[0]);
    out[0] = limbs_of(OP == FIELD_ADD ? f64_add(a, b) : OP == FIELD_SUB ? f64_sub(a, b) : f64_mont_mul(a, b));
  } else {
    const u128 a = limbs128(x[0], x[1]);
    const u128 b = limbs128(y[0], y[1]);
    const u128 r = OP == FIELD_ADD ? f128_add(a, b) : OP == FIELD_SUB ? f128_sub(a, b) : f128_mont_mul(a, b);
    out[0] = limbs_of(r.lo);
    out[1] = limbs_of(r.hi);
  }
}

template <int N, int OP, bool VEC>
__global__ void __launch_bounds__(FIELD_THREADS)
field_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b, int32_t* __restrict__ out,
             const FieldIndex ix) {
  const long long i = blockIdx.x * static_cast<long long>(FIELD_THREADS) + threadIdx.x;
  if (i >= ix.count) return;
  // The element's coordinates, innermost first; the outermost needs no division.
  long long rest = i, oa = 0, ob = 0;
#pragma unroll
  for (int d = FIELD_MAX_DIMS - 1; d > 0; --d) {
    if (d < ix.ndim) {
      const long long c = rest % ix.shape[d];
      rest /= ix.shape[d];
      oa += c * ix.sa[d];
      ob += c * ix.sb[d];
    }
  }
  if (ix.ndim > 0) {
    oa += rest * ix.sa[0];
    ob += rest * ix.sb[0];
  }
  constexpr int Q = N / 4;
  int4 x[Q], y[Q], r[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    x[q] = load_quad<VEC>(a + oa, ix.la, q);
    y[q] = load_quad<VEC>(b + ob, ix.lb, q);
  }
  apply<N, OP>(x, y, r);
  int4* dst = reinterpret_cast<int4*>(out + i * N);
#pragma unroll
  for (int q = 0; q < Q; ++q) dst[q] = r[q];
}

template <int N, int OP>
static cudaError_t launch_op(const int32_t* a, const int32_t* b, int32_t* out, const FieldIndex& ix,
                             bool vec, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>((ix.count + FIELD_THREADS - 1) / FIELD_THREADS);
  if (vec)
    field_kernel<N, OP, true><<<blocks, FIELD_THREADS, 0, st>>>(a, b, out, ix);
  else
    field_kernel<N, OP, false><<<blocks, FIELD_THREADS, 0, st>>>(a, b, out, ix);
  return cudaGetLastError();
}

template <int N>
static cudaError_t launch_limbs(int op, const int32_t* a, const int32_t* b, int32_t* out,
                                const FieldIndex& ix, bool vec, cudaStream_t st) {
  if (op == FIELD_ADD) return launch_op<N, FIELD_ADD>(a, b, out, ix, vec, st);
  if (op == FIELD_SUB) return launch_op<N, FIELD_SUB>(a, b, out, ix, vec, st);
  if (op == FIELD_MUL) return launch_op<N, FIELD_MUL>(a, b, out, ix, vec, st);
  return cudaErrorInvalidValue;
}

// meta: count, ndim, la, lb, then shape, sa and sb, FIELD_MAX_DIMS each (int64).
extern "C" int field_op(const void* a, const void* b, void* out, const void* meta, int op,
                        int num_limbs, int vec, void* stream) {
  const long long* m = static_cast<const long long*>(meta);
  FieldIndex ix;
  ix.count = m[0];
  ix.ndim = static_cast<int>(m[1]);
  ix.la = m[2];
  ix.lb = m[3];
  if (ix.ndim < 0 || ix.ndim > FIELD_MAX_DIMS) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < FIELD_MAX_DIMS; ++d) {
    ix.shape[d] = m[4 + d];
    ix.sa[d] = m[4 + FIELD_MAX_DIMS + d];
    ix.sb[d] = m[4 + 2 * FIELD_MAX_DIMS + d];
  }
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  auto* po = static_cast<int32_t*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (num_limbs == 4) err = launch_limbs<4>(op, pa, pb, po, ix, vec != 0, st);
  if (num_limbs == 8) err = launch_limbs<8>(op, pa, pb, po, ix, vec != 0, st);
  return static_cast<int>(err);
}
