"""Batched Field64 and Field128 arithmetic in PyTorch: 16-bit limbs,
Montgomery multiplication (port of `mastic_tpu/ops/field_jax.py`).

Layout as in the JAX package: shape (..., n), little-endian limb order,
n = 4 for Field64 and 8 for Field128, limb values < 2^16.  Limbs cross
function boundaries as int32.  Elements the FLP multiplies live in the
Montgomery domain; payloads stay plain.

`FieldSpec.add` / `sub` / `neg` / `mul` / `to_mont` / `from_mont` on a
CUDA tensor launch the field kernel (`csrc/field.cu`), one launch an
operation, counted as "field" (Field64) or "field_f128" (Field128) in
`kernels.launches`; on any other device they run the plain version,
`PlainField`'s limb code (every spec's `plain`).  The plain version
computes in int64, where a 16x16-bit product and every column sum fit
exactly (at n = 8 a column sums at most 2n + 2 halves of products,
below 2^21), so each of its steps is the JAX package's uint32 step with
the same values; the kernel gives the same bits on every input, limbs
that encode values >= p included.  The plain versions of K1 and K3
(`ops/binder.py`, `ops/level.py`) call `spec.plain` on the card too, so
that holding a kernel against its plain version never runs `csrc/`.
"""

import ctypes

import numpy as np
import torch

from ..scalar.field import Field64, Field128
from . import kernels
from .bits import I32, I64

_MASK16 = 0xFFFF


class PlainField:
    """Constants for one prime field, precomputed on the host with
    Python bignums, and the plain limb code on any device."""

    def __init__(self, modulus: int, encoded_size: int, gen_order: int):
        self.modulus = modulus
        self.encoded_size = encoded_size
        self.num_limbs = encoded_size // 2
        self.gen_order = gen_order
        n = self.num_limbs
        self.R = pow(2, 16 * n, modulus)
        self.R2 = (self.R * self.R) % modulus
        # -p^-1 mod 2^16, the REDC quotient constant.
        self.P_PRIME = (-pow(modulus, -1, 1 << 16)) & _MASK16
        self.P = [int(x) for x in self.int_to_limbs(modulus)]
        self.R2_LIMBS = self.int_to_limbs(self.R2)
        self.ONE_MONT = self.int_to_limbs(self.R % modulus)
        self.plain = self

    # -- host-side converters (Python bignum) -----------------------

    def int_to_limbs(self, value: int) -> np.ndarray:
        return np.array([(value >> (16 * i)) & _MASK16
                         for i in range(self.num_limbs)], np.int32)

    def limbs_to_int(self, limbs) -> int:
        limbs = np.asarray(limbs)
        return sum(int(limbs[..., i]) << (16 * i)
                   for i in range(self.num_limbs))

    def to_mont_host(self, value: int) -> np.ndarray:
        return self.int_to_limbs((value * self.R) % self.modulus)

    # -- device ops --------------------------------------------------

    def _limbs(self, x, like: torch.Tensor) -> list:
        """A limb tensor or a host constant as a list of n int64
        tensors (constants broadcast)."""
        if not isinstance(x, torch.Tensor):
            # A host constant, uploaded once per device (a blocking copy
            # each call would synchronize the stream).
            a = np.ascontiguousarray(x, np.int64)
            x = kernels.const_array(a.tobytes(), a.dtype.str, a.shape,
                                    like.device)
        x = x.to(I64)
        return [x[..., i] for i in range(x.shape[-1])]

    def _propagate(self, cols: list, num_out: int) -> list:
        """Carry-propagate column sums into `num_out` 16-bit limbs."""
        limbs = []
        carry = None
        for i in range(num_out):
            v = cols[i] if i < len(cols) else torch.zeros_like(cols[0])
            if carry is not None:
                v = v + carry
            limbs.append(v & _MASK16)
            carry = v >> 16
        return limbs

    def _sub_limbs(self, a: list, b: list) -> tuple:
        """a - b limbwise with borrow chain; returns (diff, borrow)."""
        diff = []
        borrow = None
        for i in range(len(a)):
            need = b[i] if borrow is None else b[i] + borrow
            borrow = (a[i] < need).to(I64)
            diff.append((a[i] + (borrow << 16) - need) & _MASK16)
        return (diff, borrow)

    def _cond_sub_p(self, limbs: list) -> list:
        """One conditional subtract of p (constant-time select)."""
        p_ext = self.P + [0] * (len(limbs) - self.num_limbs)
        (diff, borrow) = self._sub_limbs(limbs, p_ext)
        keep = borrow == 1
        return [torch.where(keep, limbs[i], diff[i])
                for i in range(self.num_limbs)]

    def _stack(self, limbs: list) -> torch.Tensor:
        return torch.stack(limbs, dim=-1).to(I32)

    def _broadcast(self, a: list, b: list) -> tuple:
        shape = torch.broadcast_shapes(a[0].shape, b[0].shape)
        return ([x.expand(shape) for x in a], [x.expand(shape) for x in b])

    def add(self, a, b) -> torch.Tensor:
        like = a if isinstance(a, torch.Tensor) else b
        (a, b) = self._broadcast(self._limbs(a, like), self._limbs(b, like))
        s = self._propagate([x + y for (x, y) in zip(a, b)],
                            self.num_limbs + 1)
        return self._stack(self._cond_sub_p(s))

    def sub(self, a, b) -> torch.Tensor:
        like = a if isinstance(a, torch.Tensor) else b
        (a, b) = self._broadcast(self._limbs(a, like), self._limbs(b, like))
        (diff, borrow) = self._sub_limbs(a, b)
        plus_p = self._propagate([d + p for (d, p) in zip(diff, self.P)],
                                 self.num_limbs)
        under = borrow == 1
        return self._stack([torch.where(under, x, y)
                            for (x, y) in zip(plus_p, diff)])

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def mul(self, a, b) -> torch.Tensor:
        """Montgomery product: mont(x)*mont(y) -> mont(x*y)."""
        n = self.num_limbs
        like = a if isinstance(a, torch.Tensor) else b
        (a, b) = self._broadcast(self._limbs(a, like), self._limbs(b, like))
        # Schoolbook product into 2n+1 columns (sums < 2n * 2^16).
        t = [torch.zeros_like(a[0]) for _ in range(2 * n + 1)]
        for i in range(n):
            for j in range(n):
                prod = a[i] * b[j]
                t[i + j] = t[i + j] + (prod & _MASK16)
                t[i + j + 1] = t[i + j + 1] + (prod >> 16)
        # REDC: clear the low n limbs one at a time, forwarding only the
        # cleared limb's carry (the quotient digit needs t[i] exact mod
        # 2^16 only).
        for i in range(n):
            m = (t[i] * self.P_PRIME) & _MASK16
            for k in range(n):
                mp = m * self.P[k]
                t[i + k] = t[i + k] + (mp & _MASK16)
                t[i + k + 1] = t[i + k + 1] + (mp >> 16)
            t[i + 1] = t[i + 1] + (t[i] >> 16)
        out = self._propagate(t[n:], n + 1)
        return self._stack(self._cond_sub_p(out))

    def to_mont(self, plain: torch.Tensor) -> torch.Tensor:
        return self.mul(plain, self.R2_LIMBS)

    def from_mont(self, mont: torch.Tensor) -> torch.Tensor:
        one = np.zeros(self.num_limbs, np.int64)
        one[0] = 1
        return self.mul(mont, one)

    # -- byte boundaries ---------------------------------------------

    def limbs_from_le_bytes(self, data: torch.Tensor) -> tuple:
        """uint8 (..., ENCODED_SIZE) -> (plain limbs int32, in_range
        mask): the mask is the XOF rejection-sampling predicate value
        < p."""
        pairs = data.reshape(data.shape[:-1] + (self.num_limbs, 2)).to(I64)
        limbs = pairs[..., 0] | (pairs[..., 1] << 8)
        (_, borrow) = self._sub_limbs(
            [limbs[..., i] for i in range(self.num_limbs)], self.P)
        return (limbs.to(I32), borrow == 1)

    def plain_to_le_bytes(self, plain: torch.Tensor) -> torch.Tensor:
        """Canonical little-endian wire encoding of plain limbs."""
        lo = (plain & 0xFF).to(torch.uint8)
        hi = ((plain >> 8) & 0xFF).to(torch.uint8)
        return torch.stack([lo, hi], dim=-1).reshape(
            plain.shape[:-1] + (self.encoded_size,))


# The field kernel's operations (csrc/field.cu FieldOp) and the most
# batch dimensions it indexes once merged.
_OPS = {"add": 0, "sub": 1, "mul": 2}
_MAX_DIMS = 8


def _broadcast(x: tuple, y: tuple) -> tuple:
    """The broadcast of two shapes (torch.broadcast_shapes, without its
    symbolic-shape machinery: this runs at every field operation)."""
    n = max(len(x), len(y))
    (x, y) = ((1,) * (n - len(x)) + x, (1,) * (n - len(y)) + y)
    out = []
    for (i, j) in zip(x, y):
        if i != j and 1 not in (i, j):
            raise ValueError(f"field kernel: shapes {x} and {y} do not "
                             f"broadcast")
        out.append(j if i == 1 else i)
    return tuple(out)


def _strides(t: torch.Tensor, shape: tuple) -> tuple:
    """t's element strides over the broadcast `shape`: 0 where t is
    broadcast."""
    pad = len(shape) - t.dim()
    return (0,) * pad + tuple(0 if size == 1 else stride for (size, stride)
                              in zip(t.shape, t.stride()))


def _merge_dims(shape: tuple, sa: tuple, sb: tuple) -> tuple:
    """Drop size-1 batch dimensions and merge neighbours that both
    operands step through alike (outer stride = inner stride x inner
    size): the fewest dimensions the kernel divides by."""
    dims = [[n, x, y] for (n, x, y) in zip(shape, sa, sb) if n != 1]
    merged = []
    for d in dims:
        if merged and merged[-1][1] == d[1] * d[0] and \
                merged[-1][2] == d[2] * d[0]:
            merged[-1] = [merged[-1][0] * d[0], d[1], d[2]]
        else:
            merged.append(d)
    return tuple(zip(*merged)) if merged else ((), (), ())


class FieldSpec(PlainField):
    """One prime field: the plain limb code off the card (`plain`), the
    field kernel on it."""

    def __init__(self, modulus: int, encoded_size: int, gen_order: int):
        super().__init__(modulus, encoded_size, gen_order)
        self.plain = PlainField(modulus, encoded_size, gen_order)
        self.counter = "field" if self.num_limbs == 4 else "field_f128"
        self.ZERO = np.zeros(self.num_limbs, np.int32)

    def _operand(self, x, device: torch.device) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            if x.dtype != I32:
                raise ValueError(f"field kernel: expected int32 limbs, got "
                                 f"{x.dtype}")
            return x
        # A host constant, uploaded once per device (a blocking copy each
        # call would synchronize the stream).
        a = np.ascontiguousarray(x, np.int32)
        return kernels.const_array(a.tobytes(), a.dtype.str, a.shape, device)

    def _kernel(self, op: str, a, b) -> torch.Tensor:
        """One launch of the field kernel: `op` over the broadcast of a
        and b (tensors on one card or host constants), a fresh int32
        (..., n) tensor."""
        like = a if isinstance(a, torch.Tensor) else b
        (a, b) = (self._operand(a, like.device), self._operand(b, like.device))
        n = self.num_limbs
        if a.shape[-1:] != (n,) or b.shape[-1:] != (n,):
            raise ValueError(f"field kernel: expected (..., {n}) limbs, got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        shape = _broadcast(tuple(a.shape), tuple(b.shape))
        out = torch.empty(shape, dtype=I32, device=like.device)
        if out.numel() == 0:
            return out
        (sa, sb) = (_strides(a, shape), _strides(b, shape))
        (la, lb) = (sa[-1], sb[-1])
        (dims, sa, sb) = _merge_dims(shape[:-1], sa[:-1], sb[:-1])
        if len(dims) > _MAX_DIMS:
            raise ValueError(f"field kernel: {len(dims)} batch dimensions "
                             f"after merging, at most {_MAX_DIMS}")
        vec = (la == lb == 1 and a.data_ptr() % 16 == 0
               and b.data_ptr() % 16 == 0
               and all(s % 4 == 0 for s in sa + sb))
        pad = (0,) * (_MAX_DIMS - len(dims))
        meta = (ctypes.c_longlong * (4 + 3 * _MAX_DIMS))(
            out.numel() // n, len(dims), la, lb, *dims, *pad, *sa, *pad,
            *sb, *pad)
        kernels.launch("field", "field_op", a.data_ptr(), b.data_ptr(),
                       out.data_ptr(), ctypes.addressof(meta), _OPS[op], n,
                       int(vec), kernels.stream_ptr(like.device),
                       counter=self.counter)
        return out

    def _either(self, op: str, a, b) -> torch.Tensor:
        """The kernel where the tensor operand lies on a card, else the
        plain version."""
        like = a if isinstance(a, torch.Tensor) else b
        if like.device.type == "cuda":
            return self._kernel(op, a, b)
        return getattr(self.plain, op)(a, b)

    def add(self, a, b) -> torch.Tensor:
        return self._either("add", a, b)

    def sub(self, a, b) -> torch.Tensor:
        return self._either("sub", a, b)

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        if a.device.type == "cuda":
            return self._kernel("sub", self.ZERO, a)
        return self.plain.neg(a)

    def mul(self, a, b) -> torch.Tensor:
        """Montgomery product: mont(x)*mont(y) -> mont(x*y)."""
        return self._either("mul", a, b)


def field_sum(spec: PlainField, x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact modular sum along `axis` by pairwise tree reduction."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    if n == 0:
        raise ValueError("empty field sum")
    while n > 1:
        half = n // 2
        rest = x[2 * half:]
        x = spec.add(x[:half], x[half:2 * half])
        if rest.shape[0]:
            x = torch.cat([x, rest], dim=0)
        n = x.shape[0]
    return x[0]


FIELD64 = FieldSpec(Field64.MODULUS, Field64.ENCODED_SIZE,
                    Field64.GEN_ORDER)
FIELD128 = FieldSpec(Field128.MODULUS, Field128.ENCODED_SIZE,
                     Field128.GEN_ORDER)


def spec_for(field) -> FieldSpec:
    if field is Field64:
        return FIELD64
    if field is Field128:
        return FIELD128
    raise ValueError(f"no batched spec for {field}")
