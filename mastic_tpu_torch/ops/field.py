"""Batched Field64 and Field128 arithmetic in PyTorch: 16-bit limbs,
Montgomery multiplication (port of `mastic_tpu/ops/field_jax.py`).

Layout as in the JAX package: shape (..., n), little-endian limb order,
n = 4 for Field64 and 8 for Field128, limb values < 2^16.  Limbs cross
function boundaries as int32 and are computed in int64, where a
16x16-bit product and every column sum fit exactly (at n = 8 a column
sums at most 2n + 2 halves of products, below 2^21), so each step below
is the JAX package's uint32 step with the same values.  Elements the
FLP multiplies live in the Montgomery domain; payloads stay plain.
"""

import numpy as np
import torch

from ..scalar.field import Field64, Field128
from .bits import I32, I64

_MASK16 = 0xFFFF


class FieldSpec:
    """Constants for one prime field, precomputed on the host with
    Python bignums."""

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
            x = torch.as_tensor(np.asarray(x, np.int64), device=like.device)
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


def field_sum(spec: FieldSpec, x: torch.Tensor, axis: int) -> torch.Tensor:
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
