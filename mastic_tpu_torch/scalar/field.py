"""Copy of `mastic_tpu/field.py`: the prime fields Field64 and
Field128 (NTT-friendly), per draft-irtf-cfrg-vdaf-13 §6.1.

* Field64:  p = 2^32 * 4294967295 + 1 = 2^64 - 2^32 + 1 (2-adicity 32)
* Field128: p = 2^66 * 4611686018427387897 + 1            (2-adicity 66)

Elements encode little-endian at fixed width (8 / 16 bytes).  The
batched limb arithmetic is `mastic_tpu_torch/ops/field.py`.
"""

from typing import TypeVar

from typing import Self

from .common import from_le_bytes, to_le_bytes

F = TypeVar("F", bound="Field")


class Field:
    """An element of a prime field; subclasses pin the modulus."""

    MODULUS: int
    ENCODED_SIZE: int

    def __init__(self, val: int):
        assert 0 <= val < self.MODULUS
        self.val = val

    # -- classmethod constructors ----------------------------------

    @classmethod
    def zeros(cls, length: int) -> list[Self]:
        return [cls(0)] * length

    @classmethod
    def rand_vec(cls, length: int) -> list[Self]:
        import random

        return [cls(random.randrange(cls.MODULUS)) for _ in range(length)]

    # -- arithmetic ------------------------------------------------

    def __add__(self, other: Self) -> Self:
        return self.__class__((self.val + other.val) % self.MODULUS)

    def __sub__(self, other: Self) -> Self:
        return self.__class__((self.val - other.val) % self.MODULUS)

    def __neg__(self) -> Self:
        return self.__class__((-self.val) % self.MODULUS)

    def __mul__(self, other: Self) -> Self:
        return self.__class__((self.val * other.val) % self.MODULUS)

    def __pow__(self, exp: int) -> Self:
        return self.__class__(pow(self.val, exp, self.MODULUS))

    def inv(self) -> Self:
        return self.__class__(pow(self.val, self.MODULUS - 2, self.MODULUS))

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Field) and \
            self.MODULUS == other.MODULUS and self.val == other.val

    def __hash__(self) -> int:
        return hash((self.MODULUS, self.val))

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.val})"

    def int(self) -> int:
        return self.val

    # -- encoding --------------------------------------------------

    @classmethod
    def encode_vec(cls, vec: list[Self]) -> bytes:
        return b"".join(to_le_bytes(x.val, cls.ENCODED_SIZE) for x in vec)

    @classmethod
    def decode_vec(cls, encoded: bytes) -> list[Self]:
        size = cls.ENCODED_SIZE
        if len(encoded) % size != 0:
            raise ValueError("malformed field vector encoding")
        vec = []
        for i in range(0, len(encoded), size):
            val = from_le_bytes(encoded[i:i + size])
            if val >= cls.MODULUS:
                raise ValueError("field element out of range")
            vec.append(cls(val))
        return vec

    # -- bit-vector (de)composition (vdaf-13 §6.1.2) ---------------

    @classmethod
    def encode_into_bit_vector(cls, val: int, bits: int) -> list[Self]:
        if val >= 2 ** bits:
            raise ValueError("value too large for bit length")
        return [cls((val >> i) & 1) for i in range(bits)]

    @classmethod
    def decode_from_bit_vector(cls, vec: list[Self]) -> Self:
        out = cls(0)
        for (i, x) in enumerate(vec):
            out += cls(1 << i) * x
        return out


class NttField(Field):
    """A field with large 2-adic multiplicative subgroup (required by the
    FLP polynomial arithmetic; cf. the `NttField` bound at reference
    vidpf.py:14 and mastic.py:22)."""

    GEN_ORDER: int  # order of the subgroup generated by gen()

    @classmethod
    def gen(cls) -> Self:
        """Generator of the 2^k-order NTT subgroup (7^odd_part mod p)."""
        return cls(pow(7, (cls.MODULUS - 1) // cls.GEN_ORDER, cls.MODULUS))


class Field64(NttField):
    MODULUS = 2 ** 32 * 4294967295 + 1  # 2^64 - 2^32 + 1
    GEN_ORDER = 2 ** 32
    ENCODED_SIZE = 8


class Field128(NttField):
    MODULUS = 2 ** 66 * 4611686018427387897 + 1
    GEN_ORDER = 2 ** 66
    ENCODED_SIZE = 16


def poly_eval(field: type[F], p: list[F], eval_at: F) -> F:
    """Horner evaluation of polynomial p (coefficient order: low->high)."""
    out = field(0)
    for coeff in reversed(p):
        out = out * eval_at + coeff
    return out


def poly_add(field: type[F], p: list[F], q: list[F]) -> list[F]:
    out = [field(0)] * max(len(p), len(q))
    for (i, c) in enumerate(p):
        out[i] += c
    for (i, c) in enumerate(q):
        out[i] += c
    return out


def poly_mul(field: type[F], p: list[F], q: list[F]) -> list[F]:
    if not p or not q:
        return []
    out = [field(0)] * (len(p) + len(q) - 1)
    for (i, a) in enumerate(p):
        for (j, b) in enumerate(q):
            out[i + j] += a * b
    return out


def poly_interp(field: type[F], values: list[F]) -> list[F]:
    """Interpolate coefficients of the polynomial taking value[k] at
    alpha^k, where alpha generates the order-P subgroup (P = len(values),
    a power of two): the inverse NTT."""
    size = len(values)
    assert size & (size - 1) == 0
    alpha_inv = field.gen() ** (field.GEN_ORDER - field.GEN_ORDER // size)
    size_inv = field(size).inv()
    coeffs = _ntt(field, values, alpha_inv)
    return [c * size_inv for c in coeffs]


def poly_eval_domain(field: type[F], coeffs: list[F], size: int) -> list[F]:
    """Evaluate a polynomial at alpha^k for k in range(size) (the NTT)."""
    assert size & (size - 1) == 0
    assert len(coeffs) <= size
    padded = list(coeffs) + [field(0)] * (size - len(coeffs))
    alpha = field.gen() ** (field.GEN_ORDER // size)
    return _ntt(field, padded, alpha)


def _ntt(field: type[F], values: list[F], omega: F) -> list[F]:
    """Radix-2 Cooley-Tukey transform: out[j] = sum_k values[k] omega^(jk)."""
    size = len(values)
    if size == 1:
        return list(values)
    even = _ntt(field, values[0::2], omega * omega)
    odd = _ntt(field, values[1::2], omega * omega)
    out = [field(0)] * size
    twiddle = field(1)
    for j in range(size // 2):
        t = twiddle * odd[j]
        out[j] = even[j] + t
        out[j + size // 2] = even[j] - t
        twiddle = twiddle * omega
    return out
