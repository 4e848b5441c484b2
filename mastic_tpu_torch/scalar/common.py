"""Copy of `mastic_tpu/common.py`: byte-string and vector helpers
(draft-irtf-cfrg-vdaf-13's `vdaf_poc.common`)."""

from typing import TypeVar

T = TypeVar("T")


def byte(x: int) -> bytes:
    """A single byte."""
    return int(x).to_bytes(1, "big")


def zeros(n: int) -> bytes:
    return bytes(n)


def concat(parts: list[bytes]) -> bytes:
    return b"".join(parts)


def front(length: int, vec: list[T] | bytes) -> tuple:
    """Split `vec` into its first `length` items and the remainder."""
    return (vec[:length], vec[length:])


def xor(left: bytes, right: bytes) -> bytes:
    """XOR of two byte strings (length of the shorter input)."""
    return bytes(a ^ b for (a, b) in zip(left, right))


def to_le_bytes(val: int, length: int) -> bytes:
    return int(val).to_bytes(length, "little")


def from_le_bytes(encoded: bytes) -> int:
    return int.from_bytes(encoded, "little")


def to_be_bytes(val: int, length: int) -> bytes:
    return int(val).to_bytes(length, "big")


def from_be_bytes(encoded: bytes) -> int:
    return int.from_bytes(encoded, "big")


def next_power_of_2(n: int) -> int:
    """Smallest power of 2 that is >= n (n >= 1)."""
    assert n >= 1
    return 1 << (n - 1).bit_length()


def gen_rand(length: int) -> bytes:
    import os

    return os.urandom(length)


def vec_add(left: list, right: list) -> list:
    assert len(left) == len(right)
    return [x + y for (x, y) in zip(left, right)]


def vec_sub(left: list, right: list) -> list:
    assert len(left) == len(right)
    return [x - y for (x, y) in zip(left, right)]


def vec_neg(vec: list) -> list:
    return [-x for x in vec]


def pack_bits(bits: list[bool]) -> bytes:
    """Pack bits into bytes, MSB-first within each byte — the order used
    for prefix-tree paths and agg-param prefixes (reference
    PrefixTreeIndex.encode, vidpf.py:32-39).  NOT the order of the
    public-share control bits; those use `pack_bits_le`.
    """
    out = bytearray((len(bits) + 7) // 8)
    for (i, bit) in enumerate(bits):
        out[i // 8] |= bit << (7 - (i % 8))
    return bytes(out)


def pack_bits_le(bits: list[bool]) -> bytes:
    """Pack bits into bytes, LSB-first within each byte — the order used
    by the VIDPF public-share control bits (vdaf-13 `pack_bits`)."""
    out = bytearray((len(bits) + 7) // 8)
    for (i, bit) in enumerate(bits):
        out[i // 8] |= bit << (i % 8)
    return bytes(out)


def unpack_bits_le(encoded: bytes, num_bits: int) -> list[bool]:
    if len(encoded) != (num_bits + 7) // 8:
        raise ValueError("incorrect length of encoded bits")
    bits = [(encoded[i // 8] >> (i % 8)) & 1 != 0 for i in range(num_bits)]
    leftover = len(encoded) * 8 - num_bits
    if leftover and encoded[-1] >> (8 - leftover):
        raise ValueError("nonzero padding bits")
    return bits


def unpack_bits(encoded: bytes, num_bits: int) -> list[bool]:
    if len(encoded) != (num_bits + 7) // 8:
        raise ValueError("incorrect length of encoded bits")
    bits = [
        (encoded[i // 8] >> (7 - (i % 8))) & 1 != 0
        for i in range(num_bits)
    ]
    # Trailing bits in the final byte must be zero.
    leftover = len(encoded) * 8 - num_bits
    if leftover and encoded[-1] & ((1 << leftover) - 1):
        raise ValueError("nonzero padding bits")
    return bits
