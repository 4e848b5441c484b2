"""Byte-string helpers the port needs, copied from the scalar layer of
the JAX package (`mastic_tpu/common.py`) so that the port imports
nothing of it."""


def byte(x: int) -> bytes:
    """A single byte."""
    return int(x).to_bytes(1, "big")


def to_le_bytes(val: int, length: int) -> bytes:
    return int(val).to_bytes(length, "little")


def to_be_bytes(val: int, length: int) -> bytes:
    return int(val).to_bytes(length, "big")


def next_power_of_2(n: int) -> int:
    """Smallest power of 2 that is >= n (n >= 1)."""
    assert n >= 1
    return 1 << (n - 1).bit_length()


def pack_bits(bits: list) -> bytes:
    """Pack bits into bytes, MSB-first within each byte (the order of
    prefix-tree paths)."""
    out = bytearray((len(bits) + 7) // 8)
    for (i, bit) in enumerate(bits):
        out[i // 8] |= bit << (7 - (i % 8))
    return bytes(out)
