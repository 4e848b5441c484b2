"""VIDPF constants, the path encoding and the path of an integer (copy
of the parts of `mastic_tpu/vidpf.py` the port needs)."""

from .common import pack_bits

PROOF_SIZE: int = 32
KEY_SIZE: int = 16


def encode_path(path: tuple) -> bytes:
    """Big-endian bit packing of a prefix-tree path."""
    return pack_bits(list(path))


def test_index_from_int(value: int, length: int) -> tuple:
    """The `length`-bit big-endian path of `value` (as a tuple of
    bools)."""
    return tuple((value >> (length - 1 - i)) & 1 != 0 for i in range(length))
