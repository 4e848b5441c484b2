"""VIDPF constants and the path encoding (copy of the parts of
`mastic_tpu/vidpf.py` the port needs)."""

from .common import pack_bits

PROOF_SIZE: int = 32
KEY_SIZE: int = 16


def encode_path(path: tuple) -> bytes:
    """Big-endian bit packing of a prefix-tree path."""
    return pack_bits(list(path))
