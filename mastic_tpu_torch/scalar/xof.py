"""Copy of `mastic_tpu/xof.py`: the two VDAF XOFs
(draft-irtf-cfrg-vdaf-13 §6.2).

* `XofTurboShake128`: TurboSHAKE128 with domain byte 1 over the message
  `le16(len(dst)) || dst || seed || binder`.  Used for node proofs and
  every Mastic seed and vector derivation.

* `XofFixedKeyAes128`: one TurboSHAKE-derived fixed AES key per (dst,
  binder), then a correlation-robust hash of `seed XOR
  le128(block_index)` per output block.  Used for the VIDPF extend and
  convert steps.

`Xof.next_vec` runs the true rejection loop: this is the layer that
recomputes the reports whose batched sampling fired
(`drivers/heavy_hitters.py::splice_rejected`).
"""

from .aes import Aes128
from .common import concat, from_le_bytes, to_le_bytes, xor
from .field import F
from .keccak import TurboShake128Stream, turbo_shake128


class Xof:
    """Streaming XOF interface (next / next_vec / one-shot helpers)."""

    SEED_SIZE: int

    def next(self, length: int) -> bytes:
        raise NotImplementedError()

    def next_vec(self, field: type[F], length: int) -> list[F]:
        """Rejection-sample `length` field elements from the stream."""
        vec: list[F] = []
        while len(vec) < length:
            val = from_le_bytes(self.next(field.ENCODED_SIZE))
            # The branch leaks only the rejection count, which is
            # independent of the accepted outputs (standard VDAF XOF
            # behaviour; the batched twin returns the in-range mask
            # instead, backend/xof.py::sample_vec).
            if val < field.MODULUS:
                vec.append(field(val))
        return vec

    @classmethod
    def expand_into_vec(cls, field: type[F], seed: bytes, dst: bytes,
                        binder: bytes, length: int) -> list[F]:
        return cls(seed, dst, binder).next_vec(field, length)

    @classmethod
    def derive_seed(cls, seed: bytes, dst: bytes, binder: bytes) -> bytes:
        return cls(seed, dst, binder).next(cls.SEED_SIZE)


class XofTurboShake128(Xof):
    SEED_SIZE = 32

    def __init__(self, seed: bytes, dst: bytes, binder: bytes):
        """Variable seed lengths are supported (the VIDPF node proof
        feeds 16-byte seeds, the Mastic checks empty ones); the seed is
        length-prefixed to keep the encoding injective."""
        if len(dst) >= 2 ** 16:
            raise ValueError("dst too long")
        if len(seed) >= 2 ** 8:
            raise ValueError("seed too long")
        self.stream = TurboShake128Stream(
            to_le_bytes(len(dst), 2) + dst
            + to_le_bytes(len(seed), 1) + seed + binder, domain=1)

    def next(self, length: int) -> bytes:
        return self.stream.read(length)


class XofFixedKeyAes128(Xof):
    SEED_SIZE = 16

    def __init__(self, seed: bytes, dst: bytes, binder: bytes):
        if len(seed) != self.SEED_SIZE:
            raise ValueError("incorrect seed size")
        if len(dst) >= 2 ** 16:
            raise ValueError("dst too long")
        self.length_consumed = 0
        fixed_key = turbo_shake128(
            to_le_bytes(len(dst), 2) + dst + binder, domain=2, length=16)
        self.cipher = Aes128(fixed_key)
        self.seed = seed

    def _hash_block(self, block: bytes) -> bytes:
        """The tweakable correlation-robust hash of [GKWWY20]:
        pi(x) = CIPH(sigma(x)) XOR sigma(x), sigma(lo || hi) =
        hi || (hi XOR lo)."""
        (lo, hi) = (block[:8], block[8:])
        sigma_block = concat([hi, xor(hi, lo)])
        return xor(self.cipher.encrypt_block(sigma_block), sigma_block)

    def next(self, length: int) -> bytes:
        offset = self.length_consumed % 16
        new_length = self.length_consumed + length
        block_range = range(self.length_consumed // 16,
                            (new_length + 15) // 16)
        self.length_consumed = new_length
        hashed_blocks = [
            self._hash_block(xor(self.seed, to_le_bytes(i, 16)))
            for i in block_range
        ]
        return concat(hashed_blocks)[offset:offset + length]
