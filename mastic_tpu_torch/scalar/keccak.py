"""Copy of `mastic_tpu/keccak.py`: the Keccak-p[1600] permutation and
the TurboSHAKE128 XOF (draft-irtf-cfrg-kangarootwelve), a sponge over
Keccak-p[1600, 12] with a 168-byte rate and a caller-chosen domain
byte D in [0x01, 0x7F].

The batched version is `mastic_tpu_torch/ops/keccak.py` and kernel K1
(`csrc/keccak.cu`).
"""

_MASK64 = (1 << 64) - 1

# Round constants for all 24 rounds of Keccak-f[1600], generated by the
# standard degree-8 LFSR (FIPS 202 §3.2.5).  Keccak-p[1600, 12]
# (TurboSHAKE) uses the LAST 12 of these.


def _gen_round_constants() -> list[int]:
    def lfsr86540(state: int) -> tuple[int, int]:
        bit = state & 1
        state <<= 1
        if state & 0x100:
            state ^= 0x71
        return (bit, state & 0xFF)

    constants = []
    state = 1
    for _round in range(24):
        rc = 0
        for j in range(7):
            (bit, state) = lfsr86540(state)
            rc |= bit << ((1 << j) - 1)
        constants.append(rc)
    return constants


ROUND_CONSTANTS: list[int] = _gen_round_constants()

# Rotation offsets rho[x][y], generated by the standard (x, y) walk
# (FIPS 202 §3.2.2).


def _gen_rho_offsets() -> list[list[int]]:
    offsets = [[0] * 5 for _ in range(5)]
    (x, y) = (1, 0)
    for t in range(24):
        offsets[x][y] = ((t + 1) * (t + 2) // 2) % 64
        (x, y) = (y, (2 * x + 3 * y) % 5)
    return offsets


RHO_OFFSETS: list[list[int]] = _gen_rho_offsets()


def _rotl64(val: int, shift: int) -> int:
    shift %= 64
    return ((val << shift) | (val >> (64 - shift))) & _MASK64


def keccak_p1600(lanes: list[int], num_rounds: int = 12) -> list[int]:
    """Apply Keccak-p[1600, num_rounds] to 25 u64 lanes (lane order
    A[x + 5*y], i.e. x varies fastest)."""
    a = list(lanes)
    for round_index in range(24 - num_rounds, 24):
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = \
                    _rotl64(a[x + 5 * y], RHO_OFFSETS[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ (
                    (~b[(x + 1) % 5 + 5 * y] & _MASK64)
                    & b[(x + 2) % 5 + 5 * y])
        # iota
        a[0] ^= ROUND_CONSTANTS[round_index]
    return a


def _bytes_to_lanes(data: bytes) -> list[int]:
    assert len(data) == 200
    return [int.from_bytes(data[8 * i:8 * i + 8], "little")
            for i in range(25)]


def _lanes_to_bytes(lanes: list[int]) -> bytes:
    return b"".join(lane.to_bytes(8, "little") for lane in lanes)


class Sponge:
    """Incremental Keccak sponge (byte-aligned absorb/squeeze)."""

    def __init__(self, rate: int, num_rounds: int):
        self.rate = rate
        self.num_rounds = num_rounds
        self.state = bytearray(200)
        self.offset = 0  # absorb/squeeze cursor within the rate block
        self.squeezing = False

    def _permute(self) -> None:
        self.state = bytearray(
            _lanes_to_bytes(keccak_p1600(_bytes_to_lanes(bytes(self.state)),
                                         self.num_rounds)))

    def absorb(self, data: bytes) -> None:
        assert not self.squeezing
        for b in data:
            self.state[self.offset] ^= b
            self.offset += 1
            if self.offset == self.rate:
                self._permute()
                self.offset = 0

    def finalize(self, domain: int) -> None:
        """Pad (pad10*1 with the domain byte folded in) and switch to
        squeezing."""
        assert not self.squeezing
        self.state[self.offset] ^= domain
        self.state[self.rate - 1] ^= 0x80
        self._permute()
        self.offset = 0
        self.squeezing = True

    def squeeze(self, length: int) -> bytes:
        assert self.squeezing
        out = bytearray()
        while len(out) < length:
            if self.offset == self.rate:
                self._permute()
                self.offset = 0
            take = min(length - len(out), self.rate - self.offset)
            out += self.state[self.offset:self.offset + take]
            self.offset += take
        return bytes(out)


def turbo_shake128(message: bytes, domain: int, length: int) -> bytes:
    """TurboSHAKE128(M, D, L): one-shot output of L bytes."""
    assert 0x01 <= domain <= 0x7F
    sponge = Sponge(rate=168, num_rounds=12)
    sponge.absorb(message)
    sponge.finalize(domain)
    return sponge.squeeze(length)


class TurboShake128Stream:
    """Streaming TurboSHAKE128: absorb everything up front, then read
    the output incrementally (equivalent to one-shot with a longer L)."""

    def __init__(self, message: bytes, domain: int):
        assert 0x01 <= domain <= 0x7F
        self.sponge = Sponge(rate=168, num_rounds=12)
        self.sponge.absorb(message)
        self.sponge.finalize(domain)

    def read(self, length: int) -> bytes:
        return self.sponge.squeeze(length)


def shake128(message: bytes, length: int) -> bytes:
    """SHAKE128 (24 rounds, domain 0x1F) — used only for self-tests that
    anchor the permutation against published digests."""
    sponge = Sponge(rate=168, num_rounds=24)
    sponge.absorb(message)
    sponge.finalize(0x1F)
    return sponge.squeeze(length)


def sha3_256(message: bytes) -> bytes:
    """SHA3-256: the VIDPF test-eval helper's hash, and the
    permutation's self-tests."""
    sponge = Sponge(rate=136, num_rounds=24)
    sponge.absorb(message)
    sponge.finalize(0x06)
    return sponge.squeeze(32)
