"""Copy of `mastic_tpu/aes.py`: the AES-128 block cipher (encrypt
only) behind `XofFixedKeyAes128` (draft-irtf-cfrg-vdaf-13 §6.2.2).

The S-box is generated from first principles (GF(2^8) inversion and
the affine map) and checked against FIPS-197's values.  The batched
bitsliced version is `mastic_tpu_torch/ops/aes.py` and kernel K2
(`csrc/aes.cu`).
"""


def _gf_mul(a: int, b: int) -> int:
    """Multiply in GF(2^8) modulo x^8 + x^4 + x^3 + x + 1 (0x11B)."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= 0x11B
        b >>= 1
    return out


def _gen_sbox() -> bytes:
    # Multiplicative inverse table via exp/log over generator 3.
    exp = [0] * 256
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x = _gf_mul(x, 3)
    exp[255] = exp[0]

    sbox = bytearray(256)
    for value in range(256):
        inv = 0 if value == 0 else exp[255 - log[value]]
        # Affine transform: b'_i = b_i ^ b_{i+4} ^ b_{i+5} ^ b_{i+6}
        #                        ^ b_{i+7} ^ c_i  with c = 0x63.
        res = 0
        for i in range(8):
            bit = ((inv >> i) ^ (inv >> ((i + 4) % 8))
                   ^ (inv >> ((i + 5) % 8)) ^ (inv >> ((i + 6) % 8))
                   ^ (inv >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
            res |= bit << i
        sbox[value] = res
    return bytes(sbox)


SBOX: bytes = _gen_sbox()
assert SBOX[0x00] == 0x63 and SBOX[0x01] == 0x7C and SBOX[0x53] == 0xED


def _expand_key(key: bytes) -> list[bytes]:
    """AES-128 key schedule: 11 round keys of 16 bytes."""
    assert len(key) == 16
    words = [key[4 * i:4 * i + 4] for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        temp = words[i - 1]
        if i % 4 == 0:
            # Table lookups: the scalar layer only.  The batched path
            # computes SubBytes as a bitsliced boolean circuit with no
            # table lookups (ops/sbox_tower.py), the constant-time form.
            temp = bytes([SBOX[temp[1]] ^ rcon, SBOX[temp[2]],
                          SBOX[temp[3]], SBOX[temp[0]]])
            rcon = _gf_mul(rcon, 2)
        words.append(bytes(a ^ b for (a, b) in zip(words[i - 4], temp)))
    return [b"".join(words[4 * r:4 * r + 4]) for r in range(11)]


def _mix_single_column(col: bytes) -> bytes:
    (a0, a1, a2, a3) = col
    return bytes([
        _gf_mul(a0, 2) ^ _gf_mul(a1, 3) ^ a2 ^ a3,
        a0 ^ _gf_mul(a1, 2) ^ _gf_mul(a2, 3) ^ a3,
        a0 ^ a1 ^ _gf_mul(a2, 2) ^ _gf_mul(a3, 3),
        _gf_mul(a0, 3) ^ a1 ^ a2 ^ _gf_mul(a3, 2),
    ])


class Aes128:
    """AES-128 with a precomputed key schedule; `encrypt_block` maps one
    16-byte block (column-major state order per FIPS-197)."""

    def __init__(self, key: bytes):
        self.round_keys = _expand_key(key)

    def encrypt_block(self, block: bytes) -> bytes:
        assert len(block) == 16
        state = bytes(a ^ b for (a, b) in zip(block, self.round_keys[0]))
        for round_index in range(1, 11):
            # SubBytes
            state = bytes(SBOX[b] for b in state)
            # ShiftRows: row r (bytes r, r+4, r+8, r+12) rotates left by r.
            state = bytes(state[(i + 4 * (i % 4)) % 16] for i in range(16))
            # MixColumns (skipped in the final round)
            if round_index < 10:
                state = b"".join(_mix_single_column(state[4 * c:4 * c + 4])
                                 for c in range(4))
            state = bytes(a ^ b
                          for (a, b) in zip(state, self.round_keys[round_index]))
        return state
