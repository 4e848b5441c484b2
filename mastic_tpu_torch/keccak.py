"""Keccak-f[1600] round constants and rotation offsets (copy of the
generators in `mastic_tpu/keccak.py`, FIPS 202 §3.2.2 and §3.2.5).
Keccak-p[1600, 12], the TurboSHAKE permutation, uses the last 12 round
constants."""


def _gen_round_constants() -> list:
    def lfsr86540(state: int) -> tuple:
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


ROUND_CONSTANTS: list = _gen_round_constants()


def _gen_rho_offsets() -> list:
    offsets = [[0] * 5 for _ in range(5)]
    (x, y) = (1, 0)
    for t in range(24):
        offsets[x][y] = ((t + 1) * (t + 2) // 2) % 64
        (x, y) = (y, (2 * x + 3 * y) % 5)
    return offsets


RHO_OFFSETS: list = _gen_rho_offsets()
