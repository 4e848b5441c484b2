"""Tower-field AES S-box circuit (copy of `mastic_tpu/ops/sbox_tower.py`)
plus the generator of its straight-line CUDA form.

GF(2^8) inversion via GF(2^2) -> GF(2^4) -> GF(2^8), ~4x fewer gates
than the x^254 addition chain.  The isomorphism between the AES
polynomial representation (mod x^8+x^4+x^3+x+1) and the tower
representation is derived at import time: phi sends the AES generator
X=0x02 to a root of the AES modulus inside the tower field, and the
S-box affine map is fused into the output basis-change matrix.  The
circuit functions are representation-agnostic (only ^ and & between
planes): ops/aes.py runs them on torch bit planes, and
`emit_cuda()` runs them on symbols to print the same circuit as
straight-line CUDA (`csrc/sbox_tower.cuh`, regenerated with
`python -m mastic_tpu_torch.ops.sbox_tower > mastic_tpu_torch/csrc/sbox_tower.cuh`).
ops/aes.py locks the circuit against the S-box table at import.

Tower layout (bit i of a tower byte):
  GF(2^2) element  = b0 + b1*W,            W^2 = W + 1
  GF(2^4) element  = lo2 + hi2*x,          x^2 = x + N,  N = W
  GF(2^8) element  = lo4 + hi4*y,          y^2 = y + NU (derived)
  bits: [b0..b3] = lo4 (b0,b1 its lo2; b2,b3 its hi2), [b4..b7] = hi4
"""

import numpy as np

# -- host-side tower arithmetic on ints (for deriving matrices) ------
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


def _mul2i(a: int, b: int) -> int:
    (a0, a1) = (a & 1, a >> 1)
    (b0, b1) = (b & 1, b >> 1)
    q = (a0 ^ a1) & (b0 ^ b1)
    p = a0 & b0
    t = a1 & b1
    return (p ^ t) | ((q ^ p) << 1)


def _mulw_i(a: int) -> int:
    (a0, a1) = (a & 1, a >> 1)
    return a1 | ((a0 ^ a1) << 1)


def _mul4i(a: int, b: int) -> int:
    (al, ah) = (a & 3, a >> 2)
    (bl, bh) = (b & 3, b >> 2)
    hh = _mul2i(ah, bh)
    ll = _mul2i(al, bl)
    m = _mul2i(ah ^ al, bh ^ bl)
    return (ll ^ _mulw_i(hh)) | ((m ^ ll) << 2)


def _mul8i(a: int, b: int, nu: int) -> int:
    (al, ah) = (a & 15, a >> 4)
    (bl, bh) = (b & 15, b >> 4)
    hh = _mul4i(ah, bh)
    ll = _mul4i(al, bl)
    m = _mul4i(ah ^ al, bh ^ bl)
    return (ll ^ _mul4i(hh, nu)) | ((m ^ ll) << 4)


def _find_nu() -> int:
    """Smallest nu making y^2 + y + nu irreducible over GF(2^4)."""
    for nu in range(1, 16):
        if all(_mul4i(y, y) ^ y ^ nu for y in range(16)):
            return nu
    raise AssertionError("no irreducible quadratic (unreachable)")


NU = _find_nu()


def _derive_matrices():
    """phi: AES poly basis -> tower basis (8x8 over GF(2)), and the
    output map = AES affine matrix composed with phi^-1."""
    # Root of the AES modulus inside the tower field.
    def aes_modulus_tower(t: int) -> int:
        acc = 0
        for e in (8, 4, 3, 1, 0):
            p = 1
            for _ in range(e):
                p = _mul8i(p, t, NU)
            acc ^= p
        return acc

    root = next(t for t in range(2, 256)
                if aes_modulus_tower(t) == 0)

    # phi matrix columns: phi(X^i) = root^i in tower rep.
    cols = []
    p = 1
    for _ in range(8):
        cols.append(p)
        p = _mul8i(p, root, NU)
    phi = np.zeros((8, 8), np.uint8)
    for (j, val) in enumerate(cols):
        for i in range(8):
            phi[i, j] = (val >> i) & 1

    # Invert phi over GF(2) (Gauss-Jordan).
    m = np.concatenate([phi.copy(), np.eye(8, dtype=np.uint8)], axis=1)
    for col in range(8):
        pivot = next(r for r in range(col, 8) if m[r, col])
        m[[col, pivot]] = m[[pivot, col]]
        for r in range(8):
            if r != col and m[r, col]:
                m[r] ^= m[col]
    phi_inv = m[:, 8:]

    # AES S-box affine matrix: out_i = sum_j in_{(j+i) mod 8 ...};
    # rows of the standard affine: bit i = b_i ^ b_{(i+4)%8} ^
    # b_{(i+5)%8} ^ b_{(i+6)%8} ^ b_{(i+7)%8}.
    affine = np.zeros((8, 8), np.uint8)
    for i in range(8):
        for off in (0, 4, 5, 6, 7):
            affine[i, (i + off) % 8] ^= 1
    out_map = (affine @ phi_inv) % 2
    # Sanity: phi is a field isomorphism (spot-check products).
    for (a, b) in ((0x57, 0x83), (0x02, 0x80), (0xFF, 0x1B)):
        ta = _apply_int(phi, a)
        tb = _apply_int(phi, b)
        assert _apply_int(phi_inv, _mul8i(ta, tb, NU)) == _gf_mul(a, b)
    return (phi.astype(np.uint8), out_map.astype(np.uint8))


def _apply_int(matrix: np.ndarray, val: int) -> int:
    out = 0
    for i in range(8):
        bit = 0
        for j in range(8):
            if matrix[i, j]:
                bit ^= (val >> j) & 1
        out |= bit << i
    return out


(PHI, OUT_MAP) = _derive_matrices()


# -- the circuit (representation-agnostic: ^ and & on planes) --------


def _apply_matrix(matrix: np.ndarray, planes: list) -> list:
    out = []
    for i in range(8):
        acc = None
        for j in range(8):
            if matrix[i, j]:
                acc = planes[j] if acc is None else acc ^ planes[j]
        out.append(acc)
    return out


def _mul2(a: list, b: list) -> list:
    q = (a[0] ^ a[1]) & (b[0] ^ b[1])
    p = a[0] & b[0]
    t = a[1] & b[1]
    return [p ^ t, q ^ p]


def _sq2(a: list) -> list:
    return [a[0] ^ a[1], a[1]]


def _mulw(a: list) -> list:
    return [a[1], a[0] ^ a[1]]


def _mul4(a: list, b: list) -> list:
    (al, ah) = (a[:2], a[2:])
    (bl, bh) = (b[:2], b[2:])
    hh = _mul2(ah, bh)
    ll = _mul2(al, bl)
    m = _mul2([ah[0] ^ al[0], ah[1] ^ al[1]],
              [bh[0] ^ bl[0], bh[1] ^ bl[1]])
    lo = _mulw(hh)
    return [ll[0] ^ lo[0], ll[1] ^ lo[1], m[0] ^ ll[0], m[1] ^ ll[1]]


def _sq4(a: list) -> list:
    (al, ah) = (a[:2], a[2:])
    hs = _sq2(ah)
    ls = _sq2(al)
    lo = _mulw(hs)
    return [ls[0] ^ lo[0], ls[1] ^ lo[1], hs[0], hs[1]]


def _scale4(a: list, const: int) -> list:
    """Multiply by a GF(2^4) constant via its bit-matrix (precomputed
    per constant; used only for NU)."""
    matrix = _SCALE4_MATRICES[const]
    out = []
    for i in range(4):
        acc = None
        for j in range(4):
            if matrix[i, j]:
                acc = a[j] if acc is None else acc ^ a[j]
        out.append(acc)
    return out


def _scale4_matrix(const: int) -> np.ndarray:
    matrix = np.zeros((4, 4), np.uint8)
    for j in range(4):
        val = _mul4i(1 << j, const)
        for i in range(4):
            matrix[i, j] = (val >> i) & 1
    return matrix


_SCALE4_MATRICES = {NU: _scale4_matrix(NU)}


def _inv4(a: list) -> list:
    """GF(2^4) inversion via the GF(2^2) norm (delta^-1 = delta^2)."""
    (al, ah) = (a[:2], a[2:])
    delta = _mulw(_sq2(ah))
    prod = _mul2(ah, al)
    lsq = _sq2(al)
    delta = [delta[0] ^ prod[0] ^ lsq[0], delta[1] ^ prod[1] ^ lsq[1]]
    dinv = _sq2(delta)
    out_h = _mul2(ah, dinv)
    out_l = _mul2([ah[0] ^ al[0], ah[1] ^ al[1]], dinv)
    return out_l + out_h


def _inv8(a: list) -> list:
    """GF(2^8) inversion (0 -> 0) via the GF(2^4) norm."""
    (al, ah) = (a[:4], a[4:])
    delta = _scale4(_sq4(ah), NU)
    prod = _mul4(ah, al)
    lsq = _sq4(al)
    delta = [delta[i] ^ prod[i] ^ lsq[i] for i in range(4)]
    dinv = _inv4(delta)
    out_h = _mul4(ah, dinv)
    out_l = _mul4([ah[i] ^ al[i] for i in range(4)], dinv)
    return out_l + out_h


def sbox_planes_tower(planes: list, one) -> list:
    """The AES S-box on 8 bit-planes: basis change in, tower-field
    inversion, affine-fused basis change out, 0x63 constant (`one` is
    1 for 0/1 byte planes, all-ones for packed uint32 planes)."""
    t = _apply_matrix(PHI, planes)
    inv = _inv8(t)
    out = _apply_matrix(OUT_MAP, inv)
    for i in range(8):
        if (0x63 >> i) & 1:
            out[i] = out[i] ^ one
    return out


# -- straight-line CUDA emitter ----------------------------------------


class _Sym:
    """A circuit wire while the circuit runs on symbols: ^ and & append
    one statement to the shared program and return the new wire."""

    def __init__(self, prog: list, name: str):
        self.prog = prog
        self.name = name

    def _op(self, other, op: str) -> "_Sym":
        name = f"t{len(self.prog)}"
        if other is _ONES:
            assert op == "^"
            self.prog.append(f"const uint32_t {name} = ~{self.name};")
        else:
            self.prog.append(
                f"const uint32_t {name} = {self.name} {op} {other.name};")
        return _Sym(self.prog, name)

    def __xor__(self, other) -> "_Sym":
        return self._op(other, "^")

    def __and__(self, other) -> "_Sym":
        return self._op(other, "&")


_ONES = object()   # the all-ones plane (XOR with it is NOT)


def emit_cuda() -> str:
    """The tower S-box as a CUDA device function over 8 packed planes
    (in place; plane b holds bit b of 32 bytes).  Constant-time: only
    XOR, AND and NOT, no table and no branch."""
    prog: list = []
    ins = [_Sym(prog, f"b{i}") for i in range(8)]
    outs = sbox_planes_tower(ins, _ONES)
    ands = sum(" & " in line for line in prog)
    body = "\n".join("    " + line for line in prog)
    assign = "\n".join(f"    b{i} = {o.name};" for (i, o) in
                       enumerate(outs))
    params = ", ".join(f"uint32_t& b{i}" for i in range(8))
    return f"""// Generated by mastic_tpu_torch/ops/sbox_tower.py (emit_cuda); do not edit.
// The AES S-box as the tower-field circuit on 8 bit planes, 32 bytes per
// uint32 word: {len(prog)} gates ({ands} AND, the rest XOR/NOT).  Constant-time:
// no table lookup and no branch on the data.
#pragma once
#include <cstdint>

__device__ __forceinline__ void sbox_tower({params}) {{
{body}
{assign}
}}
"""


if __name__ == "__main__":
    print(emit_cuda(), end="")
