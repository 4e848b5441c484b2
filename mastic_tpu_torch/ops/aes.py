"""Batched AES-128 (encrypt only) in PyTorch (port of
`mastic_tpu/ops/aes_jax.py`), with the wrapper of kernel K2.

Two forms, as in the JAX package:

* the byte path (`aes128_key_schedule`, `aes128_encrypt`): SubBytes is
  the tower-field S-box circuit (ops/sbox_tower.py) on the 8 bit planes
  of each byte, values 0/1;
* the batch-bitsliced path (`aes128_encrypt_bitsliced`): the state is
  bit-transposed along the batch axis, bit j of the 32-bit word at
  packed index w being batch element 32*w + j (int32 carriers,
  ops/bits.py), and each of the 128 (bit, byte) state positions is a
  dense word vector.

Both are constant-time by construction: the same gates for every
input, no table lookup.  Kernel K2 (`csrc/aes.cu`) replaces the Pallas
kernel `aes128_encrypt_bitsliced_pallas`
(mastic_tpu/ops/aes_pallas.py:107) behind `aes128_encrypt_bitsliced`
(planes in, planes out); the main path reaches K2 through its other
entry, `backend.xof.fixed_key_blocks`, which takes report-major bytes.
"""

import numpy as np
import torch

from . import kernels
from .bits import I32
from .sbox_tower import _gf_mul, sbox_planes_tower


def _planes(x):
    """Split bytes into 8 bit-planes (LSB first), values 0/1."""
    return [(x >> i) & 1 for i in range(8)]


def _unplanes(planes):
    out = planes[0]
    for i in range(1, 8):
        out = out ^ (planes[i] << i)
    return out


def _sbox_table() -> bytes:
    """The AES S-box from first principles: inverse via exp/log over
    generator 3, then the affine map with constant 0x63."""
    exp = [0] * 256
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x = _gf_mul(x, 3)
    out = bytearray(256)
    for value in range(256):
        inv = 0 if value == 0 else exp[(255 - log[value]) % 255]
        res = 0
        for i in range(8):
            bit = ((inv >> i) ^ (inv >> ((i + 4) % 8))
                   ^ (inv >> ((i + 5) % 8)) ^ (inv >> ((i + 6) % 8))
                   ^ (inv >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
            res |= bit << i
        out[value] = res
    return bytes(out)


SBOX = _sbox_table()

# Lock the circuit against the table at import (numpy path).
_check = _unplanes(sbox_planes_tower(
    _planes(np.arange(256, dtype=np.uint8)), 1))
assert bytes(_check) == SBOX, "S-box circuit diverges from table"
del _check


def sub_bytes(x: torch.Tensor) -> torch.Tensor:
    """The AES S-box elementwise on a uint8 tensor."""
    return _unplanes(sbox_planes_tower(_planes(x), 1))


def _xtime(v: torch.Tensor) -> torch.Tensor:
    # uint8 arithmetic wraps: dropping bit 8 of (v << 1) is exactly the
    # reduction the 0x1B term completes.
    return (v << 1) ^ ((v >> 7) * 0x1B)


# ShiftRows: byte i of the new state comes from byte (i + 4*(i%4)) % 16.
_SHIFT_ROWS = tuple((i + 4 * (i % 4)) % 16 for i in range(16))

_RCON = []
_r = 1
for _ in range(10):
    _RCON.append(_r)
    _r = _gf_mul(_r, 2)


def aes128_key_schedule(keys: torch.Tensor) -> torch.Tensor:
    """Batched key expansion: (..., 16) uint8 -> (..., 11, 16)."""
    words = keys.reshape(keys.shape[:-1] + (4, 4))
    rounds = [words]
    for rcon in _RCON:
        s = sub_bytes(words[..., 3, :])
        temp = torch.stack([s[..., 1] ^ rcon, s[..., 2], s[..., 3],
                            s[..., 0]], dim=-1)
        w0 = words[..., 0, :] ^ temp
        w1 = words[..., 1, :] ^ w0
        w2 = words[..., 2, :] ^ w1
        w3 = words[..., 3, :] ^ w2
        words = torch.stack([w0, w1, w2, w3], dim=-2)
        rounds.append(words)
    return torch.stack(rounds, dim=-3).reshape(keys.shape[:-1] + (11, 16))


def _sub_shift(state: torch.Tensor) -> torch.Tensor:
    return sub_bytes(state)[..., list(_SHIFT_ROWS)]


def _mix_columns(state: torch.Tensor) -> torch.Tensor:
    cols = state.reshape(state.shape[:-1] + (4, 4))
    rot1 = cols.roll(-1, -1)
    mixed = _xtime(cols) ^ _xtime(rot1) ^ rot1 \
        ^ cols.roll(-2, -1) ^ cols.roll(-3, -1)
    return mixed.reshape(state.shape)


def aes128_encrypt(round_keys: torch.Tensor,
                   blocks: torch.Tensor) -> torch.Tensor:
    """Batched ECB encrypt on the byte path: round_keys (..., 11, 16)
    and blocks (..., 16) uint8, broadcasting between batch shapes."""
    state = blocks ^ round_keys[..., 0, :]
    for r in range(1, 10):
        state = _mix_columns(_sub_shift(state)) ^ round_keys[..., r, :]
    return _sub_shift(state) ^ round_keys[..., 10, :]


# -- batch-bitsliced path ---------------------------------------------

def bitslice_pack(x: torch.Tensor) -> torch.Tensor:
    """uint8 (M, ..., K) with M % 32 == 0 -> planes (8, K, ..., M//32)
    int32, where bit j of word w is element 32*w + j of the leading
    axis."""
    m = x.shape[0]
    assert m % 32 == 0
    rest = x.shape[1:-1]
    xr = x.reshape((m // 32, 32) + rest + x.shape[-1:]).to(I32)
    shifts = torch.arange(32, dtype=I32, device=x.device).reshape(
        (1, 32) + (1,) * (len(rest) + 1))
    planes = []
    for b in range(8):
        bits = ((xr >> b) & 1) << shifts
        planes.append(_or_reduce(bits, 1))
    p = torch.stack(planes)          # (8, W, ..., K)
    p = torch.movedim(p, -1, 1)      # (8, K, W, ...)
    return torch.movedim(p, 2, -1)   # (8, K, ..., W)


def _or_reduce(bits: torch.Tensor, dim: int) -> torch.Tensor:
    """OR over `dim` of words with disjoint set bits (a plain sum, in
    int64 so the top bit cannot overflow)."""
    return bits.to(torch.int64).sum(dim).to(I32)


def bitslice_unpack(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of bitslice_pack: (8, K, ..., W) -> (32*W, ..., K)."""
    p = torch.movedim(planes, -1, 2)   # (8, K, W, ...)
    p = torch.movedim(p, 1, -1)        # (8, W, ..., K)
    shifts = torch.arange(32, dtype=I32, device=planes.device).reshape(
        (1, 32) + (1,) * (p.ndim - 2))
    acc = None
    for b in range(8):
        bits = ((p[b][:, None] >> shifts) & 1) << b
        acc = bits if acc is None else acc | bits
    out = acc.to(torch.uint8)          # (W, 32, ..., K)
    return out.reshape((-1,) + out.shape[2:])


def bitslice_keys(round_keys: torch.Tensor) -> torch.Tensor:
    """Key schedules (R, 11, 16) uint8 -> key planes (11, 8, 16, R//32)
    int32 (R % 32 == 0)."""
    return torch.movedim(bitslice_pack(round_keys), 2, 0)


def pack_mask(bits: torch.Tensor) -> torch.Tensor:
    """Pack a bool tensor (M, ...) along its leading axis -> (...,
    M//32) int32 select-mask words (bit j of word w = element 32*w+j)."""
    m = bits.shape[0]
    assert m % 32 == 0
    xr = bits.reshape((m // 32, 32) + bits.shape[1:]).to(I32)
    shifts = torch.arange(32, dtype=I32, device=bits.device).reshape(
        (1, 32) + (1,) * (bits.ndim - 1))
    words = _or_reduce(xr << shifts, 1)    # (W, ...)
    return torch.movedim(words, 0, -1)


def unpack_mask(words: torch.Tensor, m: int) -> torch.Tensor:
    """Inverse of pack_mask: (..., W) int32 -> (m, ...) bool."""
    shifts = torch.arange(32, dtype=I32, device=words.device).reshape(
        (1,) * (words.ndim - 1) + (1, 32))
    bits = (words[..., None] >> shifts) & 1          # (..., W, 32)
    bits = bits.reshape(words.shape[:-1] + (-1,))    # (..., 32W)
    return torch.movedim(bits, -1, 0)[:m].to(torch.bool)


def block_index_planes(num_blocks: int) -> np.ndarray:
    """le128(i) for i < num_blocks as plane masks: (num_blocks, 8, 16)
    int32, each entry 0 or -1 (all ones)."""
    out = np.zeros((num_blocks, 8, 16), np.int32)
    for i in range(num_blocks):
        le = i.to_bytes(16, "little")
        for b in range(8):
            for k in range(16):
                if (le[k] >> b) & 1:
                    out[i, b, k] = -1
    return out


def _xtime_planes(v: torch.Tensor) -> torch.Tensor:
    """xtime on an (8, ...) plane stack: shift planes up one, fold the
    top plane into the 0x1B taps (bits 1, 3, 4)."""
    out = v.roll(1, 0)
    hi = v[7]
    return torch.stack([out[0], out[1] ^ hi, out[2], out[3] ^ hi,
                        out[4] ^ hi, out[5], out[6], out[7]])


def _mix_columns_planes(s: torch.Tensor) -> torch.Tensor:
    c = s.reshape((8, 4, 4) + s.shape[2:])   # (planes, col, row, ...)
    rot1 = c.roll(-1, 2)
    mixed = _xtime_planes(c) ^ _xtime_planes(rot1) ^ rot1 \
        ^ c.roll(-2, 2) ^ c.roll(-3, 2)
    return mixed.reshape(s.shape)


def _sub_shift_planes(s: torch.Tensor) -> torch.Tensor:
    sb = torch.stack(sbox_planes_tower([s[b] for b in range(8)], -1))
    return sb[:, list(_SHIFT_ROWS)]


def aes128_encrypt_bitsliced(key_planes: torch.Tensor,
                             planes: torch.Tensor) -> torch.Tensor:
    """Bitsliced ECB encrypt.

    key_planes: (11, 8, 16, W) from bitslice_keys, one schedule per
    packed batch element.  planes: (8, 16, ..., W) int32 state planes
    whose middle dims broadcast against the keys (many blocks per
    batch element).  Kernel K2 on CUDA tensors, the plain version on
    CPU tensors."""
    if planes.shape[:2] != (8, 16) or key_planes.shape[:3] != (11, 8, 16) \
            or key_planes.shape[-1] != planes.shape[-1]:
        raise ValueError("expected key planes (11, 8, 16, W) and state "
                         "planes (8, 16, ..., W)")
    if planes.is_cuda:
        return _encrypt_cuda(key_planes, planes)
    return aes128_encrypt_bitsliced_plain(key_planes, planes)


def aes128_encrypt_bitsliced_plain(key_planes: torch.Tensor,
                                   planes: torch.Tensor) -> torch.Tensor:
    extra = planes.ndim - 3
    kp = key_planes.reshape(
        (11, 8, 16) + (1,) * extra + key_planes.shape[-1:])
    state = planes ^ kp[0]
    for r in range(1, 10):
        state = _mix_columns_planes(_sub_shift_planes(state)) ^ kp[r]
    return _sub_shift_planes(state) ^ kp[10]


def _encrypt_cuda(key_planes: torch.Tensor,
                  planes: torch.Tensor) -> torch.Tensor:
    kernels.check_cuda(key_planes, I32, "key_planes")
    kernels.check_cuda(planes, I32, "planes")
    w = planes.shape[-1]
    m = planes[0, 0].numel() // max(w, 1)
    out = torch.empty_like(planes)
    if m and w:
        kernels.launch("aes", "aes_bitsliced", key_planes.data_ptr(),
                       planes.data_ptr(), out.data_ptr(), m, w,
                       kernels.stream_ptr(planes.device),
                       counter="aes_planes")
    return out
