"""Batched Keccak-p[1600] and TurboSHAKE128 (port of
`mastic_tpu/ops/keccak_jax.py`), with the wrappers of kernel K1.

The public layouts are the JAX package's: lane halves `lo`, `hi` of
shape (..., 25) (int32 carriers of the uint32 halves), messages and
digests uint8.  The plain versions keep each 64-bit lane whole as an
int64 (ops/bits.py): a (25, batch) state, one vectorised step per
theta / rho / pi / chi / iota.

Kernel K1 (`csrc/keccak.cu`) replaces the Pallas permutation
`keccak_p1600_pallas` (mastic_tpu/ops/keccak_pallas.py:84).  Its entry
points: the bare permutation behind `keccak_p1600` (one thread a state,
staged through shared memory); a sponge that absorbs every rate block
of a batch in one launch behind `turbo_shake128_dynamic` and
`turbo_shake128`, each state split over a pair of threads so that the
paths' 4096-8192 messages put twice the warps on the card, reading the
rows in place through double-buffered shared memory (no padded copy,
and no copy behind a short shared prefix); and the eval proof's binder
sponge, which reads its message straight from the carried tree
(`ops/binder.py`).  The sponge's prefix, domain byte and padding reach
it as a lane template built here and uploaded once per (prefix, length,
domain) (`sponge_template`), so the kernel assembles every block
lane-wise.  In `ops.kernels.launches` the sponge counts as "keccak",
the permutation as "keccak_permute", the binder sponge as
"keccak_binder".
"""

import functools

import numpy as np
import torch

from ..scalar.keccak import RHO_OFFSETS, ROUND_CONSTANTS
from . import kernels
from .bits import I32, I64, rotl64, shr64

RATE = 168  # TurboSHAKE128 rate in bytes (21 lanes)

# rho offsets and the pi permutation for lane index i = x + 5*y.
_RHO = [RHO_OFFSETS[i % 5][i // 5] for i in range(25)]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
# Round constants as signed int64 bit patterns.
_RC = [rc - (1 << 64) if rc >> 63 else rc for rc in ROUND_CONSTANTS]


def _permute_plain(a: torch.Tensor, num_rounds: int) -> torch.Tensor:
    """Keccak-p[1600, num_rounds] on an int64 state (25, batch...)."""
    batch = a.shape[1:]
    dev = a.device
    rho = torch.tensor(_RHO, dtype=I64, device=dev).reshape(
        (25,) + (1,) * len(batch))
    pi = torch.tensor(_PI_SRC, dtype=torch.long, device=dev)
    for r in range(24 - num_rounds, 24):
        s = a.reshape((5, 5) + batch)                   # [y][x]
        c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]            # (5, batch)
        d = c.roll(1, 0) ^ rotl64(c.roll(-1, 0), 1)
        a = (s ^ d[None]).reshape((25,) + batch)
        rot = (a << rho) | shr64(a, (64 - rho) % 64)
        b = rot.index_select(0, pi).reshape((5, 5) + batch)
        chi = b ^ (~b.roll(-1, 1) & b.roll(-2, 1))
        a = chi.reshape((25,) + batch)
        a = torch.cat([a[:1] ^ _RC[r], a[1:]])
    return a


def _lanes64(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (hi.to(I64) << 32) | (lo.to(I64) & 0xFFFFFFFF)


def _check_lanes(lo: torch.Tensor, hi: torch.Tensor) -> None:
    if lo.shape != hi.shape or lo.shape[-1:] != (25,):
        raise ValueError("lo/hi must both have shape (..., 25)")


def keccak_p1600(lo: torch.Tensor, hi: torch.Tensor,
                 num_rounds: int = 12) -> tuple:
    """Apply Keccak-p[1600, num_rounds] to batched lanes: lo/hi int32
    (..., 25), lane order A[x + 5*y].  K1's permutation entry point on
    a CUDA tensor, the plain version on a CPU tensor."""
    _check_lanes(lo, hi)
    if lo.is_cuda:
        return _permute_cuda(lo, hi, num_rounds)
    return keccak_p1600_plain(lo, hi, num_rounds)


def keccak_p1600_plain(lo: torch.Tensor, hi: torch.Tensor,
                       num_rounds: int = 12) -> tuple:
    _check_lanes(lo, hi)
    a = torch.movedim(_lanes64(lo, hi), -1, 0)
    a = torch.movedim(_permute_plain(a, num_rounds), 0, -1)
    return (a.to(I32), (a >> 32).to(I32))


def _permute_cuda(lo: torch.Tensor, hi: torch.Tensor,
                  num_rounds: int) -> tuple:
    if not 1 <= num_rounds <= 24:
        raise ValueError("num_rounds must be in 1..24")
    for (t, what) in ((lo, "lo"), (hi, "hi")):
        kernels.check_cuda(t, I32, what)
    batch = lo.numel() // 25
    lo_out = torch.empty_like(lo)
    hi_out = torch.empty_like(hi)
    if batch:
        kernels.launch("keccak", "keccak_permute", lo.data_ptr(),
                       hi.data_ptr(), lo_out.data_ptr(),
                       hi_out.data_ptr(), batch, num_rounds,
                       kernels.stream_ptr(lo.device),
                       counter="keccak_permute")
    return (lo_out, hi_out)


def bytes_to_lanes(data: torch.Tensor) -> tuple:
    """uint8 (..., 8*n) -> little-endian int32 lane halves (lo, hi) of
    shape (..., n)."""
    assert data.shape[-1] % 8 == 0
    words = data.reshape(data.shape[:-1] + (-1, 2, 4)).to(I32)
    packed = words[..., 0] | (words[..., 1] << 8) | \
        (words[..., 2] << 16) | (words[..., 3] << 24)
    return (packed[..., 0], packed[..., 1])


def lanes_to_bytes(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Inverse of bytes_to_lanes: (..., n) halves -> uint8 (..., 8*n)."""
    return _lane64_bytes(_lanes64(lo, hi))


def _lane64_bytes(lanes: torch.Tensor) -> torch.Tensor:
    """int64 lanes (..., n) -> uint8 (..., 8*n), little-endian."""
    by = torch.stack([shr64(lanes, 8 * k) & 0xFF for k in range(8)],
                     dim=-1)
    return by.reshape(lanes.shape[:-1] + (-1,)).to(torch.uint8)


def _bytes_lane64(data: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 8*n) -> int64 lanes (..., n), little-endian."""
    by = data.reshape(data.shape[:-1] + (-1, 8)).to(I64)
    acc = by[..., 0]
    for k in range(1, 8):
        acc = acc | (by[..., k] << (8 * k))
    return acc


def turbo_shake128_dynamic(msg: torch.Tensor, length: int, domain: int,
                           out_len: int, num_rounds: int = 12,
                           prefix: bytes = b"") -> torch.Tensor:
    """TurboSHAKE128 over `prefix` followed by the first `length` bytes
    of every row of `msg` (uint8 (..., max_len)); bytes at positions >=
    length are ignored.  `length` and `prefix` are shared by the whole
    batch (in Mastic every runtime-varying message length is public
    protocol data).  K1's sponge on a CUDA tensor, the plain version on
    a CPU tensor."""
    if not 0x01 <= domain <= 0x7F:
        raise ValueError("domain byte out of range")
    if not 0 <= length <= msg.shape[-1]:
        raise ValueError("length exceeds the message capacity")
    if msg.is_cuda:
        return _sponge_cuda(msg, length, domain, out_len, num_rounds, prefix)
    return turbo_shake128_dynamic_plain(msg, length, domain, out_len,
                                        num_rounds, prefix)


def turbo_shake128(msg: torch.Tensor, domain: int, out_len: int,
                   num_rounds: int = 12) -> torch.Tensor:
    """Batched TurboSHAKE128(M, D, L) over whole rows: msg (..., L)
    -> (..., out_len)."""
    return turbo_shake128_dynamic(msg, msg.shape[-1], domain, out_len,
                                  num_rounds)


def turbo_shake128_dynamic_plain(msg: torch.Tensor, length: int,
                                 domain: int, out_len: int,
                                 num_rounds: int = 12,
                                 prefix: bytes = b"") -> torch.Tensor:
    """The plain version: prefix and message and pad10*1 into a padded
    copy, absorb block by block, squeeze (the keccak_jax.py:167 loop)."""
    batch = msg.shape[:-1]
    plen = len(prefix)
    length += plen
    num_blocks = length // RATE + 1
    buf = torch.zeros(batch + (num_blocks * RATE,), dtype=torch.uint8,
                      device=msg.device)
    if plen:
        buf[..., :plen] = torch.as_tensor(
            np.frombuffer(bytes(prefix), np.uint8).copy(), device=msg.device)
    buf[..., plen:length] = msg[..., :length - plen]
    buf[..., length] ^= domain
    buf[..., -1] ^= 0x80
    a = torch.zeros((25,) + batch, dtype=I64, device=msg.device)
    for i in range(num_blocks):
        block = _bytes_lane64(buf[..., i * RATE:(i + 1) * RATE])
        a = torch.cat([a[:21] ^ torch.movedim(block, -1, 0), a[21:]])
        a = _permute_plain(a, num_rounds)
    out = []
    produced = 0
    while produced < out_len:
        if produced > 0:
            a = _permute_plain(a, num_rounds)
        out.append(_lane64_bytes(torch.movedim(a[:21], 0, -1)))
        produced += RATE
    if not out:
        return torch.zeros(batch + (0,), dtype=torch.uint8,
                           device=msg.device)
    return torch.cat(out, dim=-1)[..., :out_len]


def sponge_template(prefix: bytes, length: int, domain: int) -> tuple:
    """The public part of every block of TurboSHAKE128 over `prefix`
    followed by `length` message bytes, for the sponge kernel: (a (2, nt,
    RATE) uint8 array, head).  Row 0 of template block j holds the bytes
    to XOR into the block (the prefix's, the domain byte, pad10*1's
    0x80), row 1 a mask, 0xFF on the message's bytes and 0 elsewhere.
    Template blocks 0 .. head-1 are the rate blocks that hold prefix
    bytes; block `head`, present when the final rate block holds none,
    is that final block.  Every other rate block is message bytes only."""
    plen = len(prefix)
    total = plen + length
    last = total // RATE
    head = -(-plen // RATE)
    blocks = list(range(head)) + ([last] if last >= head else [])
    pre = np.frombuffer(bytes(prefix), np.uint8)
    out = np.zeros((2, len(blocks), RATE), np.uint8)
    for (j, k) in enumerate(blocks):
        q = k * RATE + np.arange(RATE)
        in_prefix = q < plen
        out[0, j, in_prefix] = pre[q[in_prefix]]
        out[1, j] = np.where((q >= plen) & (q < total), 0xFF, 0)
        if k == last:
            out[0, j, total - k * RATE] ^= domain
            out[0, j, RATE - 1] ^= 0x80
    return (out, head)


@functools.lru_cache(maxsize=256)
def _device_template(prefix: bytes, length: int, domain: int,
                     device: torch.device) -> tuple:
    """`sponge_template` on the card, uploaded once per (prefix, length,
    domain): (uint8 tensor, head, template blocks)."""
    (tmpl, head) = sponge_template(prefix, length, domain)
    return (torch.from_numpy(tmpl).to(device), head, tmpl.shape[1])


def _sponge_cuda(msg: torch.Tensor, length: int, domain: int,
                 out_len: int, num_rounds: int, prefix: bytes) -> torch.Tensor:
    if num_rounds != 12:
        raise ValueError("the sponge kernel runs Keccak-p[1600, 12]")
    if len(prefix) + length >= 2 ** 31 - 2 * RATE:
        raise ValueError("the sponge kernel takes messages under 2 GiB")
    kernels.check_cuda(msg, torch.uint8, "msg")
    batch_shape = msg.shape[:-1]
    batch = 1
    for d in batch_shape:
        batch *= d
    out = torch.empty(batch_shape + (out_len,), dtype=torch.uint8,
                      device=msg.device)
    if batch and out_len:
        (tmpl, head, nt) = _device_template(bytes(prefix), length, domain,
                                            msg.device)
        kernels.launch("keccak", "turboshake", tmpl.data_ptr(), head, nt,
                       msg.data_ptr(), msg.shape[-1], len(prefix), length,
                       out.data_ptr(), out_len, batch,
                       kernels.stream_ptr(msg.device))
    return out
