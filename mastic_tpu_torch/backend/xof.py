"""Batched VDAF XOFs on the port's crypto kernels (port of
`mastic_tpu/backend/xof_jax.py`).

* XofTurboShake128: TurboSHAKE128(le16(len(dst)) || dst ||
  le8(len(seed)) || seed || binder, domain 1), through kernel K1.
* XofFixedKeyAes128: fixed key = TurboSHAKE128(le16(len(dst)) || dst ||
  binder, domain 2, 16); block i = pi(seed XOR le128(i)) with
  pi(x) = AES(sigma(x)) XOR sigma(x), sigma(lo||hi) = hi || hi^lo.
  On the card each call is one launch of kernel K2's fixed-key entry.

`sample_vec` reproduces the scalar rejection sampler assuming no
rejection and returns the in-range mask (False where a rejection would
have shifted the stream).
"""

import numpy as np
import torch

from ..scalar.common import to_le_bytes
from ..ops import kernels
from ..ops.aes import (aes128_encrypt_bitsliced_plain, aes128_key_schedule,
                       bitslice_keys, bitslice_pack, bitslice_unpack,
                       block_index_planes)
from ..ops.field import FieldSpec
from ..ops.keccak import turbo_shake128

_U8 = torch.uint8


def build_msg(batch_shape: tuple, device, *parts) -> torch.Tensor:
    """Concatenate message parts along the last axis.  Parts are bytes
    (broadcast across the batch) or uint8 tensors with leading dims
    broadcastable to `batch_shape`."""
    arrs = []
    for part in parts:
        if isinstance(part, (bytes, bytearray)):
            part = torch.as_tensor(np.frombuffer(bytes(part), np.uint8).copy(),
                                   device=device)
        if part.shape[-1] == 0:
            continue
        arrs.append(part.expand(tuple(batch_shape) + (part.shape[-1],)))
    if not arrs:
        return torch.zeros(tuple(batch_shape) + (0,), dtype=_U8,
                           device=device)
    return torch.cat(arrs, dim=-1)


def ts_prefix(dst: bytes, seed_len: int) -> bytes:
    """The static XofTurboShake128 message prefix for a dst and seed
    length."""
    return to_le_bytes(len(dst), 2) + dst + to_le_bytes(seed_len, 1)


def turboshake_xof(dst: bytes, seed, binder_parts: tuple, out_len: int,
                   batch_shape: tuple, device) -> torch.Tensor:
    """Batched XofTurboShake128(seed, dst, binder).next(out_len).
    `seed` and each binder part may be constant bytes or a tensor."""
    seed_len = len(seed) if isinstance(seed, (bytes, bytearray)) \
        else seed.shape[-1]
    msg = build_msg(batch_shape, device, ts_prefix(dst, seed_len), seed,
                    *binder_parts)
    return turbo_shake128(msg.contiguous(), 1, out_len)


def fixed_key_schedule(dst: bytes, binder: torch.Tensor,
                       batch_shape: tuple) -> torch.Tensor:
    """Derive the per-(dst, binder) fixed AES key and expand it:
    -> round keys (..., 11, 16)."""
    msg = build_msg(batch_shape, binder.device,
                    to_le_bytes(len(dst), 2) + dst, binder)
    keys = turbo_shake128(msg.contiguous(), 2, 16)
    return aes128_key_schedule(keys)


def _block_indices(num_blocks: int, device) -> torch.Tensor:
    """le128(i) for i in range(num_blocks): (num_blocks, 16) uint8."""
    idx = np.zeros((num_blocks, 16), np.uint8)
    for i in range(num_blocks):
        idx[i] = np.frombuffer(to_le_bytes(i, 16), np.uint8)
    return torch.as_tensor(idx, device=device)


def fixed_key_blocks(round_keys: torch.Tensor, seeds: torch.Tensor,
                     num_blocks: int) -> torch.Tensor:
    """XofFixedKeyAes128 output blocks 0..num_blocks-1.

    round_keys (R, 11, 16), one schedule per report; seeds (R, N...,
    16).  Returns (R, N..., num_blocks*16) uint8.  On a CUDA tensor
    this is one launch of kernel K2's `fixed_key_blocks` entry
    (`csrc/aes.cu`), which reads the report-major keys and seeds and
    writes the blocks itself; on a CPU tensor it runs
    `fixed_key_blocks_plain`."""
    if round_keys.ndim != 3 or round_keys.shape[1:] != (11, 16) \
            or seeds.ndim < 2 or seeds.shape[-1] != 16 \
            or seeds.shape[0] != round_keys.shape[0]:
        raise ValueError("expected round keys (R, 11, 16) and seeds "
                         "(R, N..., 16)")
    if seeds.is_cuda:
        return _fixed_key_blocks_cuda(round_keys, seeds, num_blocks)
    return fixed_key_blocks_plain(round_keys, seeds, num_blocks)


def fixed_key_blocks_plain(round_keys: torch.Tensor, seeds: torch.Tensor,
                           num_blocks: int) -> torch.Tensor:
    """The plain version of `fixed_key_blocks`: sigma and the block
    indices as byte tensors, the encryptions bitsliced along the report
    axis (padded to a multiple of 32 with zero lanes), the
    feed-forward.  The JAX package takes its bitsliced path for R >= 32
    and its byte path below: both give the same bytes."""
    x = seeds[..., None, :] ^ _block_indices(num_blocks, seeds.device)
    lo = x[..., :8]
    hi = x[..., 8:]
    sigma = torch.cat([hi, hi ^ lo], dim=-1)
    enc = _encrypt_bitsliced_reports(round_keys, sigma)
    out = enc ^ sigma
    return out.reshape(out.shape[:-2] + (num_blocks * 16,))


def _fixed_key_blocks_cuda(round_keys: torch.Tensor, seeds: torch.Tensor,
                           num_blocks: int) -> torch.Tensor:
    kernels.check_cuda(round_keys, _U8, "round_keys")
    if seeds.dtype != _U8 or seeds.device != round_keys.device:
        raise ValueError("seeds: expected uint8 on the round keys' device")
    num_reports = seeds.shape[0]
    # The kernel reads (R, S, 16) rows at any 4-byte aligned strides, so
    # a slice of a wider row (gen's next seeds) needs no copy.
    flat = seeds.reshape(num_reports, -1, 16)
    if flat.stride(2) != 1 or flat.data_ptr() % 4 \
            or flat.stride(0) % 4 or flat.stride(1) % 4:
        flat = flat.contiguous()
    num_seeds = flat.shape[1]
    out = torch.empty((num_reports, num_seeds, num_blocks * 16), dtype=_U8,
                      device=seeds.device)
    if out.numel():
        kernels.launch("aes", "fixed_key_blocks", round_keys.data_ptr(),
                       flat.data_ptr(), flat.stride(0), flat.stride(1),
                       out.data_ptr(), num_reports, num_seeds, num_blocks,
                       kernels.stream_ptr(seeds.device))
    return out.reshape(seeds.shape[:-1] + (num_blocks * 16,))


def fixed_key_blocks_planes(key_planes: torch.Tensor,
                            seed_planes: torch.Tensor,
                            num_blocks: int) -> torch.Tensor:
    """XofFixedKeyAes128 blocks entirely in the bitsliced plane domain.

    key_planes (11, 8, 16, W); seed_planes (8, 16, N..., W).  Returns
    stream planes (8, 16, N..., num_blocks, W).  The AES is its plain
    version: this serves K3's plain version, which runs no kernel."""
    idx = torch.as_tensor(block_index_planes(num_blocks),
                          device=seed_planes.device)       # (m, 8, 16)
    extra = seed_planes.ndim - 3
    idx = torch.movedim(idx, 0, -1).reshape(
        (8, 16) + (1,) * extra + (num_blocks, 1))
    x = seed_planes[..., None, :] ^ idx                     # (8,16,N..,m,W)
    lo = x[:, :8]
    hi = x[:, 8:]
    sigma = torch.cat([hi, hi ^ lo], dim=1).contiguous()
    return aes128_encrypt_bitsliced_plain(key_planes, sigma) ^ sigma


def _encrypt_bitsliced_reports(round_keys: torch.Tensor,
                               sigma: torch.Tensor) -> torch.Tensor:
    """AES over (R, N..., 16) blocks with per-report keys (R, 11, 16),
    bit-transposed along the report axis."""
    r = sigma.shape[0]
    pad = (-r) % 32
    if pad:
        sigma = torch.cat([sigma, sigma.new_zeros((pad,) + sigma.shape[1:])])
        round_keys = torch.cat([round_keys,
                                round_keys.new_zeros((pad, 11, 16))])
    planes = bitslice_pack(sigma).contiguous()      # (8, 16, N..., W)
    kp = bitslice_keys(round_keys).contiguous()     # (11, 8, 16, W)
    enc = bitslice_unpack(aes128_encrypt_bitsliced_plain(kp, planes))
    return enc[:r] if pad else enc


def sample_vec(spec: FieldSpec, stream: torch.Tensor, length: int,
               offset: int = 0) -> tuple:
    """Read `length` field elements from XOF output bytes at `offset`:
    -> (plain limbs (..., length, n), in_range (...))."""
    size = spec.encoded_size
    data = stream[..., offset:offset + length * size]
    data = data.reshape(data.shape[:-1] + (length, size))
    (limbs, ok) = spec.limbs_from_le_bytes(data)
    return (limbs, torch.all(ok, dim=-1))
