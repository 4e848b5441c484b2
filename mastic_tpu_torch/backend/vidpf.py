"""Batched VIDPF: dense level-synchronous gen / eval over torch tensors
(port of `mastic_tpu/backend/vidpf_jax.py`).

The per-report pointer tree is replaced by (reports x nodes) tensors:
one fixed-key AES schedule per (report, usage), reused for every node;
within a level all nodes extend / correct / convert / hash in one
batch; the level loop is the only sequential axis.  Every
secret-dependent choice is a lane select (torch.where) or a mask AND.

Field payloads are plain 16-bit limbs (int32, ops/field.py).
"""

from typing import NamedTuple

import numpy as np
import torch

from ..common import to_le_bytes
from ..dst import USAGE_CONVERT, USAGE_EXTEND, USAGE_NODE_PROOF, dst
from ..ops.aes import bitslice_keys, bitslice_pack, bitslice_unpack, \
    pack_mask, unpack_mask
from ..ops.field import FIELD64, FieldSpec
from ..ops.keccak import turbo_shake128_dynamic
from ..vidpf import KEY_SIZE, PROOF_SIZE
from .xof import (fixed_key_blocks, fixed_key_blocks_planes,
                  fixed_key_schedule, sample_vec, ts_prefix)

_U8 = torch.uint8


class BatchedCorrectionWords(NamedTuple):
    """Correction words for a report batch, one slice per tree level.

    seed  (R, BITS, 16) uint8
    ctrl  (R, BITS, 2) bool       [left, right]
    w     (R, BITS, VALUE_LEN, n) int32 plain limbs
    proof (R, BITS, 32) uint8
    """
    seed: torch.Tensor
    ctrl: torch.Tensor
    w: torch.Tensor
    proof: torch.Tensor


class EvalState(NamedTuple):
    """One level's node states for a report batch."""
    seed: torch.Tensor   # (R, N, 16) uint8
    ctrl: torch.Tensor   # (R, N) bool
    w: torch.Tensor      # (R, N, VALUE_LEN, n) int32 plain limbs
    proof: torch.Tensor  # (R, N, 32) uint8


def pack_path_bits(bits_arr: torch.Tensor) -> torch.Tensor:
    """MSB-first bit packing of (..., L) bools -> (..., ceil(L/8))
    uint8."""
    length = bits_arr.shape[-1]
    nbytes = (length + 7) // 8
    padded = bits_arr.new_zeros(bits_arr.shape[:-1] + (nbytes * 8,),
                                dtype=torch.int32)
    padded[..., :length] = bits_arr.to(torch.int32)
    weights = torch.as_tensor((1 << (7 - np.arange(8))).astype(np.int32),
                              device=bits_arr.device)
    grouped = padded.reshape(padded.shape[:-1] + (nbytes, 8))
    return (grouped * weights).sum(-1).to(_U8)


def level_core(spec: FieldSpec, convert_blocks: int, value_len: int,
               ext_rk: torch.Tensor, conv_rk: torch.Tensor,
               parent_seed: torch.Tensor, parent_ctrl: torch.Tensor,
               cw_slice) -> tuple:
    """extend + correct + convert for one level (everything but the
    node proof), in the bitsliced plane domain: one bitslice_pack of
    the parent seeds in, one unpack of the next seeds and payload out,
    corrections as mask ANDs on packed words.  Reports are padded to a
    multiple of 32 with zero lanes.  Returns (next_seed (R, 2N, 16), ct
    (R, 2N) bool, w plain limbs (R, 2N, VL, n), ok (R, 2N)); children
    interleave (left0, right0, left1, ...), i.e. lexicographic order.
    It runs the AES on its plain version: this is K3's plain version."""
    (seed_cw, ctrl_cw, w_cw, _proof_cw) = cw_slice
    (num_reports, num_parents) = parent_ctrl.shape
    pad = (-num_reports) % 32

    def padded(x):
        if not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    ext_kp = bitslice_keys(padded(ext_rk)).contiguous()   # (11,8,16,W)
    conv_kp = bitslice_keys(padded(conv_rk)).contiguous()
    sp = bitslice_pack(padded(parent_seed))               # (8,16,N,W)
    pctrl = pack_mask(padded(parent_ctrl))                # (N, W)

    ext = fixed_key_blocks_planes(ext_kp, sp, 2)        # (8,16,N,2,W)
    s_l = ext[..., 0, :].clone()
    s_r = ext[..., 1, :].clone()
    # Control bits are plane (0, byte 0); clear them in the seeds.
    t_l = s_l[0, 0].clone()
    t_r = s_r[0, 0].clone()
    s_l[0, 0] = 0
    s_r[0, 0] = 0

    cw_planes = bitslice_pack(padded(seed_cw))            # (8, 16, W)
    sel = cw_planes[:, :, None, :] & pctrl[None, None, :, :]
    s_l = s_l ^ sel
    s_r = s_r ^ sel
    cw_ctrl = pack_mask(padded(ctrl_cw))                  # (2, W)
    t_l = t_l ^ (pctrl & cw_ctrl[0])
    t_r = t_r ^ (pctrl & cw_ctrl[1])

    cs = torch.stack([s_l, s_r], dim=3).reshape(
        (8, 16, 2 * num_parents) + sp.shape[-1:])
    ct_words = torch.stack([t_l, t_r], dim=1).reshape(2 * num_parents, -1)

    stream = fixed_key_blocks_planes(conv_kp, cs, convert_blocks)
    next_seed = bitslice_unpack(stream[..., 0, :])[:num_reports]
    tail = stream[..., 1:, :]
    tail = bitslice_unpack(
        tail.reshape(tail.shape[:2] + (-1,) + tail.shape[-1:]))
    stream_bytes = tail[:num_reports].reshape(num_reports,
                                              2 * num_parents, -1)
    (w, ok) = sample_vec(spec, stream_bytes, value_len)

    ct = unpack_mask(ct_words, num_reports)               # (R, 2N)
    w = torch.where(ct[..., None, None], spec.add(w, w_cw[:, None]), w)
    return (next_seed.contiguous(), ct, w, ok)


class BatchedVidpf:
    """Batched VIDPF over Field64 with input length `bits` and payload
    length `value_len`."""

    def __init__(self, bits: int, value_len: int):
        self.spec: FieldSpec = FIELD64
        self.BITS = bits
        self.VALUE_LEN = value_len
        # Convert reads a 16-byte next seed then VALUE_LEN elements.
        payload_bytes = value_len * self.spec.encoded_size
        self.convert_blocks = 1 + (payload_bytes + 15) // 16

    # -- per-report key schedules ----------------------------------

    def roundkeys(self, ctx: bytes, nonces: torch.Tensor) -> tuple:
        """The two fixed-key AES schedules per report: (extend rk,
        convert rk), each (R, 11, 16)."""
        batch = nonces.shape[:-1]
        ext = fixed_key_schedule(dst(ctx, USAGE_EXTEND), nonces, batch)
        conv = fixed_key_schedule(dst(ctx, USAGE_CONVERT), nonces, batch)
        return (ext, conv)

    # -- the per-node primitives -----------------------------------

    def extend(self, ext_rk: torch.Tensor, seeds: torch.Tensor) -> tuple:
        """Extend seeds (R, N..., 16) into left/right child seeds and
        control bits (the LSB of byte 0, then cleared)."""
        blocks = fixed_key_blocks(ext_rk, seeds, 2)
        (s_l, s_r) = (blocks[..., :16].clone(), blocks[..., 16:].clone())
        t_l = (s_l[..., 0] & 1).to(torch.bool)
        t_r = (s_r[..., 0] & 1).to(torch.bool)
        s_l[..., 0] &= 0xFE
        s_r[..., 0] &= 0xFE
        return ((s_l, s_r), (t_l, t_r))

    def convert(self, conv_rk: torch.Tensor, seeds: torch.Tensor) -> tuple:
        """Convert seeds (R, N..., 16) -> (next seed, payload limbs,
        in-range mask per node)."""
        stream = fixed_key_blocks(conv_rk, seeds, self.convert_blocks)
        next_seed = stream[..., :16]
        (w, ok) = sample_vec(self.spec, stream, self.VALUE_LEN, offset=16)
        return (next_seed, w, ok)

    # -- key generation (client side) ------------------------------

    def _node_proof_dynamic(self, ctx: bytes, seeds: torch.Tensor,
                            path: torch.Tensor, i: int) -> torch.Tensor:
        """Node proof at level i over prefix | seed | BITS | le16(i) |
        packed path, hashed over its length (path bytes = i//8 + 1).
        seeds (R, S, 16); path (R, cap) is shared by the S seeds."""
        (num_reports, num_seeds) = seeds.shape[:2]
        prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), KEY_SIZE)
        tail = to_le_bytes(self.BITS, 2) + to_le_bytes(i, 2)
        shape = (num_reports, num_seeds)
        msg = torch.cat([
            torch.as_tensor(np.frombuffer(prefix, np.uint8).copy(),
                            device=seeds.device).expand(shape + (-1,)),
            seeds,
            torch.as_tensor(np.frombuffer(tail, np.uint8).copy(),
                            device=seeds.device).expand(shape + (-1,)),
            path[:, None, :].expand(shape + (-1,)),
        ], dim=-1)
        length = len(prefix) + KEY_SIZE + 4 + i // 8 + 1
        return turbo_shake128_dynamic(msg, length, 1, PROOF_SIZE)

    def gen(self, alphas: torch.Tensor, betas: torch.Tensor, ctx: bytes,
            nonces: torch.Tensor, rand: torch.Tensor) -> tuple:
        """Batched VIDPF key generation.

        alphas (R, BITS) bool; betas (R, VALUE_LEN, n) plain limbs;
        nonces (R, 16); rand (R, 32) uint8.
        Returns (BatchedCorrectionWords, keys (R, 2, 16), ok (R,)).
        Both parties' seeds go through each extend, convert and node
        proof together (one kernel launch each per level)."""
        (num_reports, bits) = alphas.shape
        assert bits == self.BITS
        spec = self.spec
        (ext_rk, conv_rk) = self.roundkeys(ctx, nonces)
        keys = torch.stack([rand[:, :KEY_SIZE], rand[:, KEY_SIZE:]], dim=1)

        # Per-level packed on-path prefixes: level i keeps the path's
        # first i+1 bits (MSB-first packing => masking trailing bits).
        path_cap = (bits + 7) // 8
        packed_full = pack_path_bits(alphas)               # (R, cap)
        byte_idx = np.arange(path_cap)

        seeds = keys.clone()                               # (R, 2, 16)
        ctrl = torch.zeros((num_reports, 2), dtype=torch.bool,
                           device=alphas.device)
        ctrl[:, 1] = True
        ok = torch.ones(num_reports, dtype=torch.bool, device=alphas.device)
        cw_seed = []
        cw_ctrl = []
        cw_w = []
        cw_proof = []
        for i in range(bits):
            bit = alphas[:, i]
            keep = np.where(byte_idx * 8 + 7 <= i, 0xFF,
                            np.where(byte_idx * 8 <= i,
                                     (0xFF << (7 - i % 8)) & 0xFF, 0))
            path = packed_full & torch.as_tensor(keep.astype(np.uint8),
                                                 device=alphas.device)

            ((s_l, s_r), (t_l, t_r)) = self.extend(ext_rk, seeds)
            # The losing child's seeds are forced to collide; control
            # corrections make on-path ctrl bits shares of 1.
            sel = bit[:, None]
            seed_cw = torch.where(sel, s_l[:, 0] ^ s_l[:, 1],
                                  s_r[:, 0] ^ s_r[:, 1])
            ctrl_cw_l = t_l[:, 0] ^ t_l[:, 1] ^ ~bit
            ctrl_cw_r = t_r[:, 0] ^ t_r[:, 1] ^ bit

            s_k = torch.where(sel[:, None], s_r, s_l)          # (R, 2, 16)
            t_k = torch.where(bit[:, None], t_r, t_l)          # (R, 2)
            ctrl_cw_keep = torch.where(bit, ctrl_cw_r, ctrl_cw_l)
            s_k = torch.where(ctrl[..., None], s_k ^ seed_cw[:, None], s_k)
            t_k = t_k ^ (ctrl & ctrl_cw_keep[:, None])

            (seeds, w, c_ok) = self.convert(conv_rk, s_k)
            ok = ok & c_ok.all(-1)

            # Payload correction: on-path shares must sum to beta.
            w_cw = spec.add(spec.sub(betas, w[:, 0]), w[:, 1])
            w_cw = torch.where(t_k[:, 1, None, None], spec.neg(w_cw), w_cw)

            # Node-proof correction, binding the on-path prefix.
            proofs = self._node_proof_dynamic(ctx, seeds.contiguous(),
                                              path, i)
            cw_seed.append(seed_cw)
            cw_ctrl.append(torch.stack([ctrl_cw_l, ctrl_cw_r], dim=-1))
            cw_w.append(w_cw)
            cw_proof.append(proofs[:, 0] ^ proofs[:, 1])
            ctrl = t_k

        cws = BatchedCorrectionWords(
            seed=torch.stack(cw_seed, dim=1), ctrl=torch.stack(cw_ctrl, dim=1),
            w=torch.stack(cw_w, dim=1), proof=torch.stack(cw_proof, dim=1))
        return (cws, keys, ok)
