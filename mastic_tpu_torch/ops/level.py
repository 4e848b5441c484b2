"""The fused VIDPF level step, kernel K3, and its plain version (port of
`mastic_tpu/ops/level_pallas.py`).

`level_step` computes one whole tree level for a report batch: extend
every parent (2 fixed-key AES blocks), correct seeds and control bits,
convert each child (`convert_blocks` AES blocks: next seed, payload
limbs with the in-range mask, w_cw added mod p where the child holds
ctrl), and the node proof (TurboSHAKE128 over prefix | next seed |
binder, XORed with proof_cw where the child holds ctrl).  Payloads are
Field64 or Field128 elements of any number: the TPU kernel's limit of
8 convert blocks is its VMEM envelope's, not the reference semantics
(the JAX package's incremental round hashes any payload through XLA).

The binder length is a runtime argument: the TPU kernel bakes it in,
so the JAX package's incremental round (whose binder grows with the
level) never reaches it; here `IncrementalMastic._eval_step_dynamic`
goes through K3 as well, and so does the from-root
`BatchedVidpf.eval_full` (every depth of a from-root round, with the
static per-depth binder; `get_beta_share` is its depth 0).  The node-proof message takes as many
rate blocks as prefix, seed and binder need (the TPU kernel's one-block
limit is its own).  On a CUDA tensor the wrapper builds the per-node
message template and launches `csrc/level.cu` on the report-major
inputs as they are (the level kernel, then the node-proof kernel: one
launch call, counted once, as "level" for Field64 payloads and
"level_f128" for Field128); on a CPU tensor it runs `level_step_plain`,
which is `level_core` plus the plain TurboSHAKE sponge.
"""

import numpy as np
import torch

from ..backend.xof import fixed_key_blocks_planes, sample_vec
from . import kernels
from .aes import bitslice_keys, bitslice_pack, bitslice_unpack, pack_mask, \
    unpack_mask
from .bits import I32
from .field import FieldSpec
from .keccak import RATE, turbo_shake128_dynamic_plain

# The launch counter of each payload field, by limb count.
COUNTERS = {4: "level", 8: "level_f128"}


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
    It runs the AES and the field on their plain versions (`spec.plain`,
    on the card too): this is K3's plain version."""
    spec = spec.plain
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



def level_step(spec, convert_blocks: int, value_len: int,
               ext_rk: torch.Tensor, conv_rk: torch.Tensor,
               parent_seed: torch.Tensor, parent_ctrl: torch.Tensor,
               cw_slice, prefix: bytes, node_binder: torch.Tensor,
               binder_len: int) -> tuple:
    """One VIDPF level.

    ext_rk/conv_rk (R, 11, 16) uint8; parent_seed (R, N, 16) uint8;
    parent_ctrl (R, N) bool; cw_slice = (seed_cw (R, 16) uint8, ctrl_cw
    (R, 2) bool, w_cw (R, VL, n) int32, proof_cw (R, 32) uint8);
    prefix = the TurboSHAKE node-proof message prefix; node_binder
    (2N, B) uint8, of which the first `binder_len` bytes of each row
    are hashed.  Returns (next_seed (R, 2N, 16) uint8, ct (R, 2N)
    bool, w (R, 2N, VL, n) int32 plain limbs, ok (R, 2N) bool, proof
    (R, 2N, 32) uint8); children interleave (left0, right0, left1,
    ...)."""
    if binder_len > node_binder.shape[-1]:
        raise ValueError("binder_len exceeds the binder rows")
    if convert_blocks != 1 + (value_len * spec.encoded_size + 15) // 16:
        raise ValueError("convert_blocks does not match the payload")
    if parent_seed.is_cuda:
        return _level_cuda(spec, convert_blocks, value_len, ext_rk, conv_rk,
                           parent_seed, parent_ctrl, cw_slice, prefix,
                           node_binder, binder_len)
    return level_step_plain(spec, convert_blocks, value_len, ext_rk,
                            conv_rk, parent_seed, parent_ctrl, cw_slice,
                            prefix, node_binder, binder_len)


def level_step_plain(spec, convert_blocks: int, value_len: int,
                     ext_rk: torch.Tensor, conv_rk: torch.Tensor,
                     parent_seed: torch.Tensor, parent_ctrl: torch.Tensor,
                     cw_slice, prefix: bytes, node_binder: torch.Tensor,
                     binder_len: int) -> tuple:
    """The plain version of K3: level_core then the node-proof sponge,
    in plain PyTorch only (no kernel), on any device."""
    (next_seed, ct, w, ok) = level_core(
        spec, convert_blocks, value_len, ext_rk, conv_rk, parent_seed,
        parent_ctrl, cw_slice)
    (num_reports, num_children) = ct.shape
    shape = (num_reports, num_children)
    msg = torch.cat([
        torch.as_tensor(np.frombuffer(prefix, np.uint8).copy(),
                        device=next_seed.device).expand(shape + (-1,)),
        next_seed,
        node_binder[None].expand(shape + (-1,)),
    ], dim=-1)
    proof = turbo_shake128_dynamic_plain(
        msg, len(prefix) + 16 + binder_len, 1, 32)
    proof_cw = cw_slice[3]
    proof = torch.where(ct[..., None], proof ^ proof_cw[:, None, :], proof)
    return (next_seed, ct, w, ok, proof)


def node_proof_template(prefix: bytes, node_binder: torch.Tensor,
                        binder_len: int) -> tuple:
    """The public part of every node-proof message, per node: prefix,
    a 16-byte hole for the seed, binder, TurboSHAKE's pad10*1 (domain
    1), as (2N, nb * 21) int64 rate-block lanes.  Returns (lanes,
    nb)."""
    plen = len(prefix)
    length = plen + 16 + binder_len
    nb = length // RATE + 1
    msg = torch.zeros((node_binder.shape[0], nb * RATE), dtype=torch.uint8,
                      device=node_binder.device)
    msg[:, :plen] = kernels.const_bytes(bytes(prefix), node_binder.device)
    msg[:, plen + 16:length] = node_binder[:, :binder_len]
    msg[:, length] ^= 0x01
    msg[:, -1] ^= 0x80
    return (msg.view(torch.int64), nb)


def _level_cuda(spec, convert_blocks: int, value_len: int,
                ext_rk: torch.Tensor, conv_rk: torch.Tensor,
                parent_seed: torch.Tensor, parent_ctrl: torch.Tensor,
                cw_slice, prefix: bytes, node_binder: torch.Tensor,
                binder_len: int) -> tuple:
    n = spec.num_limbs
    if n not in COUNTERS:
        raise ValueError(f"no level kernel for {n}-limb payloads")
    (seed_cw, ctrl_cw, w_cw, proof_cw) = cw_slice
    (num_reports, num_parents) = parent_ctrl.shape
    dev = parent_seed.device
    if parent_seed.shape != (num_reports, num_parents, 16) \
            or ext_rk.shape != (num_reports, 11, 16) \
            or conv_rk.shape != (num_reports, 11, 16) \
            or seed_cw.shape != (num_reports, 16) \
            or ctrl_cw.shape != (num_reports, 2) \
            or w_cw.shape != (num_reports, value_len, n) \
            or proof_cw.shape != (num_reports, 32) \
            or node_binder.shape[0] != 2 * num_parents:
        raise ValueError("level_step: inconsistent input shapes")
    (tmpl, nb) = node_proof_template(prefix, node_binder, binder_len)
    # The correction-word slices are strided views of the whole tree's.
    ins = [x.contiguous() for x in (ext_rk, conv_rk, parent_seed, parent_ctrl,
                                     seed_cw, ctrl_cw, w_cw, proof_cw)]
    for (t, dtype, what) in zip(
            ins + [tmpl],
            [torch.uint8] * 3 + [torch.bool, torch.uint8, torch.bool, I32,
                                 torch.uint8, torch.int64],
            ("ext round keys", "conv round keys", "parent seeds",
             "parent ctrl", "seed cw", "ctrl cw", "w cw", "proof cw",
             "node-proof template")):
        kernels.check_cuda(t, dtype, what)

    n2 = 2 * num_parents
    next_seed = torch.empty((num_reports, n2, 16), dtype=torch.uint8,
                            device=dev)
    ct = torch.empty((num_reports, n2), dtype=torch.bool, device=dev)
    w = torch.empty((num_reports, n2, value_len, n), dtype=I32, device=dev)
    ok = torch.empty((num_reports, n2), dtype=torch.bool, device=dev)
    proof = torch.empty((num_reports, n2, 32), dtype=torch.uint8, device=dev)
    if num_reports:
        kernels.launch(
            "level", "level_step", *(x.data_ptr() for x in ins),
            tmpl.data_ptr(), nb, len(prefix), next_seed.data_ptr(),
            ct.data_ptr(), w.data_ptr(), ok.data_ptr(), proof.data_ptr(),
            num_reports, num_parents, convert_blocks, value_len, n,
            kernels.stream_ptr(dev), counter=COUNTERS[n])
    return (next_seed, ct, w, ok, proof)
