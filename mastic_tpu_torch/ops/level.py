"""The fused VIDPF level step, kernel K3, and its plain version (port of
`mastic_tpu/ops/level_pallas.py`).

`level_step` computes one whole tree level for a report batch: extend
every parent (2 fixed-key AES blocks), correct seeds and control bits,
convert each child (`convert_blocks` AES blocks: next seed, payload
limbs with the in-range mask, w_cw added mod p where the child holds
ctrl), and the node proof (TurboSHAKE128 over prefix | next seed |
binder, XORed with proof_cw where the child holds ctrl).

The binder length is a runtime argument: the TPU kernel bakes it in,
so the JAX package's incremental round (whose binder grows with the
level) never reaches it; here `IncrementalMastic._eval_step_dynamic`
goes through K3 as well.  The node-proof message takes as many rate
blocks as prefix, seed and binder need (the TPU kernel's one-block
limit is its own).  On a CUDA tensor the wrapper builds the per-node
message template and launches `csrc/level.cu` on the report-major
inputs as they are (the level kernel, then the node-proof kernel: one
launch call, counted once); on a CPU tensor it runs `level_step_plain`,
which is `backend.vidpf.level_core` plus the plain TurboSHAKE sponge.
"""

import numpy as np
import torch

from ..backend.vidpf import level_core
from . import kernels
from .bits import I32
from .keccak import RATE, turbo_shake128_dynamic_plain

_MAX_CONVERT_BLOCKS = 8


def supports(convert_blocks: int) -> bool:
    """Shapes the fused level step serves: the convert stays a few AES
    blocks.  The node-proof message may take any number of rate
    blocks (a long `ctx` makes it longer than one)."""
    return convert_blocks <= _MAX_CONVERT_BLOCKS


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
    if not supports(convert_blocks):
        raise ValueError("shape outside the fused level step")
    if binder_len > node_binder.shape[-1]:
        raise ValueError("binder_len exceeds the binder rows")
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
    if spec.num_limbs != 4:
        raise NotImplementedError("the level kernel serves Field64 only")
    (seed_cw, ctrl_cw, w_cw, proof_cw) = cw_slice
    (num_reports, num_parents) = parent_ctrl.shape
    dev = parent_seed.device
    if parent_seed.shape != (num_reports, num_parents, 16) \
            or ext_rk.shape != (num_reports, 11, 16) \
            or conv_rk.shape != (num_reports, 11, 16) \
            or seed_cw.shape != (num_reports, 16) \
            or ctrl_cw.shape != (num_reports, 2) \
            or w_cw.shape != (num_reports, value_len, 4) \
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
    w = torch.empty((num_reports, n2, value_len, 4), dtype=I32, device=dev)
    ok = torch.empty((num_reports, n2), dtype=torch.bool, device=dev)
    proof = torch.empty((num_reports, n2, 32), dtype=torch.uint8, device=dev)
    if num_reports:
        kernels.launch(
            "level", "level_step", *(x.data_ptr() for x in ins),
            tmpl.data_ptr(), nb, len(prefix), next_seed.data_ptr(),
            ct.data_ptr(), w.data_ptr(), ok.data_ptr(), proof.data_ptr(),
            num_reports, num_parents, convert_blocks, value_len,
            kernels.stream_ptr(dev))
    return (next_seed, ct, w, ok, proof)
