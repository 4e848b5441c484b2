"""The fused VIDPF level step, kernel K3, and its plain version (port of
`mastic_tpu/ops/level_pallas.py`).

`level_step` computes one whole tree level for a report batch: extend
every parent (2 fixed-key AES blocks), correct seeds and control bits,
convert each child (`convert_blocks` AES blocks: next seed, payload
limbs with the in-range mask, w_cw added mod p where the child holds
ctrl), and the node proof (one-block TurboSHAKE128 over prefix | next
seed | binder, XORed with proof_cw where the child holds ctrl).

The binder length is a runtime argument: the TPU kernel bakes it in,
so the JAX package's incremental round (whose binder grows with the
level) never reaches it; here `IncrementalMastic._eval_step_dynamic`
goes through K3 as well.  On a CUDA tensor the wrapper packs the
inputs into bit planes and launches `csrc/level.cu`; on a CPU tensor
it runs `level_step_plain`, which is `backend.vidpf.level_core` plus
the plain TurboSHAKE sponge.
"""

import numpy as np
import torch

from ..backend.vidpf import level_core
from . import kernels
from .aes import bitslice_keys, bitslice_pack, pack_mask
from .bits import I32
from .keccak import RATE, turbo_shake128_dynamic_plain

_MAX_CONVERT_BLOCKS = 8


def supports(convert_blocks: int, prefix_len: int, binder_bytes: int) -> bool:
    """Shapes the fused level step serves: the node-proof message fits
    one absorb block and the convert stays a few AES blocks."""
    return (convert_blocks <= _MAX_CONVERT_BLOCKS
            and prefix_len + 16 + binder_bytes <= RATE - 1)


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
    if not supports(convert_blocks, len(prefix), binder_len):
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
    pad = (-num_reports) % 32
    r32 = num_reports + pad

    def padded(x):
        if not pad:
            return x
        return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

    words = r32 // 32
    ekp = bitslice_keys(padded(ext_rk)).reshape(11 * 128, words)
    ckp = bitslice_keys(padded(conv_rk)).reshape(11 * 128, words)
    pseed = torch.movedim(bitslice_pack(padded(parent_seed)), 2, 0)
    pseed = pseed.reshape(num_parents, 128, words)
    pctrl = pack_mask(padded(parent_ctrl))                  # (N, W)
    cwsd = bitslice_pack(padded(seed_cw)).reshape(128, words)
    cwct = pack_mask(padded(ctrl_cw))                       # (2, W)
    wcw = padded(w_cw).to(I32)
    pcw = padded(proof_cw)
    prefix_t = torch.as_tensor(np.frombuffer(prefix, np.uint8).copy(), device=dev)
    binder = node_binder.contiguous()
    ins = [x.contiguous() for x in (ekp, ckp, pseed, pctrl, cwsd, cwct,
                                     wcw, pcw)]
    for (t, dtype, what) in zip(
            ins + [prefix_t, binder],
            [I32] * 6 + [I32, torch.uint8, torch.uint8, torch.uint8],
            ("ext key planes", "conv key planes", "parent seed planes",
             "parent ctrl", "seed cw planes", "ctrl cw", "w cw",
             "proof cw", "prefix", "node binder")):
        kernels.check_cuda(t, dtype, what)

    n2 = 2 * num_parents
    next_seed = torch.empty((r32, n2, 16), dtype=torch.uint8, device=dev)
    ct = torch.empty((r32, n2), dtype=torch.bool, device=dev)
    w = torch.empty((r32, n2, value_len, 4), dtype=I32, device=dev)
    ok = torch.empty((r32, n2), dtype=torch.bool, device=dev)
    proof = torch.empty((r32, n2, 32), dtype=torch.uint8, device=dev)
    kernels.launch(
        "level", "level_step", *(x.data_ptr() for x in ins),
        prefix_t.data_ptr(), len(prefix), binder.data_ptr(),
        binder.shape[-1], binder_len, next_seed.data_ptr(), ct.data_ptr(),
        w.data_ptr(), ok.data_ptr(), proof.data_ptr(), words, num_parents,
        convert_blocks, value_len, kernels.stream_ptr(dev))
    if pad:
        return (next_seed[:num_reports], ct[:num_reports],
                w[:num_reports], ok[:num_reports], proof[:num_reports])
    return (next_seed, ct, w, ok, proof)
