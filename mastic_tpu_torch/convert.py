"""The state carried between the JAX package and the port.

Turns the JAX package's arrays, as numpy, into the port's tensors and
back: a report batch (`ReportBatch`, with the joint-rand circuits'
leader seeds and peer parts) and an aggregator's incremental carry
under the key names of the JAX package's `carry_to_arrays` /
`carry_from_arrays` (w, proof, seed, ctrl).  Field64 and Field128
limbs travel alike, as (..., n) uint32.  The
numpy side uses the JAX package's dtypes: uint32 for limbs, uint8 for
bytes, bool for bits; the torch side carries uint32 words as int32
(ops/bits.py).  Nothing here imports jax: callers hand over numpy
arrays (np.asarray of a jax.Array).
"""

import numpy as np
import torch

from . import resolve_device
from .backend.incremental import Carry
from .backend.mastic import ReportBatch
from .backend.vidpf import BatchedCorrectionWords


def to_tensor(arr, device="cuda") -> torch.Tensor:
    """A numpy array (uint32 -> int32 carrier, uint8, bool) as a
    tensor on `device`."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    if arr.dtype not in (np.int32, np.uint8, np.bool_):
        raise ValueError(f"unsupported dtype {arr.dtype}")
    return torch.from_numpy(arr.copy()).to(resolve_device(device))


def to_numpy(t: torch.Tensor, words: bool = False) -> np.ndarray:
    """A tensor as numpy; `words` gives int32 carriers back as uint32."""
    arr = t.detach().cpu().numpy()
    return arr.view(np.uint32) if words and arr.dtype == np.int32 else arr


_BATCH_KEYS = ("nonces", "cws_seed", "cws_ctrl", "cws_w", "cws_proof",
               "keys", "leader_proofs", "helper_seeds")
# Present for the joint-rand circuits only.
_JR_KEYS = ("leader_seeds", "peer_part0", "peer_part1")


def report_batch_to_arrays(batch: ReportBatch) -> dict:
    """A ReportBatch as named numpy arrays in the JAX package's dtypes;
    a joint-rand batch adds leader_seeds, peer_part0 and peer_part1
    (the JAX batch's `peer_parts[0]`, `[1]`)."""
    out = {
        "nonces": to_numpy(batch.nonces),
        "cws_seed": to_numpy(batch.cws.seed),
        "cws_ctrl": to_numpy(batch.cws.ctrl),
        "cws_w": to_numpy(batch.cws.w, words=True),
        "cws_proof": to_numpy(batch.cws.proof),
        "keys": to_numpy(batch.keys),
        "leader_proofs": to_numpy(batch.leader_proofs, words=True),
        "helper_seeds": to_numpy(batch.helper_seeds),
    }
    if batch.leader_seeds is not None:
        out.update(leader_seeds=to_numpy(batch.leader_seeds),
                   peer_part0=to_numpy(batch.peer_parts[0]),
                   peer_part1=to_numpy(batch.peer_parts[1]))
    return out


def report_batch_from_arrays(arrays, device="cuda") -> ReportBatch:
    """Inverse of report_batch_to_arrays (any mapping with those keys;
    a JAX ReportBatch gives them as nonces, cws.seed, cws.ctrl, cws.w,
    cws.proof, keys, leader_proofs, helper_seeds, and for the joint-rand
    circuits leader_seeds, peer_parts[0], peer_parts[1])."""
    missing = [k for k in _BATCH_KEYS if k not in arrays]
    if missing:
        raise KeyError(f"report batch arrays lack {missing}")

    def t(key, dtype):
        return to_tensor(np.asarray(arrays[key], dtype), device)

    (leader_seeds, peer_parts) = (None, (None, None))
    if any(k in arrays for k in _JR_KEYS):
        leader_seeds = t("leader_seeds", np.uint8)
        peer_parts = (t("peer_part0", np.uint8), t("peer_part1", np.uint8))
    return ReportBatch(
        nonces=t("nonces", np.uint8),
        cws=BatchedCorrectionWords(
            seed=t("cws_seed", np.uint8), ctrl=t("cws_ctrl", np.bool_),
            w=t("cws_w", np.uint32), proof=t("cws_proof", np.uint8)),
        keys=t("keys", np.uint8),
        leader_proofs=t("leader_proofs", np.uint32),
        helper_seeds=t("helper_seeds", np.uint8),
        leader_seeds=leader_seeds, peer_parts=peer_parts)


def carry_to_arrays(carry: Carry, prefix: str = "") -> dict:
    """A Carry as named numpy arrays, as the JAX package's
    carry_to_arrays names and types them."""
    return {
        prefix + "w": to_numpy(carry.w, words=True),
        prefix + "proof": to_numpy(carry.proof),
        prefix + "seed": to_numpy(carry.seed),
        prefix + "ctrl": to_numpy(carry.ctrl),
    }


def carry_from_arrays(arrays, prefix: str = "", device="cuda") -> Carry:
    """Inverse of carry_to_arrays (accepts any mapping of arrays)."""
    return Carry(
        w=to_tensor(np.asarray(arrays[prefix + "w"], np.uint32), device),
        proof=to_tensor(np.asarray(arrays[prefix + "proof"], np.uint8),
                        device),
        seed=to_tensor(np.asarray(arrays[prefix + "seed"], np.uint8), device),
        ctrl=to_tensor(np.asarray(arrays[prefix + "ctrl"], np.bool_), device))
