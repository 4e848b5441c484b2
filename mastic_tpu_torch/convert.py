"""The state carried between the JAX package and the port.

Turns the JAX package's arrays, as numpy, into the port's tensors and
back: a report batch (`ReportBatch`, with the joint-rand circuits'
leader seeds and peer parts), an aggregator's incremental carry under
the key names of the JAX package's `carry_to_arrays` /
`carry_from_arrays` (w, proof, seed, ctrl), a from-root prep
(`BatchedPrep`), the JAX package's from-root tree (`eval_full`'s
list of levels) as the port's flat buffer, and a chunked run's report
store (`HostReportStore.arrays`).  Field64 and Field128
limbs travel alike, as (..., n) uint32.  The
numpy side uses the JAX package's dtypes: uint32 for limbs, uint8 for
bytes, bool for bits; the torch side carries uint32 words as int32
(ops/bits.py).  Nothing here imports jax: callers hand over numpy
arrays (np.asarray of a jax.Array).  A run on a report mesh gathers its
carries over the ranks (`parallel.mesh.gather_rows`) before they come
here, so its arrays are the unsharded run's.
"""

import numpy as np
import torch

from . import resolve_device
from .backend.incremental import Carry
from .backend.mastic import BatchedPrep, ReportBatch
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


_STORE_WORDS = ("cws_w", "leader_proofs")


def store_to_arrays(store) -> dict:
    """A HostReportStore's arrays as the JAX package's HostReportStore
    holds them: numpy in its dtypes (limbs as uint32), `leader_seeds`
    None and `peer_parts` (None, None) without joint randomness."""
    def arr(key, t):
        return None if t is None else to_numpy(t, words=key in _STORE_WORDS)

    out = {k: arr(k, t) for (k, t) in store.arrays.items()
           if k != "peer_parts"}
    out["peer_parts"] = tuple(arr("peer_parts", t)
                              for t in store.arrays["peer_parts"])
    return out


def store_from_arrays(arrays, chunk_size: int, device="cuda"):
    """Inverse of store_to_arrays (a JAX HostReportStore's `arrays`): a
    HostReportStore whose tensors are pinned when `device` is the
    card."""
    from .drivers.chunked import HostReportStore, _host

    pin = resolve_device(device).type == "cuda"

    def t(x):
        return None if x is None else _host(to_tensor(x, "cpu"), pin)

    out = {k: t(x) for (k, x) in arrays.items() if k != "peer_parts"}
    out["peer_parts"] = tuple(t(x) for x in arrays["peer_parts"])
    return HostReportStore(out, int(np.asarray(arrays["nonces"]).shape[0]),
                           chunk_size)


_PREP_WORDS = ("out_share", "verifier")


def prep_to_arrays(prep: BatchedPrep, prefix: str = "") -> dict:
    """A BatchedPrep as named numpy arrays (limbs as uint32); fields
    that are None are left out."""
    return {prefix + k: to_numpy(v, words=k in _PREP_WORDS)
            for (k, v) in prep._asdict().items() if v is not None}


def prep_from_arrays(arrays, prefix: str = "", device="cuda") -> BatchedPrep:
    """Inverse of prep_to_arrays (any mapping of arrays; a missing
    field is None)."""
    def t(key):
        if prefix + key not in arrays:
            return None
        arr = np.asarray(arrays[prefix + key])
        return to_tensor(arr.astype(np.uint32) if key in _PREP_WORDS
                         else arr, device)

    return BatchedPrep(**{k: t(k) for k in BatchedPrep._fields})


def tree_from_levels(ws: list, proofs: list, device="cuda") -> tuple:
    """The JAX package's from-root tree, per depth d the children's w
    (R, N_d, VALUE_LEN, n) uint32 and proof (R, N_d, 32) uint8 (its
    `eval_full` levels as numpy), as the port's flat buffer: (w (R, T,
    VALUE_LEN, n) int32, proof (R, T, 32) uint8) on `device`."""
    return (to_tensor(np.concatenate(
                [np.asarray(w, np.uint32) for w in ws], axis=1), device),
            to_tensor(np.concatenate(
                [np.asarray(p, np.uint8) for p in proofs], axis=1), device))
