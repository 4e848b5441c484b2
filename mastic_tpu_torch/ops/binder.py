"""The eval proof's onehot and payload checks, read straight from the
carried tree: kernel K1's third entry point (`binder_sponge` in
`csrc/keccak.cu`) and its plain version.

Per aggregator and report, each check is TurboSHAKE128 (domain 1, 32
bytes out) over an XofTurboShake128 empty-seed prefix and a message
that the carry and a round's index lists define (the JAX package's
`IncrementalMastic._eval_proof`, mastic_tpu/backend/incremental.py):

* onehot: the 32-byte node proofs `proof[r, onehot_idx[k]]`, in order;
* payload: `le(sub(w[par_k, e], add(w[left_k, e], w[right_k, e])))`
  for each row k and element e < VALUE_LEN, with FieldSpec's add and
  sub (also on carried values >= p, which the level step stores where
  its in-range mask fails), 8 bytes a Field64 element and 16 a Field128
  one.

The kernel gathers the rows itself, computes the payload difference in
registers and absorbs the words where they fall in the rate lanes, so
no gathered copy, limb temporary or message exists in device memory.
One launch hashes both checks of every aggregator given.  The from-root
prep passes its flat tree (R, T, ...) as (R, 1, T, ...), its index
lists naming rows of the T-node axis.  It counts as
"keccak_binder" in `ops.kernels.launches` on Field64 carries and as
"keccak_binder_f128" on Field128 ones.
"""

import torch

from . import kernels
from .keccak import turbo_shake128_dynamic_plain

PROOF_SIZE = 32
# The launch counter of each payload field, by limb count.
COUNTERS = {4: "keccak_binder", 8: "keccak_binder_f128"}


def binder_checks(spec, ws: tuple, proofs: tuple, onehot_idx: torch.Tensor,
                  par: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                  prefix_onehot: bytes, prefix_payload: bytes) -> tuple:
    """ws: one carry.w (R, BITS, W, VALUE_LEN, n) int32 per aggregator;
    proofs: one carry.proof (R, BITS, W, 32) uint8 per aggregator;
    onehot_idx (K,), par/left/right (P,) int64 rows of the flattened
    (BITS * W) node axis.  Returns (onehot (A, R, 32), payload (A, R,
    32)) uint8.  K1's binder sponge on CUDA tensors, the plain version
    on CPU tensors."""
    if len(ws) != len(proofs) or not 1 <= len(ws) <= 2:
        raise ValueError("binder_checks takes one or two aggregators")
    if ws[0].is_cuda:
        return _checks_cuda(spec, ws, proofs, onehot_idx, par, left, right,
                            prefix_onehot, prefix_payload)
    return binder_checks_plain(spec, ws, proofs, onehot_idx, par, left,
                               right, prefix_onehot, prefix_payload)


def binder_checks_plain(spec, ws: tuple, proofs: tuple,
                        onehot_idx: torch.Tensor, par: torch.Tensor,
                        left: torch.Tensor, right: torch.Tensor,
                        prefix_onehot: bytes, prefix_payload: bytes) -> tuple:
    """The plain version: gather the rows, the plain limb arithmetic
    (`spec.plain`, on the card too), serialise, and the plain sponge
    behind the prefix."""
    spec = spec.plain
    (onehot, payload) = ([], [])
    for (w_all, proof_all) in zip(ws, proofs):
        (num_reports, bits, width, value_len, n) = w_all.shape
        w_flat = w_all.reshape(num_reports, bits * width, value_len, n)
        proof_flat = proof_all.reshape(num_reports, bits * width, PROOF_SIZE)
        diff = spec.sub(w_flat[:, par],
                        spec.add(w_flat[:, left], w_flat[:, right]))
        msg = spec.plain_to_le_bytes(diff).reshape(num_reports, -1)
        payload.append(turbo_shake128_dynamic_plain(
            msg, msg.shape[1], 1, PROOF_SIZE, prefix=prefix_payload))
        msg = proof_flat[:, onehot_idx].reshape(num_reports, -1)
        onehot.append(turbo_shake128_dynamic_plain(
            msg, msg.shape[1], 1, PROOF_SIZE, prefix=prefix_onehot))
    return (torch.stack(onehot), torch.stack(payload))


def _prefix_lanes(prefix: bytes, device) -> torch.Tensor:
    """The prefix as little-endian 64-bit lanes, zero-padded."""
    padded = bytes(prefix) + bytes(-len(prefix) % 8)
    return kernels.const_bytes(padded or bytes(8), device).view(torch.int64)


def _checks_cuda(spec, ws: tuple, proofs: tuple, onehot_idx: torch.Tensor,
                 par: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                 prefix_onehot: bytes, prefix_payload: bytes) -> tuple:
    if spec.num_limbs not in COUNTERS:
        raise ValueError(f"no binder sponge for {spec.num_limbs}-limb "
                         f"payloads")
    if len(prefix_onehot) != len(prefix_payload):
        raise ValueError("the two checks' prefixes must have one length")
    shape = ws[0].shape
    (num_reports, bits, width, value_len, n) = shape
    if n != spec.num_limbs:
        raise ValueError("binder_checks: carry limbs differ from the field's")
    for (w_all, proof_all) in zip(ws, proofs):
        if w_all.shape != shape \
                or proof_all.shape != (num_reports, bits, width, PROOF_SIZE):
            raise ValueError("binder_checks: inconsistent carry shapes")
        kernels.check_cuda(w_all, torch.int32, "carry w")
        kernels.check_cuda(proof_all, torch.uint8, "carry proof")
    if not par.shape == left.shape == right.shape:
        raise ValueError("payload index lists differ in length")
    for (t, what) in ((onehot_idx, "onehot rows"), (par, "payload parents"),
                      (left, "payload left"), (right, "payload right")):
        kernels.check_cuda(t, torch.int64, what)
    dev = ws[0].device
    pre = [_prefix_lanes(p, dev) for p in (prefix_onehot, prefix_payload)]
    num_aggs = len(ws)
    out = torch.empty((2, num_aggs, num_reports, PROOF_SIZE),
                      dtype=torch.uint8, device=dev)
    if num_reports:
        last = num_aggs - 1
        kernels.launch(
            "keccak", "binder_sponge", proofs[0].data_ptr(),
            proofs[last].data_ptr(), ws[0].data_ptr(), ws[last].data_ptr(),
            bits * width, value_len, n, onehot_idx.data_ptr(),
            onehot_idx.shape[0], par.data_ptr(), left.data_ptr(),
            right.data_ptr(), par.shape[0], pre[0].data_ptr(),
            pre[1].data_ptr(), len(prefix_onehot), out.data_ptr(),
            num_reports, num_aggs, kernels.stream_ptr(dev),
            counter=COUNTERS[n])
    return (out[0], out[1])
