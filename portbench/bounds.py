"""The least time kernels K1 (the binder sponge, `csrc/keccak.cu`) and K3
(the level step, `csrc/level.cu`) could take for a round, from the
round's shape alone.

Frozen copy of `chip_smoke.py`'s count arithmetic (`_bound`,
`KECCAK_PERM_OPS`, `_binder_cost`, `check_level`'s K3 count): H100 SXM
peaks of 3.35 TB/s of HBM and 132 SMs x 64 int32 results a clock x
1.98 GHz (the boost clock is assumed: the run records `clocks.sm`
beside it); instructions counted as the functions need them, each
input byte read once and each output byte written once.  Here the
counts are fed the round's shape: the reports, the level, VALUE_LEN,
the context's length and the candidate prefixes that the plain
reference derives, which fix the parents, the onehot and payload rows
and the node binders.  Never the kernels' own launch arguments: K3's
parents are the live ones, not the padded width the program launches.
"""

import numpy as np

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# Keccak round: theta 20 + 10, applied 50, rho 48, chi 50, iota 2.
KECCAK_PERM_OPS = 12 * (20 + 10 + 50 + 48 + 50 + 2)
KECCAK_ABSORB_OPS = 42          # one rate block: 21 lanes x 2 XOR
RATE = 168
# AES over one column of 32 blocks in 2-input gates, two a LOP3.
SBOX_GATES = 195
AES_BLOCK_OPS = (11 * 128 + 10 * 16 * SBOX_GATES + 9 * 16 * 35) / 2

# A field element is `limbs` limbs of 16 bits (Field64 4, Field128 8),
# held as int32 on the card and encoded in 2 bytes a limb.
LIMBS = {"Field64": 4, "Field128": 8}
PROOF = 32
DST_HEAD = 6 + 1 + 1            # "mastic", version, usage
ALG_ID = 4


def bound_ms(nbytes: float, ops: float) -> float:
    """The larger of the bytes' and the operations' time at peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S) * 1e3


def distinct_prefixes(prefixes: np.ndarray) -> np.ndarray:
    """n[d] = the number of distinct (d+1)-bit prefixes of the rows of
    `prefixes` (k, L+1) bool, for d in 0..L."""
    (k, depth) = prefixes.shape
    if k == 0:
        return np.zeros(depth, np.int64)
    rows = prefixes[np.lexsort(prefixes.T[::-1])]
    differ = rows[1:] != rows[:-1]
    first = np.where(differ.any(axis=1), differ.argmax(axis=1), depth)
    return 1 + (first[None, :] <= np.arange(depth)[:, None]).sum(axis=1)


def payload_elem_ops(limbs: int) -> int:
    """The payload check's arithmetic per element: 3 values from the
    limbs (one op a limb each), the add and the sub (one op a limb each
    with its carry or borrow, and one a limb for the compare against p
    and the conditional correction): `chip_smoke.py`'s
    `PAYLOAD_ELEM_OPS` (Field64) and `PAYLOAD_ELEM_OPS_F128`."""
    return 3 * limbs + limbs + limbs


def binder_ms(reports: int, aggs: int, onehot: int, payload: int,
              payload_nodes: int, value_len: int, ctx_len: int,
              limbs: int) -> float:
    """K1's binder sponge over `aggs` aggregators' trees
    (`_binder_cost`)."""
    plen = 2 + DST_HEAD + ALG_ID + ctx_len + 1
    blocks = ((plen + PROOF * onehot) // RATE + 1
              + (plen + value_len * 2 * limbs * payload) // RATE + 1)
    in_bytes = aggs * reports * (PROOF * onehot
                                 + value_len * 4 * limbs * payload_nodes) \
        + 8.0 * (onehot + 3 * payload)
    out_bytes = 2 * aggs * reports * PROOF
    ops = aggs * reports * (blocks * (KECCAK_PERM_OPS + KECCAK_ABSORB_OPS)
                            + value_len * payload * payload_elem_ops(limbs))
    return bound_ms(in_bytes + out_bytes, float(ops))


def level_ms(reports: int, parents: int, depth: int, value_len: int,
             ctx_len: int, limbs: int) -> float:
    """One K3 launch (`level_kernel` and `node_proof_kernel`) for one
    aggregator: `parents` live parents a report, their children at
    `depth` (`check_level`'s count)."""
    prefix = 2 + DST_HEAD + ctx_len + 1
    binder_len = 4 + (depth + 1 + 7) // 8
    convert_blocks = 1 + (value_len * 2 * limbs + 15) // 16
    nb = (prefix + 16 + binder_len) // RATE + 1
    pairs = (reports + 31) // 32 * parents
    in_bytes = 2 * 11 * 16 * reports + reports * parents * 17 \
        + reports * (16 + 2 + value_len * 4 * limbs + PROOF) + prefix \
        + 2 * parents * binder_len
    out_bytes = reports * 2 * parents * (16 + 1 + value_len * 4 * limbs
                                         + 1 + PROOF)
    ops = pairs * (2 * (1 + convert_blocks) * AES_BLOCK_OPS
                   + 64 * nb * (KECCAK_PERM_OPS + KECCAK_ABSORB_OPS))
    return bound_ms(float(in_bytes + out_bytes), float(ops))


def incremental_round(prefixes: np.ndarray, reports: int, value_len: int,
                      ctx_len: int, limbs: int) -> dict:
    """Bound ms of an incremental round at level L over the candidate
    `prefixes` (k, L+1): K1 once for both aggregators over the carried
    tree, K3 once an aggregator for the live parents."""
    level = prefixes.shape[1] - 1
    anc = distinct_prefixes(prefixes)
    onehot = 2 + int(2 * anc[:level].sum())
    payload = int(anc[:level].sum())
    payload_nodes = int(anc[0]) + onehot - 2 if level else 0
    parents = int(anc[level - 1]) if level else 1
    return {"k1": binder_ms(reports, 2, onehot, payload, payload_nodes,
                            value_len, ctx_len, limbs),
            "k3": 2 * level_ms(reports, parents, level, value_len, ctx_len,
                               limbs)}


def from_root_round(prefixes: np.ndarray, reports: int, value_len: int,
                    ctx_len: int, limbs: int) -> dict:
    """Bound ms of a from-root round at level L: per aggregator, K3 at
    every depth d for the distinct d-bit parents and K1 once over the
    flat tree."""
    level = prefixes.shape[1] - 1
    # parents[d] = distinct d-bit prefixes (the root at d = 0).
    parents = np.concatenate([[1], distinct_prefixes(prefixes)[:level]])
    total = int(2 * parents.sum())
    payload = int(parents[1:].sum())
    payload_nodes = int(parents[1]) + total - 2 if level else 0
    k3 = sum(level_ms(reports, int(parents[d]), d, value_len, ctx_len,
                      limbs) for d in range(level + 1))
    return {"k1": 2 * binder_ms(reports, 1, total, payload, payload_nodes,
                                value_len, ctx_len, limbs),
            "k3": 2 * k3}
