"""The benchmark's one traffic generator: a cell's measurements, drawn
from `--seed` by the parameters of its workload file.

Two recipes, chosen by the workload's "generator":

* "planted": frozen copy of `mastic_tpu_torch/tools/northstar.py`'s
  `plant_paths` and `synthetic_reports` (the north-star recipe).  A
  share of the reports carries one of a few planted full-width paths
  (when two or more are planted, the second copies the first's first
  3/4 of the tree), the rest uniform paths; every weight is 1; the
  threshold is a share of the reports.
* "attributes": frozen copy of `chip_smoke.py::attribute_measurements`
  and `attribute_inputs` (phase e): each report's attribute is one of
  the attributes of interest (a share of the reports) or one of 2^40
  others, its path the attribute's SHA3-256 hash truncated to the tree
  depth, its weight uniform in [0, max]; disjoint sets of reports get a
  flipped correction-word byte (among reports whose attribute is asked)
  or a flipped bit in the leader's proof share.

Everything is drawn with `np.random.default_rng` in bulk on the host;
the nonces, the client randomness and the verify key come from the same
generator after the measurements.  The same seed gives the same
inputs.
"""

import hashlib
from typing import NamedTuple, Optional

import numpy as np


class Traffic(NamedTuple):
    """One batch of a cell's reports, in plaintext, and what the client
    needs to shard it."""
    alphas: np.ndarray        # (R, bits) bool
    weights: np.ndarray       # (R,) int64
    nonces: np.ndarray        # (R, 16) uint8
    rand: np.ndarray          # (R, rand_size) uint8
    tamper_cw: dict           # lane -> (depth, byte, xor)
    tamper_proof: dict        # lane -> proof element index


class Collection(NamedTuple):
    """A cell's inputs: its batches (the pool), the verify key, the
    threshold (heavy hitters) or the attributes of interest."""
    batches: list
    verify_key: bytes
    threshold: Optional[int]
    attributes: Optional[list]
    planted: Optional[np.ndarray]


def plant_paths(rng: np.random.Generator, planted: int,
                bits: int) -> np.ndarray:
    """Full-width planted paths, (planted, bits) bool, pairwise
    distinct; row 1 copies row 0's first 3/4 of the tree and diverges
    there (`tools/northstar.py::plant_paths`)."""
    if planted > 2 ** bits:
        raise ValueError(f"cannot plant {planted} distinct paths in a "
                         f"{bits}-bit tree")
    paths = rng.integers(0, 2, (planted, bits)).astype(bool)
    if planted >= 2:
        split = min(max(1, (3 * bits) // 4), bits - 1)
        paths[1, :split] = paths[0, :split]
        paths[1, split] = ~paths[0, split]
        paths[1, split + 1:] = rng.integers(0, 2, bits - split - 1) \
            .astype(bool)
    for r in range(planted):
        while any(np.array_equal(paths[r], paths[s]) for s in range(r)):
            paths[r] = rng.integers(0, 2, bits).astype(bool)
    return paths


def hash_path(name: str, bits: int) -> np.ndarray:
    """SHA3-256 of an attribute, its first `bits` bits as a bool path
    (the draft's attribute-based metrics mode)."""
    digest = hashlib.sha3_256(name.encode()).digest()
    value = int.from_bytes(digest[:(bits + 7) // 8], "big")
    value >>= (8 - bits % 8) % 8
    return np.array([(value >> (bits - 1 - i)) & 1 for i in range(bits)],
                    bool)


def _client_draws(rng: np.random.Generator, reports: int,
                  rand_size: int) -> tuple:
    nonces = rng.integers(0, 256, (reports, 16), dtype=np.uint8)
    rand = rng.integers(0, 256, (reports, rand_size), dtype=np.uint8)
    return (nonces, rand)


def planted(params: dict, bits: int, rand_size: int,
            rng: np.random.Generator) -> Collection:
    """The north-star recipe: `params` "reports", "planted",
    "share_heavy", "threshold_share"."""
    (R, k) = (params["reports"], params["planted"])
    paths = plant_paths(rng, k, bits)
    heavy = int(R * params["share_heavy"])
    choice = rng.integers(0, k, heavy)
    alphas = np.concatenate([
        paths[choice], rng.integers(0, 2, (R - heavy, bits)).astype(bool)])
    weights = np.ones(R, np.int64)
    threshold = int(R * params["threshold_share"])
    (nonces, rand) = _client_draws(rng, R, rand_size)
    verify_key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    return Collection([Traffic(alphas, weights, nonces, rand, {}, {})],
                      verify_key, threshold, None, paths)


def attributes(params: dict, bits: int, rand_size: int, proof_len: int,
               rng: np.random.Generator) -> Collection:
    """The attribute recipe: `params` "reports" (per batch), "pool"
    (batches), "asked" (attributes of interest), "share_asked",
    "max_weight", "tamper_cw_share", "tamper_proof_share"."""
    R = params["reports"]
    asked = [f"attribute-{i}" for i in range(params["asked"])]
    paths = {a: hash_path(a, bits) for a in asked}
    asked_rows = np.stack([paths[a] for a in asked])
    n_cw = int(R * params["tamper_cw_share"])
    n_proof = int(R * params["tamper_proof_share"])
    batches = []
    for _ in range(params["pool"]):
        inside = rng.random(R) < params["share_asked"]
        which = rng.integers(0, len(asked), R)
        others = rng.integers(0, 2 ** 40, R)
        alphas = np.empty((R, bits), bool)
        for r in range(R):
            alphas[r] = (asked_rows[which[r]] if inside[r]
                         else hash_path(f"other-{int(others[r])}", bits))
        weights = rng.integers(0, params["max_weight"] + 1, R)
        in_set = (alphas[:, None, :] == asked_rows[None]).all(-1).any(-1)
        cw_rows = np.sort(rng.choice(np.flatnonzero(in_set), n_cw,
                                     replace=False))
        proof_rows = np.sort(rng.choice(np.setdiff1d(np.arange(R), cw_rows),
                                        n_proof, replace=False))
        cw_at = zip(rng.integers(0, bits, n_cw), rng.integers(0, 16, n_cw),
                    rng.integers(1, 256, n_cw))
        tamper_cw = {int(r): (int(d), int(i), int(x))
                     for (r, (d, i, x)) in zip(cw_rows, cw_at)}
        tamper_proof = {int(r): int(j) for (r, j) in zip(
            proof_rows, rng.integers(0, proof_len, n_proof))}
        (nonces, rand) = _client_draws(rng, R, rand_size)
        batches.append(Traffic(alphas, weights, nonces, rand, tamper_cw,
                               tamper_proof))
    verify_key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    return Collection(batches, verify_key, None, asked, None)


def generate(generator: str, params: dict, bits: int, rand_size: int,
             proof_len: int, seed: int) -> Collection:
    """The cell's inputs from `seed` by its workload's generator."""
    rng = np.random.default_rng(seed)
    if generator == "planted":
        return planted(params, bits, rand_size, rng)
    if generator == "attributes":
        return attributes(params, bits, rand_size, proof_len, rng)
    raise ValueError(f"no traffic generator {generator!r}")
