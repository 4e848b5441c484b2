"""Attribute metrics on the port against the JAX package, compared
exactly: `hash_attribute`, and `aggregate_by_attribute`'s result and
`RoundMetrics` record (all but the timing and artifact entries of
`extra`) over the same scalar-layer reports, with one tampered
correction word and one tampered leader proof share among them.  Then,
on the port alone: `AttributeMetricsRun`'s checkpoint round trip, and
heavy hitters from the root (`incremental=False`) against the
incremental runner."""

import json

import numpy as np
import pytest
import torch

from mastic_tpu import mastic as jm
from mastic_tpu.drivers import attribute_metrics as jam
from mastic_tpu_torch import (AttributeMetricsRun, aggregate_by_attribute,
                              hash_attribute)
from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.drivers.heavy_hitters import (HeavyHittersRun,
                                                     compute_heavy_hitters)

CTX = b"torch port attribute metrics"
VK = bytes(range(128, 160))
BITS = 5
ASKED = ["Greece", "Mexico", "United States", "India"]
OTHERS = ["Chile", "Kenya", "Peru", "Spain"]
REPORTS = 33
# Report index: a flipped correction-word seed byte, a changed leader
# proof share.
TAMPERED_CW = 4
TAMPERED_PROOF = 9


@pytest.mark.parametrize("bits", [1, 4, 5, 12, 32, 256])
def test_hash_attribute_matches_jax(bits):
    for attribute in ASKED + OTHERS + ["", "ünïcode"]:
        assert hash_attribute(tm.MasticCount(bits), attribute) == \
            jam.hash_attribute(jm.MasticCount(bits), attribute)


def _votes() -> list:
    """(attribute, weight) per report: four in five asked about."""
    rng = np.random.default_rng(11)
    return [((ASKED if i % 5 else OTHERS)[int(rng.integers(0, 4))],
             int(rng.integers(0, 8))) for i in range(REPORTS)]


def _scalar_reports(jmastic, votes: list) -> list:
    """The JAX package's scalar shard of each vote, from a seed, with
    two reports tampered."""
    rng = np.random.default_rng(12)
    reports = []
    for (attribute, weight) in votes:
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        rand = rng.integers(0, 256, jmastic.RAND_SIZE,
                            dtype=np.uint8).tobytes()
        (public, shares) = jmastic.shard(
            CTX, (jam.hash_attribute(jmastic, attribute), weight), nonce,
            rand)
        reports.append((nonce, public, shares))
    (nonce, public, shares) = reports[TAMPERED_CW]
    (seed, ctrl, w, proof) = public[2]
    public = public[:2] + [(bytes([seed[0] ^ 0x5A]) + seed[1:], ctrl, w,
                            proof)] + public[3:]
    reports[TAMPERED_CW] = (nonce, public, shares)
    (nonce, public, shares) = reports[TAMPERED_PROOF]
    (key, proof_share, seed_, part) = shares[0]
    proof_share = [proof_share[0] + jmastic.field(1)] + proof_share[1:]
    reports[TAMPERED_PROOF] = (nonce, public,
                               [(key, proof_share, seed_, part), shares[1]])
    return reports


@pytest.fixture(scope="module")
def rounds() -> tuple:
    """Both packages' attribute round over the same scalar reports:
    ((result, metrics) of the port, (result, metrics) of JAX)."""
    (jmastic, mastic) = (jm.MasticSum(BITS, 7), tm.MasticSum(BITS, 7))
    votes = _votes()
    reports = _scalar_reports(jmastic, votes)
    (jmetrics, tmetrics) = ([], [])
    jresult = jam.aggregate_by_attribute(jmastic, CTX, ASKED, reports,
                                         verify_key=VK, metrics_out=jmetrics)
    batch = tm.BatchedMastic(mastic).marshal_reports(reports, "cpu")
    tresult = aggregate_by_attribute(mastic, CTX, ASKED, VK, batch,
                                     metrics_out=tmetrics, device="cpu")
    return ((tresult, tmetrics), (jresult, jmetrics), votes)


def test_aggregate_by_attribute_matches_jax(rounds):
    """The per-attribute sums equal the JAX package's and the plaintext
    sums over the untampered reports."""
    ((tresult, _tm), (jresult, _jm), votes) = rounds
    assert tresult == jresult
    want = [(a, sum(w for (r, (b, w)) in enumerate(votes)
                    if b == a and r not in (TAMPERED_CW, TAMPERED_PROOF)))
            for a in ASKED]
    assert tresult == want


def test_round_metrics_match_jax(rounds):
    """RoundMetrics.as_dict() equals the JAX package's record, its schema
    stamp included, but for `extra`'s wall times and artifact-tier block
    (a layer the port has not brought over) and the port's own entries
    (no report left out as invalid, no splice rejection); the two
    tampered reports are attributed to the eval proof and the weight
    check."""
    ((_tr, tmetrics), (_jr, jmetrics), _votes) = rounds
    assert len(tmetrics) == len(jmetrics) == 1
    (got, want) = (tmetrics[0].as_dict(), jmetrics[0].as_dict())
    assert got["extra"].pop("round_wall_ms") > 0
    assert got["extra"].pop("splice_ms") >= 0
    assert (got["extra"].pop("excluded_invalid"),
            got["extra"].pop("rejected_fallback_by")) == (0, {})
    for key in ("round_wall_ms", "artifacts"):
        want["extra"].pop(key)
    assert got == want
    assert (got["accepted"], got["rejected_eval_proof"],
            got["rejected_weight_check"]) == (REPORTS - 2, 1, 1)


def test_attribute_run_round_trips_bytes():
    """A checkpoint before the round records that nothing ran, after it
    the result, which a restored run gives back without a round."""
    mastic = tm.MasticSum(BITS, 7)
    bm = tm.BatchedMastic(mastic)
    votes = _votes()[:8]
    (alphas, betas) = bm.encode_measurements(
        [(hash_attribute(mastic, a), w) for (a, w) in votes], "cpu")
    rng = np.random.default_rng(13)
    (batch, ok) = bm.shard_device(
        CTX, alphas, betas,
        torch.from_numpy(rng.integers(0, 256, (8, 16), dtype=np.uint8)),
        torch.from_numpy(rng.integers(0, 256, (8, mastic.RAND_SIZE),
                                      dtype=np.uint8)))
    run = AttributeMetricsRun(mastic, CTX, ASKED, VK, batch, ok, "cpu")
    fresh = run.to_bytes()
    assert json.loads(fresh) == {"done": False, "result": None}
    assert (run.frontier(), run.rounds_completed()) == ([], 0)
    assert run.step() is False
    assert run.result() == [(a, sum(w for (b, w) in votes if b == a))
                            for a in ASKED]
    assert (run.frontier(), run.rounds_completed()) == (run.result(), 1)
    assert run.metrics[0].accepted == 8
    back = AttributeMetricsRun.from_bytes(mastic, CTX, ASKED, VK, batch,
                                          run.to_bytes(), device="cpu")
    assert back.done and back.step_begin() is None
    assert back.result() == run.result() and back.metrics == []
    again = AttributeMetricsRun.from_bytes(mastic, CTX, ASKED, VK, batch,
                                           fresh, device="cpu")
    assert not again.done and again.step() is False
    assert again.result() == run.result()
    with pytest.raises(ValueError, match="collision"):
        AttributeMetricsRun(mastic, CTX, ["Mexico", "Japan"], VK, batch,
                            device="cpu")


def test_from_root_heavy_hitters_match_incremental():
    """compute_heavy_hitters(..., incremental=False), one from-root round
    a level, gives the incremental runner's heavy hitters and every
    level's counts (MasticCount(4), 40 reports), and one RoundMetrics
    record a level with every report accepted."""
    mastic = tm.MasticCount(4)
    bm = tm.BatchedMastic(mastic)
    rng = np.random.default_rng(14)
    values = [int(v) for v in rng.integers(0, 16, 3)] * 10 + \
        [int(v) for v in rng.integers(0, 16, 10)]
    meas = [(tuple(bool((v >> (3 - i)) & 1) for i in range(4)), 1)
            for v in values]
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    (batch, ok) = bm.shard_device(
        CTX, alphas, betas,
        torch.from_numpy(rng.integers(0, 256, (40, 16), dtype=np.uint8)),
        torch.from_numpy(rng.integers(0, 256, (40, mastic.RAND_SIZE),
                                      dtype=np.uint8)))
    thresholds = {"default": 8}
    runs = [HeavyHittersRun(mastic, CTX, thresholds, VK, batch, ok, "cpu",
                            incremental) for incremental in (True, False)]
    for run in runs:
        while run.step():
            pass
    assert runs[1].level_results == runs[0].level_results
    assert runs[1].result() == runs[0].result()
    assert len(runs[1].result()) >= 3
    assert [m.level for m in runs[1].metrics] == list(range(4))
    assert all(m.accepted == 40 and m.rejected_fallback == 0
               for m in runs[1].metrics)
    assert not runs[1].excluded().any()
    assert compute_heavy_hitters(mastic, CTX, thresholds, VK, batch, ok,
                                 "cpu", incremental=False) == runs[0].result()
