"""The plain references against hand counts, and against the program's
plain path on the CPU at a tiny size."""

import numpy as np
import pytest

from portbench import traffic
from portbench.reference import attributes as ref_attr
from portbench.reference import heavy_hitters as ref_hh
from portbench.tests.tiny import HH_CELL, run_tiny


def _hand(alphas, weights, threshold):
    """Heavy hitters by a loop over the reports, level by level."""
    (R, bits) = alphas.shape
    cands = [(False,), (True,)]
    out = []
    for level in range(bits):
        counts = []
        for p in cands:
            counts.append(sum(int(weights[r]) for r in range(R)
                              if tuple(bool(b) for b in alphas[r, :level + 1])
                              == p))
        out.append((cands, counts))
        surv = [p for (p, c) in zip(cands, counts) if c >= threshold]
        if not surv:
            return (out, [])
        if level == bits - 1:
            return (out, surv)
        cands = [p + (b,) for p in surv for b in (False, True)]


def test_heavy_hitters_reference_against_hand_count():
    col = traffic.generate("planted", HH_CELL["params"], 8, 8, 1, 11)
    t = col.batches[0]
    got = ref_hh.collection(t.alphas, t.weights, col.threshold)
    (want, hitters) = _hand(t.alphas, t.weights, col.threshold)
    assert len(got.rounds) == len(want)
    for (r, (cands, counts)) in zip(got.rounds, want):
        assert [tuple(bool(b) for b in p) for p in r.prefixes] == cands
        assert r.counts.tolist() == counts
        assert r.accepted == 64
    assert {tuple(bool(b) for b in p) for p in got.heavy_hitters} \
        == set(hitters) == {tuple(bool(b) for b in p) for p in col.planted}


def test_attribute_reference_against_hand_count():
    alphas = np.array([[0, 1], [0, 1], [1, 1], [0, 0], [0, 1]], bool)
    weights = np.array([5, 7, 9, 11, 13])
    paths = np.array([[0, 1], [1, 1], [1, 0]], bool)
    got = ref_attr.job(["a", "b", "c"], paths, alphas, weights, {1: (0, 0, 1)},
                       {2: 3})
    assert got.sums == [("a", 5 + 13), ("b", 0), ("c", 0)]
    assert got.accept.tolist() == [True, False, False, True, True]
    assert got.rejected == {"eval_proof": 1, "weight_check": 1}


def test_histogram_reference_against_hand_count():
    alphas = np.array([[0, 1], [0, 1], [1, 1], [0, 1], [0, 1]], bool)
    buckets = np.array([2, 0, 1, 2, 3])
    paths = np.array([[0, 1], [1, 1]], bool)
    got = ref_attr.job(["a", "b"], paths, alphas, buckets, {}, {4: 0}, 4)
    assert got.sums == [("a", [1, 0, 2, 0]), ("b", [0, 1, 0, 0])]
    assert got.accept.tolist() == [True, True, True, True, False]


@pytest.mark.parametrize("which", ["hh", "attr", "hist"])
def test_program_plain_path_matches_reference(which):
    line = run_tiny(which, seconds=2.0 if which == "hh" else 0.2)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0
    if which == "hh":
        assert line["attempted"] >= 8
