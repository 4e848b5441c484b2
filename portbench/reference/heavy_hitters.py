"""The plain reference of the heavy-hitters mode: per level, the
candidate prefixes, each one's weighted count over the plaintext
measurements, and the pruning at the threshold; at the last level the
heavy hitters.

The draft's functional semantics (weighted heavy hitters): level 0 asks
both one-bit prefixes; each level keeps the candidates whose count
reaches the threshold and asks both children of each, in the order the
candidates came in; a collection ends at the last level or when nothing
survives.  Every report is honest here, so every one is counted and
accepted.  Plain numpy over the measurements the benchmark made; it
imports nothing of the program.
"""

from typing import NamedTuple

import numpy as np


class Round(NamedTuple):
    level: int
    prefixes: np.ndarray   # (candidates, level + 1) bool
    counts: np.ndarray     # (candidates,) int64
    accepted: int


class Collection(NamedTuple):
    rounds: list
    heavy_hitters: np.ndarray   # (hitters, bits) bool


def collection(alphas: np.ndarray, weights: np.ndarray, threshold: int,
               honest: np.ndarray = None) -> Collection:
    """Every round of one collection over `alphas` (R, bits) bool with
    `weights` (R,), counting the reports where `honest` is True (all by
    default)."""
    (R, bits) = alphas.shape
    if honest is None:
        honest = np.ones(R, bool)
    weights = np.where(honest, weights, 0)
    bit = alphas.astype(np.int64)
    parent = np.where(honest, 0, -1)       # survivor index of each report
    survivors = np.zeros((1, 0), bool)     # the root
    rounds = []
    hitters = np.zeros((0, bits), bool)
    for level in range(bits):
        prefixes = np.concatenate([
            np.repeat(survivors, 2, axis=0),
            np.tile([[False], [True]], (len(survivors), 1))], axis=1)
        cand = np.where(parent >= 0, 2 * parent + bit[:, level], -1)
        live = cand >= 0
        counts = np.bincount(cand[live], weights=weights[live],
                             minlength=len(prefixes)).astype(np.int64)
        rounds.append(Round(level, prefixes, counts, int(honest.sum())))
        keep = counts >= threshold
        remap = np.full(len(prefixes), -1)
        remap[keep] = np.arange(int(keep.sum()))
        parent = np.where(live, remap[np.maximum(cand, 0)], -1)
        survivors = prefixes[keep]
        if level == bits - 1:
            hitters = survivors
        if not len(survivors):
            break
    return Collection(rounds, hitters)


def node_evals(rounds: list, reports: int) -> list:
    """Each round's node evaluations: 2 aggregators x the reports x its
    candidate prefixes."""
    return [2 * reports * len(r.prefixes) for r in rounds]
