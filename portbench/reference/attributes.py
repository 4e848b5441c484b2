"""The plain reference of the attribute-metrics mode: each attribute of
interest's aggregate over the reports that pass the checks (the sum of
their weights, or, for a histogram, the count of their measurements in
each bucket), and each report's verdict.

A report whose correction word was altered fails the eval proof (its
path is on the evaluated grid), one whose leader proof share was
altered fails the weight check, and every other report is accepted.
Plain numpy over the measurements and the tampering the benchmark made;
it imports nothing of the program.
"""

from typing import NamedTuple, Optional

import numpy as np


class Job(NamedTuple):
    sums: list             # [(attribute, aggregate)] in the asked order
    accept: np.ndarray     # (R,) bool
    rejected: dict         # check -> reports it rejects


def job(attributes: list, paths: np.ndarray, alphas: np.ndarray,
        weights: np.ndarray, tamper_cw: dict, tamper_proof: dict,
        buckets: Optional[int] = None) -> Job:
    """`paths` (attributes, bits) bool are the attributes' hashed paths;
    `alphas` (R, bits) bool and `weights` (R,) the reports'.  With
    `buckets`, each weight is a histogram's bucket and an attribute's
    aggregate is its list of `buckets` counts."""
    R = len(alphas)
    accept = np.ones(R, bool)
    accept[list(tamper_cw)] = False
    accept[list(tamper_proof)] = False
    sums = []
    for (name, path) in zip(attributes, paths):
        match = (alphas == path).all(axis=1) & accept
        sums.append((name, int(weights[match].sum()) if buckets is None
                     else np.bincount(weights[match],
                                      minlength=buckets).tolist()))
    return Job(sums, accept, {"eval_proof": len(tamper_cw),
                              "weight_check": len(tamper_proof)})
