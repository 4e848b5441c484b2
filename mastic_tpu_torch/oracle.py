"""Functional model of Mastic: what the protocol computes, with no
crypto (copy of `mastic_tpu/oracle.py`).  Differential-testing oracle
for the drivers: the port's tests and the north-star tool's expected
heavy hitters read it.
"""

from typing import Any, Callable, Sequence


def prefix_weights(measurements: Sequence[tuple],
                   prefixes: Sequence[tuple],
                   zero: Callable[[], Any],
                   add: Callable[[Any, Any], Any]) -> dict:
    """Total weight per candidate prefix: sum of beta over measurements
    whose alpha has that prefix.  `zero`/`add` abstract the weight
    monoid (ints, vectors, ...)."""
    out = {p: zero() for p in prefixes}
    for (alpha, beta) in measurements:
        for p in prefixes:
            if tuple(alpha[:len(p)]) == tuple(p):
                out[p] = add(out[p], beta)
    return out


def weighted_heavy_hitters(measurements: Sequence[tuple], threshold: int,
                           bit_len: int) -> list:
    """The level-by-level refinement loop over exact weights."""
    if bit_len < 1:
        raise ValueError("bit_len must be >= 1")
    prefixes = [(False,), (True,)]
    for level in range(bit_len):
        weights = prefix_weights(measurements, prefixes,
                                 zero=lambda: 0, add=lambda a, b: a + b)
        survivors = [p for p in prefixes if weights[p] >= threshold]
        if level == bit_len - 1:
            return sorted(survivors)
        prefixes = [p + (bit,) for p in survivors
                    for bit in (False, True)]
    raise AssertionError("unreachable")
