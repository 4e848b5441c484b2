"""Arithmetic the per-layer readers share.  Each reader in
`portbench/metrics/` names its mode, its kernels and its quantity, and
returns None where its cell has nothing for it to read."""

from typing import Optional

import numpy as np


def rounds(ctx: dict, mode: str, key: str = "rounds") -> Optional[list]:
    """The mode's rounds (or jobs) that a reader reads: "rounds", those
    the host-clock readings take, or "traced", those inside the device
    trace."""
    if ctx.get("mode") != mode or not ctx.get(key):
        return None
    return ctx[key]


def roofline_pct(ctx: dict, mode: str, kernel: str,
                 names: tuple) -> Optional[float]:
    """The share of its bound that kernel `kernel` reached over the
    traced part: the sum of its rounds' bound ms over the device ms of
    the operations named `names`."""
    done = rounds(ctx, mode, "traced")
    trace = ctx.get("trace")
    if done is None or trace is None or not trace.events:
        return None
    device_ms = trace.kernel_ms(names)
    if device_ms <= 0:
        return None
    return 100.0 * sum(r["bound_ms"][kernel] for r in done) / device_ms


def idle_pct(ctx: dict, mode: str) -> Optional[float]:
    """The share of the traced window in which nothing ran on the
    card."""
    trace = ctx.get("trace")
    if rounds(ctx, mode, "traced") is None or trace is None \
            or not trace.events:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s())


def median(ctx: dict, mode: str, key: str) -> Optional[float]:
    done = rounds(ctx, mode)
    return None if done is None else float(np.median([r[key]
                                                      for r in done]))


def mean(ctx: dict, mode: str, key: str) -> Optional[float]:
    done = rounds(ctx, mode)
    return None if done is None else float(np.mean([r[key] for r in done]))


def total_s(ctx: dict, mode: str, key: str) -> Optional[float]:
    done = rounds(ctx, mode)
    return None if done is None else sum(r[key] for r in done) / 1e3
