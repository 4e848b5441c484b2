"""The program's own spans, read for the per-layer metrics.

The program (`mastic_tpu_torch/obs/trace.py`) keeps its finished spans
in a ring, timed on its monotonic clock and placed on the wall clock by
the tracer's `wall_ns`, the clock of the harness's spans
(`devtrace.Trace.spans`, `time.time_ns`).  A job of the attribute mode
is the interval from its harness span `attr.new_run` to the end of its
`attr.step_finish`; the jobs read are the window's untraced ones, after
`setup.warm` and before the device trace's start (`window_ns[0]`), the
jobs that `attr.dispatch_ms` reads.  Every function returns None where
the program has no such spans (a program without them, or a ring that
dropped some), and never raises for it.
"""

from typing import Optional

import numpy as np

# The spans of one chunk of a round from the root, by the chunk's span:
# its stage's leaves and its collect's wait.
STAGE = ("vidpf.eval_full", "prep.eval_proof", "prep.weight_check")
COLLECT = ("collect.wait",)


def program_spans() -> Optional[list]:
    """(name, start_ns, end_ns, attrs) of the program's finished spans,
    on the wall clock; None where its tracer has no wall clock."""
    try:
        from mastic_tpu_torch.obs.trace import get_tracer
    except ImportError:
        return None
    tracer = get_tracer()
    wall_ns = getattr(tracer, "wall_ns", None)
    if wall_ns is None:
        return None
    return [(sp.name, wall_ns(sp.t_start_ms),
             wall_ns(sp.t_start_ms + sp.duration_ms), sp.attrs)
            for sp in tracer.spans() if sp.duration_ms is not None]


def harness(ctx: dict, name: str) -> list:
    """(start_ns, end_ns) of the harness's spans named `name`."""
    trace = ctx.get("trace")
    if trace is None:
        return []
    return [(s, e) for (n, s, e) in trace.spans if n == name]


def untraced_jobs(ctx: dict) -> Optional[list]:
    """(start_ns, end_ns) of the window's untraced jobs, in order."""
    trace = ctx.get("trace")
    warm = harness(ctx, "setup.warm")
    if ctx.get("mode") != "attribute_metrics" or not warm \
            or trace.window_ns is None:
        return None
    (lo, hi) = (warm[-1][1], trace.window_ns[0])
    ends = sorted(e for (s, e) in harness(ctx, "attr.step_finish")
                  if lo <= s and e <= hi)
    jobs = []
    for (s, _e) in sorted(harness(ctx, "attr.new_run")):
        later = [e for e in ends if e > s]
        if lo <= s and later:
            jobs.append((s, later[0]))
    return jobs or None


def _inside(spans: list, lo: int, hi: int, names: tuple) -> list:
    return [sp for sp in spans if sp[0] in names and lo <= sp[1]
            and sp[2] <= hi]


def whole(spans: list, job: tuple) -> bool:
    """Whether every chunk of the job left its spans: chunks 0..n-1 each
    with a stage holding every leaf of `STAGE` and a collect holding a
    wait."""
    for (outer, leaves) in (("chunk.stage", STAGE),
                            ("chunk.collect", COLLECT)):
        chunks = _inside(spans, *job, (outer,))
        if sorted(a.get("chunk") for (_n, _s, _e, a) in chunks) \
                != list(range(len(chunks))) or not chunks:
            return False
        for (_n, s, e, _a) in chunks:
            found = {sp[0] for sp in _inside(spans, s, e, leaves)}
            if found != set(leaves):
                return False
    return True


def job_ms(ctx: dict, name: str, share: bool = False) -> Optional[float]:
    """The host milliseconds a job spends in the program's spans named
    `name` (all its chunks, both aggregators), or with `share` their
    percentage of the job's wall time, the median over the window's
    untraced jobs; None where a job lacks a chunk's spans."""
    jobs = untraced_jobs(ctx)
    spans = program_spans()
    if jobs is None or spans is None \
            or not all(whole(spans, job) for job in jobs):
        return None
    per_job = []
    for job in jobs:
        ns = sum(e - s for (_n, s, e, _a) in _inside(spans, *job, (name,)))
        per_job.append(ns / (job[1] - job[0]) * 100 if share else ns / 1e6)
    return float(np.median(per_job))


def setup_ms(ctx: dict, name: str) -> Optional[float]:
    """The host milliseconds in the program's spans named `name` inside
    the harness's `setup.shard`; None where there are none."""
    shard = harness(ctx, "setup.shard")
    spans = program_spans()
    if len(shard) != 1 or spans is None:
        return None
    found = _inside(spans, *shard[0], (name,))
    if not found:
        return None
    return sum(e - s for (_n, s, e, _a) in found) / 1e6
