"""One run of the benchmark, then where its set-up and jobs went, read in
the same process.  Run from the root of a checkout (this change's or an
unpacked parent's, whose program has fewer spans):

    python3 <path>/run_spans.py --workload <cell> --seed N \\
        --seconds 30 --trace <0|1>

It runs `portbench.run.main` with the arguments (the result line on
standard output, as the benchmark prints it), then prints one JSON line
more:

* `harness_s`: the seconds of each of the harness's spans by name
  (`setup.shard`, `setup.warm`, the jobs' `attr.*`), and `first_span_s`,
  the process's age when the first one opened;
* `jobs`: for each job's `round` span, in order (the warm job first,
  and with `--trace 1` the traced job last), the host ms of the
  program's spans inside it by name;
* `enqueue_ms_median`: over the window's untraced jobs, the median of
  the four spans that enqueue a chunk's round (`vidpf.eval_full`,
  `prep.eval_proof`, `prep.weight_check`, `round.checks`) summed, to
  set beside the line's `attr.dispatch_ms`, and `round_checks_ms_median`.
"""

import collections
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from mastic_tpu_torch.obs.trace import get_tracer  # noqa: E402
from portbench import devtrace, run  # noqa: E402

ENQUEUE = ("vidpf.eval_full", "prep.eval_proof", "prep.weight_check",
           "round.checks")
TRACES: list = []


class KeptTrace(devtrace.Trace):
    """The harness's trace, kept for reading after the run."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        TRACES.append(self)


def report(traced: bool) -> dict:
    """The JSON line after the run (see the module's docstring)."""
    out: dict = {}
    if TRACES:
        harness: dict = collections.defaultdict(float)
        for (name, s, e) in TRACES[-1].spans:
            harness[name] += (e - s) / 1e9
        started = time.time() - run.process_age_s()
        out["harness_s"] = dict(harness)
        out["first_span_s"] = min(s for (_n, s, _e) in TRACES[-1].spans) \
            / 1e9 - started
    spans = [sp for sp in get_tracer().spans() if sp.duration_ms is not None]
    jobs = []
    for r in (sp for sp in spans if sp.name == "round"):
        (lo, hi) = (r.t_start_ms, r.t_start_ms + r.duration_ms)
        ms: dict = collections.defaultdict(float)
        for sp in spans:
            if sp is not r and lo <= sp.t_start_ms \
                    and sp.t_start_ms + sp.duration_ms <= hi:
                ms[sp.name] += sp.duration_ms
        jobs.append(dict(ms, round=r.duration_ms))
    window = jobs[1:len(jobs) - 1] if traced else jobs[1:]
    out.update(jobs=jobs, dropped=get_tracer().dropped())
    if window:
        out["enqueue_ms_median"] = float(np.median(
            [sum(j.get(k, 0.0) for k in ENQUEUE) for j in window]))
        out["round_checks_ms_median"] = float(np.median(
            [j.get("round.checks", 0.0) for j in window]))
    return out


def main() -> int:
    devtrace.Trace = KeptTrace
    rc = run.main(sys.argv[1:])
    print(json.dumps(report(sys.argv[sys.argv.index("--trace") + 1]
                            == "1")))
    return rc


if __name__ == "__main__":
    sys.exit(main())
