"""Where one job of the benchmark's cell spends the card, by the program's
innermost span, and what the spans cost.  Run from the repository's
root on a machine with an NVIDIA card:

    python3 artifacts/torch_port_pr18/probe_spans.py [--seed N]
        [--root DIR] [--label L] [--sync-only] [--jobs N] [--out DIR]

It sets up `histogram64.a16_r100000` as `portbench.run` does (the shard
of both batches, the pinned upload stores, one warm job), then:

* times a span's open and close on this host (`Tracer.span`), where the
  program has the spans;
* counts the synchronising calls of one job by source line, under
  `torch.cuda.set_sync_debug_mode("warn")`;
* runs `--jobs` untraced jobs: each one's wall time, `dispatch_ms` and
  span count, and its spans' host ms by name;
* unless `--sync-only`, traces one more job with CUDA activity and puts
  each device operation down to the innermost program span open when
  the host launched it (the runtime launch event with the operation's
  correlation id), and each idle gap of the card to the innermost span
  open when it began.  The table has one row per innermost span name:
  host ms, device operations, device ms, idle ms.

`--root DIR` imports the program and the harness from DIR (an unpacked
`git archive` of another commit).  Writes its results as JSON to
`<out>/probe_<label>.json` (default `build/probe_spans/` in the
repository holding this script) and prints them.
"""

import argparse
import bisect
import collections
import json
import os
import pathlib
import subprocess
import sys
import time
import warnings

CELL = "histogram64.a16_r100000"


class Innermost:
    """The innermost (latest-starting) of nested spans open at a wall
    time, by bisection over their starts."""

    def __init__(self, spans: list):
        self.spans = sorted(((s, e, name) for (name, s, e) in spans))
        self.starts = [s for (s, _e, _n) in self.spans]

    def __call__(self, t: int):
        k = bisect.bisect_right(self.starts, t) - 1
        while k >= 0:
            (_s, e, name) = self.spans[k]
            if t < e:
                return name
            k -= 1
        return None


def attribute(spans: list, ops: list, launches: dict, window: tuple,
              merged, gaps) -> dict:
    """spans: (name, start, end) of the job's program spans; ops: (name,
    start, end, correlation id) of its device operations; launches:
    correlation id -> the host's launch time.  Returns per innermost
    span name {"host_ms", "ops", "device_ms", "idle_ms", "leaf"} and
    the operations whose launch was not found."""
    innermost = Innermost(spans)
    parents = {sp for sp in spans
               if any(o is not sp and sp[1] <= o[1] and o[2] <= sp[2]
                      for o in spans)}
    rows: dict = collections.defaultdict(lambda: {
        "host_ms": 0.0, "ops": 0, "device_ms": 0.0, "idle_ms": 0.0,
        "leaf": True})
    for sp in spans:
        rows[sp[0]]["host_ms"] += (sp[2] - sp[1]) / 1e6
        if sp in parents:
            rows[sp[0]]["leaf"] = False
    unmatched = 0
    for (_name, s, e, corr) in ops:
        t = launches.get(corr)
        if t is None:
            unmatched += 1
            continue
        row = rows[innermost(t) or "outside spans"]
        row["ops"] += 1
        row["device_ms"] += (e - s) / 1e6
    for (a, b) in gaps(merged([(n, s, e) for (n, s, e, _c) in ops]),
                       window):
        rows[innermost(a) or "outside spans"]["idle_ms"] += \
            (b - a) / 1e6
    rows["outside spans"]["leaf"] = False
    return {"rows": {k: dict(v) for (k, v) in rows.items()},
            "unmatched_ops": unmatched}


def read_events(raw, t0: int, t1: int) -> tuple:
    """Device operations (name, start, end, correlation id) inside
    [t0, t1], the host's runtime events by correlation id, and a count
    of the events by (device type, kind)."""
    ops = []
    runtime = {}
    kinds: collections.Counter = collections.Counter()
    for ev in raw:
        dev = str(ev.device_type()).split(".")[-1]
        kind = getattr(ev, "activity_type", lambda: "")()
        kinds[f"{dev}/{kind}"] += 1
        if dev == "CUDA":
            if getattr(ev, "is_user_annotation", lambda: False)():
                continue
            (s, e) = (ev.start_ns(), ev.start_ns() + ev.duration_ns())
            if e > t0 and s < t1:
                ops.append((ev.name(), max(s, t0), min(e, t1),
                            ev.correlation_id()))
        elif ev.correlation_id():
            runtime.setdefault(ev.correlation_id(), ev.start_ns())
    return (ops, runtime, kinds)


def sync_count(fn) -> tuple:
    """Run fn under the synchronisation debug mode: (its result, the
    synchronising calls by file:line)."""
    import torch

    seen: collections.Counter = collections.Counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        if "synchroniz" in str(w.message):
            seen[f"{os.path.relpath(w.filename)}:{w.lineno}"] += 1
    return (out, seen)


def span_cost(n: int = 20000) -> dict:
    """Microseconds of one span's open and close on this host."""
    from mastic_tpu_torch.obs import trace as obs_trace

    tracer = obs_trace.configure()
    t0 = time.perf_counter()
    for _ in range(n):
        with tracer.span("probe", agg_id=0):
            pass
    out = {"span_us": (time.perf_counter() - t0) / n * 1e6}
    obs_trace.configure()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2147490301)
    parser.add_argument("--root", default=".")
    parser.add_argument("--label", default="change")
    parser.add_argument("--jobs", type=int, default=3)
    parser.add_argument("--sync-only", action="store_true")
    parser.add_argument("--out", default=str(
        pathlib.Path(__file__).resolve().parents[2] / "build" / "probe_spans"))
    args = parser.parse_args()
    root = pathlib.Path(args.root).resolve()
    dest = pathlib.Path(args.out).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch

    from portbench import catalog, devtrace, system, traffic
    from portbench.modes import attribute_metrics as mode
    from mastic_tpu_torch.obs import trace as obs_trace

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = {"label": args.label, "seed": args.seed, "card": smi,
           "spans_in_program": hasattr(obs_trace.Tracer, "wall_ns")}
    if out["spans_in_program"]:
        out["span_cost"] = span_cost()
    cell = catalog.cell(CELL)
    config = catalog.config(cell["config"])
    mastic = system.instantiate(config)
    data = traffic.generate(cell["generator"], cell["params"], mastic.bits,
                            mastic.RAND_SIZE, mastic.valid.PROOF_LEN,
                            args.seed)
    dev = torch.device("cuda", 0)
    tr = devtrace.Trace(False)
    state = mode.setup(cell, config, data, dev, tr)
    out["setup_s"] = time.perf_counter() - t_start
    print("setup", round(out["setup_s"], 1), flush=True)

    def one(b: int) -> dict:
        j = mode.job(state, b, tr)
        torch.cuda.synchronize(dev)
        return j

    (j, seen) = sync_count(lambda: one(1))
    out["sync_calls"] = sum(seen.values())
    out["sync_by_line"] = dict(seen.most_common())
    tracer = obs_trace.get_tracer()
    jobs = []
    for k in range(args.jobs):
        n0 = tracer.finished()
        j = one(k % 2)
        by_name: dict = collections.defaultdict(float)
        for sp in tracer.spans()[-(tracer.finished() - n0):]:
            by_name[sp.name] += sp.duration_ms
        jobs.append({"wall_ms": j["wall_ms"], "dispatch_ms": j["dispatch_ms"],
                     "spans": tracer.finished() - n0,
                     "span_ms": dict(by_name)})
    out["jobs"] = jobs
    print(json.dumps(jobs), flush=True)
    if not args.sync_only and out["spans_in_program"]:
        out["traced"] = traced_job(state, mode, tr, dev, devtrace)
    out["probe_s"] = time.perf_counter() - t_start
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"probe_{args.label}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return 0


def traced_job(state: dict, mode, tr, dev, devtrace) -> dict:
    """One job under torch.profiler with CUDA activity, its device
    operations and idle gaps put down to the innermost program span."""
    import torch

    from mastic_tpu_torch.obs import trace as obs_trace

    tracer = obs_trace.get_tracer()
    torch.cuda.synchronize(dev)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    n0 = tracer.finished()
    t0 = time.time_ns()
    j = mode.job(state, 0, tr)
    torch.cuda.synchronize(dev)
    t1 = time.time_ns()
    prof.__exit__(None, None, None)
    new = tracer.spans()[-(tracer.finished() - n0):]
    spans = [(sp.name, tracer.wall_ns(sp.t_start_ms),
              tracer.wall_ns(sp.t_start_ms + sp.duration_ms)) for sp in new]
    t_read = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    (ops, runtime, kinds) = read_events(raw, t0, t1)
    got = attribute(spans, ops, runtime, (t0, t1), devtrace.merged,
                    devtrace.gaps)
    rows = got["rows"]
    idle = sum(r["idle_ms"] for r in rows.values())
    leaf_idle = sum(r["idle_ms"] for r in rows.values() if r["leaf"])
    busy = sum(b - a for (a, b) in devtrace.merged(
        [(n, s, e) for (n, s, e, _c) in ops])) / 1e6
    return {"window_ms": (t1 - t0) / 1e6, "busy_ms": busy, "idle_ms": idle,
            "idle_in_leaf_share": leaf_idle / idle if idle else None,
            "device_ops": len(ops), "unmatched_ops": got["unmatched_ops"],
            "runtime_events": len(runtime), "raw_events": len(raw),
            "event_kinds": dict(kinds.most_common(12)),
            "spans": len(spans), "job_wall_ms": j["wall_ms"],
            "dispatch_ms": j["dispatch_ms"],
            "read_s": time.perf_counter() - t_read,
            "rows": dict(sorted(rows.items(),
                                key=lambda kv: -kv[1]["idle_ms"]))}


if __name__ == "__main__":
    sys.exit(main())
