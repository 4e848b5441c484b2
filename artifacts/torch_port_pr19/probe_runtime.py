"""Where the host's time goes inside the program's spans, by CUDA
runtime call: one job of the benchmark's cell traced with CUDA activity,
each runtime call (cudaLaunchKernel, cudaMemcpyAsync, cudaMalloc, ...)
put down to the innermost program span open when it began, its time
summed by (span, call), and each span's launch times (quartiles, 99th
percentile, those over 50 us).  A launch that waits for room in the
card's queue, or a free or copy that waits for the card, shows here as
host time of that call.  Run from the repository's root on a machine
with an NVIDIA card:

    python3 artifacts/torch_port_pr19/probe_runtime.py [--seed N]
        [--out DIR]

It sets up `histogram64.a16_r100000` as `portbench.run` does, runs one
untraced job, then traces one job (with the kernels' launch counts in
it).  Writes `<out>/probe_runtime.json`
(default `build/probe_runtime/`) and prints it.
"""

import argparse
import collections
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "artifacts" / "torch_port_pr18"))

import probe_spans  # noqa: E402


def launch_quantiles(us: list) -> dict:
    """A span's cudaLaunchKernel times: quartiles, the 99th percentile,
    and the launches over 50 us (a launch that waits for room in the
    card's queue) with their total ms."""
    us = sorted(us)
    slow = [u for u in us if u > 50.0]
    return {"count": len(us),
            "q": [us[int(f * (len(us) - 1))] for f in (0.25, 0.5, 0.75,
                                                        0.99)],
            "over_50us": len(slow), "over_50us_ms": sum(slow) / 1e3}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=2147490301)
    parser.add_argument("--out", default=str(ROOT / "build" /
                                             "probe_runtime"))
    args = parser.parse_args()
    import torch

    from mastic_tpu_torch.obs import trace as obs_trace
    from mastic_tpu_torch.ops import kernels
    from portbench import catalog, devtrace, system, traffic
    from portbench.modes import attribute_metrics as mode

    cell = catalog.cell(probe_spans.CELL)
    config = catalog.config(cell["config"])
    mastic = system.instantiate(config)
    data = traffic.generate(cell["generator"], cell["params"], mastic.bits,
                            mastic.RAND_SIZE, mastic.valid.PROOF_LEN,
                            args.seed)
    dev = torch.device("cuda", 0)
    tr = devtrace.Trace(False)
    state = mode.setup(cell, config, data, dev, tr)
    mode.job(state, 1, tr)
    torch.cuda.synchronize(dev)
    tracer = obs_trace.get_tracer()
    before = dict(kernels.launches)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    n0 = tracer.finished()
    t0 = time.time_ns()
    j = mode.job(state, 0, tr)
    torch.cuda.synchronize(dev)
    t1 = time.time_ns()
    prof.__exit__(None, None, None)
    launches = {k: v - before.get(k, 0) for (k, v) in kernels.launches.items()
                if v != before.get(k, 0)}
    new = tracer.spans()[-(tracer.finished() - n0):]
    spans = [(sp.name, tracer.wall_ns(sp.t_start_ms),
              tracer.wall_ns(sp.t_start_ms + sp.duration_ms)) for sp in new]
    innermost = probe_spans.Innermost(spans)
    calls: dict = collections.defaultdict(lambda: [0, 0.0])
    launch_us: dict = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if str(ev.device_type()).split(".")[-1] == "CUDA":
            continue
        s = ev.start_ns()
        if not t0 <= s <= t1 or not ev.name().startswith("cuda"):
            continue
        key = f"{innermost(s) or 'outside spans'} | {ev.name()}"
        calls[key][0] += 1
        calls[key][1] += ev.duration_ns() / 1e6
        if ev.name() == "cudaLaunchKernel":
            launch_us[innermost(s) or "outside spans"].append(
                ev.duration_ns() / 1e3)
    rows = sorted(([k, n, ms] for (k, (n, ms)) in calls.items()),
                  key=lambda r: -r[2])
    out = {"seed": args.seed, "card": torch.cuda.get_device_name(dev),
           "job_wall_ms": j["wall_ms"], "dispatch_ms": j["dispatch_ms"],
           "window_ms": (t1 - t0) / 1e6, "launches": launches,
           "calls": [{"span_call": k, "count": n, "ms": ms}
                     for (k, n, ms) in rows[:40]],
           "launch_us": {span: launch_quantiles(us)
                         for (span, us) in launch_us.items()}}
    dest = pathlib.Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    (dest / "probe_runtime.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
