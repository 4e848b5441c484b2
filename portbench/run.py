"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds the program (`mastic_tpu_torch`),
on a machine with an NVIDIA card.  The run makes the cell's inputs from
`--seed` (`portbench/traffic.py`), shards them on the card and warms the
cell's shapes (set-up, timed from the process's start), measures for
`--seconds` (the window), compares what the window produced with the
plain reference (`portbench/reference/`), and prints one JSON line:

    {"correct", "attempted", "failed", "metrics", "device",
     ["breakdown"], "counts", "compared"}

With `--trace 0` the metrics are the cell's end-to-end metrics in
`BENCHMARK.json`, with `--trace 1` its per-layer metrics, read from the
device trace of the window and the harness's spans by the readers in
`portbench/metrics/`.  "compared" (last) holds each number compared
with the reference beside its limit; the same lines end standard error.

Exits 3 without a result when there is no card (or fewer than the cell
asks for), and 4 when JAX or the JAX package is loaded once the window
has closed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

WALL0 = time.time()

from portbench import catalog, devtrace, system, traffic  # noqa: E402

# Top-level module names that no run may load (compared whole).
FORBIDDEN = ("jax", "jaxlib", "flax", "mastic_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time() - WALL0


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def nvidia_smi() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads
    them ("" where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def run_cell(name: str, cell: dict, config: dict, seed: int, seconds: float,
             trace: bool, device, bench=None) -> dict:
    """Set-up, window, check and readings of one run: the result line's
    dict."""
    import torch

    mode = catalog.mode(cell["mode"])
    mastic = system.instantiate(config)
    data = traffic.generate(cell["generator"], cell["params"], mastic.bits,
                            mastic.RAND_SIZE, mastic.valid.PROOF_LEN, seed)
    on_card = device.type == "cuda"
    tr = devtrace.Trace(trace, on_card)
    state = mode.setup(cell, config, data, device, tr)
    smi_before = nvidia_smi() if on_card else ""
    setup_s = process_age_s()
    result = mode.window(state, seconds, tr)
    if on_card:
        torch.cuda.synchronize(device)
    tr.stop()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    smi_after = nvidia_smi() if on_card else ""
    for key in ("batch", "pool"):
        state.pop(key, None)

    e2e = mode.end_to_end(state, result)
    e2e["setup_s"] = (setup_s, "s")
    checked = mode.check(state, result)
    compared = checked["compared"]
    correct = all(v <= limit for (v, limit) in compared.values())
    if trace:
        ctx = dict(mode.layer_context(state, result), trace=tr)
        wanted = (catalog.metrics_for(bench, "per_layer", name, set(e2e))
                  if bench else [(n, None) for n in catalog.readers()])
        metrics = {}
        for (metric, unit) in wanted:
            value = catalog.reader(metric).read(ctx)
            if value is not None:
                metrics[metric] = {"value": value, "unit": unit}
    else:
        wanted = (catalog.metrics_for(bench, "end_to_end", name, set(e2e))
                  if bench else [(n, u) for (n, (_v, u)) in e2e.items()])
        metrics = {n: {"value": e2e[n][0], "unit": u} for (n, u) in wanted
                   if n in e2e}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak,
           "nvidia_smi": [smi_before, smi_after]}
    line = {"correct": correct, "attempted": checked["attempted"],
            "failed": checked["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s()
        line["breakdown"] = tr.breakdown()
    line["counts"] = dict(mode.counts(state, result),
                          window_s=result["seconds"])
    line["compared"] = {k: {"value": v, "limit": limit}
                        for (k, (v, limit)) in compared.items()}
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    bench = catalog.benchmark()
    cell = catalog.cell(args.workload)
    import torch

    chips = cell.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line = run_cell(args.workload, cell, catalog.config(cell["config"]),
                    args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    for (k, v) in line["compared"].items():
        print(f"{k} {v['value']} <= {v['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
