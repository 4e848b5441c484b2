"""The north-star tool on the card at the sizes that fit it, one run
after another in this process (`tools.northstar.collect`, the code path
of `python -m mastic_tpu_torch.tools.northstar`).  For each run it
records the tool's JSON line, the device peak
(`torch.cuda.max_memory_allocated`) beside the envelope's, the host's
smallest MemAvailable while the run held its memory (sampled every
0.5 s), the call's wall time, and the card's name and power limit
(nvidia-smi), into `chiprun_out/northstar_pr11/<name>.json`, and prints
a summary line per run.  Run from the repository's root:

    python3 artifacts/torch_port_pr11/northstar_card.py \\
        resident:auto chunked:32768 chunked:131072

`resident:auto` takes the largest multiple of 4096 reports whose
resident envelope at width 8 (`memory_envelope(bm, R, 8, R)`, the
tool's final width with three planted paths) fits the card's budget,
times `--resident-share`; `resident:N` and `chunked:N` take N reports.
Every run is MasticCount(256), the tool's default recipe (three planted
paths, threshold 0.1 R), chunks of 4096 in chunked mode.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import threading
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

from mastic_tpu_torch.backend.mastic import (BatchedMastic,  # noqa: E402
                                             MasticCount)
from mastic_tpu_torch.drivers.chunked import memory_envelope  # noqa: E402
from mastic_tpu_torch.ops import kernels  # noqa: E402
from mastic_tpu_torch.tools import northstar  # noqa: E402

OUT = pathlib.Path("chiprun_out") / "northstar_pr11"
BITS = 256
CHUNK = 4096
WIDTH = 8


def mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def resident_reports(dev: torch.device, share: float) -> tuple:
    """The largest R (a multiple of 4096) whose resident envelope at
    WIDTH fits the device budget, scaled by `share`; and the envelope's
    per-report bytes."""
    bm = BatchedMastic(MasticCount(BITS))
    one = memory_envelope(bm, 1, WIDTH, 1, dev)
    per = one["device_peak_bytes_per_chunk"]
    budget = one["device_budget_bytes"]
    r = int(budget * share) // per // CHUNK * CHUNK
    return (r, per, budget)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("runs", nargs="+")
    parser.add_argument("--resident-share", type=float, default=1.0)
    args = parser.parse_args()
    kernels.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    for spec in args.runs:
        (mode, size) = spec.split(":")
        why = f"given ({size})"
        if size == "auto":
            (reports, per, budget) = resident_reports(dev,
                                                      args.resident_share)
            why = (f"the largest multiple of {CHUNK} whose resident envelope "
                   f"at width {WIDTH} ({per} B a report) fits "
                   f"{args.resident_share} x the device budget {budget} B")
        else:
            reports = int(size)
        argv = ["--reports", str(reports), "--bits", str(BITS),
                "--chunk-size", str(CHUNK), "--device", "cuda"]
        if mode == "resident":
            argv.append("--resident")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        low = [mem_available()]
        done = threading.Event()

        def sample():
            while not done.wait(0.5):
                low[0] = min(low[0], mem_available())

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()
        t0 = time.perf_counter()
        before = mem_available()
        try:
            (_a, result, _r) = northstar.collect(argv)
            torch.cuda.synchronize()
        finally:
            done.set()
            sampler.join()
        wall = time.perf_counter() - t0
        line = result["line"]
        env = line["envelope"]
        bound = env["device_peak_bytes_per_chunk" if mode == "resident"
                    else "device_peak_bytes_per_chunk_pipelined"]
        peak = torch.cuda.max_memory_allocated(dev)
        record = {"name": f"{mode}_{reports}", "card": card,
                  "argv": argv, "why": why, "line": line,
                  "device_peak_bytes": peak,
                  "envelope_peak_bytes": bound,
                  "peak_over_envelope": peak / bound,
                  "host_mem_available_before": before,
                  "host_mem_available_low": low[0],
                  "call_seconds": wall,
                  "launches": dict(kernels.launches),
                  "oracle_paths": len(result["heavy_hitters"])}
        (OUT / f"{record['name']}.json").write_text(
            json.dumps(record, indent=1) + "\n")
        print(f"{record['name']}: ok {line['ok']}, R {reports} ({why}), "
              f"{line['levels']} levels, width {env['width']}, shard "
              f"{line['shard_seconds']} s, rounds {line['wall_seconds']} s, "
              f"{line['node_evals_per_sec']} node evals/s (p50 a chunk "
              f"{line['per_chunk_evals_per_sec_p50']}), device peak {peak} B "
              f"against the envelope's {bound} B "
              f"({peak / bound:.4f}), host MemAvailable {before} -> low "
              f"{low[0]} B; call {wall:.1f} s; launches "
              + json.dumps(record["launches"]), flush=True)
        if not line["ok"]:
            raise SystemExit(f"{record['name']}: ok is false")
        del result
    print("done", flush=True)


if __name__ == "__main__":
    main()
