"""Phases m and n of chip_smoke.py alone, for a short call on the card:
the kernels, the kernel rows at phase n's shapes, phase n (n1
MasticMultihotCountVec, n2 MasticHistogram at 100 000 reports) and
phase m (the north-star tool: chunked, resident and over NCCL at one
rank), each with every launch counter set to 0 just before it.  Then
one resident north-star run at `--bits 256` (`--resident-reports`,
default 32 768) that reads the final width and the device peak beside
the envelope's.  Run from the repository's root:

    python3 artifacts/torch_port_pr11/probe_mn.py [--resident-reports N]
"""
import argparse
import json
import subprocess
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mastic_tpu_torch.ops import kernels  # noqa: E402
from mastic_tpu_torch.tools import northstar  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--resident-reports", type=int, default=8 * cs.R)
    args = parser.parse_args()
    t_start = time.perf_counter()
    kernels.build()
    print("build", round(time.perf_counter() - t_start, 1), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    rows = cs.check_phase_n_shapes(dev, gen)
    print("kernel rows", round(time.perf_counter() - t0, 1), "s", flush=True)
    (results, counts, peaks) = ({}, {}, {})
    for (name, drive) in (
            ("multihot", lambda: cs.multihot_path(dev, 0)),
            ("histogram_100k", lambda: cs.histogram_100k(dev, 0, 0.0))):
        torch.cuda.empty_cache()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        results[name] = drive()
        torch.cuda.synchronize()
        results[name]["path_s"] = time.perf_counter() - t0
        counts[name] = dict(kernels.launches)
        peaks[name] = torch.cuda.max_memory_allocated(dev)
        print(name, round(results[name]["path_s"], 1), "s", flush=True)
    cs._print_phase_n(results, peaks, counts)
    m = cs.northstar_phase(dev, 0.0)
    cs._print_northstar(m)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    (_a, result, _r) = northstar.collect(
        ["--reports", str(args.resident_reports), "--bits", "256",
         "--resident", "--device", "cuda"])
    torch.cuda.synchronize()
    line = result["line"]
    peak = torch.cuda.max_memory_allocated(dev)
    env = line["envelope"]
    print(f"resident north star at {args.resident_reports} x 256: ok "
          f"{line['ok']}, width {env['width']}, device peak {peak} B "
          f"against the envelope's {env['device_peak_bytes_per_chunk']} B "
          f"(ratio {peak / env['device_peak_bytes_per_chunk']:.4f}); "
          f"shard {line['shard_seconds']} s, rounds {line['wall_seconds']} "
          f"s; call {time.perf_counter() - t0:.1f} s; launches "
          + json.dumps(kernels.launches))
    print(json.dumps(line))
    print(json.dumps({"kernels": rows}))
    print("probe", round(time.perf_counter() - t_start, 1), "s")


if __name__ == "__main__":
    main()
