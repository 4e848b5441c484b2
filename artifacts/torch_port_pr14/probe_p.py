"""Phase p of `chip_smoke.py` (the collector service under a report
mesh) alone, on one card:

    python3 artifacts/torch_port_pr14/probe_p.py [--root DIR] [--no-cut]

Builds the kernels, runs phase a (the Count path: p1 holds its levels
against it) and one `tools.serve` child of the default scenario (p2
holds `--mesh 1 --backend nccl`'s results against it, as the smoke holds
them against phase o's child), then phase p, and prints the card's name
and power limit and phase p's lines.  `--no-cut` runs p1 through all
256 levels (the smoke cuts it at 64); `--root` takes the package and
`chip_smoke.py` from an unpacked `git archive` (default: this
checkout).  Exits non-zero if any part fails.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=str,
                        default=str(pathlib.Path(__file__).resolve()
                                    .parents[2]))
    parser.add_argument("--no-cut", action="store_true")
    args = parser.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from mastic_tpu_torch.ops import kernels

    if not torch.cuda.is_available():
        print("probe_p: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t_start = time.perf_counter()
    kernels.build()
    dev = torch.device("cuda", 0)
    results = {"count": chip_smoke.main_path(dev, 0, chip_smoke.BITS)}
    print(f"phase a: {time.perf_counter() - t_start:.1f} s", flush=True)
    proc = subprocess.run(
        [sys.executable, "-m", "mastic_tpu_torch.tools.serve", "--device",
         "cuda"], cwd=root, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stderr[-3000:], file=sys.stderr)
        return 1
    serve_results = json.loads(proc.stdout.strip().splitlines()[-1])[
        "results"]
    elapsed = 0.0 if args.no_cut else chip_smoke.MESH_SERVICE_CUT_AFTER_S
    p = chip_smoke.mesh_service_phase(results, serve_results, elapsed)
    chip_smoke._print_mesh_service(p)
    print(f"probe_p: {time.perf_counter() - t_start:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
