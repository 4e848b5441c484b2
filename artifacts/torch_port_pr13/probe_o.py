"""Phase o of `chip_smoke.py` (the kernel store) alone, then
`python -m mastic_tpu_torch.tools.bake --smoke`, on one card.

    python3 artifacts/torch_port_pr13/probe_o.py [--root DIR]

Prints the card's name and power limit, phase o's lines (the bake, each
serve child's time from its spawn to the end of its first round, the
store child's per-library load and probe times) and the bake smoke's
JSON line, whose `first_round_s` holds the three cold starts: an empty
build root (nvcc inline), the build directory reused, the store with
nvcc hidden.  `--root` takes the package and `chip_smoke.py` from an
unpacked `git archive` (default: this checkout).  Exits non-zero if
either part fails.
"""

import argparse
import pathlib
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=str,
                        default=str(pathlib.Path(__file__).resolve()
                                    .parents[2]))
    args = parser.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("probe_o: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    store = chip_smoke.store_phase(torch.device("cuda", 0))
    chip_smoke._print_store(store)
    print(f"phase o: {store['phase_s']:.1f} s", flush=True)
    proc = subprocess.run(
        [sys.executable, "-m", "mastic_tpu_torch.tools.bake", "--smoke"],
        cwd=root, capture_output=True, text=True, timeout=900)
    print(proc.stderr[-4000:], file=sys.stderr)
    lines = proc.stdout.strip().splitlines()
    print(lines[-1] if lines else "bake --smoke printed nothing", flush=True)
    print(f"probe_o: {time.perf_counter() - t0:.1f} s in all")
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
