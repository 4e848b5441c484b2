"""The service's drills, the WAL bench and the meshed serve tool on one
card, each as its own command, in turn:

    python3 artifacts/torch_port_pr14/tools_card.py [--only NAME,...]
        [--out-dir DIR]

Prints the card's name and power limit, then for each command its name,
exit code, wall seconds and last output line (its JSON line); the whole
output of each goes to DIR/NAME.out and NAME.err (default
build/tools_card).  Exits non-zero if any command did.  The commands (all on the card):

  overlap_drill  tools.serve --overlap-drill
  chaos_drill    tools.serve --chaos-drill 7 --chaos-seeds 3
  wal_drill      tools.serve --wal-drill 7 --wal-seeds 3
  wal_bench      tools.loadgen --wal-bench (20 000 reports, 32 workers)
  mesh2_smoke    tools.serve --mesh 2 --backend gloo --smoke
  mesh1_nccl     tools.serve --mesh 1 --backend nccl (the default scenario)
"""

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
SERVE = [sys.executable, "-m", "mastic_tpu_torch.tools.serve"]
COMMANDS = {
    "overlap_drill": SERVE + ["--overlap-drill"],
    "chaos_drill": SERVE + ["--chaos-drill", "7", "--chaos-seeds", "3"],
    "wal_drill": SERVE + ["--wal-drill", "7", "--wal-seeds", "3"],
    "wal_bench": [sys.executable, "-m", "mastic_tpu_torch.tools.loadgen",
                  "--wal-bench"],
    "mesh2_smoke": SERVE + ["--mesh", "2", "--backend", "gloo", "--smoke",
                            "--status-port", "0"],
    "mesh1_nccl": SERVE + ["--mesh", "1", "--backend", "nccl"],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", type=str, default=",".join(COMMANDS))
    parser.add_argument("--out-dir", type=str,
                        default=str(ROOT / "build" / "tools_card"))
    args = parser.parse_args()
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    failed = 0
    for name in args.only.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(COMMANDS[name], cwd=ROOT, capture_output=True,
                              text=True, timeout=1500)
        wall = time.perf_counter() - t0
        (out_dir / f"{name}.out").write_text(proc.stdout)
        (out_dir / f"{name}.err").write_text(proc.stderr)
        lines = proc.stdout.strip().splitlines()
        print(f"{name}: rc {proc.returncode}, {wall:.1f} s: "
              f"{lines[-1] if lines else proc.stderr[-1500:]}", flush=True)
        failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
