"""Phase q of `chip_smoke.py` (the node axis) alone, on one card:

    python3 artifacts/torch_port_pr15/probe_q.py [--root DIR] [--cut]

Builds the kernels, checks them at phase q's shapes
(`check_node_shapes`), runs phase e (the attribute round on one rank:
phase q's reference), then phase j's two gloo ranks without the NCCL
rank (q1 runs inside them) and q2's four, and prints the card's name
and power limit, the kernel rows and phase q's lines.  `--cut` runs q1's
Count run and q2 at NODES_CUT_R reports, as the smoke does when it is
late; `--root` takes the package and `chip_smoke.py` from an unpacked
`git archive` (default: this checkout).  Exits non-zero if any part
fails.
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
    parser.add_argument("--cut", action="store_true")
    args = parser.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from mastic_tpu_torch.ops import kernels
    from mastic_tpu_torch.parallel import spawn

    if not torch.cuda.is_available():
        print("probe_q: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t_start = time.perf_counter()
    kernels.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = cs.check_node_shapes(dev, gen, 0)
    print(json.dumps({"kernels": rows}), flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    phase_e = cs.attributes_path(dev, 0)
    peak_e = torch.cuda.max_memory_allocated(dev)
    phase_e.pop("handoff")
    phase_e.pop("service")
    torch.cuda.empty_cache()
    print(f"phase e: round {phase_e['round_s']:.3f} s, peak {peak_e} B; "
          f"{time.perf_counter() - t_start:.1f} s so far", flush=True)
    nodes_r = (cs.NODES_CUT_R if args.cut else cs.MESH_R,
               cs.NODES_CUT_R if args.cut else cs.ATTR_R)
    t0 = time.perf_counter()
    gloo = spawn(cs.mesh_gloo_rank, cs.MESH_RANKS, "gloo", "cuda", 0,
                 cs.MESH_LEVELS, nodes_r[0])
    gloo_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q2 = spawn(cs.nodes_q2_rank, cs.NODES_Q2_RANKS, "gloo", "cuda", 0,
               nodes_r[1])
    mesh = {"gloo": [r[0] for r in gloo], "q2": [r[0] for r in q2],
            "q2_s": time.perf_counter() - t0, "nodes_cut": args.cut}
    for (rank, r) in enumerate(mesh["gloo"]):
        print(f"phase j rank {rank}: resident {r['resident']['levels']} "
              f"levels, rounds {r['resident']['rounds_s']:.3f} s; "
              f"attributes round {r['attributes']['round_s']:.3f} s; "
              f"phase j and q1 {gloo_s:.1f} s")
    cs._print_nodes(mesh, phase_e, peak_e)
    print(f"probe_q: {time.perf_counter() - t_start:.1f} s in all")
    return 0


if __name__ == "__main__":
    sys.exit(main())
