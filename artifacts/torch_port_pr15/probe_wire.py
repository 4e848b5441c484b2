"""The node axis's exchange through host memory, alone: two gloo ranks
sharing one card swap a buffer of `--gb` GB (phase q1's attribute prep
sends ~1.4 GB each way) as `parallel/grid.py` does, staged through
pageable host memory (`tensor.cpu()`, then `.to(card)`) or through
pinned host memory (copies into a pinned buffer, non-blocking), in
turns (pageable, pinned, pinned, pageable, ...):

    python3 artifacts/torch_port_pr15/probe_wire.py [--gb 1.4] [--reps 3]

Prints, per rank and run, the host clock of the copy to host memory,
the `all_to_all_single`, and the copy back, each ended by a synchronize,
and the card's name and power limit.  Exits non-zero if a received
buffer differs from what its peer sent.
"""

import argparse
import pathlib
import subprocess
import sys
import time


def rank_main(mesh, nbytes: int, reps: int) -> list:
    import torch
    import torch.distributed as dist

    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    send = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev,
                         generator=gen)
    peer = torch.Generator(device=dev).manual_seed(1 - mesh.rank)
    want = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev,
                         generator=peer)
    splits_in = [0, nbytes] if mesh.rank == 0 else [nbytes, 0]
    out = []
    for i in range(2 * reps):
        pinned = i % 4 in (1, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if pinned:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            host.copy_(send, non_blocking=True)
            torch.cuda.synchronize()
            recv = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        else:
            host = send.cpu()
            recv = torch.empty(nbytes, dtype=torch.uint8)
        t1 = time.perf_counter()
        dist.all_to_all_single(recv, host, splits_in, splits_in)
        t2 = time.perf_counter()
        back = recv.to(dev, non_blocking=pinned)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if not torch.equal(back, want):
            raise AssertionError("the received buffer differs")
        out.append({"pinned": pinned, "to_host_ms": (t1 - t0) * 1e3,
                    "collective_ms": (t2 - t1) * 1e3,
                    "to_card_ms": (t3 - t2) * 1e3})
        del host, recv, back
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gb", type=float, default=1.4)
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import torch

    from mastic_tpu_torch.parallel import spawn

    if not torch.cuda.is_available():
        print("probe_wire: no CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    got = spawn(rank_main, 2, "gloo", "cuda", int(args.gb * 1e9), args.reps)
    for (rank, (runs, _launches)) in enumerate(got):
        for r in runs:
            print(f"rank {rank} {'pinned' if r['pinned'] else 'pageable'}: "
                  f"to host {r['to_host_ms']:.1f} ms, all_to_all_single "
                  f"{r['collective_ms']:.1f} ms, to the card "
                  f"{r['to_card_ms']:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
