"""Start ranks for a report mesh: `spawn(fn, world, backend, device,
*args)` runs `fn(mesh, *args)` in `world` processes (the spawn start
method) and returns each rank's result and kernel launches, in rank
order.

The ranks meet through a `file://` store in a temporary directory (no
TCP port, so concurrent groups cannot collide), and
`init_process_group(timeout=...)` bounds a rank left waiting in a
collective by a rank that failed.  A rank that raises fails the whole
call: the parent stops every rank and raises with the rank's traceback.
Nothing falls back to another backend.

`fn` and everything in `args` are pickled: `fn` must be importable by
name from a module that does not import jax (a spawned child imports
the target's module), which is why the rank programs of the tests, the
multichip tool and the card's smoke live in `parallel/jobs.py` or in
the script that spawns them.
"""

import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# How long a rank may wait in a collective, and the parent for a rank.
DEFAULT_TIMEOUT_S = 600


def rank_device(device, rank: int) -> torch.device:
    """A rank's compute device: "cuda" means card rank mod the card
    count (ranks share a card when there are more ranks than cards),
    anything else is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def _rank_main(rank: int, world: int, backend: str, device, store: str,
               timeout_s: float, fn, args: tuple, results) -> None:
    """One rank: its thread share, its device, the process group, then
    `fn(mesh, *args)`; the result (or the traceback) goes to the
    parent."""
    from ..ops import kernels
    from .mesh import make_mesh

    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        try:
            mesh = make_mesh(world, device=dev)
            kernels.reset_launches()
            value = fn(mesh, *args)
            results.put((rank, True, (value, dict(kernels.launches))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, backend: str, device, *args,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run `fn(mesh, *args)` on `world` ranks over `backend` ("gloo" or
    "nccl"), each on `rank_device(device, rank)`.  Returns [(result,
    ops.kernels.launches of the rank)] in rank order; raises if a rank
    raises, dies or outlasts `timeout_s`."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: 'gloo' or 'nccl'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: dict = {}
    with tempfile.TemporaryDirectory(prefix="mastic_mesh_") as tmp:
        store = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world, backend, device, store,
                                   timeout_s, fn, args, results))
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout_s
        try:
            # Drain the queue before joining: a rank's result can be
            # larger than the pipe holds.
            while len(got) < world:
                try:
                    (rank, ok, payload) = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for (r, p) in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    if time.monotonic() > deadline:
                        missing = sorted(set(range(world)) - set(got))
                        raise TimeoutError(f"ranks {missing} gave no "
                                           f"result in {timeout_s} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                got[rank] = payload
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
    return [got[rank] for rank in range(world)]
