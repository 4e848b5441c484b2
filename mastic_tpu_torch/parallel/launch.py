"""Start ranks for a report mesh: `spawn(fn, world, backend, device,
*args)` runs `fn(mesh, *args)` in `world` processes (the spawn start
method) and returns each rank's result and kernel launches, in rank
order.

The ranks meet through a `file://` store in a temporary directory (no
TCP port, so concurrent groups cannot collide), and
`init_process_group(timeout=...)` bounds a rank left waiting in a
collective by a rank that failed.  A rank that raises fails the whole
call: the parent stops every rank and raises with the rank's traceback;
a rank that exits with no result (a fault injector's kill) raises
`RankExit` with its exit code.  Nothing falls back to another backend.

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
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# How long a rank may wait in a collective, and the parent for a rank.
DEFAULT_TIMEOUT_S = 600
# How long the other ranks get to report theirs once a rank has failed.
FAILURE_SETTLE_S = 10.0


def rank_device(device, rank: int) -> torch.device:
    """A rank's compute device: "cuda" means card rank mod the card
    count (ranks share a card when there are more ranks than cards),
    anything else is taken as it is."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class RankExit(RuntimeError):
    """A rank exited with `exitcode` and gave no result."""

    def __init__(self, rank: int, exitcode: int):
        super().__init__(f"rank {rank} exited with code {exitcode} and no "
                         f"result")
        self.rank = rank
        self.exitcode = exitcode


def _rank_main(rank: int, world: int, backend: str, device, store: str,
               timeout_s: float, fn, args: tuple, results) -> None:
    """One rank: its thread share, its device, the process group, then
    `fn(mesh, *args)`; the result (or the traceback) goes to the
    parent."""
    from ..ops import kernels
    from .mesh import make_mesh

    joined = False
    try:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                timeout=timedelta(seconds=timeout_s))
        joined = True
        mesh = make_mesh(world, device=dev)
        kernels.reset_launches()
        value = fn(mesh, *args)
        results.put((rank, True, (value, dict(kernels.launches))))
    except BaseException:
        # Sent before the group closes: the other ranks fail at their
        # next collective, and this is why.
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if joined:
            dist.destroy_process_group()


def spawn(fn, world: int, backend: str, device, *args,
          timeout_s: float = DEFAULT_TIMEOUT_S,
          wall_s: Optional[float] = None) -> list:
    """Run `fn(mesh, *args)` on `world` ranks over `backend` ("gloo" or
    "nccl"), each on `rank_device(device, rank)`.  Returns [(result,
    ops.kernels.launches of the rank)] in rank order; raises if a rank
    raises or dies, waits in a collective longer than `timeout_s`, or
    the ranks outlast `wall_s` (default `timeout_s`) in all.  After a
    rank's failure the others get FAILURE_SETTLE_S to report theirs
    (one rank's error fails the others' next collective), and every
    failing rank's traceback is raised, in rank order; a rank that died
    with no result is the cause (`RankExit`)."""
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
        deadline = time.monotonic() + (timeout_s if wall_s is None
                                       else wall_s)
        failed: dict = {}
        settle = None
        try:
            # Drain the queue before joining: a rank's result can be
            # larger than the pipe holds.
            while len(got) + len(failed) < world:
                try:
                    (rank, ok, payload) = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for (r, p) in enumerate(procs)
                            if r not in got and r not in failed
                            and p.exitcode not in (None, 0)]
                    if dead:
                        raise RankExit(dead[0], procs[dead[0]].exitcode)
                    now = time.monotonic()
                    if settle is not None and now > settle:
                        break
                    if now > deadline:
                        missing = sorted(set(range(world)) - set(got))
                        raise TimeoutError(f"ranks {missing} gave no "
                                           f"result in time")
                    continue
                if ok:
                    got[rank] = payload
                    continue
                failed[rank] = payload
                if settle is None:
                    settle = time.monotonic() + FAILURE_SETTLE_S
            if failed:
                raise RuntimeError("\n".join(
                    f"rank {rank} of {world} failed:\n{payload}"
                    for (rank, payload) in sorted(failed.items())))
            for proc in procs:
                proc.join(timeout=60)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(timeout=10)
    return [got[rank] for rank in range(world)]
