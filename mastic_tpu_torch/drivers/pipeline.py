"""The chunk-streaming executor (port of `mastic_tpu/drivers/pipeline.py`,
the `MASTIC_PIPELINE` lever).

The chunked runners (`drivers/chunked.py`, and the attribute round's
`chunk_size`) stream fixed-size report chunks through one round.  Run
serially, each chunk pays upload -> compute -> download -> host fold
with the card idle during the host's part and the host idle during the
card's.  `run_chunks` keeps two chunks in flight instead: chunk i+1 is
staged (its uploads and its round dispatched) before chunk i is
collected (its one blocking wait, its downloads read, its results
folded on the host).

On the card, staging means: the uploads are `non_blocking` copies
from pinned host memory on a copy stream of their own; the compute
stream waits on a `torch.cuda.Event` recorded after them; the
downloads go into pinned host buffers on a download stream that waits
on the compute; and `collect` makes the chunk's one blocking wait, an
`Event.synchronize()` after the downloads.  On the CPU the same loop
runs with no streams.  Each chunk's phases (host milliseconds of
upload, dispatch, wait, download, host fold) land in a timeline, so
the overlap is a measured number (`overlap_efficiency`), not a claim.
`ChunkedRound` is the skeleton both chunked rounds run on: the
transfers, the collect's one wait, the exchange of each chunk's
aggregate shares and masks over a report mesh (`parallel/mesh.py`; the
identity without one, so that there is one code path), the fold of the
summed shares, the timeline and the `pipeline` and `mesh` metrics
blocks.  Under a mesh every rank runs the same chunks over its own rows
of each, and the round's mode is agreed over the ranks.

The JAX module's `paused_gc` (a workaround for a garbage collection
during JAX tracing), `ProgramCache` and `to_struct` (compiled-program
caching and its lowering signatures) and `plan_shape_key` /
`predicted_next_plans` (warming the programs of the predicted next
round) have no counterpart: the port runs eagerly and traces no
program.
"""

import os
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch

from ..obs import trace as obs_trace


class CopyStreams:
    """The streams of a chunked round on the card: the compute stream
    (the current stream when the round starts, where the kernels
    launch), an upload stream and a download stream.  On the CPU there
    are none, and every copy is the tensor itself."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.compute = torch.cuda.current_stream(device)
            self.up = torch.cuda.Stream(device)
            self.down = torch.cuda.Stream(device)


class ChunkTransfer:
    """One chunk's trip through the card.  `upload()` brackets the
    chunk's host-to-device copies (made `non_blocking` from pinned
    memory, on the upload stream); the compute stream waits for them.
    `download(pairs)` records the end of the chunk's compute and copies
    each device tensor into its pinned host buffer on the download
    stream.  `wait()` is the chunk's one blocking wait; only after it
    may the host read those buffers or drop the chunk's device tensors
    (the caller keeps them referenced until then, so the caching
    allocator cannot hand their memory to another stream early)."""

    def __init__(self, streams: CopyStreams):
        self.s = streams
        self.events: dict = {}

    def _mark(self, name: str, stream) -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        self.events[name] = ev
        return ev

    @contextmanager
    def upload(self):
        if not self.s.on_card:
            yield
            return
        with torch.cuda.stream(self.s.up):
            self._mark("up0", self.s.up)
            yield
            uploaded = self._mark("up1", self.s.up)
        self.s.compute.wait_event(uploaded)
        self._mark("compute0", self.s.compute)

    def to_device(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A host tensor on the card (inside `upload()`), or itself on
        the CPU."""
        if t is None or not self.s.on_card:
            return t
        return t.to(self.s.device, non_blocking=True)

    def download(self, pairs: list) -> list:
        """(host buffer or None, device tensor) pairs -> the host
        tensors: a None buffer gets a new pinned one.  On the CPU the
        device tensor is copied into its buffer, or is itself the
        host tensor."""
        if not self.s.on_card:
            out = []
            for (dst, src) in pairs:
                if dst is not None and dst.data_ptr() != src.data_ptr():
                    dst.copy_(src)
                    src = dst
                out.append(src)
            return out
        computed = self._mark("compute1", self.s.compute)
        self.s.down.wait_event(computed)
        out = []
        with torch.cuda.stream(self.s.down):
            self._mark("down0", self.s.down)
            for (dst, src) in pairs:
                if dst is None:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                dst.copy_(src, non_blocking=True)
                out.append(dst)
            self._mark("down1", self.s.down)
        return out

    def wait(self) -> None:
        if self.s.on_card:
            self.events["down1"].synchronize()

    def device_ms(self) -> Optional[dict]:
        """After `wait()`, the card's own times of the chunk's uploads,
        compute and downloads, each from the moment its stream reached
        it, in ms; None on the CPU."""
        if not self.s.on_card:
            return None
        ev = self.events
        return {"upload_ms": ev["up0"].elapsed_time(ev["up1"]),
                "compute_ms": ev["compute0"].elapsed_time(ev["compute1"]),
                "download_ms": ev["down0"].elapsed_time(ev["down1"])}


def pipeline_enabled() -> bool:
    """The `MASTIC_PIPELINE` lever, read each round (not at import), so
    a long-lived process can be steered without a restart.  Default on:
    the pipelined path gives the serial path's results bit for bit."""
    return os.environ.get("MASTIC_PIPELINE", "1").lower() \
        not in ("0", "off", "false", "")


def run_chunks(num_chunks: int, stage: Callable, collect: Callable,
               pipelined: bool) -> tuple:
    """Drive `stage` / `collect` over `num_chunks` chunks.

    `stage(i) -> (handle, phases)` uploads chunk i's inputs and
    dispatches its device work without waiting for it; `collect(i,
    handle) -> phases` makes the chunk's one blocking wait, reads its
    downloads and folds them into host state.  `phases` are dicts of
    phase name -> ms.

    Pipelined, chunk i+1 is staged before chunk i is collected; serial,
    each chunk is collected before the next is staged.  (The JAX
    function's `before_last_collect` hook, where it warms the next
    round's programs, has no use here.)

    Each stage and collect is a span, `chunk.stage` and
    `chunk.collect` with the chunk's index, under the caller's
    current span (a round's).

    Returns (timeline, wall_ms): per chunk a record with the stage and
    collect timestamps (ms since the loop started), the merged phases
    and its host_syncs, and the loop's wall time."""
    timeline: list = [None] * num_chunks
    t0 = time.perf_counter()
    tracer = obs_trace.get_tracer()

    def now_ms() -> float:
        return (time.perf_counter() - t0) * 1e3

    def do_stage(i: int):
        start = now_ms()
        with tracer.span("chunk.stage", chunk=i):
            (handle, phases) = stage(i)
        timeline[i] = {
            "chunk": i,
            "stage_start_ms": round(start, 3),
            "stage_end_ms": round(now_ms(), 3),
            "phases": dict(phases),
            "host_syncs": 0,
        }
        return handle

    def do_collect(i: int, handle) -> None:
        rec = timeline[i]
        rec["collect_start_ms"] = round(now_ms(), 3)
        with tracer.span("chunk.collect", chunk=i):
            rec["phases"].update(collect(i, handle))
        rec["collect_end_ms"] = round(now_ms(), 3)
        # collect() waits exactly once (the chunk's download event).
        rec["host_syncs"] = 1

    if pipelined and num_chunks > 1:
        in_flight = do_stage(0)
        for i in range(num_chunks):
            staged_next = (do_stage(i + 1) if i + 1 < num_chunks
                           else None)
            do_collect(i, in_flight)
            in_flight = staged_next
    else:
        for i in range(num_chunks):
            do_collect(i, do_stage(i))
    return (timeline, now_ms())


def overlap_efficiency(timeline: Sequence[dict], wall_ms: float) -> float:
    """The share of the chunks' summed phase time hidden by overlap:
    1 - wall / sum(phases).  0.0 when nothing overlapped (serial, or a
    single chunk)."""
    busy = sum(sum(rec["phases"].values()) for rec in timeline)
    if wall_ms <= 0.0 or busy <= wall_ms:
        return 0.0
    return round(1.0 - wall_ms / busy, 4)


def pipeline_mode(num_chunks: int) -> tuple:
    """(mode, fallback reason) of a chunked round, by the lever and the
    chunk count: ("pipelined", None), or ("serial", "lever-off" |
    "single-chunk").  The incremental runner degrades further, to
    "device-budget", when two chunks in flight would not fit."""
    if not pipeline_enabled():
        return ("serial", "lever-off")
    if num_chunks < 2:
        return ("serial", "single-chunk")
    return ("pipelined", None)


class ChunkedRound:
    """What the two chunked rounds (the incremental runner's and the
    attribute round's) share: a `ChunkTransfer` per chunk, the collect
    that waits once before the host reads the chunk's downloads, the
    mesh's exchange of the chunk's aggregate shares and verdict masks
    (`parallel.mesh.gather_round`; with no mesh, the downloads as they
    are), the fold of the summed shares mod p, the timeline records and
    the `pipeline` (and under a mesh the `mesh`) metrics block.
    `bounds` holds each chunk's (lo, hi) report range; `rows` is the
    length of an aggregate share, `spec` its field.  The mode is agreed
    over the ranks: if any rank would run serially, all do, for the
    reason of the highest code in `MODES`."""

    # (mode, fallback reason) in the order the ranks agree on: the
    # largest index any rank reads wins.
    MODES = (("pipelined", None), ("serial", "single-chunk"),
             ("serial", "lever-off"), ("serial", "device-budget"))

    def __init__(self, streams: CopyStreams, bounds: Sequence[tuple],
                 mode: str, fallback: Optional[str], rows: int, spec,
                 mesh=None):
        from ..parallel.mesh import agree_max

        self.streams = streams
        self.bounds = list(bounds)
        (code,) = agree_max(mesh, [self.MODES.index((mode, fallback))])
        (self.mode, self.fallback) = self.MODES[code]
        self.spec = spec
        self.mesh = mesh
        self.agg_shares = [[0] * rows for _ in range(2)]
        self.xfers: dict = {}
        self.timeline: list = []
        self.wall_ms = 0.0
        self.skews: dict = {}
        self.share_bytes = 0

    def transfer(self, i: int) -> ChunkTransfer:
        """Chunk i's transfer, kept for its device times."""
        self.xfers[i] = ChunkTransfer(self.streams)
        return self.xfers[i]

    def collect(self, i: int, handle: dict, fold: Callable) -> dict:
        """The body of a `collect`: chunk i's one blocking wait, then its
        device tensors (`handle["device"]`, referenced until now)
        dropped, the exchange of its downloaded shares (`handle
        ["shares"]`, (2, rows, n) limbs) and masks (`handle["masks"]`,
        (tile rows, k) bool) over the mesh, the summed shares folded,
        and the chunk's masks over its live reports (numpy (hi - lo, k))
        handed to `fold`.  Returns the chunk's phases: the JAX package's
        (`download_ms` is the wait-to-host interval) and `gather_ms`,
        the exchange (no mesh: next to nothing).  The wait is the span
        `collect.wait`."""
        from ..parallel.mesh import gather_round

        t0 = time.perf_counter()
        with obs_trace.get_tracer().span("collect.wait", chunk=i):
            self.xfers[i].wait()
        t_wait = time.perf_counter()
        del handle["device"]
        (shares, masks) = (handle["shares"].cpu(), handle["masks"].cpu())
        t_down = time.perf_counter()
        (lo, hi) = self.bounds[i]
        g = gather_round(self.mesh, self.spec, shares, masks, hi - lo)
        t_gather = time.perf_counter()
        self.skews[i] = g.skew_ms
        self.share_bytes += g.share_bytes
        self.fold_shares([[self.spec.limbs_to_int(row) for row in share]
                          for share in g.shares.numpy()])
        fold(g.masks.numpy())
        return {"compute_wait_ms": (t_wait - t0) * 1e3,
                "download_ms": (t_down - t_wait) * 1e3,
                "gather_ms": (t_gather - t_down) * 1e3,
                "host_ms": (time.perf_counter() - t_gather) * 1e3}

    def fold_shares(self, shares: Sequence[list]) -> None:
        """Add one chunk's aggregate shares (a list of field elements
        per aggregator) into the round's, mod p."""
        p = self.spec.modulus
        self.agg_shares = [[(x + y) % p for (x, y) in zip(total, share)]
                           for (total, share) in zip(self.agg_shares,
                                                     shares)]

    def run(self, stage: Callable, collect: Callable) -> list:
        """`run_chunks` over every chunk in this round's mode; each
        timeline record gains its report count, its wall time and, on
        the card, its streams' own times (`device_ms`)."""
        (timeline, wall_ms) = run_chunks(len(self.bounds), stage, collect,
                                         pipelined=self.mode == "pipelined")
        for rec in timeline:
            (lo, hi) = self.bounds[rec["chunk"]]
            rec["reports"] = hi - lo
            rec["wall_ms"] = round(
                max(rec["collect_end_ms"] - rec["stage_start_ms"], 0.0), 2)
            device_ms = self.xfers[rec["chunk"]].device_ms()
            if device_ms is not None:
                rec["device_ms"] = device_ms
            if self.mesh is not None:
                rec["shard_wait_skew_ms"] = self.skews[rec["chunk"]]
        (self.timeline, self.wall_ms) = (timeline, wall_ms)
        return timeline

    def pipeline_block(self) -> dict:
        """The round's `extra["pipeline"]`, with the JAX package's keys
        (minus `aot`), after `run`."""
        on_card = [rec["device_ms"] for rec in self.timeline
                   if "device_ms" in rec]
        return {
            "mode": self.mode,
            "fallback": self.fallback,
            "round_wall_ms": round(self.wall_ms, 2),
            "overlap_efficiency": overlap_efficiency(self.timeline,
                                                     self.wall_ms),
            # The port compiles and warms no program: kept at zero so
            # that the block has the JAX package's keys.
            "compile_inline_ms": 0.0,
            "warm_ms": 0.0,
            "host_syncs": sum(rec["host_syncs"] for rec in self.timeline),
            # The card's own copy and compute times, summed over the
            # chunks, and the share of them hidden by running the three
            # streams at once (None on the CPU).  The host's phases run
            # one after another, so overlap_efficiency stays near 0.
            "device_ms": ({k: sum(d[k] for d in on_card)
                           for k in on_card[0]} if on_card else None),
            "device_overlap_efficiency": (
                overlap_efficiency([{"phases": d} for d in on_card],
                                   self.wall_ms) if on_card else None),
        }

    def mesh_block(self, device_rows: int) -> dict:
        """The round's `extra["mesh"]` (JAX keys), after `run`: chunks
        of `device_rows` rows (padded to the shard multiple) split over
        the ranks, the bytes of the shares every rank received, and the
        spread of the ranks' arrival at each chunk's exchange."""
        from ..parallel.mesh import mesh_block

        return mesh_block(self.mesh, device_rows, self.share_bytes,
                          list(self.skews.values()))
