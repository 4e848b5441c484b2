"""Report sharding over `torch.distributed` (port of
`mastic_tpu/parallel/mesh.py`).

The JAX mesh is single-controller: one process drives every device, and
GSPMD turns the masked sum over the report-sharded axis into a psum.
Here each rank is one process with one device, and every rank runs the
same program on its own rows.  Every rank is handed the same arguments
as the JAX call (the global reports, batch or store) and keeps only its
rows on its device: with n report ranks a tile of R rows splits into
the contiguous blocks [c R/n, (c+1) R/n), in report-rank order.  The
only cross-rank traffic is the round's aggregate shares, its
report-axis verdict masks, and a checkpoint's carries, gathered when
one is taken.

The mesh is ("reports", "nodes"), laid out as the JAX package lays its
devices out (`devices.reshape(world // nodes, nodes)`): rank r sits at
report coordinate r // nodes and node coordinate r % nodes.  Everything
on the report axis (`rows`, `bounds`, `place_reports`, `gather_rows`,
`sum_shares`, `gather_round`) works on the report coordinate and over
the report group (the ranks of one node coordinate), so that, as with
JAX's P("reports") replicated over "nodes", the node ranks of one
report block repeat its work.  The node axis is used only where
`install_grid_sharding` (`parallel/grid.py`) splits the from-root
rounds' trees over it.

Field sums cross ranks by gather, then `ops.field.field_sum` in rank
order (`sum_shares`): the limbs are int32 values below 2^16, so an
`all_reduce(SUM)` over them would leave them unnormalised, and a packed
64-bit sum would wrap mod 2^64, not mod p.  The gathered sum is exact
and the same on every rank, so every control decision the drivers take
from it (pruning, width growth) is taken alike on every rank; the
decisions a rank could read locally (the pipeline lever, the device
budget) are agreed explicitly (`agree_max`, `agree_min`).  A rank that
branched alone would deadlock the next collective.

Collectives run on the group's backend, named by the caller: NCCL takes
CUDA tensors (one card per rank), gloo takes CPU tensors, and under
gloo the shares and masks (kilobytes) are staged through host memory.
The choice is made by the backend's name, never by catching an error.

A decision no rank can take from the round's data (a clock, a failure,
what an HTTP door admitted) is rank 0's: `ReportMesh.broadcast` sends
its value to every rank, and `gather_objects` collects every rank's
(the collector service's scheduler takes both, `drivers/service.py`).

`place_reports` keeps this rank's rows of a batch, a carry or the round
keys; `gather_rows` puts all ranks' rows back together; `gather_round`
is a round's whole exchange.  `sharded_gen`, `sharded_prep` and
`sharded_round` are the JAX package's `sharded_*_fn` over these, and
`shard_incremental_runner` shards a resident runner.

No counterpart: `place_replicated`'s role of pinning the input
placements of AOT-compiled programs (the port compiles none).
`shard_batch` is `place_reports` of one tensor.
"""

import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.field import field_sum


class ReportMesh:
    """The ranks of an initialised process group on a ("reports",
    "nodes") mesh.  `shape` reads as the JAX mesh's: {"reports": world //
    nodes, "nodes": nodes}.  `rank` is the global rank, `report_rank` and
    `node_rank` its coordinates; `report_group` holds the ranks of this
    node coordinate and `node_group` those of this report coordinate
    (None: the whole group, or no other rank).  `device` is this rank's
    compute device; `backend` the group's ("gloo" or "nccl")."""

    def __init__(self, world: int, rank: int, backend: str,
                 device: torch.device, nodes: int = 1,
                 groups: tuple = (None, None)):
        self.shape = {"reports": world // nodes, "nodes": nodes}
        self.world = world
        self.rank = rank
        self.report_rank = rank // nodes
        self.node_rank = rank % nodes
        (self.report_group, self.node_group) = groups
        self.backend = backend
        self.device = device

    def __repr__(self) -> str:
        return (f"ReportMesh(reports={self.shape['reports']}, "
                f"nodes={self.shape['nodes']}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")

    def rows(self, total: int) -> int:
        """Rows of a `total`-row tile on each report rank; `total` must
        divide evenly (a chunked round pads its chunks to the shard
        multiple first)."""
        n = self.shape["reports"]
        if total % n != 0:
            raise ValueError(
                f"report count {total} must be divisible by the mesh's "
                f"reports axis ({n}) to shard evenly")
        return total // n

    def bounds(self, total: int) -> tuple:
        """This rank's rows [lo, hi) of a `total`-row tile."""
        rows = self.rows(total)
        return (self.report_rank * rows, (self.report_rank + 1) * rows)

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the backend's collectives take it: on this rank's
        card for NCCL, in host memory for gloo."""
        if self.backend == "nccl":
            return t.to(self.device)
        return t.cpu()

    def _gather(self, t: torch.Tensor, axis: str) -> list:
        n = self.shape[axis]
        if n == 1:
            return [t.cpu()]
        t = self.wire(t.contiguous())
        out = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(out, t, group=(self.report_group if axis == "reports"
                                       else self.node_group))
        return [x.cpu() for x in out]

    def all_gather(self, t: torch.Tensor) -> list:
        """Every report rank's `t` (equal shapes), in report-rank order,
        in host memory."""
        return self._gather(t, "reports")

    def node_all_gather(self, t: torch.Tensor) -> list:
        """Every node rank's `t` (equal shapes) of this report
        coordinate, in node-rank order, in host memory."""
        return self._gather(t, "nodes")

    def node_all_to_all(self, sends: list, sizes: list) -> list:
        """Bytes between the node ranks of this report coordinate:
        sends[k] (uint8, 1-D) goes to node rank k and sizes[k] bytes come
        from it; the slot of this rank is skipped (its part stays where
        it is).  Returns the received buffers in node-rank order (None
        for this rank's slot), on this rank's card for NCCL, in host
        memory for gloo."""
        me = self.node_rank
        inp = torch.cat([self.wire(t) for (k, t) in enumerate(sends)
                         if k != me])
        splits_in = [0 if k == me else int(t.numel())
                     for (k, t) in enumerate(sends)]
        splits_out = [0 if k == me else n for (k, n) in enumerate(sizes)]
        out = torch.empty(sum(splits_out), dtype=torch.uint8,
                          device=inp.device)
        dist.all_to_all_single(out, inp, splits_out, splits_in,
                               group=self.node_group)
        parts = list(torch.split(out, splits_out))
        parts[me] = None
        return parts

    def broadcast(self, obj):
        """Rank 0's `obj` (any picklable value; the others pass anything)
        on every rank: how rank 0's decisions reach the others."""
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def gather_objects(self, obj) -> list:
        """Every rank's `obj` (picklable), in rank order, on every
        rank."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out


def make_mesh(n_devices: Optional[int] = None, nodes_axis: int = 1,
              device=None) -> ReportMesh:
    """The ("reports", "nodes") mesh over the initialised default
    process group (`parallel.launch.spawn` sets one up), `nodes_axis`
    ranks on the node axis and the rest on reports, laid out as the JAX
    package lays devices out.  `n_devices`, if given, must be the world
    size, and `nodes_axis` must divide it; `device` is this rank's
    compute device, by default its card under either backend (raising
    with no card): the CPU only when asked for.  Every rank must make
    the same call: the report and node groups are new process groups."""
    if n_devices is not None and (nodes_axis < 1
                                  or n_devices % nodes_axis != 0):
        raise ValueError("nodes_axis must divide n_devices")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"has {world} ranks")
    if nodes_axis < 1 or world % nodes_axis != 0:
        raise ValueError("nodes_axis must divide n_devices")
    backend = dist.get_backend()
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device per rank")
    rank = dist.get_rank()
    groups = (None, None)
    if nodes_axis > 1:
        # Every rank creates every group, in the same order.
        reports = world // nodes_axis
        by_node = [dist.new_group([c * nodes_axis + j
                                   for c in range(reports)])
                   for j in range(nodes_axis)]
        by_report = [dist.new_group([c * nodes_axis + j
                                     for j in range(nodes_axis)])
                     for c in range(reports)]
        groups = (by_node[rank % nodes_axis], by_report[rank // nodes_axis])
    return ReportMesh(world, rank, backend, device, nodes_axis, groups)


# -- placing and gathering rows -------------------------------------------

def tree_map(fn, tree):
    """`fn` over every tensor of a tree of NamedTuples, tuples and lists;
    None leaves stay None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    raise TypeError(f"not a tensor tree: {type(tree)}")


def place_reports(mesh: Optional[ReportMesh], tree):
    """This rank's rows of every tensor of a tree (a report batch, a
    carry, the round keys), leading axis = reports, each a contiguous
    copy on the tensor's device, so that the whole can be freed.  Every
    tensor's row count must divide evenly over the ranks.  No mesh
    leaves the tree as it is."""
    if mesh is None:
        return tree

    def rows(x):
        (lo, hi) = mesh.bounds(x.shape[0])
        return x[lo:hi].clone()

    return tree_map(rows, tree)


def place_replicated(mesh: Optional[ReportMesh], tree):
    """The identity: every rank already holds the small per-round inputs
    in full (each rank is handed the same arguments), and the port
    compiles no program whose input placements would need pinning."""
    return tree


def gather_rows(mesh: Optional[ReportMesh], t: torch.Tensor,
                total: Optional[int] = None) -> torch.Tensor:
    """All report ranks' rows of `t` (leading axis = reports, equal on
    every rank), in report-rank order, in host memory; rows past `total`
    (padding) dropped.  No mesh: `t` itself, in host memory."""
    if mesh is None:
        out = t.cpu()
    else:
        out = torch.cat(mesh.all_gather(t))
    return out if total is None else out[:total]


def sum_shares(mesh: Optional[ReportMesh], spec,
               shares: torch.Tensor) -> torch.Tensor:
    """Aggregate shares (..., L, n) int32 limbs summed over the report
    ranks, in host memory: every report rank's shares gathered, then
    `field_sum` in report-rank order (exact mod p, and the same on every
    rank)."""
    if mesh is None:
        return shares.cpu()
    return field_sum(spec, torch.stack(mesh.all_gather(shares)), axis=0)


def agree_max(mesh: Optional[ReportMesh], values: list) -> list:
    """The element-wise largest of every rank's integers (over both
    axes, so that every rank takes the same decision)."""
    if mesh is None:
        return list(values)
    got = mesh.gather_objects([int(v) for v in values])
    return [max(column) for column in zip(*got)]


def agree_min(mesh: Optional[ReportMesh], values: list) -> list:
    """The element-wise smallest of every rank's integers."""
    return [-v for v in agree_max(mesh, [-v for v in values])]


class Gathered(NamedTuple):
    """One round's (or chunk's) exchange, the same on every rank.

    shares       (A, L, n) int32 limbs: the A aggregators' shares summed
                 over the report ranks, in host memory
    masks        (rows, k) bool: every report rank's verdict masks in
                 report-rank order, padding dropped, in host memory
    skew_ms      the spread of the report ranks' arrival at the
                 exchange (wall clock; 0.0 without a mesh)
    share_bytes  bytes of the gathered shares (every report rank's)
    """
    shares: torch.Tensor
    masks: torch.Tensor
    skew_ms: float
    share_bytes: int


def gather_round(mesh: Optional[ReportMesh], spec, shares: torch.Tensor,
                 masks: torch.Tensor,
                 total: Optional[int] = None) -> Gathered:
    """A round's whole cross-rank exchange: the ranks' arrival times,
    the verdict masks (`masks` (rows, k) bool, this rank's rows;
    gathered as bytes) and the aggregate shares (`shares` (A, L, n),
    this rank's; summed by `sum_shares`).  Without a mesh the inputs
    come back in host memory as they are."""
    if mesh is None:
        return Gathered(shares.cpu(), masks.cpu()[:total], 0.0, 0)
    arrived = mesh.all_gather(torch.tensor([time.time()],
                                           dtype=torch.float64))
    arrived = torch.cat(arrived)
    masks = gather_rows(mesh, masks.to(torch.uint8), total).to(torch.bool)
    summed = sum_shares(mesh, spec, shares)
    return Gathered(
        shares=summed, masks=masks,
        skew_ms=float(arrived.max() - arrived.min()) * 1e3,
        share_bytes=mesh.shape["reports"] * shares.numel()
        * shares.element_size())


def mesh_block(mesh: ReportMesh, device_rows: int, share_bytes: int,
               skews: list) -> dict:
    """A round's `RoundMetrics.extra["mesh"]`, with the JAX package's
    keys: `report_shards` (the report axis's ranks),
    `device_rows_per_chunk` (rows of one chunk, or of the resident
    batch, padded to the shard multiple), `rows_per_shard` (of those,
    each report rank's), `psum_bytes_per_round` (bytes of the aggregate
    shares every rank received in the round's gathers: the port's
    counterpart of the psum), and `shard_wait_skew_ms_p50` / `_max`
    (over the round's exchanges, the spread of the report ranks'
    arrival, on the wall clock)."""
    skews = sorted(skews)
    n = mesh.shape["reports"]
    return {"report_shards": n, "device_rows_per_chunk": device_rows,
            "rows_per_shard": device_rows // n,
            "psum_bytes_per_round": share_bytes,
            "shard_wait_skew_ms_p50": skews[len(skews) // 2] if skews
            else 0.0,
            "shard_wait_skew_ms_max": skews[-1] if skews else 0.0}


# -- the JAX package's sharded functions ------------------------------------

def sharded_gen(bm, mesh: ReportMesh, ctx: bytes):
    """Batched client-side VIDPF key generation over the mesh: fn(alphas,
    betas, nonces, rand), each the global batch, -> (cws, keys, ok) of
    this rank's rows (`gather_rows` puts them together)."""
    def fn(alphas, betas, nonces, rand):
        return bm.vidpf.gen(*place_reports(mesh, (alphas, betas)), ctx,
                            *place_reports(mesh, (nonces, rand)))

    return fn


def sharded_prep(bm, mesh: ReportMesh, agg_id: int, verify_key: bytes,
                 ctx: bytes, agg_param):
    """One aggregator's from-root prep over the mesh: fn(nonces, cws,
    keys[, proof_shares | seeds][, peer_parts]), each global, ->
    BatchedPrep of this rank's rows (with `install_grid_sharding`,
    split over the node ranks of its report block, with the same
    rows)."""
    def fn(nonces, cws, keys, proof_shares=None, seeds=None,
           peer_parts=None):
        (nonces, cws, keys, proof_shares, seeds, peer_parts) = \
            place_reports(mesh, (nonces, cws, keys, proof_shares, seeds,
                                 peer_parts))
        return bm.prep(agg_id, verify_key, ctx, agg_param, nonces, cws,
                       keys, proof_shares=proof_shares, seeds=seeds,
                       peer_jr_parts=peer_parts)

    return fn


def sharded_round(bm, mesh: ReportMesh, verify_key: bytes, ctx: bytes,
                  agg_param):
    """A whole two-aggregator round from the root over the mesh: both
    preps, every check (the FLP weight check on weight-check rounds),
    the masked aggregates on each rank's rows (with
    `install_grid_sharding`, the preps split over the node ranks of its
    report block), then the exchange.  fn(batch), the global batch, ->
    (agg_share0, agg_share1, accept, ok): the aggregates summed over the
    report ranks, the masks over every report, all in host memory and
    the same on every rank."""
    def fn(batch):
        (agg0, agg1, accept, ok, _checks) = bm.round_device_checks(
            verify_key, ctx, agg_param, place_reports(mesh, batch))
        g = gather_round(mesh, bm.spec, torch.stack([agg0, agg1]),
                         torch.stack([accept, ok], dim=1))
        return (g.shares[0], g.shares[1], g.masks[:, 0], g.masks[:, 1])

    return fn


def shard_incremental_runner(runner, mesh: ReportMesh) -> None:
    """Shard a resident incremental runner over `mesh`: each rank keeps
    its rows of the batch, both carries, the round keys and its masks,
    so that the round's exchange is the only cross-rank traffic.  The
    resident batch is the device tile, so its report count must divide
    evenly.  A chunked runner takes its mesh at construction
    (`ChunkedIncrementalRunner(mesh=)`: each rank builds only its tiles
    of the padded chunks), so it is refused here."""
    if getattr(runner, "store", None) is not None:
        raise ValueError("a chunked runner takes its mesh at construction "
                         "(ChunkedIncrementalRunner(mesh=...))")
    if runner.mesh is not None:
        raise ValueError("the runner is sharded already")
    mesh.rows(runner.num_reports)
    runner.shard(mesh)
