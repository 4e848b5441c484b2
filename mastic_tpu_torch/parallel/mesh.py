"""Report sharding over `torch.distributed` (port of
`mastic_tpu/parallel/mesh.py`).

The JAX mesh is single-controller: one process drives every device, and
GSPMD turns the masked sum over the report-sharded axis into a psum.
Here each rank is one process with one device, and every rank runs the
same program on its own rows.  Every rank is handed the same arguments
as the JAX call (the global reports, batch or store) and keeps only its
rows on its device: with n ranks a tile of R rows splits into the
contiguous blocks [rank R/n, (rank+1) R/n), in rank order.  The only
cross-rank traffic is the round's aggregate shares, its report-axis
verdict masks, and a checkpoint's carries, gathered when one is taken.

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

`place_reports` keeps this rank's rows of a batch, a carry or the round
keys; `gather_rows` puts all ranks' rows back together; `gather_round`
is a round's whole exchange.  `sharded_gen`, `sharded_prep` and
`sharded_round` are the JAX package's `sharded_*_fn` over these, and
`shard_incremental_runner` shards a resident runner.

No counterpart: `install_grid_sharding` (the node axis; `make_mesh`
refuses `nodes_axis` > 1) and `place_replicated`'s role of pinning the
input placements of AOT-compiled programs (the port compiles none).
`shard_batch` is `place_reports` of one tensor.
"""

import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from ..ops.field import field_sum


class ReportMesh:
    """The ranks of an initialised process group, laid along the report
    axis.  `shape` reads as the JAX mesh's: {"reports": world, "nodes":
    1}.  `device` is this rank's compute device; `backend` the group's
    ("gloo" or "nccl")."""

    def __init__(self, world: int, rank: int, backend: str,
                 device: torch.device):
        self.shape = {"reports": world, "nodes": 1}
        self.rank = rank
        self.backend = backend
        self.device = device

    def __repr__(self) -> str:
        return (f"ReportMesh(reports={self.shape['reports']}, "
                f"rank={self.rank}, backend={self.backend!r}, "
                f"device={self.device})")

    def rows(self, total: int) -> int:
        """Rows of a `total`-row tile on each rank; `total` must divide
        evenly (a chunked round pads its chunks to the shard multiple
        first)."""
        n = self.shape["reports"]
        if total % n != 0:
            raise ValueError(
                f"report count {total} must be divisible by the mesh's "
                f"reports axis ({n}) to shard evenly")
        return total // n

    def bounds(self, total: int) -> tuple:
        """This rank's rows [lo, hi) of a `total`-row tile."""
        rows = self.rows(total)
        return (self.rank * rows, (self.rank + 1) * rows)

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """`t` where the backend's collectives take it: on this rank's
        card for NCCL, in host memory for gloo."""
        if self.backend == "nccl":
            return t.to(self.device)
        return t.cpu()

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's `t` (equal shapes), in rank order, in host
        memory."""
        t = self.wire(t.contiguous())
        out = [torch.empty_like(t) for _ in range(self.shape["reports"])]
        dist.all_gather(out, t)
        return [x.cpu() for x in out]


def make_mesh(n_devices: Optional[int] = None, nodes_axis: int = 1,
              device=None) -> ReportMesh:
    """The report mesh over the initialised default process group
    (`parallel.launch.spawn` sets one up): every rank on the report
    axis.  `n_devices`, if given, must be the world size; `device` is
    this rank's compute device, by default its card under either
    backend (raising with no card): the CPU only when asked for.  The
    node axis is not sharded: `nodes_axis` > 1 raises."""
    if nodes_axis != 1:
        raise ValueError(
            f"nodes_axis={nodes_axis}: the port shards the report axis "
            f"only (the node axis is ROADMAP item 7b)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group "
                         f"has {world} ranks")
    backend = dist.get_backend()
    device = resolve_device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device per rank")
    return ReportMesh(world, dist.get_rank(), backend, device)


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
    """All ranks' rows of `t` (leading axis = reports, equal on every
    rank), in rank order, in host memory; rows past `total` (padding)
    dropped.  No mesh: `t` itself, in host memory."""
    if mesh is None:
        out = t.cpu()
    else:
        out = torch.cat(mesh.all_gather(t))
    return out if total is None else out[:total]


def sum_shares(mesh: Optional[ReportMesh], spec,
               shares: torch.Tensor) -> torch.Tensor:
    """Aggregate shares (..., L, n) int32 limbs summed over the ranks,
    in host memory: every rank's shares gathered, then `field_sum` in
    rank order (exact mod p, and the same on every rank)."""
    if mesh is None:
        return shares.cpu()
    return field_sum(spec, torch.stack(mesh.all_gather(shares)), axis=0)


def agree_max(mesh: Optional[ReportMesh], values: list) -> list:
    """The element-wise largest of every rank's integers."""
    if mesh is None:
        return list(values)
    got = torch.stack(mesh.all_gather(torch.tensor(values,
                                                   dtype=torch.int64)))
    return [int(v) for v in got.max(dim=0).values]


def agree_min(mesh: Optional[ReportMesh], values: list) -> list:
    """The element-wise smallest of every rank's integers."""
    return [-v for v in agree_max(mesh, [-v for v in values])]


class Gathered(NamedTuple):
    """One round's (or chunk's) exchange, the same on every rank.

    shares       (A, L, n) int32 limbs: the A aggregators' shares summed
                 over the ranks, in host memory
    masks        (rows, k) bool: every rank's verdict masks in rank
                 order, padding dropped, in host memory
    skew_ms      the spread of the ranks' arrival at the exchange
                 (wall clock; 0.0 without a mesh)
    share_bytes  bytes of the gathered shares (every rank's)
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
    keys: `report_shards` (ranks), `device_rows_per_chunk` (rows of one
    chunk, or of the resident batch, padded to the shard multiple),
    `rows_per_shard` (of those, each rank's), `psum_bytes_per_round`
    (bytes of the aggregate shares every rank received in the round's
    gathers: the port's counterpart of the psum), and
    `shard_wait_skew_ms_p50` / `_max` (over the round's exchanges, the
    spread of the ranks' arrival, on the wall clock)."""
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
    BatchedPrep of this rank's rows."""
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
    the masked aggregates on each rank's rows, then the exchange.
    fn(batch), the global batch, -> (agg_share0, agg_share1, accept,
    ok): the aggregates summed over the ranks, the masks over every
    report, all in host memory and the same on every rank."""
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
