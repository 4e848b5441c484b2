"""The node axis: from-root rounds split over a mesh's node ranks (port
of `mastic_tpu/parallel/mesh.py::install_grid_sharding`).

In the JAX package `install_grid_sharding` constrains every depth's
(reports x nodes) eval grid to both mesh axes, and GSPMD moves whatever
the checks read between the devices.  Here each rank is a process that
sees only its own tensors, so the split and its exchange are explicit:

* The walk.  The round's sorted prefixes are cut into one contiguous
  block per node rank (`backend.schedule.node_blocks`), and each node
  rank walks only its block's subtree from the root, kernel K3 once a
  depth over the block's parents, for every report of its report
  block.  A node's payload and proof depend only on its path, so each
  walked node equals the unsplit round's, and no depth needs another
  rank's parents; only the shallow ancestors that blocks share are
  walked by more than one rank.
* The exchange.  The eval proof's onehot and payload checks hash every
  node of a report in the tree's breadth-first order, and a Keccak
  sponge cannot absorb its pieces apart.  So the report block is cut
  into one sub-block per node rank, and one all-to-all over the node
  group transposes the tree: node rank j sends node rank k the payloads
  and proofs of the nodes j owns (each node is owned by the lowest
  block that holds it) for k's reports.  Each rank then holds every
  node of its sub-block's reports in the round's flat order, and the
  unsplit prep's checks run on it unchanged (`BatchedMastic.prep_tree`:
  K1's binder sponge over the round's own index lists, the counter
  check, the FLP weight check, the out shares).  Payload limbs are
  below 2^16, so each travels as its two low bytes.  The local tree is
  freed as soon as its rows are packed, and the prep runs one
  aggregator at a time, as the unsplit prep does.
* The verdicts.  Each rank's walk saw the in-range masks of its own
  nodes only, so the walk's `ok` masks are ANDed over the node group
  before the checks, and each sub-block's prep rows are gathered over
  the node group in the end: every node rank returns the report block's
  `BatchedPrep`, equal to the unsplit prep's, and the report axis
  (`gather_round`, `sum_shares`) goes on as without the split.

An empty block (fewer prefixes than node ranks) walks nothing and still
joins every collective; a report block of fewer reports than node ranks
is not split (each node rank preps it whole).  The exchange's bytes and times are kept in
`GridSplit.stats` (one entry a prep: bytes each way, the exchange on
the card by CUDA events, and on the host's clock the packing and copies
to the wire, the collective, and the copies back and unpacking) for the
card's smoke; no round metrics key is added.
"""

import time
from typing import NamedTuple

import numpy as np
import torch

from ..backend.schedule import LevelSchedule, node_blocks, schedule_inputs
from .mesh import ReportMesh

PROOF_SIZE = 32


class _Plan(NamedTuple):
    """One round's split as this node rank sees it."""
    local: object     # this rank's ScheduleInputs (None: empty block)
    owned: list       # per node rank, its owned nodes' local positions
    targets: list     # per node rank, those nodes in the round's flat axis
    total: int        # the round's nodes
    shared: int       # this rank's nodes that a lower node rank walks


def sub_blocks(rows: int, nodes: int) -> list:
    """[lo, hi) of each node rank's reports of a `rows`-report block,
    as even as they can be (the first ones a report longer)."""
    cuts = np.cumsum([0] + [len(p) for p in
                            np.array_split(np.arange(rows), nodes)])
    return [(int(cuts[k]), int(cuts[k + 1])) for k in range(nodes)]


class GridSplit:
    """`install_grid_sharding`'s hook: `BatchedMastic.prep` hands its
    from-root prep to `prep` here.  The last round's plan is kept, so
    that both aggregators' preps of a round build the blocks once."""

    def __init__(self, mesh: ReportMesh):
        self.mesh = mesh
        self.stats: list = []
        self._plan: tuple = (None, None)

    def plan(self, agg_param, bits: int, device) -> _Plan:
        """The round's blocks, this rank's schedule on `device` and the
        exchange's index lists; the last round's is kept."""
        (level, prefixes, _wc) = agg_param
        key = (level, tuple(prefixes), bits, str(device))
        if self._plan[0] != key:
            sched = LevelSchedule(prefixes, level, bits)
            blocks = node_blocks(sched, self.mesh.shape["nodes"])
            mine = blocks[self.mesh.node_rank]
            local = (None if mine.sched is None
                     else schedule_inputs(mine.sched, device))
            owned = [torch.as_tensor(np.flatnonzero(b.owned), device=device)
                     for b in blocks]
            targets = [torch.as_tensor(b.index[b.owned], device=device)
                       for b in blocks]
            self._plan = (key, _Plan(local, owned, targets,
                                     sched.total_nodes, mine.shared))
        return self._plan[1]

    def splits(self, rows: int) -> bool:
        """Whether a report block of `rows` reports is split: not when a
        sub-block would be empty (every node rank then preps it whole,
        the same choice on each, from the same rows)."""
        return rows >= self.mesh.shape["nodes"]

    def prep(self, bm, agg_id: int, verify_key: bytes, ctx: bytes,
             agg_param, nonces: torch.Tensor, cws, keys: torch.Tensor,
             proof_shares, seeds, peer_jr_parts, sched):
        """`BatchedMastic.prep` over the node ranks (see the module's
        docstring): every argument is this report block's, and so is the
        returned BatchedPrep, the same on every node rank."""
        mesh = self.mesh
        dev = nonces.device
        rows = int(nonces.shape[0])
        plan = self.plan(agg_param, bm.m.bits, dev)
        bounds = sub_blocks(rows, mesh.shape["nodes"])
        (lo, hi) = bounds[mesh.node_rank]
        spec = bm.spec
        vl = bm.m.value_len
        if plan.local is None:
            w_loc = torch.empty((rows, 0, vl, spec.num_limbs),
                                dtype=torch.int32, device=dev)
            proof_loc = torch.empty((rows, 0, PROOF_SIZE), dtype=torch.uint8,
                                    device=dev)
            ok = torch.ones(rows, dtype=torch.bool, device=dev)
        else:
            (w_loc, proof_loc, _out, ok) = bm.vidpf.eval_full(
                agg_id, cws, keys, plan.local, ctx, nonces)
        ok = torch.stack(mesh.node_all_gather(ok.to(torch.uint8))).bool() \
            .all(dim=0).to(dev)
        tree = [w_loc, proof_loc]
        del w_loc, proof_loc
        (w_all, proof_all) = self._exchange(plan, bounds, tree, agg_id)
        out_w = w_all[:, sched.out_index + sched.offset[sched.level]]
        if agg_id == 1:
            out_w = spec.neg(out_w)

        def cut(t):
            return None if t is None else t[lo:hi]

        prep = bm.prep_tree(agg_id, verify_key, ctx, agg_param, sched,
                            w_all, proof_all, out_w, ok[lo:hi], cut(nonces),
                            cut(proof_shares), cut(seeds),
                            cut(peer_jr_parts))
        del w_all, proof_all, out_w
        return type(prep)(*(None if t is None
                            else self._gather_rows(t, bounds)
                            for t in prep))

    def _exchange(self, plan: _Plan, bounds: list, tree: list,
                  agg_id: int) -> tuple:
        """The all-to-all that transposes the tree: the local tree
        (`tree` = [w (R, T_j, VALUE_LEN, n) int32, proof (R, T_j, 32)
        uint8], emptied here once its rows are packed) in, (w (r, T,
        VALUE_LEN, n), proof (r, T, 32)) over every node of this rank's
        r sub-block reports, in the round's flat order, out."""
        (w_loc, proof_loc) = tree
        tree.clear()
        mesh = self.mesh
        me = mesh.node_rank
        dev = w_loc.device
        (_rows, _t, vl, n) = w_loc.shape
        row_bytes = vl * n * 2 + PROOF_SIZE
        timing = dev.type == "cuda"
        if timing:
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
        t0 = time.perf_counter()
        (lo, hi) = bounds[me]
        w_all = torch.empty((hi - lo, plan.total, vl, n), dtype=torch.int32,
                            device=dev)
        proof_all = torch.empty((hi - lo, plan.total, PROOF_SIZE),
                                dtype=torch.uint8, device=dev)
        own = plan.owned[me]
        w_all[:, plan.targets[me]] = w_loc[lo:hi, own]
        proof_all[:, plan.targets[me]] = proof_loc[lo:hi, own]
        sends = [None if k == me
                 else mesh.wire(_pack(w_loc[a:b], proof_loc[a:b], own))
                 for (k, (a, b)) in enumerate(bounds)]
        local_nodes = int(w_loc.shape[1])
        del w_loc, proof_loc
        sizes = [(hi - lo) * int(t.shape[0]) * row_bytes
                 for t in plan.owned]
        t1 = time.perf_counter()
        got = mesh.node_all_to_all(sends, sizes)
        t2 = time.perf_counter()
        sent = sum(int(t.numel()) for t in sends if t is not None)
        del sends
        for (k, buf) in enumerate(got):
            if buf is not None:
                _unpack(buf.to(dev).reshape(hi - lo, -1, row_bytes), w_all,
                        proof_all, plan.targets[k])
        t3 = time.perf_counter()
        # The host clock's phases read the device's work only where the
        # wire is host memory (gloo: the copies synchronise).
        entry = {"agg_id": agg_id, "nodes": local_nodes,
                 "shared": plan.shared, "total": plan.total,
                 "bytes_sent": sent,
                 "bytes_received": sum(sizes) - sizes[me],
                 "wall_ms": (t3 - t0) * 1e3, "to_wire_ms": (t1 - t0) * 1e3,
                 "collective_ms": (t2 - t1) * 1e3,
                 "from_wire_ms": (t3 - t2) * 1e3}
        if timing:
            events[1].record()
            entry["events"] = events
        self.stats.append(entry)
        return (w_all, proof_all)

    def _gather_rows(self, t: torch.Tensor, bounds: list) -> torch.Tensor:
        """Every node rank's sub-block rows of a prep output, in report
        order, on this rank's device: padded to the longest sub-block
        for the gather, the padding dropped."""
        (dtype, dev) = (t.dtype, t.device)
        longest = max(b - a for (a, b) in bounds)
        t = t.to(torch.uint8) if dtype == torch.bool else t
        pad = longest - t.shape[0]
        if pad:
            t = torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
        parts = self.mesh.node_all_gather(t)
        return torch.cat([p[:b - a] for (p, (a, b)) in zip(parts, bounds)]
                         ).to(device=dev, dtype=dtype)

    def summary(self) -> list:
        """`stats` with each exchange's time on the card (CUDA events
        around the packing, the copies to and from host memory, the
        collective and the unpacking) as `device_ms`; waits for the
        card."""
        out = []
        for entry in self.stats:
            entry = dict(entry)
            events = entry.pop("events", None)
            if events is not None:
                events[1].synchronize()
                entry["device_ms"] = events[0].elapsed_time(events[1])
            out.append(entry)
        return out


# Rows packed or unpacked at a time: their int32 payloads' temporary
# stays near this many bytes.
PACK_BYTES = 1 << 28


def _row_step(nodes: int, vl: int, n: int) -> int:
    return max(1, PACK_BYTES // max(1, nodes * vl * n * 4))


def _pack(w: torch.Tensor, proof: torch.Tensor,
          own: torch.Tensor) -> torch.Tensor:
    """The rows of `own` (local node positions) of w (r, T_j, VALUE_LEN,
    n) int32 and proof (r, T_j, 32) uint8, as bytes: per (report, node)
    each limb's two low bytes, then the proof."""
    (rows, _t, vl, n) = w.shape
    out = torch.empty((rows, own.shape[0], vl * n * 2 + PROOF_SIZE),
                      dtype=torch.uint8, device=w.device)
    step = _row_step(own.shape[0], vl, n)
    for r in range(0, rows, step):
        part = w[r:r + step, own].view(torch.uint8)
        out[r:r + step, :, :-PROOF_SIZE] = part.reshape(
            part.shape[:-1] + (n, 4))[..., :2].reshape(
            part.shape[:2] + (vl * n * 2,))
        out[r:r + step, :, -PROOF_SIZE:] = proof[r:r + step, own]
    return out.reshape(-1)


def _unpack(buf: torch.Tensor, w_all: torch.Tensor, proof_all: torch.Tensor,
            targets: torch.Tensor) -> None:
    """`_pack`'s bytes (r, nodes, row bytes) into the columns `targets`
    of w_all (r, T, VALUE_LEN, n) and proof_all (r, T, 32)."""
    (rows, nodes, _b) = buf.shape
    (vl, n) = w_all.shape[2:]
    step = _row_step(nodes, vl, n)
    for r in range(0, rows, step):
        part = buf[r:r + step]
        limbs = torch.zeros(part.shape[:2] + (vl, n, 4), dtype=torch.uint8,
                            device=buf.device)
        limbs[..., :2] = part[..., :-PROOF_SIZE].reshape(
            part.shape[:2] + (vl, n, 2))
        w_all[r:r + part.shape[0], targets] = limbs.view(torch.int32)[..., 0]
        proof_all[r:r + part.shape[0], targets] = part[..., -PROOF_SIZE:]


def install_grid_sharding(bm, mesh: ReportMesh) -> None:
    """Split `bm`'s from-root rounds (`prep`, and so `prep_both`,
    `round_device_checks`, `sharded_prep`, `sharded_round`, `run_round`
    and the attribute round) over `mesh`'s node axis; setting
    `bm.vidpf.constrain_state` back to None turns it off.  The
    incremental engine is not split, as in the JAX package.  Every node
    rank must run the same rounds."""
    bm.vidpf.constrain_state = (GridSplit(mesh) if mesh.shape["nodes"] > 1
                                else None)
