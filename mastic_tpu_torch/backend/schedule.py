"""The from-root prefix-tree grid of one round (port of
`mastic_tpu/backend/schedule.py`).

The candidate prefixes and the level are public (the aggregation
parameter) and the same for every report, so the tree shape, the
parent gathers, the node-proof binders and the order of the check
binders are computed once on the host.  The grid reproduces the
reference's breadth-first materialisation order: at each depth the
children are generated left then right from lexicographically sorted
parents, which keeps every depth sorted.

The port keeps a round's tree in one flat node axis, depth after depth
(`LevelSchedule.offset`), and `schedule_inputs` uploads what the round
needs on the device, once per round: the parent gathers, every node
binder, and kernel K1's index lists into the flat axis.

`node_blocks` cuts a round's tree into the subtrees of contiguous
blocks of its sorted prefixes, one per rank of a mesh's node axis
(`parallel/grid.py`): each block is the tree of its own prefixes, so a
rank walks it from the root with no other rank's nodes.
"""

from bisect import bisect_left
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..scalar.common import to_le_bytes
from ..scalar.vidpf import encode_path


class LevelSchedule:
    """The dense node grid for evaluating `prefixes` at `level`.

    Per depth d in 0..level, node arrays hold the children at depth d in
    lexicographic order:

      num_children[d]   2 * number of distinct d-bit parent paths
      parent_index[d]   for d > 0: position of each depth-d parent in
                        the depth d-1 child array (None at d = 0: the
                        root)
      node_binder[d]    node-proof binder bytes per child, uint8
                        (num_children[d], 4 + ceil((d+1)/8))
      internal_index[d] for d < level: positions in child array d of
                        the nodes whose children are materialised at
                        d+1 (the payload-check participants), in BFS
                        order
      out_index         position of each requested prefix (caller's
                        order) in the child array at depth `level`
      offset[d]         where depth d starts in the flat node axis
                        (sum of num_children[:d]; offset[level + 1] is
                        total_nodes)
    """

    def __init__(self, prefixes: Sequence, level: int, bits: int):
        if any(len(p) != level + 1 for p in prefixes):
            raise ValueError("prefix with incorrect length")
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("candidate prefixes are non-unique")
        self.level = level
        self.bits = bits
        self.prefixes = tuple(prefixes)

        parents = [sorted(set(p[:d] for p in prefixes))
                   for d in range(level + 1)]
        children = [[par + (b,) for par in parents[d] for b in (False, True)]
                    for d in range(level + 1)]
        child_pos = [{path: i for (i, path) in enumerate(lvl)}
                     for lvl in children]

        self.num_children = [len(lvl) for lvl in children]
        self.parent_index: list = [None]
        for d in range(1, level + 1):
            self.parent_index.append(np.array(
                [child_pos[d - 1][par] for par in parents[d]], np.int32))

        self.node_binder = []
        for d in range(level + 1):
            head = to_le_bytes(bits, 2) + to_le_bytes(d, 2)
            self.node_binder.append(np.stack([
                np.frombuffer(head + encode_path(path), np.uint8)
                for path in children[d]]))

        self.internal_index = []
        for d in range(level):
            self.internal_index.append(np.array(
                [child_pos[d][par] for par in parents[d + 1]], np.int32))

        self.out_index = np.array(
            [child_pos[level][p] for p in self.prefixes], np.int32)
        self.offset = [0]
        for n in self.num_children:
            self.offset.append(self.offset[-1] + n)

    @property
    def total_nodes(self) -> int:
        """Total materialised nodes = the onehot binder's rows."""
        return sum(self.num_children)

    def check_indices(self) -> tuple:
        """K1's index lists into the flat node axis, in the reference's
        BFS order: (onehot, payload parent, left, right) int64.  The
        onehot binder is every node's proof, depth after depth; the
        payload binder pairs each internal node at depth d with its two
        children at d + 1, which sit side by side in child order."""
        (par, left) = ([], [])
        for d in range(self.level):
            internal = self.internal_index[d].astype(np.int64)
            par.append(self.offset[d] + internal)
            left.append(self.offset[d + 1]
                        + 2 * np.arange(len(internal), dtype=np.int64))
        par = np.concatenate(par) if par else np.zeros(0, np.int64)
        left = np.concatenate(left) if left else np.zeros(0, np.int64)
        return (np.arange(self.total_nodes, dtype=np.int64), par, left,
                left + 1)


class NodeBlock(NamedTuple):
    """One node rank's subtree of a round's tree (`node_blocks`).

    sched   the LevelSchedule of the block's prefixes (None for an empty
            block: fewer prefixes than node ranks)
    index   (T_j,) int64: each of the block's nodes, in its own flat
            order, as a node of the round's flat axis
    owned   (T_j,) bool: the nodes this block answers for; a node that
            several blocks hold (a shared ancestor's child) is owned by
            the lowest of them, so the owned nodes of all blocks are
            every node of the round once
    """
    sched: Optional[LevelSchedule]
    index: np.ndarray
    owned: np.ndarray

    @property
    def shared(self) -> int:
        """The block's nodes that a lower block holds too."""
        return int((~self.owned).sum())


def node_blocks(sched: LevelSchedule, nodes: int) -> list:
    """`sched`'s tree split over `nodes` node ranks: the sorted prefixes
    cut into `nodes` contiguous blocks as even as they can be (the first
    ones a prefix longer), each block the tree of its prefixes.  Each
    depth's children are sorted, so a block's children at depth d are a
    contiguous run of the round's, starting at its first prefix's
    parent; only the shallow ancestors that blocks share are held by
    more than one."""
    prefixes = sorted(sched.prefixes)
    parents = [sorted(set(p[:d] for p in prefixes))
               for d in range(sched.level + 1)]
    claimed = np.zeros(sched.total_nodes, bool)
    blocks = []
    for part in np.array_split(np.arange(len(prefixes)), nodes):
        if not len(part):
            empty = np.zeros(0, np.int64)
            blocks.append(NodeBlock(None, empty, empty.astype(bool)))
            continue
        mine = [prefixes[i] for i in part]
        sub = LevelSchedule(mine, sched.level, sched.bits)
        index = np.concatenate([
            sched.offset[d] + 2 * bisect_left(parents[d], mine[0][:d])
            + np.arange(sub.num_children[d], dtype=np.int64)
            for d in range(sched.level + 1)])
        owned = ~claimed[index]
        claimed[index] = True
        blocks.append(NodeBlock(sub, index, owned))
    return blocks


class ScheduleInputs(NamedTuple):
    """A LevelSchedule on the device (`schedule_inputs`)."""
    level: int
    offset: tuple                # per depth, then total_nodes
    parent_index: torch.Tensor   # int64, depths 1..level's gathers
    #                              concatenated
    node_binder: torch.Tensor    # (total_nodes, 4 + ceil((level+1)/8))
    binder_len: tuple            # per depth: 4 + ceil((d+1)/8)
    onehot_idx: torch.Tensor     # (total_nodes,) int64
    payload_parent: torch.Tensor  # (payload rows,) int64
    payload_left: torch.Tensor
    payload_right: torch.Tensor
    out_index: torch.Tensor      # (P,) int64

    @property
    def total_nodes(self) -> int:
        return self.offset[-1]

    def parents(self, d: int) -> torch.Tensor:
        """Depth d's parent gather into the depth d-1 child array."""
        # Depth k > 0 has num_children[k] / 2 parents and depth 0 two
        # children, so depth d's list starts at offset[d] / 2 - 1.
        return self.parent_index[self.offset[d] // 2 - 1:
                                 self.offset[d + 1] // 2 - 1]


def schedule_inputs(sched: LevelSchedule, device) -> ScheduleInputs:
    """Everything a from-root round reads of its schedule, uploaded
    once per round (not once per depth): the concatenated parent gathers,
    every depth's node binders zero-padded to the longest, and K1's
    index lists."""
    binder = np.zeros((sched.total_nodes,
                       sched.node_binder[-1].shape[-1]), np.uint8)
    for (d, rows) in enumerate(sched.node_binder):
        binder[sched.offset[d]:sched.offset[d + 1], :rows.shape[-1]] = rows
    parents = np.concatenate(
        [np.zeros(0, np.int64)]
        + [p.astype(np.int64) for p in sched.parent_index[1:]])
    (onehot, par, left, right) = sched.check_indices()

    def dev(x):
        return torch.as_tensor(x, device=device)

    return ScheduleInputs(
        level=sched.level, offset=tuple(sched.offset),
        parent_index=dev(parents), node_binder=dev(binder),
        binder_len=tuple(rows.shape[-1] for rows in sched.node_binder),
        onehot_idx=dev(onehot), payload_parent=dev(par),
        payload_left=dev(left), payload_right=dev(right),
        out_index=dev(sched.out_index.astype(np.int64)))
