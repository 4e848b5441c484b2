"""Cross-round incremental VIDPF evaluation for heavy hitters (port of
`mastic_tpu/backend/incremental.py`).

Each aggregator carries, per tree depth, the payload and node-proof
tensors of every node materialised so far, plus the seed/ctrl state of
the newest depth.  A round at level L gathers the surviving depth-(L-1)
parents and runs one level step (kernel K3) for them; the eval-proof
binders cover the full ancestor tree byte-exactly, defined by the
carried tensors and host-computed index lists: on the card kernel K1's
binder sponge reads the rows where they lie in the carry and computes
the payload difference in registers (`ops/binder.py`), for both
aggregators in one launch (`agg_rounds`).  Per-depth tensors are
padded to a fixed node width W and the depth axis to BITS.

`RoundPlan` is host code, a copy of the JAX package's.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.level import level_step
from ..scalar.common import to_le_bytes
from ..scalar.dst import USAGE_NODE_PROOF, dst
from ..scalar.vidpf import PROOF_SIZE, encode_path
from .mastic import BatchedMastic
from .vidpf import KEY_SIZE, EvalState
from .xof import ts_prefix


class Carry(NamedTuple):
    """One aggregator's cross-round state.

    w      (R, BITS, W, VALUE_LEN, n) int32 plain limbs, rows 0..level live
    proof  (R, BITS, W, 32) uint8
    seed   (R, W, 16) uint8 (newest depth only)
    ctrl   (R, W) bool
    """
    w: torch.Tensor
    proof: torch.Tensor
    seed: torch.Tensor
    ctrl: torch.Tensor


def _ancestors(prefixes: Sequence, level: int) -> list:
    """Per depth d <= level, the distinct ancestors of `prefixes` at
    depth d, in lexicographic order."""
    return [sorted(set(p[:d + 1] for p in prefixes))
            for d in range(level + 1)]


def needed_paths(prefixes: Sequence, level: int,
                 anc: Optional[list] = None) -> list:
    """Per depth d <= level, the nodes a round at `level` touches: both
    children of every ancestor of `prefixes` at depth d-1, in
    lexicographic order (the reference's BFS materialisation order)."""
    if anc is None:
        anc = _ancestors(prefixes, level)
    return [[par + (b,) for par in (anc[d - 1] if d else [()])
             for b in (False, True)]
            for d in range(level + 1)]


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


class RoundPlan:
    """Host-side inputs for one incremental round (see the JAX
    package's RoundPlan: creation-time layouts per depth, the new
    level's layout, parent gather, node binders, and the onehot /
    payload / output gather lists, capacity-bucketed to powers of
    two)."""

    def __init__(self, prefixes: Sequence, level: int, bits: int,
                 width: int, layouts: list):
        if any(len(p) != level + 1 for p in prefixes):
            raise ValueError("prefix with incorrect length")
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("candidate prefixes are non-unique")
        if level != len(layouts):
            raise ValueError(
                f"incremental rounds must advance one level at a time "
                f"(have layouts for depths 0..{len(layouts) - 1}, "
                f"round is at level {level})")
        half = width // 2
        self.level = level
        self.width = width
        self.prefixes = tuple(prefixes)

        anc = _ancestors(prefixes, level)
        if any(len(anc[d]) > half for d in range(level)):
            raise ValueError("frontier exceeds padded width")
        if level == 0:
            self.layout_new = [(False,), (True,)]
        else:
            self.layout_new = [p + (b,) for p in anc[level - 1]
                               for b in (False, True)]
        full = list(layouts) + [self.layout_new]
        pos_maps = [{p: i for (i, p) in enumerate(lay)} for lay in full]

        self.parent_idx = np.zeros(half, np.int64)
        if level == 0:
            self.parent_count = 1
        else:
            for (i, p) in enumerate(anc[level - 1]):
                self.parent_idx[i] = pos_maps[level - 1][p]
            self.parent_count = len(anc[level - 1])

        path_bytes = (bits + 7) // 8
        self.binder_capacity = 4 + path_bytes
        self.node_binder = np.zeros((width, self.binder_capacity), np.uint8)
        head = to_le_bytes(bits, 2) + to_le_bytes(level, 2)
        for (i, p) in enumerate(self.layout_new):
            row = head + encode_path(p)
            self.node_binder[i, :len(row)] = np.frombuffer(row, np.uint8)
        self.binder_len = 4 + (level + 1 + 7) // 8

        rows = []
        for d in range(level + 1):
            if d == level:
                current = self.layout_new
            elif d == 0:
                current = [(False,), (True,)]
            else:
                current = [p + (b,) for p in anc[d - 1]
                           for b in (False, True)]
            rows += [d * width + pos_maps[d][p] for p in current]
        self.onehot_rows = len(rows)
        self.onehot_idx = np.zeros(_next_pow2(max(1, self.onehot_rows)),
                                   np.int64)
        self.onehot_idx[:len(rows)] = rows

        (par, left, right) = ([], [], [])
        for d in range(level):
            for p in anc[d]:
                par.append(d * width + pos_maps[d][p])
                left.append((d + 1) * width + pos_maps[d + 1][p + (False,)])
                right.append((d + 1) * width + pos_maps[d + 1][p + (True,)])
        self.payload_rows = len(par)
        cap_p = _next_pow2(max(1, self.payload_rows))
        self.payload_parent = np.zeros(cap_p, np.int64)
        self.payload_left = np.zeros(cap_p, np.int64)
        self.payload_right = np.zeros(cap_p, np.int64)
        self.payload_parent[:len(par)] = par
        self.payload_left[:len(left)] = left
        self.payload_right[:len(right)] = right

        self.num_out = len(self.prefixes)
        self.out_idx = np.zeros(_next_pow2(max(1, self.num_out)), np.int64)
        for (i, p) in enumerate(self.prefixes):
            self.out_idx[i] = pos_maps[level][p]


class IncrementalRound(NamedTuple):
    """A RoundPlan's index lists as device tensors.  The onehot and
    payload lists hold only their live rows: the sponge hashes those
    and nothing of the padded capacity."""
    level: int
    parent_idx: torch.Tensor     # (W/2,)
    parent_count: int
    node_binder: torch.Tensor    # (W, B) uint8
    binder_len: int
    onehot_idx: torch.Tensor     # (onehot_rows,)
    payload_parent: torch.Tensor  # (payload_rows,)
    payload_left: torch.Tensor
    payload_right: torch.Tensor
    out_idx: torch.Tensor        # (capOut,)


def round_inputs(plan: RoundPlan, device) -> IncrementalRound:
    def dev(x):
        return torch.as_tensor(x, device=device)

    return IncrementalRound(
        level=plan.level, parent_idx=dev(plan.parent_idx),
        parent_count=plan.parent_count, node_binder=dev(plan.node_binder),
        binder_len=plan.binder_len,
        onehot_idx=dev(plan.onehot_idx[:plan.onehot_rows]),
        payload_parent=dev(plan.payload_parent[:plan.payload_rows]),
        payload_left=dev(plan.payload_left[:plan.payload_rows]),
        payload_right=dev(plan.payload_right[:plan.payload_rows]),
        out_idx=dev(plan.out_idx))


class IncrementalMastic:
    """The incremental round engine for one BatchedMastic instance."""

    def __init__(self, bm: BatchedMastic, width: int):
        assert width >= 2 and width & (width - 1) == 0
        self.bm = bm
        self.width = width
        self.bits = bm.m.bits

    def init_carry(self, num_reports: int, keys: torch.Tensor,
                   agg_id: int) -> Carry:
        """Pre-round-0 carry: the frontier is the root key."""
        dev = keys.device
        spec = self.bm.spec
        seed = torch.zeros((num_reports, self.width, KEY_SIZE),
                           dtype=torch.uint8, device=dev)
        seed[:, 0, :] = keys
        ctrl = torch.zeros((num_reports, self.width), dtype=torch.bool,
                           device=dev)
        ctrl[:, 0] = bool(agg_id)
        return Carry(
            w=torch.zeros((num_reports, self.bits, self.width,
                           self.bm.vidpf.VALUE_LEN, spec.num_limbs),
                          dtype=torch.int32, device=dev),
            proof=torch.zeros((num_reports, self.bits, self.width,
                               PROOF_SIZE), dtype=torch.uint8, device=dev),
            seed=seed, ctrl=ctrl)

    # -- one round ---------------------------------------------------

    def agg_round(self, agg_id: int, verify_key: bytes, ctx: bytes,
                  carry: Carry, rnd: IncrementalRound,
                  ext_rk: torch.Tensor, conv_rk: torch.Tensor,
                  cws) -> tuple:
        """Evaluate the new level, refresh the carry, emit the eval
        proof and the (padded) truncated out share.

        The new depth row is written into carry.w and carry.proof in
        place (the JAX package donates the carry to the same effect).
        Returns (carry', eval_proof (R, 32), out_share (R,
        capOut*(1+OUTPUT_LEN), n), ok (R,))."""
        return self.agg_rounds((agg_id,), verify_key, ctx, (carry,), rnd,
                               ext_rk, conv_rk, cws)[0]

    def agg_rounds(self, agg_ids: tuple, verify_key: bytes, ctx: bytes,
                   carries: tuple, rnd: IncrementalRound,
                   ext_rk: torch.Tensor, conv_rk: torch.Tensor,
                   cws) -> list:
        """`agg_round` for each aggregator in `agg_ids` with its carry:
        the level steps one after another, then every aggregator's
        binder checks in one sponge launch.  Returns one agg_round
        result per aggregator."""
        bm = self.bm
        spec = bm.spec
        cw_slice = tuple(x[:, rnd.level] for x in
                         (cws.seed, cws.ctrl, cws.w, cws.proof))
        steps = []
        for carry in carries:
            parents = EvalState(seed=carry.seed[:, rnd.parent_idx],
                                ctrl=carry.ctrl[:, rnd.parent_idx],
                                w=None, proof=None)
            (child, ok) = self._eval_step_dynamic(ext_rk, conv_rk, parents,
                                                  cw_slice, ctx, rnd)
            carry.w[:, rnd.level] = child.w
            carry.proof[:, rnd.level] = child.proof
            steps.append((child, ok))

        eval_proofs = self._eval_proofs(
            agg_ids, verify_key, ctx, tuple(c.w for c in carries),
            tuple(c.proof for c in carries), rnd)

        out = []
        for (agg_id, carry, (child, ok), eval_proof) in zip(
                agg_ids, carries, steps, eval_proofs):
            out_w = child.w[:, rnd.out_idx]
            if agg_id == 1:
                out_w = spec.neg(out_w)
            out.append((Carry(w=carry.w, proof=carry.proof, seed=child.seed,
                              ctrl=child.ctrl), eval_proof,
                        bm.out_share(out_w), ok))
        return out

    def _eval_step_dynamic(self, ext_rk: torch.Tensor,
                           conv_rk: torch.Tensor, parents: EvalState,
                           cw_slice, ctx: bytes,
                           rnd: IncrementalRound) -> tuple:
        """The level step with the runtime-length node-proof binder,
        through kernel K3.  Only live parent lanes count toward the
        rejection mask."""
        vid = self.bm.vidpf
        prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), KEY_SIZE)
        (next_seed, ct, w, ok, proof) = level_step(
            vid.spec, vid.convert_blocks, vid.VALUE_LEN, ext_rk, conv_rk,
            parents.seed, parents.ctrl, cw_slice, prefix, rnd.node_binder,
            rnd.binder_len)
        child = EvalState(seed=next_seed, ctrl=ct, w=w, proof=proof)
        dead = torch.arange(ok.shape[-1], device=ok.device) \
            >= 2 * rnd.parent_count
        return (child, torch.all(ok | dead, dim=-1))

    def _eval_proof(self, agg_id: int, verify_key: bytes, ctx: bytes,
                    w_all: torch.Tensor, proof_all: torch.Tensor,
                    rnd: IncrementalRound) -> torch.Tensor:
        """The three checks over one aggregator's carried tree, hashed
        with their runtime-length binders."""
        return self._eval_proofs((agg_id,), verify_key, ctx, (w_all,),
                                 (proof_all,), rnd)[0]

    def _eval_proofs(self, agg_ids: tuple, verify_key: bytes, ctx: bytes,
                     ws: tuple, proofs: tuple,
                     rnd: IncrementalRound) -> list:
        """`_eval_proof` for each aggregator, in one `binder_checks`
        call (`BatchedMastic.eval_proofs`, which the from-root prep
        calls too) over the carries and the round's index lists."""
        return self.bm.eval_proofs(agg_ids, verify_key, ctx, ws, proofs,
                                   rnd.onehot_idx, rnd.payload_parent,
                                   rnd.payload_left, rnd.payload_right)
