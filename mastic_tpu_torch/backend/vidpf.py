"""Batched VIDPF: dense level-synchronous gen / eval over torch tensors
(port of `mastic_tpu/backend/vidpf_jax.py`).

The per-report pointer tree is replaced by (reports x nodes) tensors:
one fixed-key AES schedule per (report, usage), reused for every node;
within a level all nodes extend / correct / convert / hash in one
batch; the level loop is the only sequential axis.  Every
secret-dependent choice is a lane select (torch.where) or a mask AND.

Field payloads are plain 16-bit limbs (int32, ops/field.py).
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..obs import trace as obs_trace
from ..ops.field import FIELD64, FieldSpec
from ..ops.keccak import turbo_shake128_dynamic
from ..ops.level import level_step
from ..scalar.common import to_le_bytes
from ..scalar.dst import USAGE_CONVERT, USAGE_EXTEND, USAGE_NODE_PROOF, dst
from ..scalar.vidpf import PROOF_SIZE, Vidpf
from .schedule import LevelSchedule, ScheduleInputs, schedule_inputs
from .xof import fixed_key_blocks, fixed_key_schedule, sample_vec, ts_prefix

_U8 = torch.uint8
KEY_SIZE = Vidpf.KEY_SIZE


class BatchedCorrectionWords(NamedTuple):
    """Correction words for a report batch, one slice per tree level.

    seed  (R, BITS, 16) uint8
    ctrl  (R, BITS, 2) bool       [left, right]
    w     (R, BITS, VALUE_LEN, n) int32 plain limbs
    proof (R, BITS, 32) uint8
    """
    seed: torch.Tensor
    ctrl: torch.Tensor
    w: torch.Tensor
    proof: torch.Tensor


class EvalState(NamedTuple):
    """One level's node states for a report batch."""
    seed: torch.Tensor   # (R, N, 16) uint8
    ctrl: torch.Tensor   # (R, N) bool
    w: torch.Tensor      # (R, N, VALUE_LEN, n) int32 plain limbs
    proof: torch.Tensor  # (R, N, 32) uint8


def pack_path_bits(bits_arr: torch.Tensor) -> torch.Tensor:
    """MSB-first bit packing of (..., L) bools -> (..., ceil(L/8))
    uint8."""
    length = bits_arr.shape[-1]
    nbytes = (length + 7) // 8
    padded = bits_arr.new_zeros(bits_arr.shape[:-1] + (nbytes * 8,),
                                dtype=torch.int32)
    padded[..., :length] = bits_arr.to(torch.int32)
    weights = torch.as_tensor((1 << (7 - np.arange(8))).astype(np.int32),
                              device=bits_arr.device)
    grouped = padded.reshape(padded.shape[:-1] + (nbytes, 8))
    return (grouped * weights).sum(-1).to(_U8)


class BatchedVidpf:
    """Batched VIDPF with input length `bits` and payload length
    `value_len` over the field of `spec` (Field64 by default)."""

    def __init__(self, bits: int, value_len: int, spec: FieldSpec = FIELD64):
        self.spec = spec
        self.BITS = bits
        self.VALUE_LEN = value_len
        # Convert reads a 16-byte next seed then VALUE_LEN elements.
        payload_bytes = value_len * self.spec.encoded_size
        self.convert_blocks = 1 + (payload_bytes + 15) // 16
        # The node-axis hook: a `parallel.grid.GridSplit` splits the
        # from-root preps over a mesh's node ranks (set by
        # `parallel.install_grid_sharding`; None: unsplit).
        self.constrain_state = None

    # -- per-report key schedules ----------------------------------

    def roundkeys(self, ctx: bytes, nonces: torch.Tensor) -> tuple:
        """The two fixed-key AES schedules per report: (extend rk,
        convert rk), each (R, 11, 16)."""
        batch = nonces.shape[:-1]
        ext = fixed_key_schedule(dst(ctx, USAGE_EXTEND), nonces, batch)
        conv = fixed_key_schedule(dst(ctx, USAGE_CONVERT), nonces, batch)
        return (ext, conv)

    # -- the per-node primitives -----------------------------------

    def extend(self, ext_rk: torch.Tensor, seeds: torch.Tensor) -> tuple:
        """Extend seeds (R, N..., 16) into left/right child seeds and
        control bits (the LSB of byte 0, then cleared)."""
        blocks = fixed_key_blocks(ext_rk, seeds, 2)
        (s_l, s_r) = (blocks[..., :16].clone(), blocks[..., 16:].clone())
        t_l = (s_l[..., 0] & 1).to(torch.bool)
        t_r = (s_r[..., 0] & 1).to(torch.bool)
        s_l[..., 0] &= 0xFE
        s_r[..., 0] &= 0xFE
        return ((s_l, s_r), (t_l, t_r))

    def convert(self, conv_rk: torch.Tensor, seeds: torch.Tensor) -> tuple:
        """Convert seeds (R, N..., 16) -> (next seed, payload limbs,
        in-range mask per node)."""
        stream = fixed_key_blocks(conv_rk, seeds, self.convert_blocks)
        next_seed = stream[..., :16]
        (w, ok) = sample_vec(self.spec, stream, self.VALUE_LEN, offset=16)
        return (next_seed, w, ok)

    # -- key generation (client side) ------------------------------

    def _node_proof_dynamic(self, ctx: bytes, seeds: torch.Tensor,
                            path: torch.Tensor, i: int) -> torch.Tensor:
        """Node proof at level i over prefix | seed | BITS | le16(i) |
        packed path, hashed over its length (path bytes = i//8 + 1).
        seeds (R, S, 16); path (R, cap) is shared by the S seeds."""
        (num_reports, num_seeds) = seeds.shape[:2]
        prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), KEY_SIZE)
        tail = to_le_bytes(self.BITS, 2) + to_le_bytes(i, 2)
        shape = (num_reports, num_seeds)
        msg = torch.cat([
            torch.as_tensor(np.frombuffer(prefix, np.uint8).copy(),
                            device=seeds.device).expand(shape + (-1,)),
            seeds,
            torch.as_tensor(np.frombuffer(tail, np.uint8).copy(),
                            device=seeds.device).expand(shape + (-1,)),
            path[:, None, :].expand(shape + (-1,)),
        ], dim=-1)
        length = len(prefix) + KEY_SIZE + 4 + i // 8 + 1
        return turbo_shake128_dynamic(msg, length, 1, PROOF_SIZE)

    def gen(self, alphas: torch.Tensor, betas: torch.Tensor, ctx: bytes,
            nonces: torch.Tensor, rand: torch.Tensor) -> tuple:
        """Batched VIDPF key generation.

        alphas (R, BITS) bool; betas (R, VALUE_LEN, n) plain limbs;
        nonces (R, 16); rand (R, 32) uint8.
        Returns (BatchedCorrectionWords, keys (R, 2, 16), ok (R,)).
        Both parties' seeds go through each extend, convert and node
        proof together (one kernel launch each per level)."""
        (num_reports, bits) = alphas.shape
        assert bits == self.BITS
        spec = self.spec
        (ext_rk, conv_rk) = self.roundkeys(ctx, nonces)
        keys = torch.stack([rand[:, :KEY_SIZE], rand[:, KEY_SIZE:]], dim=1)

        # Per-level packed on-path prefixes: level i keeps the path's
        # first i+1 bits (MSB-first packing => masking trailing bits).
        path_cap = (bits + 7) // 8
        packed_full = pack_path_bits(alphas)               # (R, cap)
        byte_idx = np.arange(path_cap)

        seeds = keys.clone()                               # (R, 2, 16)
        dev = alphas.device
        ctrl = torch.zeros((num_reports, 2), dtype=torch.bool, device=dev)
        ctrl[:, 1] = True
        ok = torch.ones(num_reports, dtype=torch.bool, device=dev)
        # Filled level by level: a long payload's correction words are
        # most of the batch (17 GB at 4096 reports of SumVec(1024) at
        # 128 bits), so no second copy is stacked at the end.
        cws = BatchedCorrectionWords(
            seed=torch.empty((num_reports, bits, KEY_SIZE), dtype=_U8,
                             device=dev),
            ctrl=torch.empty((num_reports, bits, 2), dtype=torch.bool,
                             device=dev),
            w=torch.empty((num_reports, bits, self.VALUE_LEN,
                           spec.num_limbs), dtype=torch.int32, device=dev),
            proof=torch.empty((num_reports, bits, PROOF_SIZE), dtype=_U8,
                              device=dev))
        for i in range(bits):
            bit = alphas[:, i]
            keep = np.where(byte_idx * 8 + 7 <= i, 0xFF,
                            np.where(byte_idx * 8 <= i,
                                     (0xFF << (7 - i % 8)) & 0xFF, 0))
            path = packed_full & torch.as_tensor(keep.astype(np.uint8),
                                                 device=alphas.device)

            ((s_l, s_r), (t_l, t_r)) = self.extend(ext_rk, seeds)
            # The losing child's seeds are forced to collide; control
            # corrections make on-path ctrl bits shares of 1.
            sel = bit[:, None]
            seed_cw = torch.where(sel, s_l[:, 0] ^ s_l[:, 1],
                                  s_r[:, 0] ^ s_r[:, 1])
            ctrl_cw_l = t_l[:, 0] ^ t_l[:, 1] ^ ~bit
            ctrl_cw_r = t_r[:, 0] ^ t_r[:, 1] ^ bit

            s_k = torch.where(sel[:, None], s_r, s_l)          # (R, 2, 16)
            t_k = torch.where(bit[:, None], t_r, t_l)          # (R, 2)
            ctrl_cw_keep = torch.where(bit, ctrl_cw_r, ctrl_cw_l)
            s_k = torch.where(ctrl[..., None], s_k ^ seed_cw[:, None], s_k)
            t_k = t_k ^ (ctrl & ctrl_cw_keep[:, None])

            (seeds, w, c_ok) = self.convert(conv_rk, s_k)
            ok = ok & c_ok.all(-1)

            # Payload correction: on-path shares must sum to beta.
            w_cw = spec.add(spec.sub(betas, w[:, 0]), w[:, 1])
            w_cw = torch.where(t_k[:, 1, None, None], spec.neg(w_cw), w_cw)

            # Node-proof correction, binding the on-path prefix.
            proofs = self._node_proof_dynamic(ctx, seeds.contiguous(),
                                              path, i)
            cws.seed[:, i] = seed_cw
            cws.ctrl[:, i, 0] = ctrl_cw_l
            cws.ctrl[:, i, 1] = ctrl_cw_r
            cws.w[:, i] = w_cw
            cws.proof[:, i] = proofs[:, 0] ^ proofs[:, 1]
            ctrl = t_k
        return (cws, keys, ok)

    # -- evaluation from the root (aggregator side) ------------------

    def root_state(self, agg_id: int, keys: torch.Tensor) -> EvalState:
        """The pre-level-0 state: root seed = the party's key (R, 16),
        root ctrl = agg_id."""
        return EvalState(
            seed=keys[:, None, :],
            ctrl=torch.full((keys.shape[0], 1), bool(agg_id),
                            dtype=torch.bool, device=keys.device),
            w=None, proof=None)

    def eval_step(self, ext_rk: torch.Tensor, conv_rk: torch.Tensor,
                  parents: EvalState, cw_slice, ctx: bytes,
                  node_binder: torch.Tensor, binder_len: int) -> tuple:
        """One tree level through kernel K3: extend every parent,
        correct, convert and hash both children, with the first
        `binder_len` bytes of each row of node_binder (2N, B) uint8 as
        the node-proof binders.  Returns (EvalState of the children,
        ok (R,))."""
        prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), KEY_SIZE)
        (next_seed, ct, w, ok, proof) = level_step(
            self.spec, self.convert_blocks, self.VALUE_LEN, ext_rk, conv_rk,
            parents.seed, parents.ctrl, cw_slice, prefix, node_binder,
            binder_len)
        return (EvalState(seed=next_seed, ctrl=ct, w=w, proof=proof),
                torch.all(ok, dim=-1))

    def eval_full(self, agg_id: int, cws: BatchedCorrectionWords,
                  keys: torch.Tensor, sched: ScheduleInputs, ctx: bytes,
                  nonces: torch.Tensor) -> tuple:
        """Evaluate the whole grid of `sched` from the root, one level
        step a depth.  Each depth's children are copied into one flat
        buffer at the depth's offset; only the newest depth's seeds and
        ctrl bits are kept besides.

        Returns (w (R, T, VALUE_LEN, n) unnegated payloads, proof (R, T,
        32) node proofs, both over the T = total_nodes nodes in BFS
        order; out_w (R, P, VALUE_LEN, n) payload shares in the caller's
        prefix order, negated for aggregator 1; ok (R,)).  The walk's
        enqueueing is the span `vidpf.eval_full`."""
        with obs_trace.get_tracer().span("vidpf.eval_full", agg_id=agg_id):
            (ext_rk, conv_rk) = self.roundkeys(ctx, nonces)
            num_reports = keys.shape[0]
            dev = keys.device
            total = sched.total_nodes
            w_all = torch.empty((num_reports, total, self.VALUE_LEN,
                                 self.spec.num_limbs), dtype=torch.int32,
                                device=dev)
            proof_all = torch.empty((num_reports, total, PROOF_SIZE),
                                    dtype=_U8, device=dev)
            state = self.root_state(agg_id, keys)
            ok = torch.ones(num_reports, dtype=torch.bool, device=dev)
            for d in range(sched.level + 1):
                if d:
                    pidx = sched.parents(d)
                    state = EvalState(seed=state.seed[:, pidx],
                                      ctrl=state.ctrl[:, pidx], w=None,
                                      proof=None)
                cw_slice = (cws.seed[:, d], cws.ctrl[:, d], cws.w[:, d],
                            cws.proof[:, d])
                (lo, hi) = sched.offset[d:d + 2]
                (state, step_ok) = self.eval_step(
                    ext_rk, conv_rk, state, cw_slice, ctx,
                    sched.node_binder[lo:hi], sched.binder_len[d])
                ok = ok & step_ok
                w_all[:, lo:hi] = state.w
                proof_all[:, lo:hi] = state.proof
            out_w = state.w[:, sched.out_index]
            if agg_id == 1:
                out_w = self.spec.neg(out_w)
        return (w_all, proof_all, out_w, ok)

    def get_beta_share(self, agg_id: int, cws: BatchedCorrectionWords,
                       keys: torch.Tensor, ctx: bytes,
                       nonces: torch.Tensor) -> tuple:
        """Each party's beta share: the sum of its two depth-0 payloads
        from a depth-0 `eval_full`, negated for aggregator 1.  Returns
        (share (R, VALUE_LEN, n), ok (R,))."""
        sched = schedule_inputs(LevelSchedule([(False,), (True,)], 0,
                                              self.BITS), keys.device)
        (w, _proof, _out, ok) = self.eval_full(agg_id, cws, keys, sched,
                                               ctx, nonces)
        share = self.spec.add(w[:, 0], w[:, 1])
        if agg_id == 1:
            share = self.spec.neg(share)
        return (share, ok)

    # -- scalar correction words in and out (test and wire boundary) --

    def cws_from_host(self, batches: list,
                      device="cuda") -> BatchedCorrectionWords:
        """Scalar correction words, one list of (seed, [ctrl_l, ctrl_r],
        payload, proof) per report, as tensors on `device`.  Payload
        elements are read through their `.int()`."""
        num_reports = len(batches)
        seed = np.zeros((num_reports, self.BITS, KEY_SIZE), np.uint8)
        ctrl = np.zeros((num_reports, self.BITS, 2), bool)
        w = np.zeros((num_reports, self.BITS, self.VALUE_LEN,
                      self.spec.num_limbs), np.int32)
        proof = np.zeros((num_reports, self.BITS, PROOF_SIZE), np.uint8)
        for (r, cws) in enumerate(batches):
            for (d, (s, c, wv, p)) in enumerate(cws):
                seed[r, d] = np.frombuffer(s, np.uint8)
                ctrl[r, d] = c
                for (j, el) in enumerate(wv):
                    w[r, d, j] = self.spec.int_to_limbs(el.int())
                proof[r, d] = np.frombuffer(p, np.uint8)
        device = resolve_device(device)
        return BatchedCorrectionWords(*(torch.as_tensor(x, device=device)
                                        for x in (seed, ctrl, w, proof)))

    def cws_to_host(self, cws: BatchedCorrectionWords, report: int,
                    field=int) -> list:
        """One report's correction words as scalar (seed, [ctrl_l,
        ctrl_r], payload, proof) tuples, payload elements built by
        `field` from their integer values."""
        (seed, ctrl, w, proof) = (x[report].cpu().numpy() for x in cws)
        return [(seed[d].tobytes(), [bool(ctrl[d, 0]), bool(ctrl[d, 1])],
                 self.w_to_host(w[d], field), proof[d].tobytes())
                for d in range(self.BITS)]

    def w_to_host(self, w, field=int) -> list:
        """(..., VALUE_LEN, n) plain limbs -> nested lists of `field`
        elements built from their integer values."""
        arr = w.cpu().numpy() if isinstance(w, torch.Tensor) else w
        if arr.ndim == 2:
            return [field(self.spec.limbs_to_int(arr[j]))
                    for j in range(arr.shape[0])]
        return [self.w_to_host(arr[i], field) for i in range(arr.shape[0])]
