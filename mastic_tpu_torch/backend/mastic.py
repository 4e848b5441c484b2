"""Batched Mastic: client sharding, the FLP weight check and masked
aggregation over whole report batches (port of
`mastic_tpu/backend/mastic_jax.py`).

The five instantiations (`MasticCount`, `MasticSum`, `MasticSumVec`,
`MasticHistogram`, `MasticMultihotCountVec`) carry the parameters the
batched engine reads; `Mastic.scalar()` gives the matching instance of
the scalar layer (`scalar/mastic.py`), which the drivers run one report
at a time where the batched XOF sampling fired.  The three
ParallelSum circuits run over Field128 with joint randomness: the
client derives both aggregators' joint-rand parts from their depth-0
beta shares, and each aggregator's input share carries its peer's part.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..flp.circuits import (Count, Histogram, MultihotCountVec, Sum,
                            SumVec)
from ..flp.flp import BatchedFlp
from ..ops.binder import binder_checks
from ..ops.field import field_sum, spec_for
from ..scalar import mastic as scalar_mastic
from ..scalar.common import to_le_bytes
from ..scalar.dst import (USAGE_EVAL_PROOF, USAGE_JOINT_RAND,
                          USAGE_JOINT_RAND_PART, USAGE_JOINT_RAND_SEED,
                          USAGE_ONEHOT_CHECK, USAGE_PAYLOAD_CHECK,
                          USAGE_PROOF_SHARE, USAGE_PROVE_RAND,
                          USAGE_QUERY_RAND, dst_alg)
from ..scalar.vidpf import PROOF_SIZE, Vidpf
from ..scalar.xof import XofTurboShake128
from .schedule import LevelSchedule, ScheduleInputs, schedule_inputs
from .vidpf import BatchedCorrectionWords, BatchedVidpf
from .xof import sample_vec, turboshake_xof, ts_prefix

SEED_SIZE = XofTurboShake128.SEED_SIZE


class Mastic:
    """Mastic over one validity circuit with `bits`-bit inputs: the
    parameters the batched engine reads.  Each instantiation names its
    scalar twin (`SCALAR`) and the arguments both are built from."""

    ID = 0xFFFFFFFF
    NONCE_SIZE = scalar_mastic.Mastic.NONCE_SIZE
    VERIFY_KEY_SIZE = SEED_SIZE
    VIDPF_RAND_SIZE = Vidpf.RAND_SIZE
    SCALAR: Optional[type] = None

    def __init__(self, bits: int, valid, *args):
        self.bits = bits
        self.valid = valid
        self.field = valid.field
        self.value_len = 1 + valid.MEAS_LEN
        self.RAND_SIZE = self.VIDPF_RAND_SIZE + 2 * SEED_SIZE
        if valid.JOINT_RAND_LEN > 0:  # the leader's joint-rand seed
            self.RAND_SIZE += SEED_SIZE
        self._args = (bits,) + args
        self._scalar = None

    def scalar(self):
        """The matching instance of the scalar layer (`scalar/mastic.py`:
        the same ID, bits and circuit parameters), built once."""
        if self.SCALAR is None:
            raise TypeError(f"{type(self).__name__} has no scalar twin")
        if self._scalar is None:
            self._scalar = self.SCALAR(*self._args)
        return self._scalar

    def is_valid(self, agg_param, previous_agg_params: list) -> bool:
        """The weight check happens exactly once, on the first round,
        and the level strictly increases between rounds."""
        (level, _prefixes, do_weight_check) = agg_param
        weight_checked = \
            (do_weight_check and len(previous_agg_params) == 0) or \
            (not do_weight_check and
             any(prev[2] for prev in previous_agg_params))
        level_increased = len(previous_agg_params) == 0 or \
            level > previous_agg_params[-1][0]
        return weight_checked and level_increased

    def unshard(self, agg_shares: list) -> list:
        """Merge the two aggregate shares (lists of ints mod p) and
        decode: per prefix, chunks of 1 + OUTPUT_LEN (the counter, then
        the truncated weight)."""
        p = self.field.MODULUS
        agg = [(a + b) % p for (a, b) in zip(*agg_shares)]
        width = 1 + self.valid.OUTPUT_LEN
        return [self.valid.decode(agg[i + 1:i + width])
                for i in range(0, len(agg), width)]


class MasticCount(Mastic):
    ID = 0xFFFF0001
    SCALAR = scalar_mastic.MasticCount

    def __init__(self, bits: int):
        super().__init__(bits, Count())


class MasticSum(Mastic):
    ID = 0xFFFF0002
    SCALAR = scalar_mastic.MasticSum

    def __init__(self, bits: int, max_measurement: int):
        super().__init__(bits, Sum(max_measurement), max_measurement)


class MasticSumVec(Mastic):
    ID = 0xFFFF0003
    SCALAR = scalar_mastic.MasticSumVec

    def __init__(self, bits: int, length: int, sum_vec_bits: int,
                 chunk_length: int):
        super().__init__(bits, SumVec(length, sum_vec_bits, chunk_length),
                         length, sum_vec_bits, chunk_length)


class MasticHistogram(Mastic):
    ID = 0xFFFF0004
    SCALAR = scalar_mastic.MasticHistogram

    def __init__(self, bits: int, length: int, chunk_length: int):
        super().__init__(bits, Histogram(length, chunk_length), length,
                         chunk_length)


class MasticMultihotCountVec(Mastic):
    ID = 0xFFFF0005
    SCALAR = scalar_mastic.MasticMultihotCountVec

    def __init__(self, bits: int, length: int, max_weight: int,
                 chunk_length: int):
        super().__init__(bits, MultihotCountVec(length, max_weight,
                                                chunk_length),
                         length, max_weight, chunk_length)


class ReportBatch(NamedTuple):
    """A report batch as device tensors."""
    nonces: torch.Tensor              # (R, 16) uint8
    cws: BatchedCorrectionWords
    keys: torch.Tensor                # (R, 2, 16) uint8
    leader_proofs: torch.Tensor       # (R, PROOF_LEN, n) int32 plain limbs
    helper_seeds: torch.Tensor        # (R, 32) uint8
    leader_seeds: Optional[torch.Tensor] = None   # (R, 32) or None
    peer_parts: tuple = (None, None)  # per aggregator: (R, 32) or None

    def tensors(self) -> list:
        """Every tensor of the batch, in a fixed order (None left out)."""
        return [t for t in (self.nonces, *self.cws, self.keys,
                            self.leader_proofs, self.helper_seeds,
                            self.leader_seeds, *self.peer_parts)
                if t is not None]


class BatchedPrep(NamedTuple):
    """Per-report results of one aggregator's from-root prep.

    out_share    (R, P*(1+OUTPUT_LEN), n) plain limbs
    eval_proof   (R, 32) uint8
    verifier     (R, VERIFIER_LEN, n) plain limbs: this aggregator's FLP
                 verifier share (weight-check rounds), else None
    joint_rand_part / joint_rand_seed  (R, 32) uint8 (joint-rand
                 circuits on weight-check rounds), else None
    ok           (R,) bool: False where XOF rejection sampling fired
    """
    out_share: torch.Tensor
    eval_proof: torch.Tensor
    verifier: Optional[torch.Tensor]
    joint_rand_part: Optional[torch.Tensor]
    joint_rand_seed: Optional[torch.Tensor]
    ok: torch.Tensor


class BatchedMastic:
    """Batched execution engine for one Mastic instantiation."""

    def __init__(self, mastic: Mastic):
        self.m = mastic
        self.spec = spec_for(mastic.field)
        self.vidpf = BatchedVidpf(mastic.bits, mastic.value_len, self.spec)
        self.bflp = BatchedFlp(mastic.valid)
        self._trunc = self._truncate_map()
        self._trunc_dev: dict = {}

    # -- truncation as a static linear map -------------------------

    def _truncate_map(self) -> tuple:
        """Every circuit's truncate() is linear (identity, projection or
        bit recomposition): a gather where each output is one input,
        else a constant Montgomery matrix."""
        valid = self.m.valid
        meas_len = valid.MEAS_LEN
        cols = []
        for j in range(meas_len):
            unit = [0] * meas_len
            unit[j] = 1
            cols.append(valid.truncate(unit))
        # matrix[out][in]
        matrix = [[cols[j][o] for j in range(meas_len)]
                  for o in range(valid.OUTPUT_LEN)]
        gather = []
        for row in matrix:
            nonzero = [j for j in range(meas_len) if row[j] != 0]
            if len(nonzero) != 1 or row[nonzero[0]] != 1:
                break
            gather.append(nonzero[0])
        else:
            return ("gather", np.array(gather, np.int64))
        mont = np.zeros((valid.OUTPUT_LEN, meas_len, self.spec.num_limbs),
                        np.int64)
        for (o, row) in enumerate(matrix):
            for (j, x) in enumerate(row):
                mont[o, j] = self.spec.to_mont_host(x)
        return ("matrix", mont)

    def truncate(self, w: torch.Tensor) -> torch.Tensor:
        """flp.truncate on plain-limb payloads (..., MEAS_LEN, n) ->
        (..., OUTPUT_LEN, n)."""
        (kind, data) = self._trunc
        # The map goes to the device once: an upload from pageable
        # memory at every round would wait for the stream.
        data_dev = self._trunc_dev.get(w.device)
        if data_dev is None:
            data_dev = torch.as_tensor(data, device=w.device)
            self._trunc_dev[w.device] = data_dev
        if kind == "gather":
            return w[..., data_dev, :]
        prods = self.spec.mul(w[..., None, :, :], data_dev)
        return field_sum(self.spec, prods, axis=-2)

    def out_share(self, out_w: torch.Tensor) -> torch.Tensor:
        """Per prefix [counter] + truncate(weight): payload shares (R,
        P, VALUE_LEN, n) -> (R, P*(1+OUTPUT_LEN), n)."""
        trunc = self.truncate(out_w[..., 1:, :])
        return torch.cat([out_w[..., :1, :], trunc], dim=-2).reshape(
            out_w.shape[0], -1, self.spec.num_limbs)

    # -- the eval proof --------------------------------------------

    def eval_proofs(self, agg_ids: tuple, verify_key: bytes, ctx: bytes,
                    ws: tuple, proofs: tuple, onehot_idx: torch.Tensor,
                    par: torch.Tensor, left: torch.Tensor,
                    right: torch.Tensor) -> list:
        """The eval proof of each aggregator in `agg_ids` over its tree:
        ws[i] (R, D, W, VALUE_LEN, n) unnegated payloads and proofs[i]
        (R, D, W, 32) node proofs, whose nodes 0 and 1 of depth 0 are
        the root's children (an incremental carry, or a from-root
        buffer viewed as D = 1); the index lists name rows of the
        flattened (D * W) node axis.  The onehot and payload checks of
        all aggregators are one `binder_checks` call (kernel K1 reads
        the rows where they lie; the plain version gathers them); then,
        per aggregator, the counter check (the root children's share of
        the counter, plus agg_id, so the parties agree iff it is 1) and
        the eval-proof XOF.  Returns one (R, 32) uint8 per aggregator."""
        spec = self.spec
        (onehot, payload) = binder_checks(
            spec, ws, proofs, onehot_idx, par, left, right,
            ts_prefix(dst_alg(ctx, USAGE_ONEHOT_CHECK, self.m.ID), 0),
            ts_prefix(dst_alg(ctx, USAGE_PAYLOAD_CHECK, self.m.ID), 0))
        out = []
        for (i, (agg_id, w_all)) in enumerate(zip(agg_ids, ws)):
            counter = spec.add(w_all[:, 0, 0, 0], w_all[:, 0, 1, 0])
            if agg_id == 1:
                one = np.zeros(spec.num_limbs, np.int64)
                one[0] = 1
                counter = spec.add(counter, one)
            out.append(turboshake_xof(
                dst_alg(ctx, USAGE_EVAL_PROOF, self.m.ID), verify_key,
                (onehot[i], spec.plain_to_le_bytes(counter), payload[i]),
                PROOF_SIZE, (w_all.shape[0],), w_all.device))
        return out

    # -- batched XOF derivations -----------------------------------

    def _expand_vec(self, seed, usage: int, ctx: bytes, binder_parts,
                    length: int, batch_shape, device) -> tuple:
        stream = turboshake_xof(dst_alg(ctx, usage, self.m.ID), seed,
                                binder_parts, length * self.spec.encoded_size,
                                batch_shape, device)
        return sample_vec(self.spec, stream, length)

    def helper_proof_share(self, ctx: bytes, seeds: torch.Tensor) -> tuple:
        return self._expand_vec(seeds, USAGE_PROOF_SHARE, ctx, (),
                                self.m.valid.PROOF_LEN, seeds.shape[:-1],
                                seeds.device)

    def prove_rand(self, ctx: bytes, seeds: torch.Tensor) -> tuple:
        return self._expand_vec(seeds, USAGE_PROVE_RAND, ctx, (),
                                self.m.valid.PROVE_RAND_LEN,
                                seeds.shape[:-1], seeds.device)

    def query_rand(self, verify_key: bytes, ctx: bytes,
                   nonces: torch.Tensor, level: int) -> tuple:
        return self._expand_vec(
            verify_key, USAGE_QUERY_RAND, ctx,
            (nonces, to_le_bytes(level, 2)),
            self.m.valid.QUERY_RAND_LEN, nonces.shape[:-1], nonces.device)

    def joint_rand_part(self, ctx: bytes, seeds: torch.Tensor,
                        weight_share: torch.Tensor,
                        nonces: torch.Tensor) -> torch.Tensor:
        """One party's joint-rand part: bound to the nonce and its
        weight share (..., MEAS_LEN, n)."""
        encoded = self.spec.plain_to_le_bytes(weight_share).reshape(
            weight_share.shape[:-2] + (-1,))
        return turboshake_xof(
            dst_alg(ctx, USAGE_JOINT_RAND_PART, self.m.ID), seeds,
            (torch.cat([nonces, encoded], dim=-1),), SEED_SIZE,
            seeds.shape[:-1], seeds.device)

    def joint_rand_seed(self, ctx: bytes, part0: torch.Tensor,
                        part1: torch.Tensor) -> torch.Tensor:
        return turboshake_xof(
            dst_alg(ctx, USAGE_JOINT_RAND_SEED, self.m.ID), b"",
            (part0, part1), SEED_SIZE, part0.shape[:-1], part0.device)

    def joint_rand(self, ctx: bytes, seeds: torch.Tensor) -> tuple:
        return self._expand_vec(seeds, USAGE_JOINT_RAND, ctx, (),
                                self.m.valid.JOINT_RAND_LEN,
                                seeds.shape[:-1], seeds.device)

    # -- batched client shard --------------------------------------

    def encode_measurements(self, measurements: list,
                            device="cuda") -> tuple:
        """[(alpha path, weight)] -> (alphas (R, BITS) bool, betas (R,
        VALUE_LEN, n) plain limbs with the counter 1 first), on
        `device`."""
        device = resolve_device(device)
        num = len(measurements)
        alphas = np.zeros((num, self.m.bits), bool)
        # Every circuit's encoding is below 2^64 (bits, one-hot entries,
        # weights); a larger value would raise here, not wrap.
        values = np.zeros((num, self.m.value_len), np.uint64)
        values[:, 0] = 1
        for (r, (alpha, weight)) in enumerate(measurements):
            alphas[r] = alpha
            values[r, 1:] = self.m.valid.encode(weight)
        betas = np.zeros((num, self.m.value_len, self.spec.num_limbs),
                         np.int32)
        for i in range(4):
            betas[..., i] = (values >> np.uint64(16 * i)) & np.uint64(0xFFFF)
        return (torch.as_tensor(alphas, device=device),
                torch.as_tensor(betas, device=device))

    def shard_device(self, ctx: bytes, alphas: torch.Tensor,
                     betas: torch.Tensor, nonces: torch.Tensor,
                     rand: torch.Tensor) -> tuple:
        """Batched client sharding of a whole report batch.

        alphas (R, BITS) bool; betas (R, VALUE_LEN, n) plain limbs;
        nonces (R, 16); rand (R, RAND_SIZE) uint8, split as the scalar
        layer splits it.  Returns (ReportBatch, ok): lanes where XOF
        rejection sampling fired carry garbage."""
        use_jr = self.m.valid.JOINT_RAND_LEN > 0
        vs = self.m.VIDPF_RAND_SIZE
        vidpf_rand = rand[:, :vs]
        prove_seed = rand[:, vs:vs + SEED_SIZE].contiguous()
        helper_seed = rand[:, vs + SEED_SIZE:vs + 2 * SEED_SIZE].contiguous()
        leader_seed = (rand[:, vs + 2 * SEED_SIZE:vs + 3 * SEED_SIZE]
                       .contiguous() if use_jr else None)

        (cws, keys, ok) = self.vidpf.gen(alphas, betas, ctx, nonces,
                                         vidpf_rand)
        joint_rand = None
        peer_parts: tuple = (None, None)
        if use_jr:
            parts = []
            for (agg_id, seed) in ((0, leader_seed), (1, helper_seed)):
                (share, bok) = self.vidpf.get_beta_share(
                    agg_id, cws, keys[:, agg_id], ctx, nonces)
                ok = ok & bok
                parts.append(self.joint_rand_part(ctx, seed, share[..., 1:, :],
                                                  nonces))
            (joint_rand, jok) = self.joint_rand(
                ctx, self.joint_rand_seed(ctx, parts[0], parts[1]))
            ok = ok & jok
            # Each party's input share carries the peer's part.
            peer_parts = (parts[1], parts[0])

        (prove_rand, pok) = self.prove_rand(ctx, prove_seed)
        proof = self.bflp.prove(betas[..., 1:, :], prove_rand, joint_rand)
        (helper_share, hok) = self.helper_proof_share(ctx, helper_seed)
        leader_proofs = self.spec.sub(proof, helper_share)
        batch = ReportBatch(nonces=nonces, cws=cws, keys=keys,
                            leader_proofs=leader_proofs,
                            helper_seeds=helper_seed,
                            leader_seeds=leader_seed, peer_parts=peer_parts)
        return (batch, ok & pok & hok)

    # -- the FLP weight check --------------------------------------

    def _weight_check(self, agg_id: int, verify_key: bytes, ctx: bytes,
                      level: int, nonces: torch.Tensor,
                      beta_share: torch.Tensor,
                      proof_shares: Optional[torch.Tensor],
                      seeds: Optional[torch.Tensor],
                      peer_jr_parts: Optional[torch.Tensor]) -> tuple:
        """One aggregator's FLP weight check over its beta share.
        Returns (verifier, joint_rand_part, joint_rand_seed, ok), the
        joint-rand values None for circuits without joint randomness."""
        (query_rand, ok) = self.query_rand(verify_key, ctx, nonces, level)
        expanded_proof = proof_shares
        if agg_id == 1:
            (expanded_proof, pok) = self.helper_proof_share(ctx, seeds)
            ok = ok & pok
        (joint_rand, part, jr_seed) = (None, None, None)
        if self.m.valid.JOINT_RAND_LEN > 0:
            part = self.joint_rand_part(ctx, seeds, beta_share[..., 1:, :],
                                        nonces)
            parts = (part, peer_jr_parts) if agg_id == 0 \
                else (peer_jr_parts, part)
            jr_seed = self.joint_rand_seed(ctx, *parts)
            (joint_rand, jok) = self.joint_rand(ctx, jr_seed)
            ok = ok & jok
        (verifier, vok) = self.bflp.query(
            beta_share[..., 1:, :], expanded_proof, query_rand, joint_rand,
            2)
        return (verifier, part, jr_seed, ok & vok)

    def weight_check_device(self, verify_key: bytes, ctx: bytes,
                            level: int, batch: ReportBatch,
                            w0_pair: torch.Tensor,
                            w1_pair: torch.Tensor) -> tuple:
        """Both aggregators' FLP weight check from their unnegated
        depth-0 child payloads w{a}_pair (R, 2, VALUE_LEN, n).
        Returns (checks {"weight_check": (R,) bool, and for joint-rand
        circuits "joint_rand": the two parties' joint-rand seeds
        agree}, ok (R,))."""
        results = []
        ok = None
        for (agg_id, w_pair) in ((0, w0_pair), (1, w1_pair)):
            beta_share = self.spec.add(w_pair[:, 0], w_pair[:, 1])
            if agg_id == 1:
                beta_share = self.spec.neg(beta_share)
            (verifier, _part, jr_seed, aok) = self._weight_check(
                agg_id, verify_key, ctx, level, batch.nonces, beta_share,
                batch.leader_proofs if agg_id == 0 else None,
                batch.leader_seeds if agg_id == 0 else batch.helper_seeds,
                batch.peer_parts[agg_id])
            results.append((verifier, jr_seed))
            ok = aok if ok is None else ok & aok
        verifier = self.spec.add(results[0][0], results[1][0])
        checks = {"weight_check": self.bflp.decide(verifier)}
        if results[0][1] is not None:
            checks["joint_rand"] = torch.all(results[0][1] == results[1][1],
                                             dim=-1)
        return (checks, ok)

    # -- from-root prep and the round finish ------------------------

    def schedule(self, agg_param, device) -> ScheduleInputs:
        """The round's grid (`LevelSchedule`) uploaded to `device`."""
        (level, prefixes, _wc) = agg_param
        return schedule_inputs(LevelSchedule(prefixes, level, self.m.bits),
                               device)

    def prep(self, agg_id: int, verify_key: bytes, ctx: bytes, agg_param,
             nonces: torch.Tensor, cws: BatchedCorrectionWords,
             keys: torch.Tensor, proof_shares: Optional[torch.Tensor] = None,
             seeds: Optional[torch.Tensor] = None,
             peer_jr_parts: Optional[torch.Tensor] = None,
             sched: Optional[ScheduleInputs] = None) -> BatchedPrep:
        """One aggregator's prep over the report batch, from the root:
        the whole grid through `eval_full` (K3 a depth), the eval proof
        over the flat tree (K1's binder sponge), the truncated out
        shares, and on weight-check rounds the FLP query over the beta
        share the depth-0 children give.

        keys (R, 16): this aggregator's VIDPF keys; proof_shares: the
        leader's FLP proof shares (R, PROOF_LEN, n) (aggregator 0);
        seeds: the helper's FLP seeds (aggregator 1), or the leader's
        joint-rand seeds; peer_jr_parts: the other party's joint-rand
        parts (joint-rand circuits only); sched: the round's uploaded
        grid, built here when None.  Only the returned BatchedPrep
        outlives the call, so one tree buffer is alive at a time.  With
        `vidpf.constrain_state` set (`parallel.install_grid_sharding`)
        the prep is split over a mesh's node ranks, with the same
        result."""
        if sched is None:
            sched = self.schedule(agg_param, nonces.device)
        split = self.vidpf.constrain_state
        if split is not None and split.splits(nonces.shape[0]):
            return split.prep(self, agg_id, verify_key, ctx, agg_param,
                              nonces, cws, keys, proof_shares, seeds,
                              peer_jr_parts, sched)
        (w_all, proof_all, out_w, ok) = self.vidpf.eval_full(
            agg_id, cws, keys, sched, ctx, nonces)
        return self.prep_tree(agg_id, verify_key, ctx, agg_param, sched,
                              w_all, proof_all, out_w, ok, nonces,
                              proof_shares, seeds, peer_jr_parts)

    def prep_tree(self, agg_id: int, verify_key: bytes, ctx: bytes,
                  agg_param, sched: ScheduleInputs, w_all: torch.Tensor,
                  proof_all: torch.Tensor, out_w: torch.Tensor,
                  ok: torch.Tensor, nonces: torch.Tensor,
                  proof_shares: Optional[torch.Tensor],
                  seeds: Optional[torch.Tensor],
                  peer_jr_parts: Optional[torch.Tensor]) -> BatchedPrep:
        """`prep` past the walk, over an evaluated tree (`eval_full`'s
        outputs: w_all, proof_all over the round's flat node axis, out_w,
        ok) and the same reports' inputs."""
        (level, _prefixes, do_weight_check) = agg_param
        (eval_proof,) = self.eval_proofs(
            (agg_id,), verify_key, ctx, (w_all[:, None],),
            (proof_all[:, None],), sched.onehot_idx, sched.payload_parent,
            sched.payload_left, sched.payload_right)
        (verifier, jr_part, jr_seed) = (None, None, None)
        if do_weight_check:
            beta_share = self.spec.add(w_all[:, 0], w_all[:, 1])
            if agg_id == 1:
                beta_share = self.spec.neg(beta_share)
            (verifier, jr_part, jr_seed, wok) = self._weight_check(
                agg_id, verify_key, ctx, level, nonces, beta_share,
                proof_shares, seeds, peer_jr_parts)
            ok = ok & wok
        return BatchedPrep(out_share=self.out_share(out_w),
                           eval_proof=eval_proof, verifier=verifier,
                           joint_rand_part=jr_part, joint_rand_seed=jr_seed,
                           ok=ok)

    def prep_both(self, verify_key: bytes, ctx: bytes, agg_param,
                  batch: ReportBatch,
                  sched: Optional[ScheduleInputs] = None) -> tuple:
        """Both aggregators' prep on one batch, aggregator 0 first, over
        one upload of the round's grid (`sched`, built here when None)."""
        if sched is None:
            sched = self.schedule(agg_param, batch.nonces.device)
        p0 = self.prep(0, verify_key, ctx, agg_param, batch.nonces,
                       batch.cws, batch.keys[:, 0],
                       proof_shares=batch.leader_proofs,
                       seeds=batch.leader_seeds,
                       peer_jr_parts=batch.peer_parts[0], sched=sched)
        p1 = self.prep(1, verify_key, ctx, agg_param, batch.nonces,
                       batch.cws, batch.keys[:, 1], seeds=batch.helper_seeds,
                       peer_jr_parts=batch.peer_parts[1], sched=sched)
        return (p0, p1)

    def accept_checks(self, prep0: BatchedPrep, prep1: BatchedPrep,
                      do_weight_check: bool) -> dict:
        """Per-check verdict masks (R,) bool: "eval_proof" (the two eval
        proofs equal), on weight-check rounds "weight_check" (FLP decide
        over the summed verifier shares), and for joint-rand circuits
        "joint_rand" (the two joint-rand seeds agree).  Only the checks
        this round runs have keys."""
        checks = {"eval_proof": torch.all(
            prep0.eval_proof == prep1.eval_proof, dim=-1)}
        if do_weight_check:
            verifier = self.spec.add(prep0.verifier, prep1.verifier)
            checks["weight_check"] = self.bflp.decide(verifier)
        if prep0.joint_rand_seed is not None:
            checks["joint_rand"] = torch.all(
                prep0.joint_rand_seed == prep1.joint_rand_seed, dim=-1)
        return checks

    def accept_mask(self, prep0: BatchedPrep, prep1: BatchedPrep,
                    do_weight_check: bool) -> torch.Tensor:
        """The AND of accept_checks: the round's accept verdict."""
        return all_checks(self.accept_checks(prep0, prep1,
                                              do_weight_check))

    def round_device(self, verify_key: bytes, ctx: bytes, agg_param,
                     batch: ReportBatch,
                     valid: Optional[torch.Tensor] = None) -> tuple:
        """One whole from-root round on the device: both preps, every
        check, masked aggregation.  Returns (agg_share0, agg_share1,
        accept, ok)."""
        return self.round_device_checks(verify_key, ctx, agg_param, batch,
                                        valid)[:4]

    def round_device_checks(self, verify_key: bytes, ctx: bytes, agg_param,
                            batch: ReportBatch,
                            valid: Optional[torch.Tensor] = None,
                            sched: Optional[ScheduleInputs] = None) -> tuple:
        """round_device plus the per-check masks: (agg0, agg1, accept,
        ok, checks).  `accept` is the checks' verdict and `ok` the XOF
        verdict alone: False where rejection sampling fired in either
        prep, so that the lane carries garbage (the drivers recompute it
        through the scalar layer).  Lanes with `ok` False, and lanes
        whose `valid` is False (e.g. the shard's own sampling fired),
        are left out of both aggregates.  sched: the round's uploaded
        grid, built here when None."""
        (_level, _prefixes, do_weight_check) = agg_param
        (p0, p1) = self.prep_both(verify_key, ctx, agg_param, batch, sched)
        checks = self.accept_checks(p0, p1, do_weight_check)
        accept = all_checks(checks)
        ok = p0.ok & p1.ok
        keep = accept & ok
        if valid is not None:
            keep = keep & valid
        agg0 = self.aggregate(p0.out_share, keep)
        agg1 = self.aggregate(p1.out_share, keep)
        return (agg0, agg1, accept, ok, checks)

    def aggregate(self, out_share: torch.Tensor,
                  accept: torch.Tensor) -> torch.Tensor:
        """Sum accepted reports' out shares: (R, L, n) -> (L, n)."""
        masked = torch.where(accept[:, None, None], out_share,
                             torch.zeros_like(out_share))
        return field_sum(self.spec, masked, axis=0)

    def agg_share_to_host(self, agg_share: torch.Tensor) -> list:
        arr = agg_share.cpu().numpy()
        return [self.spec.limbs_to_int(arr[i]) for i in range(arr.shape[0])]

    def marshal_reports(self, reports: list, device="cuda") -> ReportBatch:
        """Scalar-layer reports [(nonce, public_share, input_shares)] as
        a ReportBatch on `device` (the aggregators' upload ingestion).
        The public share is the correction words (see
        `BatchedVidpf.cws_from_host`); input share a is (key, proof
        shares or None, seed or None, peer joint-rand part or None), the
        leader's proof shares read through `.int()`."""
        device = resolve_device(device)

        def stack(get, dtype=np.uint8):
            return torch.as_tensor(np.stack([
                np.frombuffer(get(r), dtype) for r in reports]),
                device=device)

        cws = self.vidpf.cws_from_host([ps for (_, ps, _) in reports],
                                       device)
        keys = torch.stack([stack(lambda r, a=a: r[2][a][0])
                            for a in range(2)], dim=1)
        leader_proofs = torch.as_tensor(np.stack([
            np.stack([self.spec.int_to_limbs(x.int()) for x in sh[0][1]])
            for (_, _, sh) in reports]), device=device)
        (leader_seeds, peer_parts) = (None, (None, None))
        if self.m.valid.JOINT_RAND_LEN > 0:
            leader_seeds = stack(lambda r: r[2][0][2])
            peer_parts = tuple(stack(lambda r, a=a: r[2][a][3])
                               for a in range(2))
        return ReportBatch(
            nonces=stack(lambda r: r[0]), cws=cws, keys=keys,
            leader_proofs=leader_proofs,
            helper_seeds=stack(lambda r: r[2][1][2]),
            leader_seeds=leader_seeds, peer_parts=peer_parts)

    def marshal_party_reports(self, agg_id: int, reports: list,
                              device="cuda") -> dict:
        """One party's view of the upload channel: reports [(nonce,
        public_share, input_share)] whose input share is this
        aggregator's only (a process-separated party never sees its
        peer's), as the keyword arguments of `prep` on `device`: nonces,
        cws, keys, proof_shares (the leader's, else None), seeds (None
        where no report carries one) and peer_jr_parts (joint-rand
        circuits, else None)."""
        device = resolve_device(device)

        def stack(get):
            return torch.as_tensor(np.stack([
                np.frombuffer(get(sh), np.uint8) for (_, _, sh) in reports]),
                device=device)

        out = {"nonces": torch.as_tensor(np.stack([
                   np.frombuffer(n, np.uint8) for (n, _, _) in reports]),
                   device=device),
               "cws": self.vidpf.cws_from_host(
                   [ps for (_, ps, _) in reports], device),
               "keys": stack(lambda sh: sh[0]),
               "proof_shares": None, "seeds": None, "peer_jr_parts": None}
        if agg_id == 0:
            out["proof_shares"] = torch.as_tensor(np.stack([
                np.stack([self.spec.int_to_limbs(x.int()) for x in sh[1]])
                for (_, _, sh) in reports]), device=device)
        if any(sh[2] is not None for (_, _, sh) in reports):
            out["seeds"] = stack(lambda sh: sh[2])
        if self.m.valid.JOINT_RAND_LEN > 0:
            out["peer_jr_parts"] = stack(lambda sh: sh[3])
        return out

    def marshal_party_blobs(self, agg_id: int, blobs: np.ndarray,
                            device="cuda") -> tuple:
        """One party's upload blobs as `marshal_party_reports` gives
        their decoded reports, parsed from the bytes on `device` with no
        report decoded in Python.  blobs (R, report size) uint8: nonce ‖
        public share (packed ctrl bits, seeds, payloads, proofs) ‖ this
        aggregator's input share.  Returns (prep keyword arguments,
        well_formed (R,) bool): False where `wire.decode_report` would
        refuse the blob (nonzero ctrl padding bits, or a payload or
        proof-share element outside the field)."""
        device = resolve_device(device)
        m = self.m
        (bits, vl, elem) = (m.bits, m.value_len, m.field.ENCODED_SIZE)
        rows = torch.as_tensor(blobs, device=device)
        num = rows.shape[0]
        offset = 0

        def take(size: int) -> torch.Tensor:
            nonlocal offset
            offset += size
            return rows[:, offset - size:offset]

        def limbs(data: torch.Tensor, shape: tuple) -> torch.Tensor:
            nonlocal well_formed
            (out, in_range) = self.spec.limbs_from_le_bytes(
                data.reshape((num,) + shape + (elem,)))
            well_formed = well_formed & in_range.reshape(num, -1).all(-1)
            return out.contiguous()

        well_formed = torch.ones(num, dtype=torch.bool, device=device)
        nonces = take(m.NONCE_SIZE).contiguous()
        ctrl_len = (2 * bits + 7) // 8
        packed = take(ctrl_len)
        pad = 8 * ctrl_len - 2 * bits
        if pad:
            well_formed = well_formed & ((packed[:, -1] >> (8 - pad)) == 0)
        idx = torch.arange(2 * bits, device=device)
        ctrl = ((packed[:, idx // 8] >> (idx % 8)) & 1).bool()
        seed = take(bits * Vidpf.KEY_SIZE).reshape(num, bits, Vidpf.KEY_SIZE)
        w = limbs(take(bits * vl * elem), (bits, vl))
        proof = take(bits * PROOF_SIZE).reshape(num, bits, PROOF_SIZE)
        out = {"nonces": nonces,
               "cws": BatchedCorrectionWords(
                   seed.contiguous(), ctrl.reshape(num, bits, 2).contiguous(),
                   w, proof.contiguous()),
               "keys": take(Vidpf.KEY_SIZE).contiguous(),
               "proof_shares": None, "seeds": None, "peer_jr_parts": None}
        use_jr = m.valid.JOINT_RAND_LEN > 0
        if agg_id == 0:
            plen = m.valid.PROOF_LEN
            out["proof_shares"] = limbs(take(plen * elem), (plen,))
        if agg_id == 1 or use_jr:
            out["seeds"] = take(SEED_SIZE).contiguous()
        if use_jr:
            out["peer_jr_parts"] = take(SEED_SIZE).contiguous()
        if offset != rows.shape[1]:
            raise ValueError(f"upload blobs are {rows.shape[1]} bytes, the "
                             f"report layout {offset}")
        return (out, well_formed)


def all_checks(checks: dict) -> torch.Tensor:
    """The AND of a round's per-check masks: its accept verdict."""
    accept = checks["eval_proof"]
    for (name, mask) in checks.items():
        if name != "eval_proof":
            accept = accept & mask
    return accept
