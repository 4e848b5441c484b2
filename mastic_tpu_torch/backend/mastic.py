"""Batched Mastic: client sharding, the FLP weight check and masked
aggregation over whole report batches (port of
`mastic_tpu/backend/mastic_jax.py`).

The five instantiations (`MasticCount`, `MasticSum`, `MasticSumVec`,
`MasticHistogram`, `MasticMultihotCountVec`) carry their parameters in
place of the JAX package's scalar Mastic instances.  The three
ParallelSum circuits run over Field128 with joint randomness: the
client derives both aggregators' joint-rand parts from their depth-0
beta shares, and each aggregator's input share carries its peer's part.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import to_le_bytes
from ..dst import (USAGE_JOINT_RAND, USAGE_JOINT_RAND_PART,
                   USAGE_JOINT_RAND_SEED, USAGE_PROOF_SHARE,
                   USAGE_PROVE_RAND, USAGE_QUERY_RAND, dst_alg)
from ..flp.circuits import (Count, Histogram, MultihotCountVec, Sum,
                            SumVec)
from ..flp.flp import BatchedFlp
from ..ops.field import field_sum, spec_for
from .vidpf import BatchedCorrectionWords, BatchedVidpf
from .xof import sample_vec, turboshake_xof

SEED_SIZE = 32  # XofTurboShake128.SEED_SIZE


class Mastic:
    """Mastic over one validity circuit with `bits`-bit inputs: the
    parameters the batched engine reads."""

    ID = 0xFFFFFFFF
    NONCE_SIZE = 16
    VERIFY_KEY_SIZE = SEED_SIZE
    VIDPF_RAND_SIZE = 32

    def __init__(self, bits: int, valid):
        self.bits = bits
        self.valid = valid
        self.field = valid.field
        self.value_len = 1 + valid.MEAS_LEN
        self.RAND_SIZE = self.VIDPF_RAND_SIZE + 2 * SEED_SIZE
        if valid.JOINT_RAND_LEN > 0:  # the leader's joint-rand seed
            self.RAND_SIZE += SEED_SIZE

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

    def __init__(self, bits: int):
        super().__init__(bits, Count())


class MasticSum(Mastic):
    ID = 0xFFFF0002

    def __init__(self, bits: int, max_measurement: int):
        super().__init__(bits, Sum(max_measurement))


class MasticSumVec(Mastic):
    ID = 0xFFFF0003

    def __init__(self, bits: int, length: int, sum_vec_bits: int,
                 chunk_length: int):
        super().__init__(bits, SumVec(length, sum_vec_bits, chunk_length))


class MasticHistogram(Mastic):
    ID = 0xFFFF0004

    def __init__(self, bits: int, length: int, chunk_length: int):
        super().__init__(bits, Histogram(length, chunk_length))


class MasticMultihotCountVec(Mastic):
    ID = 0xFFFF0005

    def __init__(self, bits: int, length: int, max_weight: int,
                 chunk_length: int):
        super().__init__(bits, MultihotCountVec(length, max_weight,
                                                chunk_length))


class ReportBatch(NamedTuple):
    """A report batch as device tensors."""
    nonces: torch.Tensor              # (R, 16) uint8
    cws: BatchedCorrectionWords
    keys: torch.Tensor                # (R, 2, 16) uint8
    leader_proofs: torch.Tensor       # (R, PROOF_LEN, n) int32 plain limbs
    helper_seeds: torch.Tensor        # (R, 32) uint8
    leader_seeds: Optional[torch.Tensor] = None   # (R, 32) or None
    peer_parts: tuple = (None, None)  # per aggregator: (R, 32) or None


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
        Returns (verifier, joint_rand_seed or None, ok)."""
        (query_rand, ok) = self.query_rand(verify_key, ctx, nonces, level)
        expanded_proof = proof_shares
        if agg_id == 1:
            (expanded_proof, pok) = self.helper_proof_share(ctx, seeds)
            ok = ok & pok
        joint_rand = None
        jr_seed = None
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
        return (verifier, jr_seed, ok & vok)

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
            (verifier, jr_seed, aok) = self._weight_check(
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

    def aggregate(self, out_share: torch.Tensor,
                  accept: torch.Tensor) -> torch.Tensor:
        """Sum accepted reports' out shares: (R, L, n) -> (L, n)."""
        masked = torch.where(accept[:, None, None], out_share,
                             torch.zeros_like(out_share))
        return field_sum(self.spec, masked, axis=0)

    def agg_share_to_host(self, agg_share: torch.Tensor) -> list:
        arr = agg_share.cpu().numpy()
        return [self.spec.limbs_to_int(arr[i]) for i in range(arr.shape[0])]
