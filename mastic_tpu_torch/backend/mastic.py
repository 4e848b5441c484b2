"""Batched Mastic for MasticCount: client sharding, the FLP weight check
and masked aggregation over whole report batches (port of
`mastic_tpu/backend/mastic_jax.py`).

Only the Count circuit (Field64) is ported so far; `MasticCount`
carries its parameters in place of the JAX package's scalar Mastic
instance.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from ..common import to_le_bytes
from ..dst import (USAGE_PROOF_SHARE, USAGE_PROVE_RAND, USAGE_QUERY_RAND,
                   dst_alg)
from ..flp.circuits import Count
from ..flp.flp import BatchedFlp
from ..ops.field import FIELD64, field_sum
from .vidpf import BatchedCorrectionWords, BatchedVidpf
from .xof import sample_vec, turboshake_xof

SEED_SIZE = 32  # XofTurboShake128.SEED_SIZE


class MasticCount:
    """MasticCount(bits): Mastic over Field64 with the Count circuit."""

    ID = 0xFFFF0001
    NONCE_SIZE = 16
    VERIFY_KEY_SIZE = SEED_SIZE
    VIDPF_RAND_SIZE = 32
    RAND_SIZE = VIDPF_RAND_SIZE + 2 * SEED_SIZE

    def __init__(self, bits: int):
        self.bits = bits
        self.valid = Count()
        self.value_len = 1 + self.valid.MEAS_LEN

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
        decode: one weighted count per prefix."""
        p = FIELD64.modulus
        agg = [(a + b) % p for (a, b) in zip(*agg_shares)]
        width = 1 + self.valid.OUTPUT_LEN
        return [agg[i + 1] for i in range(0, len(agg), width)]


class ReportBatch(NamedTuple):
    """A report batch as device tensors."""
    nonces: torch.Tensor              # (R, 16) uint8
    cws: BatchedCorrectionWords
    keys: torch.Tensor                # (R, 2, 16) uint8
    leader_proofs: torch.Tensor       # (R, PROOF_LEN, n) int32 plain limbs
    helper_seeds: torch.Tensor        # (R, 32) uint8


class BatchedMastic:
    """Batched execution engine for one MasticCount instantiation."""

    def __init__(self, mastic: MasticCount):
        self.m = mastic
        self.spec = FIELD64
        self.vidpf = BatchedVidpf(mastic.bits, mastic.value_len)
        self.bflp = BatchedFlp(mastic.valid)

    def truncate(self, w: torch.Tensor) -> torch.Tensor:
        """Count's truncate() is the identity on its one measurement
        element (the JAX package's "gather" case)."""
        return w[..., :self.m.valid.OUTPUT_LEN, :]

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

    # -- batched client shard --------------------------------------

    def encode_measurements(self, measurements: list,
                            device="cuda") -> tuple:
        """[(alpha path, weight)] -> (alphas (R, BITS) bool, betas (R,
        VALUE_LEN, n) plain limbs with the counter 1 first), on
        `device`."""
        device = resolve_device(device)
        num = len(measurements)
        alphas = np.zeros((num, self.m.bits), bool)
        betas = np.zeros((num, self.m.value_len, self.spec.num_limbs),
                         np.int32)
        for (r, (alpha, weight)) in enumerate(measurements):
            alphas[r] = alpha
            beta = [1] + self.m.valid.encode(weight)
            for (j, el) in enumerate(beta):
                betas[r, j] = self.spec.int_to_limbs(el)
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
        vs = self.m.VIDPF_RAND_SIZE
        vidpf_rand = rand[:, :vs]
        prove_seed = rand[:, vs:vs + SEED_SIZE].contiguous()
        helper_seed = rand[:, vs + SEED_SIZE:vs + 2 * SEED_SIZE].contiguous()

        (cws, keys, ok) = self.vidpf.gen(alphas, betas, ctx, nonces,
                                         vidpf_rand)
        (prove_rand, pok) = self.prove_rand(ctx, prove_seed)
        proof = self.bflp.prove(betas[..., 1:, :], prove_rand, None)
        (helper_share, hok) = self.helper_proof_share(ctx, helper_seed)
        leader_proofs = self.spec.sub(proof, helper_share)
        batch = ReportBatch(nonces=nonces, cws=cws, keys=keys,
                            leader_proofs=leader_proofs,
                            helper_seeds=helper_seed)
        return (batch, ok & pok & hok)

    # -- the FLP weight check --------------------------------------

    def _weight_check(self, agg_id: int, verify_key: bytes, ctx: bytes,
                      level: int, nonces: torch.Tensor,
                      beta_share: torch.Tensor,
                      proof_shares: Optional[torch.Tensor],
                      seeds: Optional[torch.Tensor]) -> tuple:
        """One aggregator's FLP weight check over its beta share.
        Returns (verifier, ok)."""
        (query_rand, ok) = self.query_rand(verify_key, ctx, nonces, level)
        expanded_proof = proof_shares
        if agg_id == 1:
            (expanded_proof, pok) = self.helper_proof_share(ctx, seeds)
            ok = ok & pok
        (verifier, vok) = self.bflp.query(
            beta_share[..., 1:, :], expanded_proof, query_rand, None, 2)
        return (verifier, ok & vok)

    def weight_check_device(self, verify_key: bytes, ctx: bytes,
                            level: int, batch: ReportBatch,
                            w0_pair: torch.Tensor,
                            w1_pair: torch.Tensor) -> tuple:
        """Both aggregators' FLP weight check from their unnegated
        depth-0 child payloads w{a}_pair (R, 2, VALUE_LEN, n).
        Returns (checks {"weight_check": (R,) bool}, ok (R,))."""
        verifiers = []
        ok = None
        for (agg_id, w_pair) in ((0, w0_pair), (1, w1_pair)):
            beta_share = self.spec.add(w_pair[:, 0], w_pair[:, 1])
            if agg_id == 1:
                beta_share = self.spec.neg(beta_share)
            (verifier, aok) = self._weight_check(
                agg_id, verify_key, ctx, level, batch.nonces, beta_share,
                batch.leader_proofs if agg_id == 0 else None,
                None if agg_id == 0 else batch.helper_seeds)
            verifiers.append(verifier)
            ok = aok if ok is None else ok & aok
        verifier = self.spec.add(verifiers[0], verifiers[1])
        return ({"weight_check": self.bflp.decide(verifier)}, ok)

    def aggregate(self, out_share: torch.Tensor,
                  accept: torch.Tensor) -> torch.Tensor:
        """Sum accepted reports' out shares: (R, L, n) -> (L, n)."""
        masked = torch.where(accept[:, None, None], out_share,
                             torch.zeros_like(out_share))
        return field_sum(self.spec, masked, axis=0)

    def agg_share_to_host(self, agg_share: torch.Tensor) -> list:
        arr = agg_share.cpu().numpy()
        return [self.spec.limbs_to_int(arr[i]) for i in range(arr.shape[0])]
