"""Copy of `mastic_tpu/mastic.py`: the Mastic VDAF, a two-party,
one-round VDAF for weighted heavy hitters and attribute-based metrics,
composing a VIDPF (input and prefix side) with an FLP (weight-validity
side).  The aggregator's prep walks the level-synchronous prefix tree
of `vidpf.py`, the schedule the batched engine shares.

The five instantiations here are the scalar protocol behind the port's
parameter classes (`backend/mastic.py::Mastic.scalar`).
"""

from typing import Generic, Optional, TypeAlias, TypeVar

from .common import (concat, front, pack_bits, to_be_bytes, to_le_bytes,
                     unpack_bits, vec_add, vec_neg, vec_sub)
from .dst import (USAGE_EVAL_PROOF, USAGE_JOINT_RAND, USAGE_JOINT_RAND_PART,
                  USAGE_JOINT_RAND_SEED, USAGE_ONEHOT_CHECK,
                  USAGE_PAYLOAD_CHECK, USAGE_PROOF_SHARE, USAGE_PROVE_RAND,
                  USAGE_QUERY_RAND, dst_alg)
from .field import F, Field64, Field128
from .flp import (Count, FlpBBCGGI19, Histogram, MultihotCountVec, Sum,
                  SumVec, Valid)
from .vdaf import Vdaf
from .vidpf import PROOF_SIZE, CorrectionWord, Path, PrefixTree, Vidpf
from .xof import XofTurboShake128

W = TypeVar("W")
R = TypeVar("R")

MasticAggParam: TypeAlias = tuple[
    int,                  # level
    tuple[Path, ...],     # candidate prefixes
    bool,                 # whether to do the weight check
]

MasticInputShare: TypeAlias = tuple[
    bytes,              # VIDPF key
    Optional[list],     # FLP leader proof share
    Optional[bytes],    # FLP seed
    Optional[bytes],    # FLP peer joint rand part
]

MasticPrepState: TypeAlias = tuple[
    list,               # truncated output share
    Optional[bytes],    # predicted FLP joint rand seed
]

MasticPrepShare: TypeAlias = tuple[
    bytes,              # VIDPF eval proof
    Optional[list],     # FLP verifier share
    Optional[bytes],    # FLP joint randomness part
]

MasticPrepMessage: TypeAlias = Optional[bytes]  # FLP joint rand seed


class ReportRejected(Exception):
    """A report failed one of the protocol's validity checks (VIDPF
    eval proof, FLP decide, or joint-rand confirmation).  Distinct
    from programming/infrastructure errors so callers that treat
    rejection as a per-report verdict (e.g. the XOF rejection-sampling
    fallback) don't swallow real bugs."""


class Mastic(
        Generic[W, R, F],
        Vdaf[
            tuple[Path, W],          # Measurement
            MasticAggParam,
            list[CorrectionWord],    # PublicShare
            MasticInputShare,
            list,                    # OutShare
            list,                    # AggShare
            list,                    # AggResult
            MasticPrepState,
            MasticPrepShare,
            MasticPrepMessage,
        ]):

    xof = XofTurboShake128

    ID: int = 0xFFFFFFFF
    VERIFY_KEY_SIZE = XofTurboShake128.SEED_SIZE
    NONCE_SIZE = 16
    SHARES = 2
    ROUNDS = 1

    test_vec_name = "Mastic"

    def __init__(self, bits: int, valid: Valid[W, R, F]):
        self.field: type[F] = valid.field
        self.flp = FlpBBCGGI19(valid)
        self.vidpf = Vidpf(valid.field, bits, 1 + valid.MEAS_LEN)
        self.RAND_SIZE = self.vidpf.RAND_SIZE + 2 * self.xof.SEED_SIZE
        if self.flp.JOINT_RAND_LEN > 0:  # FLP leader seed
            self.RAND_SIZE += self.xof.SEED_SIZE

    # -- client (reference mastic.py:91-185) -----------------------

    def shard(self, ctx: bytes, measurement: "tuple[Path, W]",
          nonce: bytes, rand: bytes
          ) -> tuple[list[CorrectionWord], list[MasticInputShare]]:
        """Produce the public share (VIDPF correction words) and the
        two input shares.  One code path serves both FLP families: for
        joint-rand circuits the client additionally derives both
        parties' joint-rand parts itself (it knows both beta shares)
        and attaches the peer's part to each input share.
        """
        use_jr = self.flp.JOINT_RAND_LEN > 0
        seeds_needed = 3 if use_jr else 2
        (vidpf_rand, rest) = front(self.vidpf.RAND_SIZE, rand)
        seeds = []
        for _ in range(seeds_needed):
            (seed, rest) = front(self.xof.SEED_SIZE, rest)
            seeds.append(bytes(seed))
        assert len(rest) == 0
        (prove_rand_seed, helper_seed) = seeds[:2]
        leader_seed = seeds[2] if use_jr else None

        # beta = counter || encoded weight.
        (alpha, weight) = measurement
        beta = [self.field(1)] + self.flp.encode(weight)

        (correction_words, keys) = \
            self.vidpf.gen(alpha, beta, ctx, nonce, vidpf_rand)

        joint_rand: list[F] = []
        parts = None
        if use_jr:
            # Each party contributes a part bound to its beta share;
            # the client evaluates both shares to compute both parts.
            parts = []
            for (agg_id, seed) in ((0, leader_seed), (1, helper_seed)):
                beta_share = self.vidpf.get_beta_share(
                    agg_id, correction_words, keys[agg_id], ctx, nonce)
                parts.append(self.joint_rand_part(
                    ctx, seed, beta_share[1:], nonce))
            joint_rand = self.joint_rand(
                ctx, self.joint_rand_seed(ctx, parts))

        proof = self.flp.prove(beta[1:],
                               self.prove_rand(ctx, prove_rand_seed),
                               joint_rand)
        leader_proof_share = vec_sub(
            proof, self.helper_proof_share(ctx, helper_seed))

        input_shares: list[MasticInputShare] = [
            (keys[0], leader_proof_share, leader_seed,
             parts[1] if parts else None),
            (keys[1], None, helper_seed, parts[0] if parts else None),
        ]
        return (correction_words, input_shares)

    # -- aggregation-parameter policy (reference mastic.py:187-203) -

    def is_valid(self, agg_param: MasticAggParam,
             previous_agg_params: list[MasticAggParam]) -> bool:
        (level, _prefixes, do_weight_check) = agg_param

        # The weight check happens exactly once, on the first round.
        weight_checked = \
            (do_weight_check and len(previous_agg_params) == 0) or \
            (not do_weight_check and
                any(prev[2] for prev in previous_agg_params))

        # The level is strictly increasing between rounds.
        level_increased = len(previous_agg_params) == 0 or \
            level > previous_agg_params[-1][0]

        return weight_checked and level_increased

    # -- aggregator (reference mastic.py:205-318) ------------------

    def prep_init(self, verify_key: bytes, ctx: bytes, agg_id: int,
                  agg_param: MasticAggParam, nonce: bytes,
                  correction_words: list[CorrectionWord],
                  input_share: MasticInputShare
                  ) -> tuple[MasticPrepState, MasticPrepShare]:
        (level, prefixes, do_weight_check) = agg_param
        (key, proof_share, seed, peer_joint_rand_part) = \
            self.expand_input_share(ctx, agg_id, input_share)

        # Evaluate the VIDPF over the level-synchronous node grid.
        (out_share, tree) = self.vidpf.eval_level_synchronous(
            agg_id, correction_words, key, level, prefixes, ctx, nonce)

        # Weight check: query the FLP against this party's beta share.
        joint_rand_part = None
        joint_rand_seed = None
        verifier_share = None
        if do_weight_check:
            # This party's beta share is the sum of the two depth-1
            # payloads, both already present in the evaluated tree.
            beta_share = vec_add(tree.levels[0][(False,)].w,
                                 tree.levels[0][(True,)].w)
            if agg_id == 1:
                beta_share = vec_neg(beta_share)
            query_rand = self.query_rand(verify_key, ctx, nonce, level)
            joint_rand: list[F] = []
            if self.flp.JOINT_RAND_LEN > 0:
                assert seed is not None
                assert peer_joint_rand_part is not None
                joint_rand_part = self.joint_rand_part(
                    ctx, seed, beta_share[1:], nonce)
                if agg_id == 0:
                    joint_rand_parts = [joint_rand_part,
                                        peer_joint_rand_part]
                else:
                    joint_rand_parts = [peer_joint_rand_part,
                                        joint_rand_part]
                joint_rand_seed = self.joint_rand_seed(
                    ctx, joint_rand_parts)
                joint_rand = self.joint_rand(ctx, joint_rand_seed)
            verifier_share = self.flp.query(
                beta_share[1:], proof_share, query_rand, joint_rand, 2)

        (payload_check_binder, onehot_check_binder) = \
            self.check_binders(tree)

        payload_check = self.xof(
            b"",
            dst_alg(ctx, USAGE_PAYLOAD_CHECK, self.ID),
            payload_check_binder,
        ).next(PROOF_SIZE)

        onehot_check = self.xof(
            b"",
            dst_alg(ctx, USAGE_ONEHOT_CHECK, self.ID),
            onehot_check_binder,
        ).next(PROOF_SIZE)

        # Counter check: beta[0] must equal 1.  Aggregator 1 adds 1 to
        # its (negated) share so both parties derive the same bytes iff
        # the counter is correct.
        w0 = tree.levels[0][(False,)].w
        w1 = tree.levels[0][(True,)].w
        counter_check = self.field.encode_vec(
            [w0[0] + w1[0] + self.field(agg_id)])

        # A single proof binding all three checks.
        eval_proof = self.xof(
            verify_key,
            dst_alg(ctx, USAGE_EVAL_PROOF, self.ID),
            onehot_check + counter_check + payload_check,
        ).next(PROOF_SIZE)

        # Truncate each per-prefix payload to its aggregatable part.
        truncated_out_share: list[F] = []
        for val_share in out_share:
            truncated_out_share += [val_share[0]] + \
                self.flp.truncate(val_share[1:])

        prep_state = (truncated_out_share, joint_rand_seed)
        prep_share = (eval_proof, verifier_share, joint_rand_part)
        return (prep_state, prep_share)

    def check_binders(self, tree: PrefixTree[F]) -> tuple[bytes, bytes]:
        """Assemble the payload- and onehot-check binders.

        The reference walks its lazily built tree breadth-first
        (mastic.py:258-287); the equivalent order here is: per depth,
        nodes in lexicographic path order (see vidpf.tree_schedule).
        Every materialized node contributes its proof to the onehot
        binder; every *internal* node (one with both children, i.e. a
        path node) contributes `w - w_left - w_right` to the payload
        binder.
        """
        payload_check_binder = b""
        onehot_check_binder = b""
        for (depth, nodes) in enumerate(tree.levels):
            next_nodes = tree.levels[depth + 1] \
                if depth + 1 < len(tree.levels) else {}
            for (path, node) in nodes.items():
                left = next_nodes.get(path + (False,))
                right = next_nodes.get(path + (True,))
                if left is not None and right is not None:
                    payload_check_binder += self.field.encode_vec(
                        vec_sub(node.w, vec_add(left.w, right.w)))
                onehot_check_binder += node.proof
        return (payload_check_binder, onehot_check_binder)

    def prep_shares_to_prep(self, ctx: bytes,
                        agg_param: MasticAggParam,
                        prep_shares: list[MasticPrepShare]
                        ) -> MasticPrepMessage:
        (_level, _prefixes, do_weight_check) = agg_param

        if len(prep_shares) != 2:
            raise ValueError("unexpected number of prep shares")

        (eval_proof_0, verifier_share_0, joint_rand_part_0) = prep_shares[0]
        (eval_proof_1, verifier_share_1, joint_rand_part_1) = prep_shares[1]

        # VIDPF validity: both parties must derive identical proofs.
        if eval_proof_0 != eval_proof_1:
            raise ReportRejected("VIDPF verification failed")

        if not do_weight_check:
            return None
        if verifier_share_0 is None or verifier_share_1 is None:
            raise ValueError("expected FLP verifier shares")

        # FLP validity.
        verifier = vec_add(verifier_share_0, verifier_share_1)
        if not self.flp.decide(verifier):
            raise ReportRejected("FLP verification failed")

        if self.flp.JOINT_RAND_LEN == 0:
            return None
        if joint_rand_part_0 is None or joint_rand_part_1 is None:
            raise ValueError("expected FLP joint randomness parts")

        return self.joint_rand_seed(ctx, [joint_rand_part_0,
                                          joint_rand_part_1])

    def prep_next(self, _ctx: bytes, prep_state: MasticPrepState,
              prep_msg: MasticPrepMessage) -> list:
        (truncated_out_share, joint_rand_seed) = prep_state
        if joint_rand_seed is not None:
            if prep_msg is None:
                raise ValueError("expected joint rand confirmation")
            if prep_msg != joint_rand_seed:
                raise ReportRejected("joint rand confirmation failed")
        return truncated_out_share

    # -- aggregation & collection (reference mastic.py:379-411) ----

    def agg_init(self, agg_param: MasticAggParam) -> list:
        (_level, prefixes, _do_weight_check) = agg_param
        return self.field.zeros(len(prefixes) * (1 + self.flp.OUTPUT_LEN))

    def agg_update(self, agg_param: MasticAggParam, agg_share: list,
               out_share: list) -> list:
        return vec_add(agg_share, out_share)

    def merge(self, agg_param: MasticAggParam,
          agg_shares: list) -> list:
        agg = self.agg_init(agg_param)
        for agg_share in agg_shares:
            agg = vec_add(agg, agg_share)
        return agg

    def unshard(self, agg_param: MasticAggParam, agg_shares: list,
            _num_measurements: int) -> list:
        agg = self.merge(agg_param, agg_shares)
        agg_result = []
        while len(agg) > 0:
            (chunk, agg) = front(1 + self.flp.OUTPUT_LEN, agg)
            meas_count = chunk[0].int()
            agg_result.append(self.flp.decode(chunk[1:], meas_count))
        return agg_result

    # -- wire encodings (reference mastic.py:413-435, :512-559) ----

    def encode_agg_param(self, agg_param: MasticAggParam) -> bytes:
        (level, prefixes, do_weight_check) = agg_param
        if level not in range(2 ** 16):
            raise ValueError("level out of range")
        if len(prefixes) not in range(2 ** 32):
            raise ValueError("number of prefixes out of range")
        encoded = bytes()
        encoded += to_be_bytes(level, 2)
        encoded += to_be_bytes(len(prefixes), 4)
        for prefix in prefixes:
            encoded += pack_bits(list(prefix))
        encoded += to_be_bytes(int(do_weight_check), 1)
        return encoded

    def decode_agg_param(self, encoded: bytes) -> MasticAggParam:
        if len(encoded) < 7:
            raise ValueError("malformed agg param")
        level = int.from_bytes(encoded[:2], "big")
        num_prefixes = int.from_bytes(encoded[2:6], "big")
        prefix_bytes = ((level + 1) + 7) // 8
        if len(encoded) != 6 + num_prefixes * prefix_bytes + 1:
            raise ValueError("malformed agg param")
        off = 6
        prefixes = []
        for _ in range(num_prefixes):
            chunk = encoded[off:off + prefix_bytes]
            prefixes.append(tuple(unpack_bits(chunk, level + 1)))
            off += prefix_bytes
        do_weight_check = bool(encoded[off])
        return (level, tuple(prefixes), do_weight_check)

    def expand_input_share(
            self, ctx: bytes, agg_id: int,
            input_share: MasticInputShare
    ) -> tuple[bytes, list, Optional[bytes], Optional[bytes]]:
        if agg_id == 0:
            (key, proof_share, seed, peer_joint_rand_part) = input_share
            assert proof_share is not None
        else:
            (key, _leader_share, seed, peer_joint_rand_part) = input_share
            assert seed is not None
            proof_share = self.helper_proof_share(ctx, seed)
        return (key, proof_share, seed, peer_joint_rand_part)

    # -- XOF derivations (reference mastic.py:452-510) -------------
    #
    # Every per-protocol random vector is one row of this table: the
    # XOF usage plus which FLP length it expands to.  The seed and
    # binder vary per row and are supplied by the caller.

    _VEC_DERIVATIONS = {
        "prove_rand": (USAGE_PROVE_RAND, "PROVE_RAND_LEN"),
        "proof_share": (USAGE_PROOF_SHARE, "PROOF_LEN"),
        "joint_rand": (USAGE_JOINT_RAND, "JOINT_RAND_LEN"),
        "query_rand": (USAGE_QUERY_RAND, "QUERY_RAND_LEN"),
    }

    def derive_vec(self, what: str, ctx: bytes, seed: bytes,
                   binder: bytes = b"") -> list[F]:
        (usage, length_attr) = self._VEC_DERIVATIONS[what]
        return self.xof.expand_into_vec(
            self.field, seed, dst_alg(ctx, usage, self.ID), binder,
            getattr(self.flp, length_attr))

    def prove_rand(self, ctx: bytes, seed: bytes) -> list[F]:
        return self.derive_vec("prove_rand", ctx, seed)

    def helper_proof_share(self, ctx: bytes, seed: bytes) -> list[F]:
        return self.derive_vec("proof_share", ctx, seed)

    def joint_rand(self, ctx: bytes, seed: bytes) -> list[F]:
        return self.derive_vec("joint_rand", ctx, seed)

    def query_rand(self, verify_key: bytes, ctx: bytes, nonce: bytes,
                   level: int) -> list[F]:
        return self.derive_vec("query_rand", ctx, verify_key,
                               nonce + to_le_bytes(level, 2))

    def joint_rand_part(self, ctx: bytes, seed: bytes,
                        weight_share: list[F], nonce: bytes) -> bytes:
        return self.xof.derive_seed(
            seed, dst_alg(ctx, USAGE_JOINT_RAND_PART, self.ID),
            nonce + self.field.encode_vec(weight_share))

    def joint_rand_seed(self, ctx: bytes, parts: list[bytes]) -> bytes:
        return self.xof.derive_seed(
            b"", dst_alg(ctx, USAGE_JOINT_RAND_SEED, self.ID),
            concat(parts))


##
# INSTANTIATIONS (reference mastic.py:567-614; IANA codepoints from
# draft-mouris-cfrg-mastic.md:1359-1366)
#


class MasticCount(Mastic[int, int, Field64]):
    ID = 0xFFFF0001
    test_vec_name = "MasticCount"

    def __init__(self, bits: int):
        super().__init__(bits, Count(Field64))


class MasticSum(Mastic[int, int, Field64]):
    ID = 0xFFFF0002
    test_vec_name = "MasticSum"

    def __init__(self, bits: int, max_measurement: int):
        super().__init__(bits, Sum(Field64, max_measurement))


class MasticSumVec(Mastic[list[int], list[int], Field128]):
    ID = 0xFFFF0003
    test_vec_name = "MasticSumVec"

    def __init__(self, bits: int, length: int, sum_vec_bits: int,
                 chunk_length: int):
        super().__init__(
            bits, SumVec(Field128, length, sum_vec_bits, chunk_length))


class MasticHistogram(Mastic[int, list[int], Field128]):
    ID = 0xFFFF0004
    test_vec_name = "MasticHistogram"

    def __init__(self, bits: int, length: int, chunk_length: int):
        super().__init__(bits, Histogram(Field128, length, chunk_length))


class MasticMultihotCountVec(Mastic[list[bool], list[int], Field128]):
    ID = 0xFFFF0005
    test_vec_name = "MasticMultihotCountVec"

    def __init__(self, bits: int, length: int, max_weight: int,
                 chunk_length: int):
        super().__init__(
            bits, MultihotCountVec(Field128, length, max_weight,
                                   chunk_length))
