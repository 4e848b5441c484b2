"""Copy of `mastic_tpu/vidpf.py`: the Verifiable Incremental
Distributed Point Function (VIDPF) of [MST24], evaluated
level-synchronously: one tree level at a time over a dense, sorted grid
of nodes, the schedule the batched engine
(`mastic_tpu_torch/backend/`) runs over whole report batches.

Verifiability hooks:
  * per-node proofs (TurboSHAKE over the corrected seed),
  * payload sums (each node's payload equals the sum of its children's),
  * the counter (first payload element) at the root.
"""

from typing import Generic, Sequence, TypeAlias

from .common import pack_bits, pack_bits_le, to_le_bytes, unpack_bits_le, \
    vec_add, vec_neg, vec_sub, xor
from .dst import USAGE_CONVERT, USAGE_EXTEND, USAGE_NODE_PROOF, dst
from .field import F
from .xof import XofFixedKeyAes128, XofTurboShake128

PROOF_SIZE: int = 32

# A bit-path into the binary prefix tree; () is the root.
Path: TypeAlias = tuple[bool, ...]

CorrectionWord: TypeAlias = tuple[
    bytes,       # seed correction
    list[bool],  # control-bit corrections (left, right)
    list,        # payload correction
    bytes,       # node-proof correction
]


def encode_path(path: Path) -> bytes:
    """Big-endian bit packing (reference PrefixTreeIndex.encode,
    vidpf.py:32-39)."""
    return pack_bits(list(path))


class EvalNode(Generic[F]):
    """Per-node evaluation state of one aggregator: corrected seed,
    control bit, payload and node proof (reference PrefixTreeEntry,
    vidpf.py:60-81)."""

    __slots__ = ("seed", "ctrl", "w", "proof")

    def __init__(self, seed: bytes, ctrl: bool, w: list[F], proof: bytes):
        self.seed = seed
        self.ctrl = ctrl
        self.w = w
        self.proof = proof


class PrefixTree(Generic[F]):
    """The level-synchronous evaluation grid for one (report, aggregator)
    pair: `nodes[d]` maps each materialized depth-(d+1) path to its
    EvalNode.  Within a level, iteration order is lexicographic, which
    reproduces the reference's breadth-first traversal order
    (mastic.py:258-287) — see `Vidpf.tree_schedule`."""

    def __init__(self) -> None:
        self.levels: list[dict[Path, EvalNode[F]]] = []


def tree_schedule(prefixes: Sequence[Path], level: int) \
        -> list[list[Path]]:
    """The dense node grid implied by a candidate-prefix set: for each
    depth d+1 in 1..level+1, the sorted list of both children of every
    path node `p[:d]`.

    Sorting lexicographically per level reproduces the reference's BFS
    materialization order exactly: children are enqueued left-then-right
    in parents' visit order, so each level of the queue is in
    lexicographic order.  The schedule depends only on the (public)
    prefix set, never on secret data: the batched engine precomputes it
    on the host and applies it as a static gather.
    """
    schedule = []
    for depth in range(level + 1):
        parents = sorted(set(p[:depth] for p in prefixes))
        children = []
        for parent in parents:
            children.append(parent + (False,))
            children.append(parent + (True,))
        schedule.append(children)
    return schedule


class Vidpf(Generic[F]):
    """VIDPF with field `field`, input length `bits` and payload length
    `value_len` (reference Vidpf, vidpf.py:84-101)."""

    KEY_SIZE = XofFixedKeyAes128.SEED_SIZE
    NONCE_SIZE = XofFixedKeyAes128.SEED_SIZE
    RAND_SIZE = 2 * XofFixedKeyAes128.SEED_SIZE

    def __init__(self, field: type[F], bits: int, value_len: int):
        self.field = field
        self.BITS = bits
        self.VALUE_LEN = value_len

    # -- key generation (client side; reference vidpf.py:103-211) --

    def gen(self,
            alpha: Path,
            beta: list[F],
            ctx: bytes,
            nonce: bytes,
            rand: bytes,
            ) -> tuple[list[CorrectionWord], list[bytes]]:
        """Produce the public share (one correction word per level) and
        the two aggregator keys."""
        if len(alpha) != self.BITS:
            raise ValueError("alpha out of range")
        if len(beta) != self.VALUE_LEN:
            raise ValueError("incorrect beta length")
        if len(nonce) != self.NONCE_SIZE:
            raise ValueError("incorrect nonce size")
        if len(rand) != self.RAND_SIZE:
            raise ValueError("randomness has incorrect length")

        keys = [rand[:self.KEY_SIZE], rand[self.KEY_SIZE:]]
        seed = [keys[0], keys[1]]
        ctrl = [False, True]
        correction_words: list[CorrectionWord] = []
        for i in range(self.BITS):
            bit = alpha[i]
            keep = int(bit)
            lose = 1 - keep

            # Extend both parties' seeds into left/right children.
            (s0, t0) = self.extend(seed[0], ctx, nonce)
            (s1, t1) = self.extend(seed[1], ctx, nonce)

            # Seed/ctrl corrections: arranged so that after correction,
            # on-path children differ (ctrl shares of 1) while off-path
            # children collide (ctrl shares of 0).
            #
            # Timing note on the suppressions below: gen() is client
            # code running over the client's OWN (alpha, beta) — no
            # other party observes its timing — and the deployed
            # batched twin replaces every secret-dependent choice with
            # a lane select (backend/vidpf.py gen).
            seed_cw = xor(s0[lose], s1[lose])
            ctrl_cw = [
                t0[0] ^ t1[0] ^ (not bit),
                t0[1] ^ t1[1] ^ bit,
            ]

            s0k = xor(s0[keep], seed_cw) if ctrl[0] else s0[keep]
            t0k = t0[keep] ^ (ctrl[0] and ctrl_cw[keep])
            s1k = xor(s1[keep], seed_cw) if ctrl[1] else s1[keep]
            t1k = t1[keep] ^ (ctrl[1] and ctrl_cw[keep])

            # Convert the kept child seeds into payloads + next seeds.
            (seed0, w0) = self.convert(s0k, ctx, nonce)
            (seed1, w1) = self.convert(s1k, ctx, nonce)
            seed = [seed0, seed1]
            ctrl = [t0k, t1k]

            # Payload correction: make the on-path payload shares sum
            # to beta.
            w_cw = vec_add(vec_sub(beta, w0), w1)
            if ctrl[1]:
                w_cw = vec_neg(w_cw)

            # Node-proof correction: on path, exactly one party
            # corrects, aligning the two proofs.
            idx = alpha[:i + 1]
            proof_cw = xor(
                self.node_proof(seed[0], ctx, idx),
                self.node_proof(seed[1], ctx, idx),
            )

            correction_words.append((seed_cw, ctrl_cw, w_cw, proof_cw))

        return (correction_words, keys)

    # -- evaluation (aggregator side) ------------------------------

    def eval_level_synchronous(self,
                               agg_id: int,
                               correction_words: list[CorrectionWord],
                               key: bytes,
                               level: int,
                               prefixes: Sequence[Path],
                               ctx: bytes,
                               nonce: bytes,
                               ) -> tuple[list[list[F]], PrefixTree[F]]:
        """Evaluate the prefix tree one level at a time over the dense
        node grid of `tree_schedule`.

        Equivalent to the reference's per-prefix lazy walk
        (eval_with_siblings, vidpf.py:213-261) but with each level's
        nodes computed in one pass: the shape the batched engine runs
        over whole report batches.  Returns the per-prefix payload shares (negated for
        aggregator 1) and the populated tree.
        """
        if agg_id not in range(2):
            raise ValueError("invalid aggregator ID")
        if len(correction_words) != self.BITS:
            raise ValueError("correction words have incorrect length")
        if level not in range(self.BITS):
            raise ValueError("level too deep")
        for prefix in prefixes:
            if len(prefix) != level + 1:
                raise ValueError("prefix with incorrect length")
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("candidate prefixes are non-unique")

        root = EvalNode(key, bool(agg_id), self.field.zeros(self.VALUE_LEN),
                        b"")
        tree: PrefixTree[F] = PrefixTree()
        schedule = tree_schedule(prefixes, level)
        prev: dict[Path, EvalNode[F]] = {(): root}
        for (depth, paths) in enumerate(schedule):
            nodes: dict[Path, EvalNode[F]] = {}
            for path in paths:
                parent = prev[path[:-1]]
                nodes[path] = self.eval_next(
                    parent, correction_words[depth], ctx, nonce, path)
            tree.levels.append(nodes)
            prev = nodes

        out_share = []
        for prefix in prefixes:
            w = tree.levels[level][prefix].w
            out_share.append(list(w) if agg_id == 0 else vec_neg(w))
        return (out_share, tree)

    def get_beta_share(self,
                       agg_id: int,
                       correction_words: list[CorrectionWord],
                       key: bytes,
                       ctx: bytes,
                       nonce: bytes,
                       ) -> list[F]:
        """Each party's share of beta: the sum of the two depth-1
        payloads (reference vidpf.py:263-279)."""
        root = EvalNode(key, bool(agg_id), self.field.zeros(self.VALUE_LEN),
                        b"")
        left = self.eval_next(root, correction_words[0], ctx, nonce,
                              (False,))
        right = self.eval_next(root, correction_words[0], ctx, nonce,
                               (True,))
        beta_share = vec_add(left.w, right.w)
        if agg_id == 1:
            beta_share = vec_neg(beta_share)
        return beta_share

    def eval_next(self,
                  node: EvalNode[F],
                  correction_word: CorrectionWord,
                  ctx: bytes,
                  nonce: bytes,
                  path: Path,
                  ) -> EvalNode[F]:
        """Extend `node`, select/correct the child on `path`'s last bit,
        convert to a payload + next seed, and attach the corrected node
        proof (reference vidpf.py:281-325).

        Scalar reference note: branches on secret control bits below are
        replaced by lane-wise selects in the batched engine, which is
        constant-time by construction.
        """
        (seed_cw, ctrl_cw, w_cw, proof_cw) = correction_word
        keep = int(path[-1])

        (s, t) = self.extend(node.seed, ctx, nonce)
        if node.ctrl:
            s[keep] = xor(s[keep], seed_cw)
            t[keep] ^= ctrl_cw[keep]

        (next_seed, w) = self.convert(s[keep], ctx, nonce)
        next_ctrl = t[keep]
        if next_ctrl:
            w = vec_add(w, w_cw)

        proof = self.node_proof(next_seed, ctx, path)
        if next_ctrl:
            proof = xor(proof, proof_cw)

        return EvalNode(next_seed, next_ctrl, w, proof)

    def verify(self, proof0: bytes, proof1: bytes) -> bool:
        return proof0 == proof1

    # -- the two PRGs and the node hash (reference vidpf.py:330-380) --

    def extend(self,
               seed: bytes,
               ctx: bytes,
               nonce: bytes,
               ) -> tuple[list[bytes], list[bool]]:
        """Extend a seed into (left seed, right seed) plus control bits.
        The control bits are the LSBs of the child seeds, which are then
        zeroed (127-bit seeds; saves one AES block per node)."""
        xof = XofFixedKeyAes128(seed, dst(ctx, USAGE_EXTEND), nonce)
        s = [
            bytearray(xof.next(self.KEY_SIZE)),
            bytearray(xof.next(self.KEY_SIZE)),
        ]
        t = [bool(s[0][0] & 1), bool(s[1][0] & 1)]
        s[0][0] &= 0xFE
        s[1][0] &= 0xFE
        return ([bytes(s[0]), bytes(s[1])], t)

    def convert(self,
                seed: bytes,
                ctx: bytes,
                nonce: bytes,
                ) -> tuple[bytes, list[F]]:
        """Convert a selected child seed into the next-level seed and a
        payload vector."""
        xof = XofFixedKeyAes128(seed, dst(ctx, USAGE_CONVERT), nonce)
        next_seed = xof.next(XofFixedKeyAes128.SEED_SIZE)
        payload = xof.next_vec(self.field, self.VALUE_LEN)
        return (next_seed, payload)

    def node_proof(self,
                   seed: bytes,
                   ctx: bytes,
                   path: Path) -> bytes:
        """TurboSHAKE proof binding (seed, BITS, level, path)."""
        binder = \
            to_le_bytes(self.BITS, 2) + \
            to_le_bytes(len(path) - 1, 2) + \
            encode_path(path)
        xof = XofTurboShake128(seed, dst(ctx, USAGE_NODE_PROOF), binder)
        return xof.next(PROOF_SIZE)

    # -- public-share wire format (reference vidpf.py:382-394) -----

    def encode_public_share(self,
                            correction_words: list[CorrectionWord]) -> bytes:
        (seeds, ctrl, payloads, proofs) = zip(*correction_words)
        encoded = bytes()
        encoded += pack_bits_le([bit for pair in ctrl for bit in pair])
        for seed in seeds:
            encoded += seed
        for payload in payloads:
            encoded += self.field.encode_vec(payload)
        for proof in proofs:
            encoded += proof
        return encoded

    def decode_public_share(self, encoded: bytes) -> list[CorrectionWord]:
        """Inverse of encode_public_share (needed by the wire layer; the
        reference never decodes, test vectors only encode)."""
        b = self.BITS
        elem = self.field.ENCODED_SIZE
        ctrl_len = (2 * b + 7) // 8
        expect = ctrl_len + b * (self.KEY_SIZE + self.VALUE_LEN * elem
                                 + PROOF_SIZE)
        if len(encoded) != expect:
            raise ValueError("malformed public share")
        ctrl_bits = unpack_bits_le(encoded[:ctrl_len], 2 * b)
        off = ctrl_len
        seeds = [encoded[off + i * self.KEY_SIZE:
                         off + (i + 1) * self.KEY_SIZE] for i in range(b)]
        off += b * self.KEY_SIZE
        payloads = []
        for i in range(b):
            payloads.append(self.field.decode_vec(
                encoded[off:off + self.VALUE_LEN * elem]))
            off += self.VALUE_LEN * elem
        proofs = [encoded[off + i * PROOF_SIZE:
                          off + (i + 1) * PROOF_SIZE] for i in range(b)]
        return [
            (seeds[i], [ctrl_bits[2 * i], ctrl_bits[2 * i + 1]],
             payloads[i], proofs[i])
            for i in range(b)
        ]

    def is_prefix(self, x: Path, y: Path, level: int) -> bool:
        """True iff `x` is the level-`level` prefix of `y`."""
        return x == y[:level + 1]

    # -- test helpers (reference vidpf.py:409-427) -----------------

    def test_index_from_int(self, value: int, length: int) -> Path:
        assert length <= self.BITS
        return tuple(
            (value >> (length - 1 - i)) & 1 != 0 for i in range(length))

    def prefixes_for_level(self, level: int) -> tuple[Path, ...]:
        """Every (level+1)-bit prefix, in lexicographic order.

        Deliberate divergence from the reference helper
        (vidpf.py:424-427), which enumerates only range(2**level) —
        the half of the prefixes whose leading bit is 0.  Tests here
        exercise on-path nodes for arbitrary alphas, so the full
        2**(level+1) enumeration is required.
        """
        return tuple(self.test_index_from_int(v, level + 1)
                     for v in range(2 ** (level + 1)))
