"""Deterministic test-vector generator (copy of
`mastic_tpu/gen_test_vec.py` over the port's scalar layer).

Re-emits the nine conformance vectors of the draft's
`test_vec/mastic/` byte for byte (JSON formatting included): shard,
prep, aggregate and unshard of `scalar/mastic.py`, every wire message
encoded by `testvec_codec.py`.  Randomness is the counting-byte
pattern (00 01 02 ...) for every nonce, shard rand and the verify
key, the convention of every shipped vector's "rand" field.

Nothing here touches a card.  Run as a module to (re)write the files:
    python -m mastic_tpu_torch.gen_test_vec [output_dir]
"""

import json
import os
import sys

from . import testvec_codec as codec
from .scalar.mastic import (Mastic, MasticCount, MasticHistogram,
                            MasticMultihotCountVec, MasticSum, MasticSumVec)


def deterministic_bytes(length: int) -> bytes:
    """The counting-byte test pattern used for all test-vector
    randomness."""
    return bytes(i & 0xFF for i in range(length))


def _jsonify_measurement(measurement) -> list:
    (alpha, weight) = measurement
    return [list(alpha), weight]


def gen_test_vec(mastic: Mastic, agg_param, ctx: bytes,
                 measurements: list) -> dict:
    """Run the whole protocol deterministically and capture every wire
    message, in the reference vector schema."""
    verify_key = deterministic_bytes(mastic.VERIFY_KEY_SIZE)
    nonce = deterministic_bytes(mastic.NONCE_SIZE)
    rand = deterministic_bytes(mastic.RAND_SIZE)

    test_vec: dict = {
        "agg_param": mastic.encode_agg_param(agg_param).hex(),
        "ctx": ctx.hex(),
        "prep": [],
        "shares": 2,
        "verify_key": verify_key.hex(),
    }
    codec.set_type_param(mastic, test_vec)

    agg_shares = [mastic.agg_init(agg_param) for _ in range(2)]
    for measurement in measurements:
        (public_share, input_shares) = mastic.shard(
            ctx, measurement, nonce, rand)

        prep_states = []
        prep_shares = []
        for agg_id in range(2):
            (state, share) = mastic.prep_init(
                verify_key, ctx, agg_id, agg_param, nonce, public_share,
                input_shares[agg_id])
            prep_states.append(state)
            prep_shares.append(share)
        prep_msg = mastic.prep_shares_to_prep(ctx, agg_param,
                                              prep_shares)

        out_shares = []
        for agg_id in range(2):
            out_share = mastic.prep_next(ctx, prep_states[agg_id],
                                         prep_msg)
            out_shares.append(out_share)
            agg_shares[agg_id] = mastic.agg_update(
                agg_param, agg_shares[agg_id], out_share)

        test_vec["prep"].append({
            "input_shares": [
                codec.encode_input_share(mastic, share).hex()
                for share in input_shares
            ],
            "measurement": _jsonify_measurement(measurement),
            "nonce": nonce.hex(),
            "out_shares": [
                [mastic.field.encode_vec([x]).hex() for x in out_share]
                for out_share in out_shares
            ],
            "prep_messages": [
                codec.encode_prep_msg(mastic, prep_msg).hex()],
            "prep_shares": [[
                codec.encode_prep_share(mastic, share).hex()
                for share in prep_shares
            ]],
            "public_share":
                codec.encode_public_share(mastic, public_share).hex(),
            "rand": rand.hex(),
        })

    test_vec["agg_shares"] = [
        codec.encode_agg_share(mastic, share).hex()
        for share in agg_shares
    ]
    test_vec["agg_result"] = mastic.unshard(agg_param, agg_shares,
                                            len(measurements))
    return test_vec


def render_test_vec(test_vec: dict) -> str:
    """The exact on-disk representation of the reference files."""
    return json.dumps(test_vec, indent=4, sort_keys=True) + "\n"


def _idx(mastic: Mastic, value: int, length: int) -> tuple:
    return mastic.vidpf.test_index_from_int(value, length)


def all_test_vecs() -> list[tuple[str, Mastic, tuple, list]]:
    """The nine (filename, instance, agg_param, measurements) configs
    of the draft's generator, as the JAX package lists them."""
    ctx_configs = []
    count2 = MasticCount(2)
    ctx_configs.append((
        "MasticCount_0.json", count2,
        (0, (_idx(count2, 0b0, 1), _idx(count2, 0b1, 1)), True),
        [(_idx(count2, 0b10, 2), True)]))
    ctx_configs.append((
        "MasticCount_1.json", count2,
        (1, (_idx(count2, 0b00, 2), _idx(count2, 0b01, 2)), True),
        [(_idx(count2, 0b10, 2), True)]))
    # A candidate-prefix set stressing the BFS traversal order of the
    # evaluation-proof computation.
    count5 = MasticCount(5)
    bfs_prefixes = (
        (False, False, False, False, False),
        (False, False, True, True, False),
        (False, False, True, True, True),
        (False, True, True, False, False),
        (False, True, True, True, True),
        (True, False, False, False, False),
        (True, True, True, True, True),
    )
    bfs_measurements = [
        ((False, False, False, False, False), True),
        ((False, False, False, False, False), True),
        ((False, False, True, True, True), True),
        ((False, False, True, True, False), True),
        ((False, True, True, True, True), True),
        ((False, True, True, False, False), True),
        ((False, True, True, False, False), True),
        ((False, True, True, False, False), True),
    ]
    ctx_configs.append(("MasticCount_2.json", count5,
                        (4, bfs_prefixes, True), bfs_measurements))
    # The same round without the weight check.
    ctx_configs.append(("MasticCount_3.json", count5,
                        (4, bfs_prefixes, False), bfs_measurements))

    sum3 = MasticSum(2, 2 ** 3 - 1)
    ctx_configs.append((
        "MasticSum_0.json", sum3,
        (0, (_idx(sum3, 0b0, 1), _idx(sum3, 0b1, 1)), True),
        [(_idx(sum3, 0b10, 2), 1), (_idx(sum3, 0b00, 2), 6),
         (_idx(sum3, 0b11, 2), 7), (_idx(sum3, 0b01, 2), 5),
         (_idx(sum3, 0b11, 2), 2)]))
    sum2 = MasticSum(2, 2 ** 2 - 1)
    ctx_configs.append((
        "MasticSum_1.json", sum2,
        (1, (_idx(sum2, 0b00, 2), _idx(sum2, 0b01, 2)), True),
        [(_idx(sum2, 0b10, 2), 3), (_idx(sum2, 0b00, 2), 2),
         (_idx(sum2, 0b11, 2), 0), (_idx(sum2, 0b01, 2), 1),
         (_idx(sum2, 0b01, 2), 2)]))

    sumvec = MasticSumVec(16, 3, 1, 1)
    ctx_configs.append((
        "MasticSumVec_0.json", sumvec,
        (14, (_idx(sumvec, 0b111100001111000, 15),), True),
        [(_idx(sumvec, 0b1111000011110000, 16), [0, 0, 1]),
         (_idx(sumvec, 0b1111000011110001, 16), [0, 1, 0])]))

    histogram = MasticHistogram(2, 4, 2)
    ctx_configs.append((
        "MasticHistogram_0.json", histogram,
        (1, (_idx(histogram, 0b00, 2), _idx(histogram, 0b01, 2)), True),
        [(_idx(histogram, 0b10, 2), 1), (_idx(histogram, 0b01, 2), 2),
         (_idx(histogram, 0b00, 2), 3)]))

    multihot = MasticMultihotCountVec(2, 4, 2, 2)
    ctx_configs.append((
        "MasticMultihotCountVec_0.json", multihot,
        (1, (_idx(multihot, 0b00, 2), _idx(multihot, 0b01, 2)), True),
        [(_idx(multihot, 0b10, 2), [False, True, True, False]),
         (_idx(multihot, 0b01, 2), [False, True, True, False])]))
    return ctx_configs


def main(out_dir: str) -> None:
    ctx = b"some application"
    os.makedirs(out_dir, exist_ok=True)
    for (filename, mastic, agg_param, measurements) in all_test_vecs():
        rendered = render_test_vec(
            gen_test_vec(mastic, agg_param, ctx, measurements))
        with open(os.path.join(out_dir, filename), "w") as f:
            f.write(rendered)
        print(f"wrote {filename}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "test_vec/mastic")
