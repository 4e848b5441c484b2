"""Copy of `mastic_tpu/testvec_codec.py` over the port's scalar layer:
the byte encodings of the wire messages, in the layout of the draft's
test vectors (`scalar/mastic.py` instances; the public share's
encoder is the VIDPF's own).  The wire codecs (`wire.py`) build on
them."""

from typing import Any

from .scalar.mastic import (Mastic, MasticInputShare, MasticPrepMessage,
                            MasticPrepShare)
from .scalar.vidpf import CorrectionWord


def set_type_param(mastic: Mastic, test_vec: dict[str, Any]) -> list[str]:
    test_vec["vidpf_bits"] = int(mastic.vidpf.BITS)
    return ["vidpf_bits"] + \
        mastic.flp.valid.test_vec_set_type_param(test_vec)


def encode_input_share(mastic: Mastic,
                       input_share: MasticInputShare) -> bytes:
    (key, proof_share, seed, peer_joint_rand_part) = input_share
    optional = [
        mastic.field.encode_vec(proof_share)
        if proof_share is not None else b"",
        seed or b"",
        peer_joint_rand_part or b"",
    ]
    return key + b"".join(optional)


def encode_public_share(mastic: Mastic,
                        correction_words: list[CorrectionWord]) -> bytes:
    return mastic.vidpf.encode_public_share(correction_words)


def encode_agg_share(mastic: Mastic, agg_share: list) -> bytes:
    return mastic.field.encode_vec(agg_share) if agg_share else b""


def encode_prep_share(mastic: Mastic,
                      prep_share: MasticPrepShare) -> bytes:
    (eval_proof, verifier_share, joint_rand_part) = prep_share
    return eval_proof + (joint_rand_part or b"") + (
        mastic.field.encode_vec(verifier_share)
        if verifier_share is not None else b"")


def encode_prep_msg(mastic: Mastic,
                    prep_message: MasticPrepMessage) -> bytes:
    return prep_message or b""
