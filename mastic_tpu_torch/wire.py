"""Inter-party wire codec (copy of `mastic_tpu/wire.py` over the port's
Mastic parameter classes): the size of every channel's message, the
decoders of the encodings in `testvec_codec.py`, and the framing the
process-separated parties (`drivers/parties.py`) speak.

Every function takes a `backend.mastic.Mastic` instance; the field
elements, correction words and shares they read and return are those of
its scalar twin (`Mastic.scalar()`), so the bytes are the JAX package's
bytes.  All message lengths are static given (instantiation, agg_id,
agg_param).  A decoder refuses a malformed message with a ValueError
(or EOFError) whose text names the channel.
"""

import struct
from typing import IO, Optional

from .scalar.vidpf import PROOF_SIZE, Vidpf
from .scalar.xof import XofTurboShake128

SEED_SIZE = XofTurboShake128.SEED_SIZE
KEY_SIZE = Vidpf.KEY_SIZE


# -- sizes -----------------------------------------------------------

def input_share_size(mastic, agg_id: int) -> int:
    """One aggregator's input share: its VIDPF key, then the leader's
    FLP proof share or the helper's seed, and for joint-rand circuits
    a seed and the peer's joint-rand part."""
    use_jr = mastic.valid.JOINT_RAND_LEN > 0
    if agg_id == 0:
        size = KEY_SIZE + mastic.valid.PROOF_LEN * mastic.field.ENCODED_SIZE
        if use_jr:
            size += 2 * SEED_SIZE
    else:
        size = KEY_SIZE + SEED_SIZE
        if use_jr:
            size += SEED_SIZE
    return size


def prep_share_size(mastic, agg_param) -> int:
    """One aggregator's prep share: the eval proof, and on weight-check
    rounds the joint-rand part and the FLP verifier share."""
    (_level, _prefixes, do_weight_check) = agg_param
    size = PROOF_SIZE
    if do_weight_check:
        if mastic.valid.JOINT_RAND_LEN > 0:
            size += SEED_SIZE
        size += mastic.valid.VERIFIER_LEN * mastic.field.ENCODED_SIZE
    return size


def agg_share_size(mastic, agg_param) -> int:
    """One aggregate share: per prefix the counter and the truncated
    weight."""
    (_level, prefixes, _wc) = agg_param
    return len(prefixes) * (1 + mastic.valid.OUTPUT_LEN) \
        * mastic.field.ENCODED_SIZE


def report_size(mastic, agg_id: int) -> int:
    """One aggregator's view of an upload blob: nonce ‖ public share
    ‖ that party's input share (decode_report refuses other sizes)."""
    return (mastic.NONCE_SIZE + public_share_size(mastic)
            + input_share_size(mastic, agg_id))


def public_share_size(mastic) -> int:
    """ceil(2*BITS/8) packed ctrl bits + per-level seed, payload CW
    and proof CW."""
    bits = mastic.bits
    return (2 * bits + 7) // 8 + bits * (
        KEY_SIZE + PROOF_SIZE + mastic.value_len * mastic.field.ENCODED_SIZE)


# -- decoders (inverses of testvec_codec's encoders) -----------------

def decode_input_share(mastic, agg_id: int, encoded: bytes) -> tuple:
    if len(encoded) != input_share_size(mastic, agg_id):
        raise ValueError(
            f"input share has incorrect length: got {len(encoded)}, "
            f"want {input_share_size(mastic, agg_id)}")
    use_jr = mastic.valid.JOINT_RAND_LEN > 0
    (key, rest) = (encoded[:KEY_SIZE], encoded[KEY_SIZE:])
    proof_share = None
    seed = None
    if agg_id == 0:
        plen = mastic.valid.PROOF_LEN * mastic.field.ENCODED_SIZE
        try:
            proof_share = mastic.field.decode_vec(rest[:plen])
        except ValueError as exc:
            raise ValueError(f"input share: proof share: {exc}")
        rest = rest[plen:]
        if use_jr:
            (seed, rest) = (rest[:SEED_SIZE], rest[SEED_SIZE:])
    else:
        (seed, rest) = (rest[:SEED_SIZE], rest[SEED_SIZE:])
    peer_part = rest[:SEED_SIZE] if use_jr else None
    return (key, proof_share, seed, peer_part)


def decode_public_share(mastic, encoded: bytes) -> list:
    return mastic.scalar().vidpf.decode_public_share(encoded)


def decode_prep_share(mastic, agg_param, encoded: bytes) -> tuple:
    if len(encoded) != prep_share_size(mastic, agg_param):
        raise ValueError(
            f"prep share has incorrect length: got {len(encoded)}, "
            f"want {prep_share_size(mastic, agg_param)}")
    (_level, _prefixes, do_weight_check) = agg_param
    (eval_proof, rest) = (encoded[:PROOF_SIZE], encoded[PROOF_SIZE:])
    verifier = None
    jr_part = None
    if do_weight_check:
        if mastic.valid.JOINT_RAND_LEN > 0:
            (jr_part, rest) = (rest[:SEED_SIZE], rest[SEED_SIZE:])
        try:
            verifier = mastic.field.decode_vec(rest)
        except ValueError as exc:
            raise ValueError(f"prep share: verifier: {exc}")
    return (eval_proof, verifier, jr_part)


def decode_prep_msg(mastic, agg_param, encoded: bytes) -> Optional[bytes]:
    (_level, _prefixes, do_weight_check) = agg_param
    if do_weight_check and mastic.valid.JOINT_RAND_LEN > 0:
        if len(encoded) != SEED_SIZE:
            raise ValueError("prep message has incorrect length")
        return encoded
    if encoded != b"":
        raise ValueError("unexpected prep message payload")
    return None


def decode_agg_share(mastic, agg_param, encoded: bytes) -> list:
    if len(encoded) != agg_share_size(mastic, agg_param):
        raise ValueError(
            f"aggregate share has incorrect length: got "
            f"{len(encoded)}, want {agg_share_size(mastic, agg_param)}")
    try:
        return mastic.field.decode_vec(encoded)
    except ValueError as exc:
        raise ValueError(f"aggregate share: {exc}")


# -- report upload framing -------------------------------------------

def encode_report(mastic, agg_id: int, nonce: bytes, public_share: list,
                  input_share: tuple) -> bytes:
    """One aggregator's view of an upload: nonce || public share ||
    that party's input share (all fixed-size for the instantiation)."""
    from .testvec_codec import encode_input_share

    scalar = mastic.scalar()
    return nonce + scalar.vidpf.encode_public_share(public_share) \
        + encode_input_share(scalar, input_share)


def decode_report(mastic, agg_id: int, encoded: bytes) -> tuple:
    if len(encoded) != report_size(mastic, agg_id):
        raise ValueError(
            f"report for aggregator {agg_id} has incorrect length: "
            f"got {len(encoded)}, want {report_size(mastic, agg_id)}")
    nonce = encoded[:mastic.NONCE_SIZE]
    rest = encoded[mastic.NONCE_SIZE:]
    ps_size = public_share_size(mastic)
    try:
        public_share = decode_public_share(mastic, rest[:ps_size])
    except ValueError as exc:
        raise ValueError(f"report: public share: {exc}")
    try:
        input_share = decode_input_share(mastic, agg_id, rest[ps_size:])
    except ValueError as exc:
        raise ValueError(f"report: {exc}")
    return (nonce, public_share, input_share)


# -- stream framing for the party channels ---------------------------

def send_msg(stream: IO[bytes], payload: bytes) -> None:
    stream.write(struct.pack("<I", len(payload)) + payload)
    stream.flush()


def recv_msg(stream: IO[bytes]) -> Optional[bytes]:
    header = stream.read(4)
    if len(header) < 4:
        return None
    (length,) = struct.unpack("<I", header)
    payload = stream.read(length)
    if len(payload) < length:
        raise EOFError("truncated message")
    return payload


def frame(payload: bytes) -> bytes:
    """Length-prefix a message for embedding in a larger blob."""
    return struct.pack("<I", len(payload)) + payload


def unframe(buf: bytes) -> tuple:
    """Pop one length-prefixed message: -> (payload, rest).  A
    truncated header or payload raises (returning a silently-short
    payload would turn a framing error into a content mismatch)."""
    (payload, end) = unframe_at(buf, 0)
    return (payload, buf[end:])


def unframe_at(buf, offset: int) -> tuple:
    """The frame at `offset` of `buf` -> (payload, offset after it),
    with unframe's refusals.  A parser walking many frames moves the
    offset instead of copying the rest of the buffer at every frame."""
    if len(buf) < offset + 4:
        raise ValueError("truncated frame header")
    (length,) = struct.unpack_from("<I", buf, offset)
    end = offset + 4 + length
    if len(buf) < end:
        raise ValueError("truncated frame payload")
    return (bytes(buf[offset + 4:end]), end)
