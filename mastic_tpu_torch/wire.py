"""Message sizes of every inter-party channel (copy of the size
formulas of `mastic_tpu/wire.py`, over the port's Mastic parameter
classes).  The codecs themselves stay with the party layer."""

from .scalar.vidpf import PROOF_SIZE, Vidpf
from .scalar.xof import XofTurboShake128

SEED_SIZE = XofTurboShake128.SEED_SIZE
KEY_SIZE = Vidpf.KEY_SIZE


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
