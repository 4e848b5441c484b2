"""Copy of `mastic_tpu/dst.py`: the domain-separation tags of every
XOF usage, in one module so that their distinctness is auditable at a
glance."""

from .common import byte, to_be_bytes

# Version of the Mastic document; 0 until adoption.
VERSION: int = 0

# Mastic usages.
USAGE_PROVE_RAND: int = 0
USAGE_PROOF_SHARE: int = 1
USAGE_QUERY_RAND: int = 2
USAGE_JOINT_RAND_SEED: int = 3
USAGE_JOINT_RAND_PART: int = 4
USAGE_JOINT_RAND: int = 5
USAGE_ONEHOT_CHECK: int = 6
USAGE_PAYLOAD_CHECK: int = 7
USAGE_EVAL_PROOF: int = 8

# VIDPF usages.
USAGE_NODE_PROOF: int = 9
USAGE_EXTEND: int = 10
USAGE_CONVERT: int = 11


def dst(ctx: bytes, usage: int) -> bytes:
    assert usage in range(12)
    return b"mastic" + byte(VERSION) + byte(usage) + ctx


def dst_alg(ctx: bytes, usage: int, algorithm_id: int) -> bytes:
    assert usage in range(12)
    assert algorithm_id in range(2 ** 32)
    return b"mastic" + byte(VERSION) + byte(usage) \
        + to_be_bytes(algorithm_id, 4) + ctx
