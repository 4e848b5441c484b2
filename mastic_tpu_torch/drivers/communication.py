"""Communication-cost report (port of
`mastic_tpu/drivers/communication.py`): the measured wire sizes of one
report of each of the draft's comparison configurations, encoded by
the port's codecs (`testvec_codec.py` over the scalar layer), beside
the protocol-shape facts the draft states (1 prep round against
Poplar1's 2).

The headline comparison — Mastic against Poplar1(256) upload,
MasticHistogram against Prio3Histogram upload — is analytic, from the
published vdaf-13 constants: Poplar1's sizes follow from the
IdpfBBCGGI21 wire structure (vdaf-13 §8), and Prio3Histogram's from
the Prio3 wire layout (vdaf-13 §7) with MEAS_LEN / PROOF_LEN taken from
the scalar layer's Histogram circuit (Prio3 uses the identical BBCGGI19
circuit family).
"""

from .. import testvec_codec as codec
from ..backend.mastic import MasticCount, MasticHistogram, MasticSum
from ..scalar.common import gen_rand
from ..scalar.field import Field128
from ..scalar.flp import FlpBBCGGI19, Histogram


def report_sizes(mastic, measurement) -> dict:
    """Encode one report of the port's Mastic `mastic` (sharded by its
    scalar twin) and measure each wire message."""
    scalar = mastic.scalar()
    ctx = b"sizes"
    nonce = gen_rand(scalar.NONCE_SIZE)
    rand = gen_rand(scalar.RAND_SIZE)
    (public_share, input_shares) = scalar.shard(ctx, measurement, nonce,
                                                rand)
    public = len(codec.encode_public_share(scalar, public_share))
    leader = len(codec.encode_input_share(scalar, input_shares[0]))
    helper = len(codec.encode_input_share(scalar, input_shares[1]))
    return {
        "public_share": public,
        "leader_share": leader,
        "helper_share": helper,
        "upload": public + leader + helper,
    }


def poplar1_sizes(bits: int) -> dict:
    """Analytic Poplar1(bits) upload sizes from the published vdaf-13
    §8 wire structure.

    IdpfBBCGGI21: KEY_SIZE 16, two packed control bits per level, a
    16-byte seed correction per level, VALUE_LEN 2 payload corrections
    over Field64 (8 B) for inner levels and Field255 (32 B) for the
    leaf.  Each input share carries the IDPF key and a 32-byte
    correlated-randomness seed; the leader additionally carries the
    explicit sketch correlation — a (a, b, c) triple per level, Field64
    inner / Field255 leaf.
    """
    public = ((2 * bits + 7) // 8    # packed control bits
              + bits * 16            # seed corrections
              + (bits - 1) * 2 * 8   # inner payload corrections
              + 2 * 32)              # leaf payload correction
    leader = 16 + 32 + 3 * (bits - 1) * 8 + 3 * 32
    helper = 16 + 32
    return {
        "public_share": public,
        "leader_share": leader,
        "helper_share": helper,
        "upload": public + leader + helper,
        "analytic": True,
    }


def prio3_histogram_sizes(length: int, chunk_length: int) -> dict:
    """Analytic Prio3Histogram(2 shares, length, chunk_length) upload
    sizes from the vdaf-13 §7 wire layout, with MEAS_LEN / PROOF_LEN
    taken from the scalar layer's Histogram circuit (Prio3 instantiates
    the identical BBCGGI19 circuit over Field128).

    Public share: one 32-byte joint-rand part per aggregator.  Leader
    share: explicit measurement + proof shares plus a 32-byte
    joint-rand blind.  Helper share: a 32-byte expansion seed plus the
    blind.
    """
    flp = FlpBBCGGI19(Histogram(Field128, length, chunk_length))
    elem = Field128.ENCODED_SIZE
    public = 2 * 32
    leader = (flp.MEAS_LEN + flp.PROOF_LEN) * elem + 32
    helper = 32 + 32
    return {
        "public_share": public,
        "leader_share": leader,
        "helper_share": helper,
        "upload": public + leader + helper,
        "analytic": True,
    }


def communication_report(print_fn=print) -> dict:
    """Mastic upload sizes for the draft's comparison configurations,
    plus the analytic Poplar1/Prio3 comparison."""
    out = {}
    alpha256 = (False,) * 256

    out["MasticCount(256)"] = report_sizes(MasticCount(256),
                                           (alpha256, 1))
    out["MasticSum(256, max=255)"] = report_sizes(
        MasticSum(256, 255), (alpha256, 17))
    out["MasticHistogram(32, 100, 10)"] = report_sizes(
        MasticHistogram(32, 100, 10), ((False,) * 32, 3))
    out["Poplar1(256)"] = poplar1_sizes(256)
    # MasticHistogram(32, 100, 10) in attribute-metrics mode (100
    # attributes x 100 buckets) against a flat Prio3Histogram over
    # 100*100 buckets with chunk = floor(sqrt(10000)).
    out["Prio3Histogram(10000, 100)"] = prio3_histogram_sizes(10000, 100)
    out["prep_rounds"] = {"mastic": 1, "poplar1_spec": 2}
    out["mastic_count_vs_poplar1_upload"] = (
        out["MasticCount(256)"]["upload"]
        / out["Poplar1(256)"]["upload"])
    out["prio3_vs_mastic_histogram_upload"] = (
        out["Prio3Histogram(10000, 100)"]["upload"]
        / out["MasticHistogram(32, 100, 10)"]["upload"])

    for (name, sizes) in out.items():
        print_fn(f"{name}: {sizes}")
    return out
