"""The port's wire codecs (`mastic_tpu_torch/wire.py`,
`testvec_codec.py`), the party upload marshalling
(`BatchedMastic.marshal_party_reports` and `marshal_party_blobs`) and
the communication report, bit for bit against the JAX package's.

Every case shards the same reports through both scalar layers from one
numpy seed; nothing here compiles a JAX program.
"""

import numpy as np
import pytest
import torch

import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
from mastic_tpu import testvec_codec as jcodec
from mastic_tpu import wire as jwire
from mastic_tpu.backend.mastic_jax import BatchedMastic as JaxBatchedMastic
from mastic_tpu.drivers import parties as jparties
from mastic_tpu_torch import convert
from mastic_tpu_torch import testvec_codec as tcodec
from mastic_tpu_torch import wire as twire
from mastic_tpu_torch.drivers import parties as tparties
from mastic_tpu_torch.drivers.communication import communication_report

CTX = b"wire codecs"

# (class name, args, measurements): every circuit at a small size.
CIRCUITS = [
    ("MasticCount", (3,), [(0b101, True), (0b010, False)]),
    ("MasticSum", (3, 7), [(0b110, 5), (0b001, 0)]),
    ("MasticSumVec", (2, 3, 2, 2), [(0b10, [1, 3, 0]), (0b01, [2, 0, 1])]),
    ("MasticHistogram", (2, 4, 2), [(0b11, 3), (0b00, 1)]),
    ("MasticMultihotCountVec", (2, 4, 2, 2),
     [(0b01, [True, False, True, False]), (0b10, [False] * 4)]),
]
IDS = [c[0] for c in CIRCUITS]


def _path(value: int, bits: int) -> tuple:
    return tuple(bool((value >> (bits - 1 - i)) & 1) for i in range(bits))


def _case(name: str, args: tuple, meas: list, seed: int = 0) -> tuple:
    """(port Mastic, JAX Mastic, port reports, JAX reports): the same
    shards from both scalar layers."""
    rng = np.random.default_rng(seed)
    port = getattr(tbm, name)(*args)
    ref = getattr(jm, name)(*args)
    (preps, jreps) = ([], [])
    for (alpha, weight) in meas:
        m = (_path(alpha, args[0]), weight)
        (nonce, rand) = (rng.bytes(16), rng.bytes(ref.RAND_SIZE))
        preps.append((nonce,) + port.scalar().shard(CTX, m, nonce, rand))
        jreps.append((nonce,) + ref.shard(CTX, m, nonce, rand))
    return (port, ref, preps, jreps)


@pytest.mark.parametrize("case", CIRCUITS, ids=IDS)
def test_codecs_give_the_jax_bytes(case):
    """encode/decode of reports, input, public, prep and aggregate
    shares and prep messages: the port's bytes are the JAX package's,
    and every decoder inverts its encoder."""
    (port, ref, preps, jreps) = _case(*case)
    ps = port.scalar()
    vk = bytes(range(32))
    level = port.bits - 1
    agg_param = (level, tuple(_path(a, port.bits) for (a, _w) in case[2]),
                 True)
    for ((nonce, pub, shares), (_n, jpub, jshares)) in zip(preps, jreps):
        assert tcodec.encode_public_share(ps, pub) \
            == jcodec.encode_public_share(ref, jpub)
        assert twire.public_share_size(port) == jwire.public_share_size(ref)
        for agg_id in range(2):
            blob = twire.encode_report(port, agg_id, nonce, pub,
                                       shares[agg_id])
            assert blob == jwire.encode_report(ref, agg_id, nonce, jpub,
                                               jshares[agg_id])
            assert len(blob) == twire.report_size(port, agg_id) \
                == jwire.report_size(ref, agg_id)
            decoded = twire.decode_report(port, agg_id, blob)
            assert twire.encode_report(port, agg_id, *decoded) == blob
            share = tcodec.encode_input_share(ps, shares[agg_id])
            assert share == jcodec.encode_input_share(ref, jshares[agg_id])
            assert twire.decode_input_share(port, agg_id, share) \
                == shares[agg_id]
        (states, pshares, jstates, jpshares) = ([], [], [], [])
        for agg_id in range(2):
            (st, sh) = ps.prep_init(vk, CTX, agg_id, agg_param, nonce, pub,
                                    shares[agg_id])
            (jst, jsh) = ref.prep_init(vk, CTX, agg_id, agg_param, nonce,
                                       jpub, jshares[agg_id])
            blob = tcodec.encode_prep_share(ps, sh)
            assert blob == jcodec.encode_prep_share(ref, jsh)
            assert len(blob) == twire.prep_share_size(port, agg_param)
            assert tcodec.encode_prep_share(
                ps, twire.decode_prep_share(port, agg_param, blob)) == blob
            states.append(st)
            pshares.append(sh)
        msg = ps.prep_shares_to_prep(CTX, agg_param, pshares)
        enc = tcodec.encode_prep_msg(ps, msg)
        assert enc == jcodec.encode_prep_msg(
            ref, ref.prep_shares_to_prep(CTX, agg_param, [
                ref.prep_init(vk, CTX, a, agg_param, nonce, jpub,
                              jshares[a])[1] for a in range(2)]))
        assert twire.decode_prep_msg(port, agg_param, enc) == msg
        out = ps.prep_next(CTX, states[0], msg)
        agg = ps.agg_update(agg_param, ps.agg_init(agg_param), out)
        blob = tcodec.encode_agg_share(ps, agg)
        assert len(blob) == twire.agg_share_size(port, agg_param)
        assert tcodec.encode_agg_share(
            ps, twire.decode_agg_share(port, agg_param, blob)) == blob
    vec = {}
    assert tcodec.set_type_param(ps, vec) == jcodec.set_type_param(ref, {})
    assert vec["vidpf_bits"] == port.bits


def _decoders(port, ref, preps, jreps) -> list:
    """(port decoder, JAX decoder, one honest encoding) per channel."""
    (nonce, pub, shares) = preps[0]
    agg_param = (port.bits - 1, (_path(0, port.bits),), True)
    vk = bytes(32)
    pshare = port.scalar().prep_init(vk, CTX, 0, agg_param, nonce, pub,
                                     shares[0])[1]
    return [
        (lambda b: twire.decode_report(port, 0, b),
         lambda b: jwire.decode_report(ref, 0, b),
         twire.encode_report(port, 0, nonce, pub, shares[0])),
        (lambda b: twire.decode_input_share(port, 1, b),
         lambda b: jwire.decode_input_share(ref, 1, b),
         tcodec.encode_input_share(port.scalar(), shares[1])),
        (lambda b: twire.decode_prep_share(port, agg_param, b),
         lambda b: jwire.decode_prep_share(ref, agg_param, b),
         tcodec.encode_prep_share(port.scalar(), pshare)),
        (lambda b: twire.decode_prep_msg(port, agg_param, b),
         lambda b: jwire.decode_prep_msg(ref, agg_param, b), b"\x00" * 32),
        (lambda b: twire.decode_agg_share(port, agg_param, b),
         lambda b: jwire.decode_agg_share(ref, agg_param, b),
         b"\x00" * twire.agg_share_size(port, agg_param)),
        (lambda b: twire.decode_public_share(port, b),
         lambda b: jwire.decode_public_share(ref, b),
         port.scalar().vidpf.encode_public_share(pub)),
    ]


def _outcome(decode, blob) -> tuple:
    try:
        decode(blob)
    except (ValueError, EOFError) as exc:
        return (type(exc).__name__, str(exc))
    return ("ok", "")


@pytest.mark.parametrize("case", [CIRCUITS[0], CIRCUITS[3]],
                         ids=["Count", "Histogram-jointrand"])
def test_malformed_inputs_raise_the_jax_messages(case):
    """Truncated, oversized, empty, out-of-range and bit-flipped inputs:
    each decoder refuses (or accepts) exactly as the JAX package's, with
    the same exception type and message, which names the channel."""
    (port, ref, preps, jreps) = _case(*case)
    for (decode, jdecode, honest) in _decoders(port, ref, preps, jreps):
        bads = [honest[:-1], honest + b"\x00", b"", b"\xff" * len(honest)]
        bads += [honest[:pos] + bytes([honest[pos] ^ 0x80])
                 + honest[pos + 1:]
                 for pos in {0, len(honest) // 3, len(honest) // 2,
                             len(honest) - 1}]
        for bad in bads:
            assert _outcome(decode, bad) == _outcome(jdecode, bad), bad
    size = twire.agg_share_size(port, (1, ((False, True),), True))
    with pytest.raises(ValueError, match="aggregate share"):
        twire.decode_agg_share(port, (1, ((False, True),), True),
                               b"\xff" * size)


def test_framing_matches_jax():
    framed = twire.frame(b"payload") + twire.frame(b"")
    assert framed == jwire.frame(b"payload") + jwire.frame(b"")
    assert twire.unframe(framed) == jwire.unframe(framed)
    assert twire.unframe_at(framed, 11) == (b"", 15)
    for cut in (framed[:3], framed[:-6]):
        with pytest.raises(ValueError, match="frame") as ei:
            twire.unframe(cut)
        with pytest.raises(ValueError) as ej:
            jwire.unframe(cut)
        assert str(ei.value) == str(ej.value)


def test_party_codecs_match_jax():
    """The quarantine ack, the round command and the upload body."""
    entries = [(3, 1, "x"), (70000, 2, "y")]
    assert tparties.encode_quarantine(entries) \
        == jparties.encode_quarantine(entries)
    assert tparties.decode_quarantine(
        tparties.encode_quarantine(entries)) == [(3, 1), (70000, 2)]
    mask = np.array([True, False, False, True, True, False, False, False,
                     True])
    cmd = tparties.encode_round_cmd(b"param", mask)
    assert cmd == jparties.encode_round_cmd(b"param", mask)
    (param, got) = tparties.decode_round_cmd(cmd, 9)
    assert param == b"param" and list(got) == list(mask)
    for (bad, n) in ((cmd[:3], 9), (cmd[:7], 9), (cmd + b"\x00", 9),
                     (b"\x00" * 5, 0)):
        outcomes = []
        for mod in (tparties, jparties):
            try:
                mod.decode_round_cmd(bad, n)
                outcomes.append("ok")
            except ValueError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
    blobs = [b"a", b"", b"report"]
    body = tparties.upload_body(blobs)
    assert tparties._parse_upload_body(body) == blobs \
        == jparties._parse_upload_body(body)
    for bad in (body[:2], body[:-1], body + b"\x00"):
        with pytest.raises(ValueError) as ei:
            tparties._parse_upload_body(bad)
        with pytest.raises(ValueError) as ej:
            jparties._parse_upload_body(bad)
        assert str(ei.value) == str(ej.value)


def _arrays(kwargs: dict) -> dict:
    """prep keyword arguments (either package's) as numpy: the
    correction words by field, limbs as uint32."""
    out = {}
    for (key, val) in kwargs.items():
        if val is None:
            out[key] = None
        elif key == "cws":
            for field in ("seed", "ctrl", "w", "proof"):
                out[f"cws_{field}"] = _np(getattr(val, field))
        else:
            out[key] = _np(val)
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return convert.to_numpy(x, words=True)
    arr = np.asarray(x)
    return arr.view(np.uint32) if arr.dtype == np.int32 else arr


@pytest.mark.parametrize("case", CIRCUITS, ids=IDS)
def test_marshal_party_reports_matches_jax(case):
    """One party's view of the upload, for both aggregators: the port's
    `marshal_party_reports` gives the JAX package's arrays, and the
    on-device parse of the same blobs (`marshal_party_blobs`, what
    `AggregatorParty.load_reports` runs) gives the same tensors."""
    (port, ref, preps, jreps) = _case(*case)
    (bm, jbm) = (tbm.BatchedMastic(port), JaxBatchedMastic(ref))
    for agg_id in range(2):
        views = [(n, pub, sh[agg_id]) for (n, pub, sh) in preps]
        jviews = [(n, pub, sh[agg_id]) for (n, pub, sh) in jreps]
        got = _arrays(bm.marshal_party_reports(agg_id, views, "cpu"))
        want = _arrays(jbm.marshal_party_reports(agg_id, jviews))
        assert got.keys() == want.keys()
        for key in want:
            if want[key] is None:
                assert got[key] is None, key
            else:
                np.testing.assert_array_equal(got[key], want[key], key)
        rows = np.stack([np.frombuffer(
            twire.encode_report(port, agg_id, *v), np.uint8) for v in views])
        (parsed, ok) = bm.marshal_party_blobs(agg_id, rows, "cpu")
        assert ok.all()
        parsed = _arrays(parsed)
        for key in want:
            if want[key] is None:
                assert parsed[key] is None, key
            else:
                np.testing.assert_array_equal(parsed[key], want[key], key)


def test_marshal_party_blobs_flags_what_decode_refuses():
    """A payload element >= p, a proof-share element >= p and nonzero
    ctrl padding bits: each refused by `decode_report`, each flagged by
    the batched parse, the other rows untouched."""
    (port, _ref, preps, _j) = _case(*CIRCUITS[0])
    bm = tbm.BatchedMastic(port)
    blob = twire.encode_report(port, 0, *[preps[0][0], preps[0][1],
                                          preps[0][2][0]])
    ctrl_len = (2 * port.bits + 7) // 8
    payload = 16 + ctrl_len + port.bits * 16
    proof_share = len(blob) - port.valid.PROOF_LEN * 8
    bad = [bytearray(blob) for _ in range(3)]
    bad[0][payload:payload + 8] = b"\xff" * 8
    bad[1][proof_share:proof_share + 8] = b"\xff" * 8
    bad[2][16 + ctrl_len - 1] |= 0x80
    rows = np.stack([np.frombuffer(bytes(b), np.uint8)
                     for b in [blob] + bad])
    (_parsed, ok) = bm.marshal_party_blobs(0, rows, "cpu")
    assert ok.tolist() == [True, False, False, False]
    for b in bad:
        with pytest.raises(ValueError):
            twire.decode_report(port, 0, bytes(b))


def test_communication_report_matches_jax():
    """The port's measured report (real shards, the port's codecs) has
    the JAX package's numbers: its wire size formulas for the three
    Mastic configurations, and its analytic Poplar1 and Prio3 rows (the
    JAX package's own tests hold its measured report to the same
    formulas)."""
    from mastic_tpu.drivers import communication as jcomm

    out = communication_report(print_fn=lambda *_: None)
    want = {}
    for (name, ref) in (("MasticCount(256)", jm.MasticCount(256)),
                        ("MasticSum(256, max=255)", jm.MasticSum(256, 255)),
                        ("MasticHistogram(32, 100, 10)",
                         jm.MasticHistogram(32, 100, 10))):
        sizes = (jwire.public_share_size(ref),
                 jwire.input_share_size(ref, 0),
                 jwire.input_share_size(ref, 1))
        want[name] = dict(zip(("public_share", "leader_share",
                               "helper_share"), sizes), upload=sum(sizes))
    want["Poplar1(256)"] = jcomm.poplar1_sizes(256)
    want["Prio3Histogram(10000, 100)"] = jcomm.prio3_histogram_sizes(10000,
                                                                     100)
    want["prep_rounds"] = {"mastic": 1, "poplar1_spec": 2}
    want["mastic_count_vs_poplar1_upload"] = (
        want["MasticCount(256)"]["upload"] / want["Poplar1(256)"]["upload"])
    want["prio3_vs_mastic_histogram_upload"] = (
        want["Prio3Histogram(10000, 100)"]["upload"]
        / want["MasticHistogram(32, 100, 10)"]["upload"])
    assert out == want
