"""Faults, sessions and the reliable transport of the port's party
layer (`mastic_tpu_torch/drivers/faults.py`, `session.py`,
`parties.py`, `net/transport.py`, `obs/`): the cases of the JAX
package's tests/test_faults.py and of the transport half of
tests/test_net.py, on the port's modules, with the JAX package's
outcomes, kinds, reason codes and counters.

Spawned parties run the port on the CPU (`device="cpu"`) with
OMP_NUM_THREADS=1.  Cases that need no JAX program of their own hold
the port's parties against its in-process engine, which
tests/test_torch_parties.py holds against the JAX package's.  Spawns
are the cost here (a port party imports torch): cases that share a
session's set-up share its spawn.
"""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

import mastic_tpu_torch.backend.mastic as tbm
from mastic_tpu_torch import wire
from mastic_tpu.drivers import faults as jfaults
from mastic_tpu_torch.drivers import faults
from mastic_tpu_torch.drivers.parties import (AggregationSession,
                                              AggregatorParty,
                                              ProcessCollector,
                                              REASON_MALFORMED)
from mastic_tpu_torch.drivers.session import (Channel, Deadline,
                                              SessionConfig, SessionError,
                                              reliable_accept,
                                              reliable_connect)
from mastic_tpu_torch.net import transport as transport_mod
from mastic_tpu_torch.net.transport import TcpListener, TlsConfig
from mastic_tpu_torch.obs import trace as obs_trace
from mastic_tpu_torch.obs.registry import configure as configure_registry
from mastic_tpu_torch.obs.registry import get_registry

CTX = b"fault matrix"
VK = bytes(range(32))
# Every exchange fails fast; no party runs more than a 2-report round.
CFG_FAST = SessionConfig(connect_timeout=60.0, exchange_timeout=10.0,
                         ack_timeout=10.0, round_deadline=60.0,
                         shutdown_timeout=1.0, retries=1, backoff=0.1)
RCFG = SessionConfig(connect_timeout=5.0, exchange_timeout=5.0,
                     ack_timeout=5.0, round_deadline=30.0,
                     shutdown_timeout=2.0, retries=2, backoff=0.05)
COUNT_SPEC = {"class": "MasticCount", "args": [2]}
COUNT_PARAM = (0, ((False,), (True,)), True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread_parties():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _count_reports(alphas: list, seed: int = 0) -> list:
    m = tbm.MasticCount(2).scalar()
    rng = np.random.default_rng(seed)
    reports = []
    for alpha in alphas:
        nonce = rng.bytes(m.NONCE_SIZE)
        (ps, shares) = m.shard(CTX, (alpha, 1), nonce,
                               rng.bytes(m.RAND_SIZE))
        reports.append((nonce, ps, shares))
    return reports


def _collector(cfg=CFG_FAST, faults_spec=None) -> ProcessCollector:
    return ProcessCollector(tbm.MasticCount(2), COUNT_SPEC, CTX, VK,
                            config=cfg, faults_spec=faults_spec,
                            device="cpu")


# -- the fault-spec parser: the JAX package's grammar -------------------

SPECS = [
    "kill:party=helper:step=round_start;"
    "corrupt:party=leader:step=prep_share:nth=2:xor=0x80:offset=6",
    "conn_drop:party=collector:step=upload;"
    "partition:party=leader:step=agg_param:delay=0.3",
    "slow_loris:party=helper:step=prep_share:delay=2;"
    "short_write:party=collector:step=wal_append:cut=3",
    "enospc:party=collector:step=wal_fsync;"
    "truncate:party=collector:step=upload_report:nth=4:cut=9",
    "",
    None,
]
BAD = [
    "explode:party=leader:step=x",        # unknown action
    "drop:party=martian:step=x",          # unknown party
    "drop:step=x",                        # missing party
    "drop:party=leader",                  # missing step
    "drop:party=leader:step=x:zap=1",     # unknown key
    "drop:party=leader:step",             # malformed field
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_jax(spec):
    got = [dataclasses.asdict(r) for r in faults.parse_faults(spec)]
    assert got == [dataclasses.asdict(r) for r in jfaults.parse_faults(spec)]


@pytest.mark.parametrize("bad", BAD)
def test_parse_faults_rejects_as_jax(bad):
    with pytest.raises(ValueError) as ei:
        faults.parse_faults(bad)
    with pytest.raises(ValueError) as ej:
        jfaults.parse_faults(bad)
    assert str(ei.value) == str(ej.value)
    assert faults.ACTIONS == jfaults.ACTIONS
    assert faults.KILL_EXIT_CODE == jfaults.KILL_EXIT_CODE


def test_rules_fire_once_at_nth():
    inj = faults.FaultInjector(
        faults.parse_faults("drop:party=leader:step=s:nth=2"), "leader")
    frame = faults.frame_of(b"abc")
    assert inj.on_send("s", frame) == [frame]      # 1st: passes
    assert inj.on_send("s", frame) == []           # 2nd: dropped
    assert inj.on_send("s", frame) == [frame]      # fired, inert now


# -- channel-level fault matrix (in-process, socketpair) ---------------

def _pair(spec=None, party="leader", rx_timeout=0.6):
    (a, b) = socket.socketpair()
    inj = (faults.FaultInjector(faults.parse_faults(spec), party)
           if spec else None)
    tx = Channel(a, "receiver", timeout=5.0, injector=inj)
    rx = Channel(b, party, timeout=rx_timeout)
    return (tx, rx)


def _send_async(tx, payload, step):
    def run():
        try:
            tx.send_msg(payload, step)
        except SessionError:
            return  # receiver gave up first — expected for stalls
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_clean_channel_roundtrip():
    (tx, rx) = _pair()
    tx.send_msg(b"hello", "s")
    assert rx.recv_msg("s") == b"hello"
    tx.close()
    assert rx.recv_msg("s") is None    # clean EOF -> None
    rx.close()


@pytest.mark.parametrize("spec", [
    "drop:party=leader:step=prep_share",
    "truncate:party=leader:step=prep_share:cut=3",
], ids=["drop", "truncate"])
def test_lost_frame_times_out_attributed(spec):
    (tx, rx) = _pair(spec)
    tx.send_msg(b"payload", "prep_share")
    t0 = time.monotonic()
    with pytest.raises(SessionError) as ei:
        rx.recv_msg("prep_share")
    assert time.monotonic() - t0 < 3.0
    assert (ei.value.kind, ei.value.party, ei.value.step) \
        == ("timeout", "leader", "prep_share")


def test_fault_corrupt_and_duplicate():
    (tx, rx) = _pair("corrupt:party=leader:step=prep_share:xor=0x80;"
                     "duplicate:party=leader:step=agg_share")
    tx.send_msg(b"payload", "prep_share")
    assert rx.recv_msg("prep_share") == bytes([b"p"[0] ^ 0x80]) + b"ayload"
    tx.send_msg(b"share", "agg_share")
    assert rx.recv_msg("agg_share") == b"share"
    assert rx.recv_msg("agg_share") == b"share"


def test_fault_delay_within_deadline_arrives():
    (tx, rx) = _pair("delay:party=leader:step=prep_share:delay=0.2",
                     rx_timeout=2.0)
    t0 = time.monotonic()
    _send_async(tx, b"payload", "prep_share")
    assert rx.recv_msg("prep_share") == b"payload"
    assert time.monotonic() - t0 >= 0.2


@pytest.mark.parametrize("spec", [
    "delay:party=leader:step=prep_share:delay=30",
    "hang:party=leader:step=prep_share",
], ids=["delay-past-deadline", "hang"])
def test_fault_stall_times_out(spec, monkeypatch):
    # A hung sender thread sleeps far past the test; the sleep is cut
    # short so the thread does not outlive the module.
    monkeypatch.setattr(faults, "HANG_SECONDS", 2.0)
    (tx, rx) = _pair(spec)
    t0 = time.monotonic()
    _send_async(tx, b"payload", "prep_share")
    with pytest.raises(SessionError) as ei:
        rx.recv_msg("prep_share")
    assert time.monotonic() - t0 < 3.0
    assert (ei.value.kind, ei.value.party) == ("timeout", "leader")


def test_deadline_budget_is_shared():
    """An exhausted session deadline fails the next call immediately
    instead of granting it a fresh per-call timeout."""
    (_tx, rx) = _pair(rx_timeout=30.0)
    deadline = Deadline(0.05)
    time.sleep(0.1)
    t0 = time.monotonic()
    with pytest.raises(SessionError) as ei:
        rx.recv_msg("agg_share", deadline)
    assert time.monotonic() - t0 < 1.0
    assert ei.value.kind == "timeout"
    assert "deadline exhausted" in ei.value.detail


# -- spawned port parties under faults ----------------------------------

def test_kill_at_spawn_attributed():
    """A party that dies before the handshake fails the collector's
    constructor at once (the accept watches the party processes),
    attributed to the dead party with the injected exit code."""
    t0 = time.monotonic()
    with pytest.raises(SessionError) as ei:
        _collector(faults_spec="kill:party=helper:step=spawn")
    assert time.monotonic() - t0 < 30
    assert (ei.value.party, ei.value.kind) == ("helper", "crashed")
    assert f"rc={faults.KILL_EXIT_CODE}" in ei.value.detail


def test_dropped_ack_retried_then_hang_times_out():
    """A lost upload ack retries the (idempotent) upload: the stale-ack
    generation guard keeps the channel in sync, the retry lands in the
    counters, and the trace shows the retry chain (each
    `session_retry` event carries the cause, the backoff slept and the
    remaining round-deadline budget).  Then the leader hangs before
    its next ack: upload() fails within the ack windows, attributed to
    the leader's upload_ack as a timeout."""
    tracer = obs_trace.configure()   # a fresh ring for this test
    cfg = dataclasses.replace(CFG_FAST, ack_timeout=1.0)
    reports = _count_reports([(False, True), (True, False)])
    try:
        coll = _collector(cfg, "drop:party=leader:step=upload_ack;"
                               "hang:party=leader:step=reports_loaded:nth=3")
        try:
            coll.upload(reports)
            assert coll.counters["retries"] == 1
            assert coll.counters["timeouts"] == 1
            assert coll.counters["quarantined"] == 0
            retries = [sp for sp in tracer.spans()
                       if sp.name == "session_retry"]
            assert retries, [sp.name for sp in tracer.spans()]
            ev = retries[0].attrs
            assert (ev["party"], ev["step"], ev["kind"], ev["attempt"]) \
                == ("leader", "upload_ack", "timeout", 1)
            assert ev["backoff_s"] > 0
            assert 0 < ev["deadline_remaining_s"] <= cfg.round_deadline
            t0 = time.monotonic()
            with pytest.raises(SessionError) as ei:
                coll.upload(reports)
            assert time.monotonic() - t0 < 15
            assert (ei.value.party, ei.value.step, ei.value.kind) \
                == ("leader", "upload_ack", "timeout")
            assert coll.counters["timeouts"] >= 2
        finally:
            coll.close()
    finally:
        obs_trace.configure()


def test_quarantine_refusal_and_naks():
    """On one pair of parties: a truncated report blob quarantines that
    report with a reason code and the batch survives; then each party
    quarantines a DIFFERENT report (the leader's copy of report 0, the
    helper's of report 1) — individually survivable, but the union
    covers the batch, so the collector refuses; then a corrupted
    command byte is refused by the party with a structured NAK, which
    arrives at once, not after the deadline.  On a second pair, every
    blob of the leader's malformed: the leader NAKs the upload."""
    coll = _collector(faults_spec=(
        "truncate:party=collector:step=upload_report:nth=2;"
        "truncate:party=collector:step=upload_report:nth=7;"
        "truncate:party=collector:step=upload_report:nth=10;"
        "corrupt:party=collector:step=agg_param:offset=4:xor=16"))
    try:
        coll.upload(_count_reports([(False, True), (True, False),
                                    (True, True)]))
        assert coll.quarantine == {1: REASON_MALFORMED}
        assert coll.counters["quarantined"] == 1
        assert list(coll.quarantine_mask()) == [False, True, False]
        with pytest.raises(SessionError) as ei:
            coll.upload(_count_reports([(False, True), (True, False)]))
        assert ei.value.kind == "protocol"
        assert "quarantined" in ei.value.detail
        t0 = time.monotonic()
        with pytest.raises(SessionError) as ei:
            coll.round(COUNT_PARAM)
        assert time.monotonic() - t0 < 15
        assert (ei.value.kind, ei.value.step) == ("protocol", "command")
    finally:
        coll.close()
    coll = _collector(faults_spec=(
        "truncate:party=collector:step=upload_report:nth=1;"
        "truncate:party=collector:step=upload_report:nth=2"))
    try:
        with pytest.raises(SessionError) as ei:
            coll.upload(_count_reports([(False, True), (True, False)]))
        assert ei.value.kind == "malformed"
        assert "malformed" in ei.value.detail
    finally:
        coll.close()


def test_kill_resume_and_snapshot_bit_identical():
    """Killing the helper at the start of the round, respawning and
    replaying gives the in-process engine's aggregate shares and
    bitmap; the completed session snapshots, and a session resumed from
    the snapshot replays the round from it, bit-identically, without a
    party round trip.  A snapshot that is not one is refused."""
    reports = _count_reports([(False, True), (True, False),
                              (False, False)])
    m = tbm.MasticCount(2)
    parties = [AggregatorParty(m, a, VK, CTX, device="cpu")
               for a in range(2)]
    for (a, p) in enumerate(parties):
        p.load_reports([wire.encode_report(
            m, a, n, ps, sh[a]) for (n, ps, sh) in reports])
    blobs = [p.prep_blob(COUNT_PARAM) for p in parties]
    (accept, _resolution) = parties[0].resolve(COUNT_PARAM, blobs[1])
    want = (parties[0].agg_share(COUNT_PARAM, accept),
            parties[1].agg_share(COUNT_PARAM, accept))

    sess = AggregationSession(m, COUNT_SPEC, CTX, VK, config=CFG_FAST,
                              faults_spec="kill:party=helper:step=round_start",
                              device="cpu")
    try:
        sess.upload(reports)
        (r1, a1, s1) = sess.round(COUNT_PARAM)
        blob = sess.to_bytes()
    finally:
        sess.close()
    assert sess.counters["respawns"] == 1
    assert sess.counters["retries"] >= 1
    assert (r1, list(a1), s1) == ([2, 1], [True] * 3, want)

    sess2 = AggregationSession.from_bytes(blob, config=CFG_FAST,
                                          device="cpu")
    try:
        assert sess2.coll.num_reports == 3 and sess2.coll.quarantine == {}
        assert len(sess2.completed) == 1
        t0 = time.monotonic()
        (r2, a2, s2) = sess2.round(COUNT_PARAM)
        assert time.monotonic() - t0 < 1.0   # replayed, not re-run
        assert (r2, list(a2), s2) == (r1, list(a1), s1)
    finally:
        sess2.close()
    with pytest.raises(ValueError):
        AggregationSession.from_bytes(b"\xff" * 64)


# -- the shaped transport ------------------------------------------------

def test_parse_shape():
    sh = transport_mod.parse_shape("bw=1m:rtt=20ms:jitter=2ms:seed=7")
    assert (sh.bandwidth, sh.rtt, sh.jitter, sh.seed) \
        == (1e6, 0.02, 0.002, 7)
    assert transport_mod.parse_shape("bw=64k").bandwidth == 64e3
    assert transport_mod.parse_shape("rtt=1.5s").rtt == 1.5
    assert transport_mod.parse_shape("") is None
    assert transport_mod.parse_shape(None) is None
    for bad in ("speed=1", "bw=fast", "rtt=xms", "bw"):
        with pytest.raises(ValueError):
            transport_mod.parse_shape(bad)


def test_shaped_channel_roundtrip_and_accounting():
    (a, b) = socket.socketpair()
    shape = transport_mod.LinkShape(bandwidth=1e6, rtt=0.004,
                                    jitter=0.001, seed=3)
    tx = Channel(a, "peer", timeout=5.0,
                 transport=transport_mod.ShapedTransport(a, shape))
    rx = Channel(b, "peer", timeout=5.0)
    try:
        payload = bytes(range(256)) * 8
        t0 = time.perf_counter()
        tx.send_msg(payload, "s")
        assert rx.recv_msg("s") == payload
        assert time.perf_counter() - t0 >= 0.002
        assert tx.transport.slept_s > 0
        assert tx.sent_bytes == rx.recv_bytes == len(payload) + 4
    finally:
        tx.close()
        rx.close()


def test_shaped_jitter_is_deterministic_per_seed():
    def sleeps(seed):
        (a, b) = socket.socketpair()
        tr = transport_mod.ShapedTransport(
            a, transport_mod.LinkShape(jitter=0.01, seed=seed))
        out = []
        for _ in range(5):
            before = tr.slept_s
            tr.send(b"x")
            out.append(round(tr.slept_s - before, 6))
        a.close()
        b.close()
        return out

    assert sleeps(11) == sleeps(11)
    assert sleeps(11) != sleeps(12)


def test_net_send_checkpoint_fires_and_plain_is_none():
    (a, b) = socket.socketpair()
    inj = faults.FaultInjector(faults.parse_faults(
        "delay:party=leader:step=net_send:delay=0.01"), "leader")
    tr = transport_mod.ShapedTransport(a, transport_mod.LinkShape(),
                                       injector=inj)
    try:
        tr.send(b"frame")
        assert inj.rules[0].fired
        assert transport_mod.for_socket(a, None) is None
    finally:
        a.close()
        b.close()


# -- transport security: mTLS + reconnect-and-replay --------------------

@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """One CA + per-party certs (the port's tools/certs.py), plus a
    second CA with its own 'collector' cert (wrong CA) and an expired
    collector cert under the pinned CA."""
    from mastic_tpu_torch.tools import certs as certs_mod

    good = tmp_path_factory.mktemp("certs")
    certs_mod.mint_party_set(good)
    certs_mod.mint_party(good, "collector", days=-1, suffix="-expired")
    rogue = tmp_path_factory.mktemp("rogue_certs")
    certs_mod.mint_ca(rogue, ca_name="rogue-ca")
    certs_mod.mint_party(rogue, "collector")
    return (good, rogue)


def _tls(d, name: str) -> TlsConfig:
    return TlsConfig(str(d / f"{name}.pem"), str(d / f"{name}.key"),
                     str(d / "ca.pem"))


def _accept_outcome(listener) -> tuple:
    """One accept on a thread: (thread, result dict with the socket or
    the refusal's kind and reason)."""
    result: dict = {}

    def run():
        try:
            result["sock"] = listener.accept("collector", 5.0)
        except SessionError as err:
            result["kind"] = err.kind
            result["reason"] = getattr(err, "reason", None)
            result["detail"] = err.detail

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return (t, result)


def _serve_one(lst, got: dict, fn) -> threading.Thread:
    def server():
        ch = reliable_accept(lst, "collector", RCFG)
        got["chan"] = ch
        fn(ch)

    t = threading.Thread(target=server, daemon=True)
    t.start()
    return t


def test_mtls_session_roundtrip(certs):
    (good, _rogue) = certs
    lst = TcpListener("127.0.0.1", 0,
                      tls=_tls(good, "leader").expecting("collector"))
    got = {}

    def serve(ch):
        got["msg"] = ch.recv_msg("m")
        ch.send_msg(b"pong", "m")

    t = _serve_one(lst, got, serve)
    ch = reliable_connect("127.0.0.1", lst.port, "leader", RCFG,
                          tls=_tls(good, "collector"))
    try:
        ch.send_msg(b"ping over mTLS", "m")
        assert ch.recv_msg("m") == b"pong"
        t.join(timeout=5)
        assert got["msg"] == b"ping over mTLS"
    finally:
        ch.close()
        got["chan"].close()
        lst.close()


def test_mtls_negative_matrix(certs):
    """Every bad credential class is refused with the JAX package's
    reason code and zero admitted frames — wrong CA, expired cert,
    plaintext client, truncated handshake — and the refusals land in
    the listener's ledger and the registry series."""
    import ssl as ssl_mod

    configure_registry()
    (good, rogue) = certs
    lst = TcpListener("127.0.0.1", 0,
                      tls=_tls(good, "leader").expecting("collector"))
    try:
        def dial_await_verdict(tls):
            try:
                s = transport_mod.tcp_dial("127.0.0.1", lst.port, "leader",
                                           5.0, tls=tls)
            except SessionError:
                return
            try:
                s.settimeout(5)
                s.recv(1)
            except (ssl_mod.SSLError, OSError):
                pass
            finally:
                s.close()

        (t, res) = _accept_outcome(lst)
        dial_await_verdict(TlsConfig(str(rogue / "collector.pem"),
                                     str(rogue / "collector.key"),
                                     str(good / "ca.pem")))
        t.join(timeout=5)
        assert (res["kind"], res["reason"]) == ("tls", "tls-wrong-ca"), res

        (t, res) = _accept_outcome(lst)
        dial_await_verdict(TlsConfig(str(good / "collector-expired.pem"),
                                     str(good / "collector-expired.key"),
                                     str(good / "ca.pem")))
        t.join(timeout=5)
        assert res["reason"] == "tls-expired-cert", res

        (t, res) = _accept_outcome(lst)
        raw = socket.create_connection(("127.0.0.1", lst.port), timeout=5)
        raw.sendall(b"\x02plaintext session frame")
        t.join(timeout=5)
        raw.close()
        assert res["reason"] == "tls-plaintext", res

        (t, res) = _accept_outcome(lst)
        raw = socket.create_connection(("127.0.0.1", lst.port), timeout=5)
        raw.sendall(b"\x16\x03\x01\x00\x80")
        raw.close()
        t.join(timeout=5)
        assert res["reason"] == "tls-truncated-handshake", res

        assert lst.refusals == {"tls-wrong-ca": 1, "tls-expired-cert": 1,
                                "tls-plaintext": 1,
                                "tls-truncated-handshake": 1}
        for reason in lst.refusals:
            assert get_registry().counter(
                "mastic_tls_refusals_total", reason=reason,
                side="server").value() == 1
    finally:
        lst.close()


def test_mtls_hostname_mismatch_refused(certs):
    """CA-valid credential, wrong NAME: refused client-side with the
    hostname reason; the listener sees the alert."""
    (good, _rogue) = certs
    lst = TcpListener("127.0.0.1", 0,
                      tls=_tls(good, "leader").expecting("collector"))
    try:
        (t, res) = _accept_outcome(lst)
        with pytest.raises(SessionError) as ei:
            reliable_connect("127.0.0.1", lst.port, "helper", RCFG,
                             tls=_tls(good, "collector"))
        assert ei.value.kind == "tls"
        assert getattr(ei.value, "reason", None) == "tls-hostname-mismatch"
        t.join(timeout=5)
        assert res.get("reason") == "tls-peer-refused", res
    finally:
        lst.close()


def test_reliable_reconnect_and_replay_exactly_once():
    lst = TcpListener("127.0.0.1", 0)
    got = {}

    def serve(ch):
        got["msgs"] = [ch.recv_msg("s") for _ in range(3)]
        ch.send_msg(b"done", "s")

    t = _serve_one(lst, got, serve)
    ch = reliable_connect("127.0.0.1", lst.port, "leader", RCFG)
    try:
        ch.send_msg(b"one", "s")
        ch.tp.kill_socket()          # drop between frames
        ch.send_msg(b"two", "s")
        ch.tp.kill_socket()          # and again
        ch.send_msg(b"three", "s")
        assert ch.recv_msg("s") == b"done"
        t.join(timeout=5)
        assert got["msgs"] == [b"one", b"two", b"three"]
        assert ch.reconnects == 2
        assert ch.replayed_frames >= 1
    finally:
        ch.close()
        got["chan"].close()
        lst.close()


def test_injected_conn_drop_recovers_and_traces():
    """An injected conn_drop fires after the frame enters the replay
    buffer: recovery is reconnect-and-replay, traced as
    `session_reconnect` (not `session_retry`) and counted."""
    configure_registry()
    tracer = obs_trace.configure()
    inj = faults.FaultInjector(faults.parse_faults(
        "conn_drop:party=collector:step=upload"), "collector")
    lst = TcpListener("127.0.0.1", 0)
    got = {}
    t = _serve_one(lst, got, lambda ch: got.update(msg=ch.recv_msg("upload")))
    ch = reliable_connect("127.0.0.1", lst.port, "leader", RCFG)
    ch.tp.injector = inj
    try:
        ch.send_msg(b"report body", "upload")
        t.join(timeout=5)
        assert got["msg"] == b"report body"
        assert inj.rules[0].fired
        assert ch.reconnects == 1 and ch.replayed_frames >= 1
        events = [sp for sp in tracer.spans()
                  if sp.name == "session_reconnect"]
        assert events, [sp.name for sp in tracer.spans()]
        assert events[-1].attrs["frames_replayed"] >= 1
        assert events[-1].attrs["redials"] == 1
        assert not [sp for sp in tracer.spans()
                    if sp.name == "session_retry"]
        reg = get_registry()
        assert reg.counter("mastic_session_reconnects_total",
                           tenant="").value() >= 1
        assert reg.counter("mastic_frames_replayed_total",
                           tenant="").value() >= 1
    finally:
        ch.close()
        got["chan"].close()
        lst.close()
        obs_trace.configure()


def test_injected_partition_heals_within_deadline():
    inj = faults.FaultInjector(faults.parse_faults(
        "partition:party=collector:step=agg_param:delay=0.3"), "collector")
    lst = TcpListener("127.0.0.1", 0)
    got = {}
    t = _serve_one(lst, got,
                   lambda ch: got.update(msg=ch.recv_msg("agg_param")))
    ch = reliable_connect("127.0.0.1", lst.port, "leader", RCFG)
    ch.tp.injector = inj
    try:
        t0 = time.monotonic()
        ch.send_msg(b"round command", "agg_param")
        t.join(timeout=10)
        assert got["msg"] == b"round command"
        assert time.monotonic() - t0 >= 0.3   # waited out the cut
        assert ch.reconnects == 1
    finally:
        ch.close()
        got["chan"].close()
        lst.close()


def test_recv_timeout_does_not_redial():
    lst = TcpListener("127.0.0.1", 0)
    got = {}
    t = _serve_one(lst, got, lambda ch: None)
    ch = reliable_connect("127.0.0.1", lst.port, "leader", RCFG)
    t.join(timeout=5)
    try:
        with pytest.raises(SessionError) as ei:
            ch.recv_msg("agg_share", timeout=0.2)
        assert ei.value.kind == "timeout"
        assert ch.reconnects == 0
    finally:
        ch.close()
        got["chan"].close()
        lst.close()


def test_tls_config_env_parsing(monkeypatch, certs):
    """A partial MASTIC_NET_TLS_* set is an error, a full set parses,
    an empty set means unarmed."""
    (good, _rogue) = certs
    for var in ("MASTIC_NET_TLS_CERT", "MASTIC_NET_TLS_KEY",
                "MASTIC_NET_TLS_CA", "MASTIC_NET_TLS_NAME"):
        monkeypatch.delenv(var, raising=False)
    assert TlsConfig.from_env() is None
    monkeypatch.setenv("MASTIC_NET_TLS_CERT", str(good / "leader.pem"))
    with pytest.raises(ValueError):
        TlsConfig.from_env()
    monkeypatch.setenv("MASTIC_NET_TLS_KEY", str(good / "leader.key"))
    monkeypatch.setenv("MASTIC_NET_TLS_CA", str(good / "ca.pem"))
    tls = TlsConfig.from_env()
    assert tls.ca_file == str(good / "ca.pem")
    assert tls.peer_name is None
    assert tls.expecting("collector").peer_name == "collector"
