"""The port's upload front against the JAX package's: the HTTP door
(`net/ingest.py`, its golden codes, bodies and headers), network
admission (`net/admission.py`: the token bucket, the LRU table, the
connection ceiling), the load generator (`net/loadgen.py`) and the
admission WAL (`drivers/wal.py`: segment bytes, recovery across the two
packages, the torn-tail matrix, the checksum skip, degrade and heal,
replay-scoped dedup).  Each case runs the same script against a JAX
front or log and the port's, and the outcomes must be equal: codes,
bodies, headers, counters and bytes.  Services run no epoch here, so no
round runs and no JAX program is compiled."""

import hashlib
import json
import os
import shutil
import socket
from http.client import HTTPConnection

import numpy as np
import pytest

import mastic_tpu.drivers.faults as jfaults
import mastic_tpu.drivers.service as jservice
import mastic_tpu.drivers.wal as jwal
import mastic_tpu.mastic as jm
import mastic_tpu.net.admission as jadmission
import mastic_tpu.net.ingest as jingest
import mastic_tpu.net.loadgen as jloadgen
from mastic_tpu.obs import registry as jregistry
import mastic_tpu_torch.backend.mastic as tbm
import mastic_tpu_torch.drivers.faults as tfaults
import mastic_tpu_torch.drivers.service as tservice
import mastic_tpu_torch.drivers.wal as twal
import mastic_tpu_torch.net.admission as tadmission
import mastic_tpu_torch.net.ingest as tingest
import mastic_tpu_torch.net.loadgen as tloadgen
from mastic_tpu_torch.obs import registry as tregistry

CTX = b"torch front"
BITS = 2
VK = bytes(range(32))

# Per package: (service, ingest, admission, loadgen, wal, faults, Mastic
# class, registry) modules.
JAX = {"service": jservice, "ingest": jingest, "admission": jadmission,
       "loadgen": jloadgen, "wal": jwal, "faults": jfaults,
       "count": jm.MasticCount, "registry": jregistry}
PORT = {"service": tservice, "ingest": tingest, "admission": tadmission,
        "loadgen": tloadgen, "wal": twal, "faults": tfaults,
        "count": tbm.MasticCount, "registry": tregistry}


def make_service(pkg: dict, **over):
    s = pkg["service"]
    spec = s.TenantSpec(name="count",
                        spec={"class": "MasticCount", "args": [BITS]},
                        ctx=CTX, verify_key=VK, thresholds={"default": 1})
    cfg = dict(page_size=4, max_buffered=64, epoch_deadline=600.0)
    cfg.update(over)
    kwargs = {"device": "cpu"} if pkg is PORT else {}
    return s.CollectorService([spec], config=s.ServiceConfig(**cfg),
                              **kwargs)


def blobs_for(pkg: dict, count: int, replay: int = 1) -> list:
    return pkg["loadgen"].build_blob_pool(pkg["count"](BITS), CTX, count,
                                          BITS, replay=replay)


def counters(svc) -> dict:
    return svc.metrics()["tenants"]["count"]["counters"]


def request(port: int, method: str, path: str, body: bytes = b"",
            headers: dict = None) -> tuple:
    """One request on a fresh connection -> (status, parsed body, the
    headers a client reads)."""
    conn = HTTPConnection("127.0.0.1", port, timeout=10.0)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        h = dict(resp.getheaders())
        return (resp.status, json.loads(data) if data else None,
                {k: h[k] for k in ("Content-Type", "Retry-After",
                                   "Connection") if k in h})
    finally:
        conn.close()


def put(port: int, body: bytes, tenant: str = "count", **headers) -> tuple:
    h = {"Content-Type": headers.pop("ctype", tingest.MEDIA_TYPE)}
    h.update({k.replace("_", "-"): v for (k, v) in headers.items()})
    return request(port, "PUT", f"/v1/tenants/{tenant}/reports", body, h)


def _raw_incomplete(port: int, blob: bytes) -> str:
    """A client promising 64 more bytes than it sends: the status line
    and body of the answer."""
    sock = socket.create_connection(("127.0.0.1", port), timeout=10)
    try:
        head = (f"PUT /v1/tenants/count/reports HTTP/1.1\r\n"
                f"Host: t\r\nContent-Type: {tingest.MEDIA_TYPE}\r\n"
                f"Content-Length: {len(blob) + 64}\r\n\r\n").encode()
        sock.sendall(head + blob)
        sock.shutdown(socket.SHUT_WR)
        chunks = []
        while True:
            data = sock.recv(4096)
            if not data:
                break
            chunks.append(data)
    finally:
        sock.close()
    resp = b"".join(chunks).decode()
    return resp.splitlines()[0] + " " + resp.split("\r\n\r\n", 1)[-1]


# Each golden scenario: (service config, NetConfig, front options, fault
# spec, script(pkg, front, svc, blobs) -> outcomes).

def _happy(pkg, front, svc, blobs):
    return [put(front.port, blobs[0])]


def _malformed(pkg, front, svc, blobs):
    return [put(front.port, b""), put(front.port, b"\x07garbage"),
            put(front.port, blobs[0][:-1]), put(front.port, blobs[0] + b"x")]


def _routes(pkg, front, svc, blobs):
    return [put(front.port, blobs[0], tenant="nope"),
            request(front.port, "PUT", "/v1/not/a/route", blobs[0],
                    {"Content-Type": tingest.MEDIA_TYPE}),
            put(front.port, blobs[0], ctype="application/json")]


def _oversized(pkg, front, svc, blobs):
    return [put(front.port, b"x" * 5000)]


def _quota(pkg, front, svc, blobs):
    return [put(front.port, b) for b in blobs[:4]]


def _queued(pkg, front, svc, blobs):
    out = [put(front.port, blobs[0]), put(front.port, b"bad")]
    svc.flush_ingest()
    return out


def _rate(pkg, front, svc, blobs):
    out = [put(front.port, blobs[0], X_Forwarded_For="10.1.2.3")
           for _ in range(4)]
    return out + [put(front.port, blobs[0], X_Forwarded_For="10.9.9.9")]


def _conns(pkg, front, svc, blobs):
    ceiling = front.cfg.max_connections
    for _ in range(ceiling):
        assert front.controller.try_acquire_connection()
    try:
        return [put(front.port, blobs[0])]
    finally:
        for _ in range(ceiling):
            front.controller.release_connection()


def _admin(pkg, front, svc, blobs):
    out = [request(front.port, "GET", "/healthz"), put(front.port, blobs[0])]
    out.append(request(front.port, "POST", "/v1/tenants/count/epoch",
                       headers={"Content-Length": "0"}))
    out.append(front.pop_epoch_requests())
    out.append(request(front.port, "POST", "/v1/admin/drain",
                       headers={"Content-Length": "0"}))
    out.append(front.drain_requested.is_set())
    return out


def _no_admin(pkg, front, svc, blobs):
    return [request(front.port, "POST", "/v1/tenants/count/epoch",
                    headers={"Content-Length": "0"})]


def _incomplete(pkg, front, svc, blobs):
    return [_raw_incomplete(front.port, blobs[0])]


def _faulted(pkg, front, svc, blobs):
    return [put(front.port, blobs[0]), put(front.port, blobs[0])]


def _suspend(pkg, front, svc, blobs):
    return [put(front.port, b"x%d" % i) for i in range(3)] \
        + [put(front.port, blobs[0])]


SCENARIOS = {
    "happy": ({}, {}, {}, None, _happy),
    "malformed": ({}, {}, {}, None, _malformed),
    "routes": ({}, {}, {}, None, _routes),
    "oversized": ({}, {"max_body": 4096}, {}, None, _oversized),
    "quota-429": ({"max_buffered": 2}, {}, {}, None, _quota),
    "quota-oldest": ({"max_buffered": 2, "shed_policy":
                      "oldest-epoch-first"}, {}, {}, None, _quota),
    "queued-202": ({"ingest_threads": 1, "ingest_queue": 8}, {}, {}, None,
                   _queued),
    "rate-limited": ({}, {"rate": 0.001, "burst": 2.0,
                          "trust_forwarded": True}, {}, None, _rate),
    "connections": ({}, {}, {}, None, _conns),
    "admin": ({}, {}, {"admin": True}, None, _admin),
    "no-admin": ({}, {}, {}, None, _no_admin),
    "incomplete-body": ({}, {}, {}, None, _incomplete),
    "truncated-body": ({}, {}, {}, "truncate:party=collector:step=http_body"
                       ":cut=40", _faulted),
    "corrupted-body": ({}, {}, {}, "corrupt:party=collector:step=http_body"
                       ":offset=6", _faulted),
    "suspension": ({"quarantine_limit": 2}, {}, {}, None, _suspend),
}


def _golden(pkg: dict, name: str) -> tuple:
    (cfg, net, opts, fault, script) = SCENARIOS[name]
    pkg["registry"].configure()
    svc = make_service(pkg, **cfg)
    injector = (pkg["faults"].FaultInjector(
        pkg["faults"].parse_faults(fault), "collector") if fault else None)
    front = pkg["ingest"].UploadFront(
        svc, config=pkg["admission"].NetConfig(**net), injector=injector,
        **opts).start()
    try:
        out = script(pkg, front, svc, blobs_for(pkg, 4))
    finally:
        front.stop()
        svc.stop_ingest()
    return (out, counters(svc), pkg["registry"].get_registry().counter(
        "mastic_net_http_requests_total", code="201").value())


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_golden_http_cases_equal_jax(name):
    """The DAP-shaped door: every golden case gives the JAX package's
    codes, bodies, headers and ledger."""
    want = _golden(JAX, name)
    got = _golden(PORT, name)
    assert got == want
    # A sanity floor on what the scenario exercised.
    if name == "happy":
        assert want[0][0][:2] == (201, {"status": "admitted"})


def test_upload_codecs_equal_jax():
    """encode_upload / decode_upload: the same bytes, and the same error
    message for every malformed blob."""
    (jblobs, tblobs) = (blobs_for(JAX, 3), blobs_for(PORT, 3))
    assert tblobs == jblobs
    (mj, mt) = (jm.MasticCount(BITS), tbm.MasticCount(BITS))
    for blob in jblobs:
        report = jservice.decode_upload(mj, blob)
        assert tservice.encode_upload(mt, tservice.decode_upload(mt, blob)) \
            == jservice.encode_upload(mj, report) == blob
    b = jblobs[0]
    (n0, rest) = (int.from_bytes(b[:4], "little"), b[4:])
    view0 = rest[:n0]
    bad = [b"", b"\x07garbage", b[:-1], b + b"\0", b[:4 + n0],
           b[:4 + n0] + b[:4 + n0],
           b[:8] + bytes([b[8] ^ 1]) + b[9:],
           b[:4 + n0] + b[4 + n0:4 + n0 + 4] + bytes([b[4 + n0 + 4] ^ 1])
           + b[4 + n0 + 5:],
           b[:4 + 17] + bytes([b[4 + 17] ^ 0xff]) + b[4 + 18:],
           b[:4] + view0[:-8] + b"\xff" * 8 + b[4 + n0:]]
    seen = []
    for blob in bad:
        errors = []
        for (svc_mod, m) in ((jservice, mj), (tservice, mt)):
            try:
                svc_mod.decode_upload(m, blob)
                errors.append(None)
            except (ValueError, EOFError) as exc:
                errors.append((type(exc).__name__, str(exc),
                               svc_mod._decode_reason(exc)))
        seen.append(errors[0])
        assert errors[1] == errors[0]
        assert errors[0] is not None, blob
    assert {e[2] for e in seen} == {1, 2}


def test_admission_controller_equals_jax():
    """The token bucket (deplete, Retry-After, refill capped at the
    burst), the LRU-bounded bucket table and the connection ceiling,
    on an injected clock."""
    outs = []
    for mod in (jadmission, tadmission):
        clock = [0.0]
        c = mod.AdmissionController(mod.NetConfig(rate=50.0, burst=5.0),
                                    clock=lambda: clock[0])
        out = [c.admit("a") for _ in range(9)]
        clock[0] += 1.0
        out += [c.admit("a") for _ in range(6)] + [c.admit("b")]
        clock[0] += 0.013
        out.append(c.admit("a"))
        lru = mod.AdmissionController(
            mod.NetConfig(rate=1.0, burst=1.0, max_tracked_ips=8),
            clock=lambda: clock[0])
        for i in range(50):
            lru.admit(f"10.0.0.{i}")
        ceiling = mod.AdmissionController(mod.NetConfig(max_connections=2))
        conns = [ceiling.try_acquire_connection() for _ in range(3)]
        ceiling.release_connection()
        conns.append(ceiling.try_acquire_connection())
        outs.append((out, lru.tracked_ips(), lru.evictions, conns))
    assert outs[1] == outs[0]
    assert outs[0][1:3] == (8, 42)
    for field in ("max_body", "max_connections", "rate", "burst",
                  "trust_forwarded", "max_tracked_ips", "io_timeout",
                  "idle_timeout"):
        assert getattr(tadmission.NetConfig(), field) \
            == getattr(jadmission.NetConfig(), field)


def test_loadgen_schedule_malform_and_pool_equal_jax():
    profile = dict(clients=1000, duration_s=2.0, rate=300.0,
                   burst_factor=3.0, malformed_frac=0.1, zipf_s=1.2,
                   workers=3, replay=4,
                   tenant_weights={"count": 0.7, "attrs": 0.3})
    (js, ts) = (jloadgen.build_schedule(jloadgen.LoadProfile(**profile),
                                        ["attrs", "count"]),
                tloadgen.build_schedule(tloadgen.LoadProfile(**profile),
                                        ["attrs", "count"]))
    assert len(js) > 100
    assert [(e.t, e.tenant, e.client, e.malformed) for e in ts] \
        == [(e.t, e.tenant, e.client, e.malformed) for e in js]
    blobs = blobs_for(JAX, 8, replay=3)
    assert blobs_for(PORT, 8, replay=3) == blobs
    (rj, rt) = (np.random.default_rng(5), np.random.default_rng(5))
    assert [tloadgen.malform(b, rt) for b in blobs] \
        == [jloadgen.malform(b, rj) for b in blobs]
    values = list(np.random.default_rng(2).random(101) * 50)
    assert tloadgen.quantiles(values) == jloadgen.quantiles(values)
    assert [tloadgen.client_ip(c) for c in (0, 7, 70000, 2 ** 24 - 1)] \
        == [jloadgen.client_ip(c) for c in (0, 7, 70000, 2 ** 24 - 1)]


def test_loadgen_small_run_accounts_exactly():
    """A small load run against the port's front: every request answered,
    the code mix equal to the service's counter deltas, the buffered
    blobs exactly the admitted ones."""
    tregistry.configure()
    svc = make_service(PORT, max_buffered=40, quarantine_limit=10 ** 6)
    front = tingest.UploadFront(svc, config=tadmission.NetConfig(
        trust_forwarded=True)).start()
    try:
        valid = blobs_for(PORT, 16, replay=2)
        pools = {"count": {"valid": valid, "malformed": [
            tloadgen.malform(b, np.random.default_rng(1)) for b in valid[:4]]}}
        gen = tloadgen.LoadGenerator("127.0.0.1", front.port,
                                     tloadgen.LoadProfile(
                                         clients=50, duration_s=0.6,
                                         rate=120.0, malformed_frac=0.2,
                                         workers=3, replay=6), pools)
        rec = gen.run()
    finally:
        front.stop()
    c = counters(svc)
    assert rec["transport_errors"] == 0
    assert rec["answered"] == rec["offered"] \
        == c["admitted"] + c["quarantined"] + c["shed"]
    assert rec["codes"].get("201", 0) == c["admitted"]
    assert rec["codes"].get("400", 0) == c["quarantined"]
    assert rec["codes"].get("429", 0) == c["shed"]
    assert len(tloadgen.buffered_blobs(svc, "count")) == c["admitted"]


# -- the admission WAL ------------------------------------------------

ALWAYS = {"fsync": "always"}


class FakeService:
    """The recovery target: records what replay submits and cuts."""

    def __init__(self, baseline=()):
        self.tenants = {"count": None}
        self.calls: list = []
        self.replayed: set = set()
        self._baseline = set(baseline)

    def submit(self, tenant, blob):
        self.calls.append(("submit", tenant, blob))
        return ("admitted", "")

    def report_digests(self, tenant):
        return set(self._baseline)

    def note_replayed(self, tenant, digest):
        self.replayed.add(digest)

    def begin_epoch(self, tenant):
        self.calls.append(("epoch", tenant, None))


def _dir_bytes(path: str) -> dict:
    return {name: open(os.path.join(path, name), "rb").read()
            for name in sorted(os.listdir(path))}


def _write_log(pkg: dict, path: str, fault=None, **cfg) -> list:
    """The same appends in either package: reports, an epoch cut, a
    covered marker.  Returns the seqs."""
    wal = pkg["wal"]
    injector = (pkg["faults"].FaultInjector(
        pkg["faults"].parse_faults(fault), "collector") if fault else None)
    w = wal.AdmissionWal(path, config=wal.WalConfig(**cfg),
                         injector=injector, fresh=True)
    seqs = [w.append_report("count", b"report-%d" % i) for i in range(5)]
    seqs.append(w.append_epoch_cut("count"))
    seqs.append(w.append_report("attrs", b"other tenant"))
    seqs.append(w.append_report("count", b"after-cut" * 40))
    w.close()
    return seqs


def _recover(pkg: dict, path: str, digest=None, service=None) -> tuple:
    w = pkg["wal"].AdmissionWal(path, config=pkg["wal"].WalConfig(**ALWAYS))
    svc = service or FakeService()
    counts = w.recover(svc, snapshot_sha256=digest)
    counts.pop("recovery_wall_ms")
    nxt = w.append_report("count", b"next")
    w.close()
    return (counts, getattr(svc, "calls", None), nxt)


def test_wal_segments_equal_and_recover_across_packages(tmp_path):
    """The same appends give byte-identical segments (rotating at a small
    bound) and covered markers in both packages; each package recovers
    the other's log to the same replay."""
    (dirs, dropped) = ({}, {})
    for (name, pkg) in (("jax", JAX), ("port", PORT)):
        d = str(tmp_path / name)
        assert _write_log(pkg, d, fsync="always", segment_bytes=64) \
            == list(range(8))
        w = pkg["wal"].AdmissionWal(d, config=pkg["wal"].WalConfig(
            **ALWAYS))
        w.recover(FakeService())
        dropped[name] = w.mark_covered(2, "digest-2")
        w.close()
        dirs[name] = d
    assert dropped["port"] == dropped["jax"] >= 1
    assert _dir_bytes(dirs["port"]) == _dir_bytes(dirs["jax"])
    assert len(_dir_bytes(dirs["jax"])) >= 3
    for digest in ("digest-2", "distrusted"):
        results = []
        for (reader, writer) in ((PORT, "jax"), (JAX, "port"), (JAX, "jax")):
            d = str(tmp_path / f"copy-{writer}-{len(results)}-{digest}")
            shutil.copytree(dirs[writer], d)
            results.append(_recover(reader, d, digest))
        assert results[0] == results[1] == results[2]
    assert results[0][0]["rejected"] == 1   # the unknown tenant


def test_wal_torn_tail_matrix_equal_jax(tmp_path):
    """Every cut inside the last record: both packages truncate to the
    same good prefix, count the same torn tail and replay the same
    records."""
    base = str(tmp_path / "base")
    w = twal.AdmissionWal(base, config=twal.WalConfig(**ALWAYS), fresh=True)
    sizes = []
    for i in range(3):
        w.append_report("count", b"record-%d" % i)
        sizes.append(os.path.getsize(w._seg_path))
    seg = os.path.basename(w._seg_path)
    w.close()
    for cut in range(sizes[1], sizes[2]):
        got = []
        for (name, pkg) in (("jax", JAX), ("port", PORT)):
            d = str(tmp_path / f"{name}{cut}")
            shutil.copytree(base, d)
            os.truncate(os.path.join(d, seg), cut)
            got.append((_recover(pkg, d), _dir_bytes(d)))
        assert got[1] == got[0], cut
        assert got[0][0][0]["torn_tail"] == (0 if cut == sizes[1] else 1)


def test_wal_checksum_skip_equal_jax(tmp_path):
    """A bit flipped after the CRC (the wal_append corrupt fault): the
    same corrupt bytes on disk, detected and skipped alike."""
    got = []
    for (name, pkg) in (("jax", JAX), ("port", PORT)):
        d = str(tmp_path / name)
        _write_log(pkg, d, fault="corrupt:party=collector:step=wal_append"
                   ":nth=2:offset=20:xor=1", fsync="always")
        got.append((_dir_bytes(d), _recover(pkg, d)))
    assert got[1] == got[0]
    assert got[0][1][0]["corrupt"] == 1


@pytest.mark.parametrize("fault", [
    "fsync_error:party=collector:step=wal_fsync:nth=1",
    "enospc:party=collector:step=wal_append:nth=2",
])
def test_wal_degrade_and_heal_equal_jax(tmp_path, fault):
    """A disk fault fails the append with the reason-coded brownout
    (degraded or full) and the next append heals by rotating: the same
    exceptions, states and bytes in both packages."""
    got = []
    for (name, pkg) in (("jax", JAX), ("port", PORT)):
        wal = pkg["wal"]
        d = str(tmp_path / name)
        w = wal.AdmissionWal(d, config=wal.WalConfig(**ALWAYS),
                             injector=pkg["faults"].FaultInjector(
                                 pkg["faults"].parse_faults(fault),
                                 "collector"), fresh=True)
        out = []
        for i in range(4):
            try:
                out.append(w.append_report("count", b"r%d" % i))
            except wal.WalUnavailable as exc:
                out.append((exc.reason, exc.retry_after))
            out.append(w.stats()["degraded"])
        w.close()
        got.append((out, _recover(pkg, d)))
    assert got[1] == got[0]
    assert any(isinstance(x, tuple) for x in got[0][0])


def test_wal_replay_scoped_dedup_equal_jax(tmp_path):
    """A service that never recovered admits identical blobs twice; after
    a recovery replays a blob, the client's retry acks as a duplicate
    without buffering it again.  The same verdicts and ledgers in both
    packages, over live services."""
    got = []
    for (name, pkg) in (("jax", JAX), ("port", PORT)):
        pkg["registry"].configure()
        blob = blobs_for(pkg, 1)[0]
        fresh = make_service(pkg)
        out = [fresh.submit("count", blob), fresh.submit("count", blob)]
        d = str(tmp_path / name)
        w = pkg["wal"].AdmissionWal(d, config=pkg["wal"].WalConfig(**ALWAYS),
                                    fresh=True)
        w.append_report("count", blob)
        w.append_report("count", b"bad")
        w.close()
        svc = make_service(pkg)
        (counts, _calls, _nxt) = _recover(pkg, d, service=svc)
        out += [counts, svc.submit("count", blob), svc.submit("count", b"x"),
                counters(fresh), counters(svc)]
        got.append(out)
    assert got[1] == got[0]
    assert got[0][3] == ("admitted", "duplicate")


def test_wal_brownout_over_http_equal_jax(tmp_path):
    """ENOSPC under the front: 503 wal-full with Retry-After, nothing
    half-admitted, the retry admitted."""
    got = []
    for (name, pkg) in (("jax", JAX), ("port", PORT)):
        pkg["registry"].configure()
        svc = make_service(pkg)
        wal = pkg["wal"]
        w = wal.AdmissionWal(str(tmp_path / name),
                             config=wal.WalConfig(**ALWAYS),
                             injector=pkg["faults"].FaultInjector(
                                 pkg["faults"].parse_faults(
                                     "enospc:party=collector:step=wal_append"
                                     ":nth=3"), "collector"), fresh=True)
        front = pkg["ingest"].UploadFront(
            svc, config=pkg["admission"].NetConfig(),
            persist=w.append_report).start()
        try:
            blobs = blobs_for(pkg, 3)
            out = [put(front.port, b) for b in blobs]
            out += [put(front.port, blobs[2]), counters(svc)]
        finally:
            front.stop()
            w.close()
        got.append((out, hashlib.sha256(b"".join(
            _dir_bytes(str(tmp_path / name)).values())).hexdigest()))
    assert got[1] == got[0]
    assert got[0][0][2][:2] == (503, {"error": "shed", "reason": "wal-full"})
