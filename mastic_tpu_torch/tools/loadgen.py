"""Load driver for the upload front (port of `tools/loadgen.py`; run as
`python -m mastic_tpu_torch.tools.loadgen`): drive the DAP-shaped
upload endpoint (`net/ingest.py`) with a zipf/Poisson/burst client mix
and report admission-latency quantiles, reports/s, the HTTP code mix
and the shed/quarantine ledger.

Modes:

* default (``--self``): boot a collector service (on `--device`,
  default cuda: without a card the tool exits non-zero) and an upload
  front in-process, run one load phase from the CLI profile
  (``--clients``, ``--rate``, ``--duration`` ...), and print one JSON
  line.  The run FAILS (exit 1) when the stated SLO (``--slo-p99-ms``)
  is missed or any request goes unaccounted;

* ``--target http://host:port``: drive an already-running endpoint
  (`python -m mastic_tpu_torch.tools.serve --upload-port`) instead of
  self-hosting (response-side accounting only: the endpoint's own
  /metrics has the server side);

* ``--wal-bench``: the cost of durability, the same HTTP admission
  (``--wal-reports`` uploads over ``--wal-workers`` keep-alive clients)
  under snapshot-before-ack, a WAL fsynced per record and a WAL with
  2 ms group commit (`measure_wal_modes`); one JSON line with each
  mode's rate and fsync waits, and a FAIL unless group commit admits at
  least 5x the snapshot-before-ack rate;

* ``--smoke``: four phases:

  1. **slo**: 10^5 simulated clients (zipf popularity, distinct
     X-Forwarded-For addresses), Poisson arrivals with bursts, a
     malformed fraction: every request answered 201/400, response
     counts equal to the service's counter deltas exactly, p99
     admission latency within the SLO;
  2. **knee**: offered load far past the admission quota: the first
     `max_buffered` uploads admit, everything after sheds 429 +
     Retry-After with the drop reason-coded in `shed_reasons`, no 5xx;
  3. **ratelimit**: one hot client against the per-IP token bucket:
     burst admits, sustained excess 429s with ``rate-limited`` in the
     tenant's shed ledger;
  4. **kill9**: the mid-upload crash drill over `tools.serve
     --upload-port --snapshot` (with its WAL): a clean child, a child
     killed by the injector mid-upload (after 3 of 6 acked), and a
     ``--resume`` child the client retries its un-acked uploads
     against; the resumed collection's results must equal the clean
     run's and the admitted total must be exactly 6.
"""

import argparse
import json
import os
import sys
import time


def fail(msg: str) -> None:
    print(f"loadgen: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build_service(device, bits: int, max_buffered: int,
                  ingest_threads: int, ingest_queue: int,
                  quarantine_limit: int = 10 ** 9):
    """A two-tenant collector for self-hosted load phases.  The
    quarantine limit defaults to effectively-unbounded: load phases
    deliberately stream malformed uploads, and the per-tenant
    suspension defense would otherwise (correctly) shut the tenant —
    that defense has its own serve-smoke coverage."""
    import numpy as np

    from mastic_tpu_torch.drivers.service import (CollectorService,
                                            ServiceConfig, TenantSpec)
    from mastic_tpu_torch.backend.mastic import MasticCount

    rng = np.random.default_rng(7)
    m_count = MasticCount(bits)
    m_attrs = MasticCount(8)
    vk = bytes(rng.integers(0, 256, m_count.VERIFY_KEY_SIZE,
                            dtype="uint8"))
    vk2 = bytes(rng.integers(0, 256, m_attrs.VERIFY_KEY_SIZE,
                             dtype="uint8"))
    specs = [
        TenantSpec(name="count",
                   spec={"class": "MasticCount", "args": [bits]},
                   ctx=b"loadgen count", verify_key=vk,
                   thresholds={"default": 2}),
        TenantSpec(name="attrs",
                   spec={"class": "MasticCount", "args": [8]},
                   ctx=b"loadgen attrs", verify_key=vk2,
                   thresholds={"default": 2}),
    ]
    cfg = ServiceConfig(page_size=64, max_buffered=max_buffered,
                        max_pending_epochs=64,
                        quarantine_limit=quarantine_limit,
                        epoch_deadline=3600.0,
                        ingest_threads=ingest_threads,
                        ingest_queue=ingest_queue)
    svc = CollectorService(specs, config=cfg, device=device)
    return (svc, {"count": (m_count, b"loadgen count"),
                  "attrs": (m_attrs, b"loadgen attrs")})


def build_pools(tenants: dict, bits: int, pool: int,
                replay: int) -> dict:
    import numpy as np

    from mastic_tpu_torch.net import loadgen

    rng = np.random.default_rng(replay + 1)
    pools = {}
    for (i, (name, (m, ctx))) in enumerate(sorted(tenants.items())):
        t_bits = m.bits
        valid = loadgen.build_blob_pool(m, ctx, pool, t_bits,
                                        replay=replay + i)
        pools[name] = {
            "valid": valid,
            "malformed": [loadgen.malform(b, rng)
                          for b in valid[:max(1, pool // 4)]],
        }
    return pools


def counter_totals(svc) -> dict:
    totals = {"admitted": 0, "quarantined": 0, "shed": 0,
              "shed_reasons": {}, "quarantine_reasons": {}}
    for t in svc.metrics()["tenants"].values():
        c = t["counters"]
        totals["admitted"] += c["admitted"]
        totals["quarantined"] += c["quarantined"]
        totals["shed"] += c["shed"]
        for (k, v) in c["shed_reasons"].items():
            totals["shed_reasons"][k] = \
                totals["shed_reasons"].get(k, 0) + v
        for (k, v) in c["quarantine_reasons"].items():
            totals["quarantine_reasons"][k] = \
                totals["quarantine_reasons"].get(k, 0) + v
    return totals


def run_phase(svc, front, profile, pools) -> dict:
    """One load phase against a live front, with the before/after
    counter deltas folded in."""
    from mastic_tpu_torch.net.loadgen import LoadGenerator

    before = counter_totals(svc)
    gen = LoadGenerator("127.0.0.1", front.port, profile, pools)
    rec = gen.run()
    svc.flush_ingest()
    after = counter_totals(svc)
    rec["service"] = {
        "admitted": after["admitted"] - before["admitted"],
        "quarantined": after["quarantined"] - before["quarantined"],
        "shed": after["shed"] - before["shed"],
        "shed_reasons": {
            k: v - before["shed_reasons"].get(k, 0)
            for (k, v) in after["shed_reasons"].items()
            if v - before["shed_reasons"].get(k, 0)},
        "quarantine_reasons": {
            k: v - before["quarantine_reasons"].get(k, 0)
            for (k, v) in after["quarantine_reasons"].items()
            if v - before["quarantine_reasons"].get(k, 0)},
    }
    return rec


def check_accounting(rec: dict, phase: str) -> None:
    """The no-silent-drops ledger: every answered request is counted
    in exactly one service ledger (shed at the door included), so
    responses and counters must sum to the same total."""
    svc = rec["service"]
    answered = rec["answered"]
    landed = svc["admitted"] + svc["quarantined"] + svc["shed"]
    if rec["transport_errors"]:
        fail(f"{phase}: {rec['transport_errors']} transport errors "
             f"(client-visible drops)")
    if landed != answered:
        fail(f"{phase}: {answered} answered requests vs "
             f"{landed} ledger entries — a drop went uncounted: "
             f"{svc}")
    for code in rec["codes"]:
        if code.startswith("5"):
            fail(f"{phase}: {rec['codes'][code]} x HTTP {code} — "
                 f"degradation must be by policy, never an error")


def phase_slo(args) -> dict:
    """Phase 1: the stated SLO at the stated client scale."""
    from mastic_tpu_torch.net.ingest import UploadFront
    from mastic_tpu_torch.net.admission import NetConfig
    from mastic_tpu_torch.net.loadgen import LoadProfile, buffered_blobs

    (svc, tenants) = build_service(args.device, bits=2,
                                   max_buffered=10 ** 6, ingest_threads=0,
                                   ingest_queue=256)
    pools = build_pools(tenants, 2, pool=64, replay=args.replay)
    front = UploadFront(
        svc, config=NetConfig(max_connections=256,
                              trust_forwarded=True)).start()
    profile = LoadProfile(
        clients=args.clients, duration_s=args.duration,
        rate=args.rate, burst_factor=3.0, malformed_frac=0.03,
        zipf_s=1.2, workers=args.workers, replay=args.replay,
        tenant_weights={"count": 0.8, "attrs": 0.2})
    rec = run_phase(svc, front, profile, pools)
    front.stop()
    check_accounting(rec, "slo")
    unexpected = set(rec["codes"]) - {"201", "400"}
    if unexpected:
        fail(f"slo: unexpected response codes {sorted(unexpected)} "
             f"(mix: {rec['codes']})")
    if rec["codes"].get("400", 0) != rec["service"]["quarantined"]:
        fail(f"slo: 400s {rec['codes'].get('400', 0)} != quarantined "
             f"{rec['service']['quarantined']}")
    buffered = sum(len(buffered_blobs(svc, t)) for t in tenants)
    if buffered != rec["service"]["admitted"]:
        fail(f"slo: {rec['service']['admitted']} admitted but "
             f"{buffered} buffered — lost or duplicated reports")
    p99 = rec["latency_ms"]["p99"]
    if p99 is None or p99 > args.slo_p99_ms:
        fail(f"slo: p99 admission latency {p99} ms over the "
             f"{args.slo_p99_ms} ms SLO")
    if rec["distinct_clients_seen"] < 100:
        fail(f"slo: only {rec['distinct_clients_seen']} distinct "
             f"clients seen")
    rec["slo_p99_ms"] = args.slo_p99_ms
    rec["slo_held"] = True
    return rec


def phase_knee(args) -> dict:
    """Phase 2: past the knee, degradation is by policy."""
    from mastic_tpu_torch.net.ingest import UploadFront
    from mastic_tpu_torch.net.admission import NetConfig
    from mastic_tpu_torch.net.loadgen import LoadProfile

    quota = 250
    (svc, tenants) = build_service(args.device, bits=2,
                                   max_buffered=quota, ingest_threads=0,
                                   ingest_queue=64)
    pools = build_pools(tenants, 2, pool=64, replay=args.replay + 10)
    front = UploadFront(
        svc, config=NetConfig(max_connections=256,
                              trust_forwarded=True)).start()
    profile = LoadProfile(
        clients=args.clients, duration_s=max(2.0, args.duration / 2),
        rate=args.rate * 6, burst_factor=2.0, malformed_frac=0.0,
        zipf_s=1.2, workers=args.workers * 2, replay=args.replay + 10,
        tenant_weights={"count": 0.8, "attrs": 0.2})
    rec = run_phase(svc, front, profile, pools)
    front.stop()
    check_accounting(rec, "knee")
    shed = rec["service"]["shed"]
    if rec["codes"].get("429", 0) != shed or shed == 0:
        fail(f"knee: 429s {rec['codes'].get('429', 0)} != shed "
             f"{shed} (mix {rec['codes']})")
    if rec["retry_after_seen"] < rec["codes"].get("429", 0):
        fail(f"knee: {rec['codes'].get('429', 0)} 429s but only "
             f"{rec['retry_after_seen']} Retry-After headers")
    known = {"reject-newest", "oldest-epoch-first",
             "ingest-queue-full", "rate-limited",
             "connections-exhausted", "body-too-large",
             "incomplete-body", "tenant-quarantined"}
    bad = set(rec["service"]["shed_reasons"]) - known
    if bad:
        fail(f"knee: unknown shed reasons {sorted(bad)}")
    # Both tenants hold exactly their quota: the knee is per-tenant
    # admission policy, not first-come starvation across tenants.
    per_tenant = {name: t["counters"]["admitted"]
                  for (name, t) in svc.metrics()["tenants"].items()}
    for (name, admitted) in per_tenant.items():
        if admitted > quota:
            fail(f"knee: tenant {name} admitted {admitted} past its "
                 f"{quota} quota")
    rec["per_tenant_admitted"] = per_tenant
    rec["quota"] = quota
    return rec


def phase_ratelimit(args) -> dict:
    """Phase 3: the per-IP token bucket, one hot client."""
    from http.client import HTTPConnection

    from mastic_tpu_torch.net.admission import NetConfig
    from mastic_tpu_torch.net.ingest import MEDIA_TYPE, UploadFront

    (svc, tenants) = build_service(args.device, bits=2,
                                   max_buffered=10 ** 6, ingest_threads=0,
                                   ingest_queue=64)
    pools = build_pools(tenants, 2, pool=8, replay=args.replay + 20)
    # rate=5/s: one token per 200 ms, far slower than a loopback
    # HTTP roundtrip, so the 20-request hammer MUST exhaust the
    # 5-token burst regardless of fabric speed.
    front = UploadFront(
        svc, config=NetConfig(rate=5.0, burst=5.0,
                              trust_forwarded=True)).start()
    blob = pools["count"]["valid"][0]
    conn = HTTPConnection("127.0.0.1", front.port, timeout=10)
    codes = {}
    retry_after = 0
    for _ in range(20):
        conn.request("PUT", "/v1/tenants/count/reports", body=blob,
                     headers={"Content-Type": MEDIA_TYPE,
                              "X-Forwarded-For": "10.9.9.9"})
        resp = conn.getresponse()
        resp.read()
        codes[resp.status] = codes.get(resp.status, 0) + 1
        if resp.getheader("Retry-After"):
            retry_after += 1
    conn.close()
    front.stop()
    sheds = counter_totals(svc)["shed_reasons"]
    if codes.get(429, 0) == 0 or sheds.get("rate-limited", 0) == 0:
        fail(f"ratelimit: bucket never fired (codes {codes}, "
             f"sheds {sheds})")
    if codes.get(429, 0) != sheds.get("rate-limited", 0):
        fail(f"ratelimit: 429s {codes.get(429, 0)} != rate-limited "
             f"sheds {sheds.get('rate-limited', 0)}")
    if retry_after < codes.get(429, 0):
        fail(f"ratelimit: Retry-After missing on some 429s")
    return {"codes": {str(k): v for (k, v) in sorted(codes.items())},
            "rate_limited_sheds": sheds.get("rate-limited", 0),
            "bucket": {"rate": 5.0, "burst": 5.0}}


def _wait_port(path: str, deadline_s: float = 120.0) -> int:
    t0 = time.monotonic()
    last_error = "file never appeared"
    while time.monotonic() - t0 < deadline_s:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)["upload_port"]
            except (ValueError, KeyError) as exc:
                # Mid-rename torn read; retried until the deadline
                # names the last failure.
                last_error = f"{type(exc).__name__}: {exc}"
        time.sleep(0.1)
    fail(f"kill9: no upload port from {path} ({last_error})")


def run_upload_drill(args, tmp: str) -> dict:
    """Phase 4: kill -9 mid-upload, resume via tools.serve --resume.
    The client holds acks for uploads 1-3 when the collector dies at
    the 4th admission; it retries the un-acked 4-6 against the
    resumed process, and the finished collection must equal a clean
    run's bit for bit with exactly 6 reports admitted overall."""
    import subprocess
    from http.client import HTTPConnection

    import numpy as np

    from mastic_tpu_torch.drivers import faults
    from mastic_tpu_torch.drivers.service import encode_upload
    from mastic_tpu_torch.backend.mastic import MasticCount
    from mastic_tpu_torch.net.ingest import MEDIA_TYPE

    bits = 2
    m = MasticCount(bits)
    scalar = m.scalar()
    rng = np.random.default_rng(args.replay + 30)
    blobs = []
    for value in [0, 0, 0, 3, 3, 3]:
        alpha = scalar.vidpf.test_index_from_int(value, bits)
        nonce = bytes(rng.integers(0, 256, m.NONCE_SIZE,
                                   dtype="uint8"))
        rand = bytes(rng.integers(0, 256, m.RAND_SIZE,
                                  dtype="uint8"))
        (ps, shares) = scalar.shard(b"serve count", (alpha, True), nonce,
                                    rand)
        blobs.append(encode_upload(m, (nonce, ps, shares)))

    def spawn(tag: str, fault=None, resume=False, snap_tag=None):
        pf = os.path.join(tmp, f"{tag}.port")
        snap = os.path.join(tmp, f"{snap_tag or tag}.snap")
        env = dict(os.environ)
        env.pop("MASTIC_FAULTS", None)
        env.pop("MASTIC_NET_SHAPE", None)
        if fault is not None:
            env["MASTIC_FAULTS"] = fault
        cmd = [sys.executable, "-m", "mastic_tpu_torch.tools.serve",
               "--reports", "6", "--bits", str(bits), "--page-size", "2",
               "--upload-port", "0", "--upload-window", "120",
               "--port-file", pf, "--snapshot", snap,
               "--device", args.device]
        if resume:
            cmd.append("--resume")
        proc = subprocess.Popen(cmd, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return (proc, pf, snap)

    def put_all(port: int, send: list) -> list:
        """PUT each blob on a fresh connection; returns the indices
        the client holds a 2xx ack for (the rest are its to
        retry)."""
        acked = []
        for (i, blob) in send:
            try:
                conn = HTTPConnection("127.0.0.1", port, timeout=30)
                conn.request("PUT", "/v1/tenants/count/reports",
                             body=blob,
                             headers={"Content-Type": MEDIA_TYPE})
                resp = conn.getresponse()
                resp.read()
                conn.close()
                if resp.status in (201, 202):
                    acked.append(i)
            except OSError as exc:
                # The collector died mid-upload: stop here and retry
                # the un-acked tail against the resumed process.
                print(f"loadgen: upload {i} un-acked "
                      f"({type(exc).__name__}) — client will retry",
                      file=sys.stderr, flush=True)
                break
        return acked

    def cut_and_drain(port: int) -> None:
        conn = HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/v1/tenants/count/epoch",
                     headers={"Content-Length": "0"})
        conn.getresponse().read()
        conn.request("POST", "/v1/admin/drain",
                     headers={"Content-Length": "0"})
        conn.getresponse().read()
        conn.close()

    def finish(proc, tag: str, expect_rc=0) -> dict:
        (out, err) = proc.communicate(timeout=1500)
        if proc.returncode != expect_rc:
            fail(f"kill9 {tag}: rc={proc.returncode} (wanted "
                 f"{expect_rc}): {err[-1500:]}")
        if expect_rc != 0:
            return {}
        return json.loads(out.strip().splitlines()[-1])

    # Clean run: all six acked, cut, drain.
    (proc, pf, _snap) = spawn("clean")
    port = _wait_port(pf)
    acked = put_all(port, list(enumerate(blobs)))
    if len(acked) != 6:
        proc.kill()
        fail(f"kill9 clean: only {acked} acked")
    cut_and_drain(port)
    clean = finish(proc, "clean")

    # Killed run: the injector kills the collector at the 4th
    # admission; the client keeps acks 0-2.
    (proc, pf, snap) = spawn(
        "killed", fault="kill:party=collector:step=admit:nth=4")
    port = _wait_port(pf)
    acked = put_all(port, list(enumerate(blobs)))
    finish(proc, "killed", expect_rc=faults.KILL_EXIT_CODE)
    if acked != [0, 1, 2]:
        fail(f"kill9 killed: acked {acked}, wanted [0, 1, 2]")
    if not os.path.exists(snap):
        fail("kill9: killed child left no snapshot")

    # Resumed run: retry the un-acked tail, cut, drain.  (Own port
    # file, the KILLED run's snapshot.)
    (proc, pf2, _s) = spawn("resumed", resume=True,
                            snap_tag="killed")
    port = _wait_port(pf2)
    acked = put_all(port, [(i, blobs[i]) for i in (3, 4, 5)])
    if len(acked) != 3:
        proc.kill()
        fail(f"kill9 resume: retries acked {acked}")
    cut_and_drain(port)
    resumed = finish(proc, "resumed")

    if resumed["results"]["count"] != clean["results"]["count"]:
        fail(f"kill9: resumed results diverge: "
             f"{resumed['results']['count']} != "
             f"{clean['results']['count']}")
    admitted = resumed["metrics"]["tenants"]["count"]["counters"][
        "admitted"]
    if admitted != 6:
        fail(f"kill9: {admitted} reports admitted over both lives, "
             f"wanted exactly 6 (lost or duplicated)")
    # Time-to-recover: the resumed collector stamps its WAL recovery
    # attribution and the drill carries it.
    wal_info = resumed.get("wal") or {}
    if "recovery_wall_ms" not in wal_info:
        fail(f"kill9: resumed run did not stamp WAL recovery "
             f"attribution: {wal_info}")
    return {"clean_result": clean["results"]["count"],
            "resumed_result": resumed["results"]["count"],
            "admitted_total": admitted,
            "recovery_wall_ms": wal_info["recovery_wall_ms"],
            "replayed_records": wal_info.get("replayed_records", 0),
            "bit_identical": True}


class _SnapshotSettler:
    """The snapshot-before-ack durability discipline as a persist
    callback, the WAL bench's baseline: an ack is released only after a
    FULL service snapshot (serialize + fsync + rename + fsync(dir))
    covering it lands.  Generously batched — one settle releases every
    waiter that arrived while the previous snapshot was writing, the
    exact analogue of the WAL's group commit — so the measured gap is
    the cost of serializing O(state) per settle vs appending
    O(record)."""

    def __init__(self, svc, path: str):
        import threading

        self.svc = svc
        self.path = path
        self.snapshot_bytes = 0
        self.settles = 0
        self._mu = threading.Lock()
        self._waiters: list = []
        self._closed = False
        self._thread = threading.Thread(target=self._loop,
                                        daemon=True,
                                        name="snapshot-settler")
        self._thread.start()

    def persist(self, tenant: str, body: bytes) -> None:
        import threading

        ev = threading.Event()
        with self._mu:
            self._waiters.append(ev)
        if not ev.wait(60.0):
            raise RuntimeError("snapshot settle timed out")

    def _loop(self) -> None:
        from mastic_tpu_torch.drivers.wal import fsync_dir

        while True:
            with self._mu:
                if self._closed:
                    for ev in self._waiters:
                        ev.set()
                    return
                batch = self._waiters
                self._waiters = []
            if not batch:
                time.sleep(0.0005)
                continue
            data = self.svc.to_bytes()
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))
            self.snapshot_bytes = len(data)
            self.settles += 1
            for ev in batch:
                ev.set()

    def close(self) -> None:
        with self._mu:
            self._closed = True
        self._thread.join(timeout=10.0)


def measure_wal_modes(device, reports: int, workers: int,
                      replay: int = 0) -> dict:
    """The same HTTP admission path (real sockets, `workers` keep-alive
    clients, `reports` valid uploads to the count tenant of a service on
    `device`) under the three persistence disciplines of the WAL bench:
    ``snapshot_before_ack`` (`_SnapshotSettler`), ``wal_always`` (one
    fsync a record) and ``wal_group`` (group commit, 2 ms).  Returns
    each mode's record (the JAX bench's keys); fails unless every mode
    acked every upload."""
    import shutil
    import tempfile
    import threading
    from http.client import HTTPConnection

    from mastic_tpu_torch.drivers.wal import AdmissionWal, WalConfig
    from mastic_tpu_torch.net.admission import NetConfig
    from mastic_tpu_torch.net.ingest import MEDIA_TYPE, UploadFront

    (_svc0, tenants) = build_service(device, bits=2, max_buffered=10 ** 6,
                                     ingest_threads=0, ingest_queue=256)
    pool = build_pools(tenants, 2, pool=64, replay=replay)["count"]["valid"]
    tmp = tempfile.mkdtemp(prefix="mastic-wal-bench-")

    def drive(front) -> tuple:
        """`reports` PUTs over `workers` keep-alive connections;
        returns (acked, wall_s).  Any non-2xx fails the bench — this
        path must admit everything, or the rates compare nothing."""
        next_i = [0]
        mu = threading.Lock()
        acked = [0]
        errors: list = []

        def worker() -> None:
            conn = HTTPConnection("127.0.0.1", front.port,
                                  timeout=30)
            try:
                while True:
                    with mu:
                        i = next_i[0]
                        if i >= reports or errors:
                            return
                        next_i[0] = i + 1
                    blob = pool[i % len(pool)]
                    # A dropped keep-alive or accept-backlog reset is
                    # the client's to retry (the un-acked upload is
                    # at-least-once by contract); only a persistent
                    # transport failure fails the bench.
                    status = None
                    for attempt in range(3):
                        try:
                            conn.request(
                                "PUT", "/v1/tenants/count/reports",
                                body=blob,
                                headers={"Content-Type": MEDIA_TYPE})
                            resp = conn.getresponse()
                            resp.read()
                            status = resp.status
                            break
                        except OSError:
                            conn.close()
                            time.sleep(0.01 * (attempt + 1))
                            conn = HTTPConnection(
                                "127.0.0.1", front.port, timeout=30)
                    if status is None:
                        errors.append(f"transport error on {i}")
                        return
                    if status not in (201, 202):
                        errors.append(f"upload {i}: {status}")
                        return
                    with mu:
                        acked[0] += 1
            finally:
                conn.close()

        threads = [threading.Thread(target=worker)
                   for _ in range(workers)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        if errors:
            fail(f"wal bench: {errors[0]}")
        return (acked[0], wall)

    def fresh_front(persist):
        (svc, _t) = build_service(device, bits=2, max_buffered=10 ** 6,
                                  ingest_threads=0, ingest_queue=256)
        front = UploadFront(
            svc, config=NetConfig(max_connections=256,
                                  trust_forwarded=True),
            persist=persist).start()
        return (svc, front)

    modes = {}
    try:
        # 1. Snapshot-before-ack.
        (svc, front) = fresh_front(None)
        settler = _SnapshotSettler(svc, os.path.join(tmp, "base.snap"))
        front._persist = settler.persist
        (acked, wall) = drive(front)
        front.stop()
        settler.close()
        if acked != reports:
            fail(f"wal bench snapshot: {acked}/{reports} acked")
        modes["snapshot_before_ack"] = {
            "acked": acked, "wall_s": round(wall, 3),
            "rate_rps": round(acked / wall, 1),
            "settles": settler.settles,
            "snapshot_bytes_final": settler.snapshot_bytes}

        # 2 + 3. The WAL disciplines.
        for (key, cfg) in (
                ("wal_always", WalConfig(fsync="always")),
                ("wal_group", WalConfig(fsync="group", group_ms=2.0))):
            wal = AdmissionWal(os.path.join(tmp, key), config=cfg)
            (svc, front) = fresh_front(wal.append_report)
            (acked, wall) = drive(front)
            front.stop()
            stats = wal.stats()
            wal.close()
            if acked != reports:
                fail(f"wal bench {key}: {acked}/{reports} acked")
            modes[key] = {
                "acked": acked, "wall_s": round(wall, 3),
                "rate_rps": round(acked / wall, 1),
                "fsync": cfg.fsync,
                "fsync_wait_ms_p50": round(
                    stats["fsync_wait_ms_p50"], 3),
                "fsync_wait_ms_p99": round(
                    stats["fsync_wait_ms_p99"], 3),
                "appends": stats["appends"],
                "segments": stats["segments"]}
            if key == "wal_group":
                modes[key]["group_ms"] = 2.0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return modes


def run_wal_bench(args) -> None:
    """The measured cost of durability: `measure_wal_modes` at
    `--wal-reports` uploads over `--wal-workers` clients.  Prints one
    JSON line with the admission rate per mode, the WAL modes' p50/p99
    fsync-wait, and the group-vs-snapshot speedup; FAILS unless group
    commit admits at least 5x the snapshot-before-ack rate.  (It writes
    no file of its own: the JAX package's BENCH_WAL.json is that
    package's.)"""
    from mastic_tpu_torch import resolve_device

    t_start = time.time()
    device = resolve_device(args.device)
    modes = measure_wal_modes(device, args.wal_reports, args.wal_workers,
                              replay=args.replay)
    speedup = (modes["wal_group"]["rate_rps"]
               / modes["snapshot_before_ack"]["rate_rps"])
    out = {"mode": "wal-bench", "platform": device.type,
           "reports": args.wal_reports, "workers": args.wal_workers,
           "modes": modes,
           "speedup_group_vs_snapshot": round(speedup, 2),
           "wall_seconds": round(time.time() - t_start, 1),
           "ok": True}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if speedup < 5.0:
        fail(f"wal bench: group-commit admission rate is only "
             f"{speedup:.2f}x the snapshot-before-ack baseline "
             f"(acceptance: >= 5x)")


def run_smoke(args) -> None:
    import tempfile

    t0 = time.time()
    out = {"mode": "loadgen-smoke",
           "slo": phase_slo(args),
           "knee": phase_knee(args),
           "ratelimit": phase_ratelimit(args)}
    if args.skip_drill:
        out["kill9"] = {"skipped": True}
    else:
        tmp = tempfile.mkdtemp(prefix="mastic_net_drill_")
        out["kill9"] = run_upload_drill(args, tmp)
    out["wall_seconds"] = round(time.time() - t0, 1)
    out["ok"] = True
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


def run_load(args) -> None:
    """One load phase: self-hosted by default; with --target, drive a
    running `tools.serve --upload-port` endpoint's demo ``count``
    tenant instead (blobs
    are built for its ctx; accounting is then response-side only —
    the endpoint's own /metrics has the server ledger)."""
    from mastic_tpu_torch.net.loadgen import (LoadGenerator, LoadProfile,
                                        build_blob_pool, malform)

    t0 = time.time()
    profile = LoadProfile(
        clients=args.clients, duration_s=args.duration,
        rate=args.rate, burst_factor=args.burst_factor,
        malformed_frac=args.malformed_frac, zipf_s=args.zipf,
        workers=args.workers, replay=args.replay)
    if args.target:
        import urllib.parse

        import numpy as np

        from mastic_tpu_torch.backend.mastic import MasticCount

        u = urllib.parse.urlparse(args.target)
        m = MasticCount(args.bits)
        rng = np.random.default_rng(args.replay + 1)
        valid = build_blob_pool(m, b"serve count", 64, args.bits,
                                replay=args.replay)
        pools = {"count": {"valid": valid,
                           "malformed": [malform(b, rng)
                                         for b in valid[:16]]}}
        gen = LoadGenerator(u.hostname, u.port, profile, pools)
        rec = gen.run()
        svc = None
    else:
        from mastic_tpu_torch.net.admission import NetConfig
        from mastic_tpu_torch.net.ingest import UploadFront

        profile.tenant_weights = {"count": 0.8, "attrs": 0.2}
        (svc, tenants) = build_service(
            args.device, bits=args.bits, max_buffered=10 ** 6,
            ingest_threads=args.ingest_threads,
            ingest_queue=args.ingest_queue)
        pools = build_pools(tenants, args.bits, pool=64,
                            replay=args.replay)
        front = UploadFront(
            svc, config=NetConfig(max_connections=256,
                                  trust_forwarded=True)).start()
        rec = run_phase(svc, front, profile, pools)
        front.stop()
        check_accounting(rec, "load")
    p99 = rec["latency_ms"]["p99"]
    rec.update({"mode": "serve-load", "slo_p99_ms": args.slo_p99_ms,
                "slo_held": p99 is not None and p99 <= args.slo_p99_ms,
                "target": args.target,
                "wall_seconds": round(time.time() - t0, 1)})
    rec["ok"] = bool(rec["slo_held"])
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not rec["ok"]:
        fail(f"serve-load: p99 {p99} ms over the {args.slo_p99_ms} "
             f"ms SLO")


def main() -> None:
    parser = argparse.ArgumentParser(
        description="closed-loop load generator for the upload front")
    parser.add_argument("--smoke", action="store_true",
                        help="the four-phase gate")
    parser.add_argument("--skip-drill", action="store_true",
                        help="skip the kill-9 subprocess drill "
                             "inside --smoke (fast local iteration)")
    parser.add_argument("--self", dest="selfhost", action="store_true",
                        help="self-host the service + front "
                             "(default)")
    parser.add_argument("--target", type=str, default=None,
                        help="drive an external endpoint instead")
    parser.add_argument("--clients", type=int, default=100_000,
                        help="simulated client population")
    parser.add_argument("--bits", type=int, default=2,
                        help="tenant tree depth for blob building")
    parser.add_argument("--duration", type=float, default=6.0)
    parser.add_argument("--rate", type=float, default=250.0,
                        help="offered arrivals/s outside bursts")
    parser.add_argument("--burst-factor", type=float, default=3.0)
    parser.add_argument("--malformed-frac", type=float, default=0.03)
    parser.add_argument("--zipf", type=float, default=1.2)
    parser.add_argument("--workers", type=int, default=6)
    parser.add_argument("--ingest-threads", type=int, default=0)
    parser.add_argument("--ingest-queue", type=int, default=256)
    parser.add_argument("--slo-p99-ms", type=float, default=250.0,
                        help="the stated admission-latency SLO the "
                             "run must hold")
    parser.add_argument("--seed", dest="replay", type=int,
                        default=0, help="deterministic replay index")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the self-hosted service's device "
                             "(default cuda; the kill9 drill's "
                             "children get it too)")
    parser.add_argument("--wal-bench", action="store_true",
                        help="measure the durability disciplines "
                             "head to head (snapshot-before-ack vs "
                             "WAL always vs WAL group commit) over "
                             "the real HTTP path")
    parser.add_argument("--wal-reports", type=int, default=20000,
                        help="uploads per --wal-bench mode — the "
                             "baseline's per-settle cost is O(state), "
                             "so the measured gap grows with this")
    parser.add_argument("--wal-workers", type=int, default=32,
                        help="concurrent clients per --wal-bench "
                             "mode")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args()

    from mastic_tpu_torch import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        fail(str(exc))
    if args.wal_bench:
        run_wal_bench(args)
    elif args.smoke:
        run_smoke(args)
    else:
        run_load(args)


if __name__ == "__main__":
    main()
