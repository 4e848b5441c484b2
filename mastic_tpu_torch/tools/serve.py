"""Collector-service driver (port of `tools/serve.py`; run as
`python -m mastic_tpu_torch.tools.serve`): boot a long-lived
multi-tenant service (`mastic_tpu_torch/drivers/service.py`) on the
card, stream synthetic uploads through it, and drain epochs.

Modes:

* default: build the demo tenants (a heavy-hitters Count collection
  and an attribute-metrics collection at another bit-width), admit
  `--reports` seeded uploads per tenant per epoch, run `--epochs`
  epochs each through the scheduler, and print one JSON line with the
  per-tenant results and the full service metrics.  With `--snapshot
  PATH` the service state is written (atomic rename) after admission
  and after every scheduler round, so a `kill -9` at any point loses
  at most the round in flight; `--resume` restores from the snapshot
  instead of re-admitting.  With `--upload-port` the synthetic
  admission is replaced by the DAP-shaped HTTP upload endpoint
  (`net/ingest.py`) for `--upload-window` seconds, with the durable
  admission WAL under it (`--wal DIR`, default `<snapshot>.wal`)
  whenever `--snapshot` is set.

* ``--smoke``: the robustness gate: two tenants plus overload and
  deadline scratch tenants, a malformed-upload burst (quarantined,
  tenant-attributed), sustained overload against a tiny quota (sheds
  counted under both policies), an epoch-deadline miss (degrades to
  the truncated frontier, marked), and a mid-epoch crash drill
  (snapshot, discard the live service, resume, identical result).
  Any violated expectation exits non-zero with the reason; the JSON
  line carries ``"ok": true`` otherwise.

* ``--soak SECONDS``: loop admit -> epoch -> drain under one deadline,
  reporting epochs completed, rounds and counter totals.

`--device` picks the runs' device (default cuda; without a card the
tool exits non-zero: nothing moves to the CPU on its own).

`MASTIC_FAULTS` (party ``collector``) is honored end to end, so e.g.
``kill:party=collector:step=epoch_round:nth=2`` exercises a real
process death mid-epoch against the snapshot/resume pair.

``--status-port N`` starts the live status surface
(`mastic_tpu_torch/obs/statusz.py`) on 127.0.0.1:N: ``/metrics``
(Prometheus), ``/statusz`` (human text) and ``/varz`` (JSON).  Port 0
binds an ephemeral port (printed as ``status_port``).  The scheduler
publishes an immutable snapshot after every quantum and the server
thread only reads published snapshots.  With ``--smoke --status-port``
the smoke gate self-fetches all three endpoints and asserts the
expected per-tenant series.  `MASTIC_TRACE_FILE=path` gets a JSONL
span trace of every epoch and round.
"""

import argparse
import hashlib
import json
import os
import sys
import time


def pin(name: str, value: str) -> None:
    """Set an environment lever at argv time, before the service (or
    any thread) reads it."""
    os.environ[name] = value


def build_reports(m, ctx, rng, values, bits):
    """Seeded client uploads: shard each value with rng-derived
    nonce/rand so two processes with one --seed build byte-identical
    reports (the unfaulted / faulted+resumed comparison needs it)."""
    scalar = m.scalar()
    reports = []
    for v in values:
        alpha = scalar.vidpf.test_index_from_int(v, bits)
        nonce = bytes(rng.integers(0, 256, m.NONCE_SIZE,
                                   dtype="uint8"))
        rand = bytes(rng.integers(0, 256, m.RAND_SIZE, dtype="uint8"))
        (ps, shares) = scalar.shard(ctx, (alpha, True), nonce, rand)
        reports.append((nonce, ps, shares))
    return reports


def strip_wall(records):
    """Epoch records minus wall-clock stamps (the bit-identity
    comparison target: everything except timing — compile accounting
    is timing too: a resumed run recomputes fewer rounds)."""
    out = []
    for rec in records:
        rec = dict(rec)
        for key in ("wall_s", "compile_ms", "inline_compiles",
                    "parse_ms"):
            rec.pop(key, None)
        out.append(rec)
    return out


def admit_all(svc, tenant, m, reports, expect=None):
    from mastic_tpu_torch.drivers.service import encode_upload

    outcomes = []
    for r in reports:
        outcomes.append(svc.submit(tenant, encode_upload(m, r)))
    if expect is not None:
        bad = [o for o in outcomes if o[0] != expect]
        if bad:
            fail(f"admission to {tenant}: expected {expect}, "
                 f"got {bad[:3]}")
    return outcomes


def fail(msg: str) -> None:
    print(f"serve: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def drain(svc, snapshot_path=None, deadline=None, status=None) -> None:
    from mastic_tpu_torch.drivers.session import Deadline

    if deadline is None:
        # The drain itself is deadline-bounded (the scheduler's
        # per-epoch deadlines bound each epoch; this bounds the loop).
        deadline = Deadline(3600.0)
    while svc.step():
        # Snapshots are quiescent points: with the overlapped
        # executor armed, writing one mid-window would force-drain
        # the in-flight rounds every quantum — snapshot only when
        # nothing is staged (serial mode: every quantum, as before).
        if snapshot_path and svc.inflight_rounds() == 0:
            write_snapshot(svc, snapshot_path)
        publish_status(status, svc)
        if deadline.expired():
            fail("drain deadline expired with epochs still queued")
    publish_status(status, svc)


def start_status(port):
    """The --status-port surface, or None when the flag is absent.
    Port 0 binds an ephemeral port (server.port has the real one)."""
    if port is None:
        return None
    from mastic_tpu_torch.obs.statusz import StatusServer

    return StatusServer(port=port).start()


def publish_status(status, svc) -> None:
    """One scheduler quantum's snapshot to the status server — the
    single-threaded scheduler's only contact with the server thread
    (snapshot-under-lock; the server never touches `svc`)."""
    if status is not None:
        status.publish(svc.metrics())


def check_status_endpoints(status) -> None:
    """Self-fetch /metrics, /statusz and /varz over real HTTP and
    assert the series the acceptance criteria name are present (the
    smoke gate's teeth)."""
    import urllib.request

    def get(path: str) -> bytes:
        url = f"http://127.0.0.1:{status.port}{path}"
        with urllib.request.urlopen(url, timeout=10) as resp:
            if resp.status != 200:
                fail(f"GET {path} -> {resp.status}")
            return resp.read()

    metrics = get("/metrics").decode()
    for needle in (
            'mastic_reports_admitted_total{tenant="count"}',
            'mastic_reports_quarantined_total{tenant="count"',
            'mastic_reports_shed_total{tenant="flood"',
            'mastic_rounds_total{tenant="count"}',
            'mastic_session_retries_total{tenant="count"}',
            "mastic_chunk_phase_ms_bucket",
            "mastic_epochs_total{",
            "mastic_round_wall_ms_bucket"):
        if needle not in metrics:
            fail(f"/metrics missing expected series {needle!r}")
    statusz = get("/statusz").decode()
    for needle in ("tenant count", "occupancy:", "counters:"):
        if needle not in statusz:
            fail(f"/statusz missing {needle!r}")
    varz = json.loads(get("/varz"))
    for key in ("metrics", "trace", "service"):
        if key not in varz:
            fail(f"/varz missing {key!r}")
    if "count" not in varz["service"].get("tenants", {}):
        fail("/varz service snapshot has no tenants")


def run_upload_window(args, svc, status, wal=None):
    """The HTTP-ingest window (`net/ingest.py`):
    serve the DAP-shaped upload endpoint for `--upload-window`
    seconds — or until a client POSTs the admin drain control — then
    cut every tenant's buffered pages into epochs and fall through to
    the normal drain.

    Plane separation: handler threads only admit (`submit()` is the
    thread-safe seam, host-only: no handler touches the card) and
    ENQUEUE — epoch cuts, snapshots and rounds execute here, on this
    thread, which owns the whole scheduler plane.  Durability: with
    `--snapshot` a WAL sits under admission — each handler's 2xx
    waits only for its record's
    (group-committed) fsync, not a full snapshot, so a client holding
    an ack can never lose that report to a kill -9; an un-acked
    upload is the client's to retry (the DAP upload contract).  The
    snapshot-before-ack ticket loop this replaces survives only as
    the compaction trigger: this thread snapshots PERIODICALLY
    (`--snapshot-every`) and truncates the WAL segments the snapshot
    covers — `tools.loadgen --smoke`'s mid-upload crash drill drives
    the kill/--resume pair."""
    from mastic_tpu_torch.drivers.session import Deadline
    from mastic_tpu_torch.net.ingest import UploadFront

    front = UploadFront(
        svc, port=args.upload_port, admin=True,
        injector=svc.injector,
        persist=(wal.append_report if wal is not None
                 else None)).start()
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"upload_port": front.port}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, args.port_file)
        fsync_dir(os.path.dirname(args.port_file))

    def compact() -> None:
        # Covered-seq FIRST: anything appended while to_bytes runs
        # is not provably in the snapshot, so it stays replayable.
        seq = wal.tail_seq()
        digest = write_snapshot(svc, args.snapshot)
        wal.mark_covered(seq, digest)

    def cut_epoch(tenant: str) -> None:
        if wal is not None:
            # Log the cut before executing it: a crash between the
            # two replays the same cut over the same reports.
            wal.append_epoch_cut(tenant)
        svc.begin_epoch(tenant)

    next_compact = time.monotonic() + args.snapshot_every
    deadline = Deadline(args.upload_window)
    while not deadline.expired():
        drain_now = front.drain_requested.wait(0.02)
        for tenant in front.pop_epoch_requests():
            cut_epoch(tenant)
        if wal is not None and time.monotonic() >= next_compact:
            compact()
            next_compact = time.monotonic() + args.snapshot_every
        publish_status(status, svc)
        if drain_now:
            break
    front.stop()
    for tenant in front.pop_epoch_requests():
        cut_epoch(tenant)
    for name in list(svc.tenants):
        cut_epoch(name)
    if wal is not None:
        compact()
    elif args.snapshot:
        write_snapshot(svc, args.snapshot)
    return front.port


def fsync_dir(path: str) -> None:
    from mastic_tpu_torch.drivers import wal as wal_mod

    wal_mod.fsync_dir(path or ".")


def write_snapshot(svc, path: str) -> str:
    """Crash-safe snapshot write — the full tmp → fsync(file) →
    os.replace → fsync(dir) sequence (RB006's required idiom: rename
    alone can land with the bytes still in the page cache).  Returns
    the SHA-256 hexdigest of the snapshot bytes: the WAL's covered
    marker records it, and recovery re-verifies it before trusting
    the marker over replay."""
    data = svc.to_bytes()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        # The snapshot carries the tenant key bindings (the resumed
        # process re-derives nothing); the trust boundary is the
        # filesystem permissions of the --snapshot path.
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))
    return hashlib.sha256(data).hexdigest()


def main() -> None:
    parser = argparse.ArgumentParser(
        description="long-lived collector service driver on the card")
    parser.add_argument("--bits", type=int, default=2,
                        help="tree depth of the heavy-hitters tenant")
    parser.add_argument("--reports", type=int, default=6,
                        help="uploads per tenant per epoch")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--page-size", type=int, default=4)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snapshot", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--smoke", action="store_true",
                        help="the serve-smoke robustness gate")
    parser.add_argument("--soak", type=float, default=0.0,
                        help="unattended soak for SECONDS "
                             "(chip-session cell)")
    parser.add_argument("--wal", type=str, default=None,
                        help="directory of the durable admission WAL "
                             "(default <snapshot>.wal — armed whenever "
                             "--snapshot and --upload-port are both "
                             "set)")
    parser.add_argument("--snapshot-every", type=float, default=5.0,
                        help="seconds between periodic compaction "
                             "snapshots while the upload window is "
                             "open (the WAL subsumed per-ack "
                             "snapshots)")
    parser.add_argument("--status-port", type=int, default=None,
                        help="serve /metrics, /statusz and /varz on "
                             "127.0.0.1:PORT (0 = ephemeral)")
    parser.add_argument("--upload-port", type=int, default=None,
                        help="serve the DAP-shaped HTTP upload "
                             "endpoint (PUT /v1/tenants/{id}/reports) "
                             "on 127.0.0.1:PORT for --upload-window "
                             "seconds before cutting epochs and "
                             "draining (0 = ephemeral)")
    parser.add_argument("--upload-window", type=float, default=30.0,
                        help="seconds the upload endpoint accepts "
                             "reports (a client POST to "
                             "/v1/admin/drain closes it early)")
    parser.add_argument("--port-file", type=str, default=None,
                        help="write the bound upload port as JSON to "
                             "this path (atomic rename) — how a "
                             "driver finds an ephemeral --upload-port "
                             "0")
    parser.add_argument("--overlap", type=int, default=None,
                        help="keep up to K tenants' rounds in flight "
                             "(overlapped epoch executor; sets "
                             "MASTIC_SERVICE_OVERLAP — <2 = the "
                             "serial round-robin scheduler)")
    parser.add_argument("--ingest-threads", type=int, default=None,
                        help="decode-validate admissions on this "
                             "many worker threads behind a bounded "
                             "queue (concurrent ingest front; sets "
                             "MASTIC_SERVICE_INGEST_THREADS — 0 = "
                             "in-process admission)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the runs' device (default cuda; cpu runs "
                             "the kernels' plain versions)")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args()

    if args.resume and not args.snapshot:
        parser.error("--resume needs --snapshot PATH")
    # argv-time environment pinning: these writes happen strictly
    # before any thread exists.
    if args.overlap is not None:
        pin("MASTIC_SERVICE_OVERLAP", str(args.overlap))
    if args.ingest_threads is not None:
        pin("MASTIC_SERVICE_INGEST_THREADS", str(args.ingest_threads))

    import numpy as np

    from mastic_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        fail(str(exc))

    if args.smoke:
        run_smoke(args, device, status=start_status(args.status_port))
        return

    from mastic_tpu_torch.drivers.service import (CollectorService,
                                            ServiceConfig, TenantSpec)
    from mastic_tpu_torch.backend.mastic import MasticCount

    t_start = time.time()
    bits = args.bits
    m_count = MasticCount(bits)
    m_attr = MasticCount(8)
    rng = np.random.default_rng(args.seed)
    # Deterministic keys: the resumed process must rebuild the same
    # tenant bindings the snapshot header carries.
    vk_count = bytes(rng.integers(0, 256, m_count.VERIFY_KEY_SIZE,
                                  dtype="uint8"))
    vk_attr = bytes(rng.integers(0, 256, m_attr.VERIFY_KEY_SIZE,
                                 dtype="uint8"))
    threshold = max(2, int(args.reports * 0.4))
    tenants = [
        TenantSpec(name="count",
                   spec={"class": "MasticCount", "args": [bits]},
                   ctx=b"serve count", verify_key=vk_count,
                   thresholds={"default": threshold},
                   chunk_size=args.chunk_size),
        TenantSpec(name="attrs",
                   spec={"class": "MasticCount", "args": [8]},
                   ctx=b"serve attrs", verify_key=vk_attr,
                   mode="attribute_metrics",
                   attributes=["checkout.html", "landing.html"],
                   chunk_size=args.chunk_size),
    ]
    config = ServiceConfig.from_env()
    config.page_size = args.page_size

    snap_sha256 = None
    if args.resume:
        with open(args.snapshot, "rb") as f:
            snap_bytes = f.read()
        snap_sha256 = hashlib.sha256(snap_bytes).hexdigest()
        svc = CollectorService.from_bytes(snap_bytes, config=config,
                                          device=device)
    else:
        svc = CollectorService(tenants, config=config, device=device)

    # The durable admission log: armed whenever the HTTP
    # ingest plane and a snapshot path are both configured.  On
    # --resume, recovery replays every record the restored snapshot
    # does not cover (verified by digest) BEFORE the window reopens.
    wal = None
    wal_recovery = None
    if args.upload_port is not None and args.snapshot:
        from mastic_tpu_torch.drivers.wal import AdmissionWal

        wal = AdmissionWal(args.wal or (args.snapshot + ".wal"),
                           injector=svc.injector,
                           fresh=not args.resume)
        if args.resume:
            wal_recovery = wal.recover(svc,
                                       snapshot_sha256=snap_sha256)
        else:
            # Seed the compaction baseline: the snapshot file exists
            # from boot, so a crash at ANY later point resumes from
            # snapshot + WAL replay, never from nothing.
            wal.mark_covered(wal.tail_seq(),
                             write_snapshot(svc, args.snapshot))
    status = start_status(args.status_port)
    publish_status(status, svc)

    hot = args.reports // 2
    count_values = [0] * hot + [2 ** bits - 1] * (args.reports - hot)
    from mastic_tpu_torch.drivers.attribute_metrics import hash_attribute
    attr_alpha = hash_attribute(m_attr, "checkout.html")
    attr_int = int("".join("1" if b else "0" for b in attr_alpha), 2)
    attr_values = [attr_int] * max(1, args.reports - 2) \
        + [0] * min(2, args.reports)

    if args.soak:
        run_soak(args, svc, m_count, count_values, rng, t_start,
                 device, status=status)
        return

    upload_port = None
    if args.upload_port is not None:
        # HTTP ingest replaces the synthetic admission loop entirely
        # (on --resume too: the reopened window is where a client
        # retries the uploads the crashed process never acked).
        upload_port = run_upload_window(args, svc, status, wal=wal)
    elif not args.resume:
        for _ in range(args.epochs):
            reports = build_reports(m_count, b"serve count", rng,
                                    count_values, bits)
            admit_all(svc, "count", m_count, reports)
            svc.begin_epoch("count")
            reports = build_reports(m_attr, b"serve attrs", rng,
                                    attr_values, 8)
            admit_all(svc, "attrs", m_attr, reports)
            svc.begin_epoch("attrs")
        if args.snapshot:
            write_snapshot(svc, args.snapshot)
    drain(svc, snapshot_path=args.snapshot, status=status)
    if args.snapshot:
        digest = write_snapshot(svc, args.snapshot)
        if wal is not None:
            wal.mark_covered(wal.tail_seq(), digest)
            wal.close()

    metrics = svc.metrics()
    out = {
        "mode": "resume" if args.resume else "serve",
        "upload_port": upload_port,
        "platform": device.type,
        "bits": bits, "reports": args.reports,
        "epochs": args.epochs,
        "status_port": status.port if status is not None else None,
        "wall_seconds": round(time.time() - t_start, 1),
        "results": {name: strip_wall(t["epochs"])
                    for (name, t) in metrics["tenants"].items()},
        "metrics": metrics,
        "ok": True,
    }
    if wal is not None:
        out["wal"] = wal.stats()
        if wal_recovery is not None:
            out["wal"]["recovery"] = wal_recovery
            out["wal"]["replayed_records"] = \
                wal_recovery["replayed"]
            out["wal"]["recovery_wall_ms"] = \
                wal_recovery["recovery_wall_ms"]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")




def run_soak(args, svc, m_count, count_values, rng, t_start, device,
             status=None) -> None:
    """Unattended soak: admit -> epoch -> drain in a loop under one
    deadline; every epoch's output is checked against the expected
    hitters, so a service that degrades mid-soak fails the cell."""
    from mastic_tpu_torch.drivers.service import encode_upload
    from mastic_tpu_torch.drivers.session import Deadline

    bits = args.bits
    expected = sorted([[False] * bits, [True] * bits])
    deadline = Deadline(args.soak)
    epochs = 0
    while not deadline.expired():
        reports = build_reports(m_count, b"serve count", rng,
                                count_values, bits)
        for r in reports:
            svc.submit("count", encode_upload(m_count, r))
        svc.begin_epoch("count")
        drain(svc, snapshot_path=args.snapshot, deadline=deadline,
              status=status)
        recs = svc.metrics()["tenants"]["count"]["epochs"]
        if recs and not recs[-1]["truncated"]:
            epochs += 1
            got = sorted(recs[-1]["result"])
            if got != expected:
                fail(f"soak epoch {epochs}: hitters {got} != "
                     f"{expected}")
    counters = svc.metrics()["tenants"]["count"]["counters"]
    out = {
        "mode": "soak",
        "platform": device.type,
        "soak_seconds": args.soak,
        "epochs_completed": epochs,
        "rounds": counters["rounds"],
        "wall_seconds": round(time.time() - t_start, 1),
        "counters": counters,
        "ok": epochs >= 1,
    }
    print(json.dumps(out), flush=True)
    if not out["ok"]:
        sys.exit(1)


def run_smoke(args, device, status=None) -> None:
    """The serve-smoke gate: one process, every defensive behavior
    demonstrated and asserted (module docstring lists them).  With a
    status server attached (`--status-port`), the three observability
    endpoints are self-fetched over real HTTP mid-run and their
    expected per-tenant series asserted (the obs-smoke gate)."""
    import numpy as np

    from mastic_tpu_torch.drivers.service import (ADMITTED, QUARANTINED,
                                            SHED, CollectorService,
                                            ServiceConfig, TenantSpec,
                                            encode_upload)
    from mastic_tpu_torch.backend.mastic import MasticCount

    t_start = time.time()
    rng = np.random.default_rng(args.seed)
    bits = 2
    m = MasticCount(bits)
    m_attr = MasticCount(8)
    vk = bytes(rng.integers(0, 256, m.VERIFY_KEY_SIZE, dtype="uint8"))
    vk_attr = bytes(rng.integers(0, 256, m_attr.VERIFY_KEY_SIZE,
                                 dtype="uint8"))

    def specs():
        return [
            TenantSpec(name="count",
                       spec={"class": "MasticCount", "args": [bits]},
                       ctx=b"smoke count", verify_key=vk,
                       thresholds={"default": 2},
                       chunk_size=args.chunk_size),
            TenantSpec(name="attrs",
                       spec={"class": "MasticCount", "args": [8]},
                       ctx=b"smoke attrs", verify_key=vk_attr,
                       mode="attribute_metrics",
                       attributes=["checkout.html", "landing.html"],
                       chunk_size=args.chunk_size),
            # Overload scratch tenant: tiny quota, never scheduled.
            TenantSpec(name="flood",
                       spec={"class": "MasticCount", "args": [bits]},
                       ctx=b"smoke flood", verify_key=vk,
                       thresholds={"default": 2}, max_buffered=5),
            # Deadline tenant: an already-expired epoch budget, so
            # its epoch degrades to the truncated frontier.
            TenantSpec(name="slow",
                       spec={"class": "MasticCount", "args": [bits]},
                       ctx=b"smoke slow", verify_key=vk,
                       thresholds={"default": 2}, epoch_deadline=0.0),
        ]

    config = ServiceConfig(page_size=3, max_buffered=64,
                           max_pending_epochs=2,
                           shed_policy="reject-newest",
                           quarantine_limit=16,
                           epoch_deadline=600.0)
    svc = CollectorService(specs(), config=config, device=device)

    # 1. malformed-upload burst: reason-coded quarantine, tenant-
    # attributed; the other tenants are untouched.
    for blob in (b"", b"\x07garbage", b"\xff" * 40):
        (outcome, detail) = svc.submit("count", blob)
        if outcome != QUARANTINED:
            fail(f"malformed blob admitted: {(outcome, detail)}")
    qm = svc.metrics()["tenants"]
    if qm["count"]["counters"]["quarantined"] != 3 \
            or qm["count"]["suspended"] \
            or qm["attrs"]["counters"]["quarantined"] != 0:
        fail(f"quarantine counters wrong: {qm['count']['counters']}")

    # 2. sustained overload against the flood tenant's quota of 5:
    # admission stays bounded, sheds are counted, memory is pages
    # not uploads.
    flood_reports = build_reports(m, b"smoke flood", rng,
                                  [0] * 12, bits)
    outcomes = admit_all(svc, "flood", m, flood_reports)
    admitted = sum(1 for o in outcomes if o[0] == ADMITTED)
    shed = sum(1 for o in outcomes if o[0] == SHED)
    fm = svc.metrics()["tenants"]["flood"]
    if admitted != 5 or shed != 7 \
            or fm["buffered_reports"] != 5 \
            or fm["counters"]["shed_reasons"].get("reject-newest") != 7:
        fail(f"reject-newest overload wrong: admitted={admitted} "
             f"shed={shed} {fm['counters']}")

    # 2b. oldest-epoch-first on a scratch service: the oldest queued
    # epoch is dropped to admit fresh load.  (Fresh spec: the flood
    # tenant above carries its own tighter max_buffered override.)
    svc_old = CollectorService(
        [TenantSpec(name="flood",
                    spec={"class": "MasticCount", "args": [bits]},
                    ctx=b"smoke flood", verify_key=vk,
                    thresholds={"default": 2}, max_buffered=6)],
        config=ServiceConfig(page_size=3,
                             max_pending_epochs=2,
                             shed_policy="oldest-epoch-first",
                             epoch_deadline=600.0), device=device)
    admit_all(svc_old, "flood", m,
              build_reports(m, b"smoke flood", rng, [0] * 6, bits),
              expect=ADMITTED)
    first_epoch = svc_old.begin_epoch("flood")
    outcomes = admit_all(svc_old, "flood", m,
                         build_reports(m, b"smoke flood", rng,
                                       [1] * 3, bits),
                         expect=ADMITTED)   # room made by the drop
    om = svc_old.metrics()["tenants"]["flood"]
    if first_epoch != 0 or om["pending_epochs"] != 0 \
            or om["counters"]["shed_reasons"] \
            .get("oldest-epoch-first") != 6:
        fail(f"oldest-epoch-first wrong: {om}")

    # 3. real multi-tenant work, admission continuing mid-flight.
    count_values = [0, 0, 0, 3, 3]
    count_reports = build_reports(m, b"smoke count", rng,
                                  count_values, bits)
    admit_all(svc, "count", m, count_reports, expect=ADMITTED)
    svc.begin_epoch("count")
    from mastic_tpu_torch.drivers.attribute_metrics import hash_attribute
    alpha = hash_attribute(m_attr, "checkout.html")
    attr_int = int("".join("1" if b else "0" for b in alpha), 2)
    attr_reports = build_reports(m_attr, b"smoke attrs", rng,
                                 [attr_int, attr_int, 0], 8)
    admit_all(svc, "attrs", m_attr, attr_reports, expect=ADMITTED)
    svc.begin_epoch("attrs")
    # deadline tenant: its expired budget must degrade, not hang.
    admit_all(svc, "slow", m,
              build_reports(m, b"smoke slow", rng, [0, 0, 3], bits),
              expect=ADMITTED)
    svc.begin_epoch("slow")

    steps = 0
    while svc.step():
        steps += 1
        publish_status(status, svc)
        if steps == 1:
            # admission while rounds are in flight: lands in the
            # open page, joins the NEXT epoch.
            admit_all(svc, "count", m,
                      build_reports(m, b"smoke count", rng,
                                    count_values, bits),
                      expect=ADMITTED)
        if steps > 200:
            fail("drain did not converge")
    publish_status(status, svc)
    if status is not None:
        # The obs-smoke teeth: fetch all three endpoints over HTTP
        # during the live process and assert the acceptance series.
        check_status_endpoints(status)

    mx = svc.metrics()["tenants"]
    count_rec = mx["count"]["epochs"][0]
    expected_hitters = sorted([[False] * bits, [True] * bits])
    if count_rec["truncated"] \
            or sorted(count_rec["result"]) != expected_hitters:
        fail(f"count epoch wrong: {count_rec}")
    attr_rec = mx["attrs"]["epochs"][0]
    if attr_rec["truncated"] or attr_rec["result"][0][1] != [2] \
            and attr_rec["result"][0][1] != 2:
        fail(f"attrs epoch wrong: {attr_rec}")
    slow_rec = mx["slow"]["epochs"][0]
    if not slow_rec["truncated"] \
            or mx["slow"]["counters"]["deadline_misses"] != 1:
        fail(f"deadline miss not degraded: {slow_rec}")

    # 4. crash drill: second count epoch, snapshot mid-epoch, discard
    # the live service, resume, drain — result bit-identical to the
    # first epoch's (same reports are NOT required; same VALUES are,
    # so compare against epoch 0's result).
    svc.begin_epoch("count")   # the mid-flight admissions from step 1
    svc.step()                 # one round into the epoch
    blob = svc.to_bytes()
    del svc
    svc2 = CollectorService.from_bytes(blob, config=config, device=device)
    drain(svc2)
    mx2 = svc2.metrics()["tenants"]
    resumed_rec = mx2["count"]["epochs"][1]
    if resumed_rec["truncated"] \
            or sorted(resumed_rec["result"]) != expected_hitters:
        fail(f"resumed epoch wrong: {resumed_rec}")
    if not mx2["count"]["counters"]["resumes"]:
        fail("resume not counted")

    out = {
        "mode": "smoke",
        "platform": device.type,
        "wall_seconds": round(time.time() - t_start, 1),
        "tenants": {name: t["counters"]
                    for (name, t) in mx2.items()},
        "scheduler_rounds": steps,
        "status_port": status.port if status is not None else None,
        "ok": True,
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
