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

* ``--overlap-drill``, ``--chaos-drill SEED``, ``--wal-drill SEED``: the
  JAX package's drills (each function's docstring), their children and
  parties on `--device`.

`--device` picks the runs' device (default cuda; without a card the
tool exits non-zero: nothing moves to the CPU on its own).

``--mesh N`` runs the default mode, ``--resume``, ``--smoke`` and
``--soak`` on N ranks (`parallel.spawn`, one process each, over
``--backend``: nccl by default, which takes one card a rank; gloo for
ranks that share a card or run on the CPU).  Each rank runs the service
with a `ReportMesh`, every run keeping the rank's rows, and rank 0
decides (`drivers/service.py`): it alone opens the upload door, the WAL
and the status port, writes `--port-file`, `--snapshot` and `--out`;
the others take the same snapshots with it (a snapshot gathers every
rank's carries) and receive the epochs it cut.  In the default mode and
``--smoke`` every rank admits the same seeded uploads.  The line is
rank 0's, with `mesh_devices` and every rank's kernel launches
(`rank_launches`); the tool fails unless every rank's results equal rank
0's.  A rank that raises makes the tool exit 1 with its traceback, one
killed by `MASTIC_FAULTS` exits with its kill code, and nothing carries
on with fewer ranks.  A rank waits at most `MESH_TIMEOUT_S` (plus the
upload window) in one collective.

``--artifact-dir DIR`` serves the kernel libraries from a kernel store
(`python -m mastic_tpu_torch.tools.bake --out DIR`): it sets
`MASTIC_ARTIFACT_DIR` for the process before any kernel loads, so the
service loads and probes the libraries at boot and a machine without
nvcc can serve.  Child processes (parties, mesh ranks) inherit it.  The
default mode's JSON line echoes `artifact_dir` and carries
`kernel_store` (inline nvcc builds, store hits and outcomes, per-library
load and probe times), `first_round_at` (the wall clock, `time.time()`,
at the end of the first scheduler round) and `round_counters` (every
round's counters, by tenant, from the epochs' trace spans).

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
import pathlib
import random
import sys
import time

# The root the drills' children and parties run from.
REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
# The longest a mesh rank waits in one collective (the upload window
# is added: the others wait that long for rank 0's door to close).
MESH_TIMEOUT_S = 600.0
# The drain's own bound (`drain`), which a mesh run's wall bound adds.
DRAIN_S = 3600.0
# Under a mesh the smoke's heavy-hitters epochs (5 and 3 reports) are
# chunked, in chunks of this many unless --chunk-size names one: only
# the chunked runner pads an epoch to the ranks.
MESH_SMOKE_CHUNK = 4


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


def drain(svc, snapshot_path=None, deadline=None, status=None):
    """Step the scheduler until every epoch is drained.  Returns the wall
    clock (`time.time()`) at the end of its first step."""
    from mastic_tpu_torch.drivers.session import Deadline

    if deadline is None:
        # The drain itself is deadline-bounded (the scheduler's
        # per-epoch deadlines bound each epoch; this bounds the loop).
        deadline = Deadline(DRAIN_S)
    first_round_at = None
    while True:
        more = svc.step()
        if first_round_at is None:
            first_round_at = time.time()
        if not more:
            break
        # Snapshots are quiescent points: with the overlapped
        # executor armed, writing one mid-window would force-drain
        # the in-flight rounds every quantum — snapshot only when
        # nothing is staged (serial mode: every quantum, as before).
        if snapshot_path and svc.inflight_rounds() == 0:
            write_snapshot(svc, snapshot_path)
        publish_status(status, svc)
        if svc.expired(deadline):
            fail("drain deadline expired with epochs still queued")
    publish_status(status, svc)
    return first_round_at


def round_counters() -> dict:
    """Every round's counters this process ran, by tenant, in order:
    the "round_counters" events of the finished epoch spans."""
    from mastic_tpu_torch.obs import trace as obs_trace

    out: dict = {}
    for span in obs_trace.get_tracer().spans():
        if span.name == "epoch":
            out.setdefault(span.attrs["tenant"], []).extend(
                ev["attrs"] for ev in span.events
                if ev["name"] == "round_counters")
    return out


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


# The window's news for the other ranks of a mesh (`follow_upload_window`).
SNAPSHOT_TICK = "snapshot"
CLOSED_TICK = "closed"


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
    covers — `tools.loadgen --smoke`'s mid-upload crash drill and
    `--wal-drill` drive the kill/--resume pair.

    Under a mesh this is rank 0's: it tells the other ranks before each
    snapshot, which they take with it, and when the window closes
    (`follow_upload_window`); its epoch cuts reach them at the
    scheduler's next quantum."""
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

    def tell(tick: str) -> None:
        if svc.mesh is not None:
            svc.mesh.broadcast(tick)

    def compact() -> None:
        # Covered-seq FIRST: anything appended while to_bytes runs
        # is not provably in the snapshot, so it stays replayable.
        seq = wal.tail_seq()
        tell(SNAPSHOT_TICK)
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
        tell(SNAPSHOT_TICK)
        write_snapshot(svc, args.snapshot)
    tell(CLOSED_TICK)
    return front.port


def follow_upload_window(args, svc) -> None:
    """The other ranks' side of rank 0's upload window: a snapshot each
    time rank 0 takes one, until rank 0 closes the window."""
    while svc.mesh.broadcast(None) == SNAPSHOT_TICK:
        write_snapshot(svc, args.snapshot)


def fsync_dir(path: str) -> None:
    from mastic_tpu_torch.drivers import wal as wal_mod

    wal_mod.fsync_dir(path or ".")


def write_snapshot(svc, path: str):
    """Crash-safe snapshot write — the full tmp → fsync(file) →
    os.replace → fsync(dir) sequence (RB006's required idiom: rename
    alone can land with the bytes still in the page cache).  Returns
    the SHA-256 hexdigest of the snapshot bytes: the WAL's covered
    marker records it, and recovery re-verifies it before trusting
    the marker over replay.  Under a mesh every rank calls it at the
    same point (`to_bytes` gathers every rank's carries) and rank 0
    alone writes; the others get None."""
    data = svc.to_bytes()
    if not svc.lead:
        return None
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


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="long-lived collector service driver on the card")
    parser.add_argument("--bits", type=int, default=2,
                        help="tree depth of the heavy-hitters tenant")
    parser.add_argument("--reports", type=int, default=6,
                        help="uploads per tenant per epoch")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--page-size", type=int, default=4)
    parser.add_argument("--chunk-size", type=int, default=None)
    parser.add_argument("--mesh", type=int, default=0,
                        help="run the service on this many ranks "
                             "(processes of torch.distributed), each "
                             "sharding the report axis; rank 0 decides")
    parser.add_argument("--backend", choices=("gloo", "nccl"),
                        default="nccl",
                        help="the ranks' collectives under --mesh "
                             "(nccl takes one card a rank)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--snapshot", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--smoke", action="store_true",
                        help="the serve-smoke robustness gate")
    parser.add_argument("--overlap-drill", action="store_true",
                        help="the overlapped-epoch drill: concurrent "
                             "submit burst against the ingest front, "
                             "then a kill-9 + --resume pair with the "
                             "overlapped executor armed")
    parser.add_argument("--soak", type=float, default=0.0,
                        help="unattended soak for SECONDS "
                             "(chip-session cell)")
    parser.add_argument("--chaos-drill", type=int, default=None,
                        metavar="SEED",
                        help="seeded network-chaos campaign: full "
                             "two-party collections over TCP+mTLS "
                             "standalone parties (tools.party) under a "
                             "randomized conn_drop/partition/"
                             "tls_handshake/slow_loris schedule — "
                             "bit-identity vs the loopback path, every "
                             "injected fault recovered and attributed")
    parser.add_argument("--chaos-seeds", type=int, default=3,
                        help="distinct chaos schedules to run, "
                             "seeds SEED..SEED+N-1 (default 3)")
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
    parser.add_argument("--wal-drill", type=int, default=None,
                        metavar="SEED",
                        help="the disk-fault leg of the seeded chaos "
                             "campaign: kill -9 at every WAL checkpoint "
                             "plus randomized kill/torn-tail/ENOSPC "
                             "schedules over the HTTP ingest path — "
                             "each must recover bit-identical with zero "
                             "lost acked reports and zero duplicates")
    parser.add_argument("--wal-seeds", type=int, default=3,
                        help="randomized WAL fault schedules to run, "
                             "seeds SEED..SEED+N-1 (default 3)")
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
    parser.add_argument("--artifact-dir", type=str, default=None,
                        help="kernel store (tools/bake.py --out): the "
                             "libraries are loaded and probed from it at "
                             "boot and on tenant admission, and nvcc "
                             "runs only for one that fails its gates "
                             "(sets MASTIC_ARTIFACT_DIR)")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    if args.resume and not args.snapshot:
        parser.error("--resume needs --snapshot PATH")
    if args.mesh < 0:
        parser.error(f"--mesh must be >= 0 (got {args.mesh})")
    if args.mesh and args.backend == "nccl" \
            and not args.device.startswith("cuda"):
        parser.error(f"--backend nccl needs a card (--device "
                     f"{args.device}): use --backend gloo")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    # argv-time environment pinning: these writes happen strictly
    # before any thread exists (and before any mesh rank is spawned,
    # so the ranks inherit them).
    if args.artifact_dir:
        # The one seam every loader reads
        # (drivers/artifacts.store_from_env); the flag just sets it.
        pin("MASTIC_ARTIFACT_DIR", args.artifact_dir)
    if args.overlap is not None:
        pin("MASTIC_SERVICE_OVERLAP", str(args.overlap))
    if args.ingest_threads is not None:
        pin("MASTIC_SERVICE_INGEST_THREADS", str(args.ingest_threads))

    from mastic_tpu_torch import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        fail(str(exc))

    if not args.smoke:
        drill = (run_overlap_drill if args.overlap_drill
                 else run_chaos_drill if args.chaos_drill is not None
                 else run_wal_drill if args.wal_drill is not None
                 else None)
        if drill is not None:
            emit(args, drill(args, device))
            return
    out = run_mesh(args, device) if args.mesh else run(args, device)
    emit(args, out)
    if not out["ok"]:
        sys.exit(1)


def emit(args, out: dict) -> None:
    """Print the JSON line, and write it to --out."""
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


def run_mesh(args, device) -> dict:
    """The service on `--mesh` ranks (`parallel/jobs.py::serve` runs `run`
    on each): rank 0's line, with every rank's kernel launches.  Exits
    with the kill code when a rank was killed by the fault injector, and
    1 when a rank failed or the ranks' results differ."""
    import torch

    from mastic_tpu_torch.drivers import faults
    from mastic_tpu_torch.parallel import jobs, spawn
    from mastic_tpu_torch.parallel.launch import RankExit

    if device.type == "cuda" and args.backend == "nccl" \
            and args.mesh > torch.cuda.device_count():
        fail(f"--mesh {args.mesh} over nccl exceeds the "
             f"{torch.cuda.device_count()} card(s): use --backend gloo")
    timeout_s = MESH_TIMEOUT_S + (args.upload_window
                                  if args.upload_port is not None else 0.0)
    try:
        ranks = spawn(jobs.serve, args.mesh, args.backend, args.device,
                      args, timeout_s=timeout_s,
                      wall_s=timeout_s + DRAIN_S + args.soak)
    except RankExit as exc:
        print(f"serve: {exc}", file=sys.stderr, flush=True)
        sys.exit(faults.KILL_EXIT_CODE
                 if exc.exitcode == faults.KILL_EXIT_CODE else 1)
    except (RuntimeError, TimeoutError) as exc:
        fail(f"--mesh {args.mesh}: {exc}")
    out = ranks[0][0]

    def outcome(line: dict):
        return line.get("results", line.get("tenants"))

    differ = [r for (r, (line, _l)) in enumerate(ranks)
              if outcome(line) != outcome(out)]
    if differ:
        fail(f"--mesh {args.mesh}: ranks {differ}' results differ from "
             f"rank 0's")
    out["rank_launches"] = [launches for (_line, launches) in ranks]
    return out


def run(args, device, mesh=None) -> dict:
    """This process's part of the service in the mode the flags name,
    on `device`, or as a rank of `mesh`.  Returns the JSON line (rank
    0's is the tool's)."""
    lead = mesh is None or mesh.rank == 0
    status = start_status(args.status_port) if lead else None
    if args.smoke:
        return run_smoke(args, device, status=status, mesh=mesh)

    import numpy as np

    from mastic_tpu_torch.drivers import artifacts
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
                                          mesh=mesh, device=device)
    else:
        svc = CollectorService(tenants, config=config, mesh=mesh,
                               device=device)

    # The durable admission log: armed whenever the HTTP
    # ingest plane and a snapshot path are both configured (rank 0's,
    # under a mesh).  On --resume, recovery replays every record the
    # restored snapshot does not cover (verified by digest) BEFORE the
    # window reopens.
    durable = args.upload_port is not None and args.snapshot
    wal = None
    wal_recovery = None
    if durable and lead:
        from mastic_tpu_torch.drivers.wal import AdmissionWal

        wal = AdmissionWal(args.wal or (args.snapshot + ".wal"),
                           injector=svc.injector,
                           fresh=not args.resume)
    if durable and args.resume:
        if wal is not None:
            wal_recovery = wal.recover(svc,
                                       snapshot_sha256=snap_sha256)
    elif durable:
        # Seed the compaction baseline: the snapshot file exists
        # from boot, so a crash at ANY later point resumes from
        # snapshot + WAL replay, never from nothing.
        seq = wal.tail_seq() if wal is not None else None
        digest = write_snapshot(svc, args.snapshot)
        if wal is not None:
            wal.mark_covered(seq, digest)
    publish_status(status, svc)

    hot = args.reports // 2
    count_values = [0] * hot + [2 ** bits - 1] * (args.reports - hot)
    from mastic_tpu_torch.drivers.attribute_metrics import hash_attribute
    attr_alpha = hash_attribute(m_attr, "checkout.html")
    attr_int = int("".join("1" if b else "0" for b in attr_alpha), 2)
    attr_values = [attr_int] * max(1, args.reports - 2) \
        + [0] * min(2, args.reports)

    if args.soak:
        return run_soak(args, svc, m_count, count_values, rng, t_start,
                        device, status=status)

    upload_port = None
    if args.upload_port is not None:
        # HTTP ingest replaces the synthetic admission loop entirely
        # (on --resume too: the reopened window is where a client
        # retries the uploads the crashed process never acked).
        if lead:
            upload_port = run_upload_window(args, svc, status, wal=wal)
        else:
            follow_upload_window(args, svc)
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
    first_round_at = drain(svc, snapshot_path=args.snapshot, status=status)
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
        "mesh_devices": args.mesh or 1,
        "status_port": status.port if status is not None else None,
        "artifact_dir": args.artifact_dir,
        "kernel_store": artifacts.process_summary(),
        "first_round_at": first_round_at,
        "wall_seconds": round(time.time() - t_start, 1),
        "results": {name: strip_wall(t["epochs"])
                    for (name, t) in metrics["tenants"].items()},
        "round_counters": round_counters(),
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
    return out


def run_soak(args, svc, m_count, count_values, rng, t_start, device,
             status=None) -> dict:
    """Unattended soak: admit -> epoch -> drain in a loop under one
    deadline; every epoch's output is checked against the expected
    hitters, so a service that degrades mid-soak fails the cell."""
    from mastic_tpu_torch.drivers.service import encode_upload
    from mastic_tpu_torch.drivers.session import Deadline

    bits = args.bits
    expected = sorted([[False] * bits, [True] * bits])
    deadline = Deadline(args.soak)
    epochs = 0
    while not svc.expired(deadline):
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
    return {
        "mode": "soak",
        "platform": device.type,
        "soak_seconds": args.soak,
        "epochs_completed": epochs,
        "rounds": counters["rounds"],
        "wall_seconds": round(time.time() - t_start, 1),
        "counters": counters,
        "ok": epochs >= 1,
    }


def run_smoke(args, device, status=None, mesh=None) -> dict:
    """The serve-smoke gate: one process, every defensive behavior
    demonstrated and asserted (module docstring lists them).  With a
    status server attached (`--status-port`), the three observability
    endpoints are self-fetched over real HTTP mid-run and their
    expected per-tenant series asserted (the obs-smoke gate).  Under a
    mesh every rank runs it alike, its heavy-hitters tenants chunked
    (MESH_SMOKE_CHUNK), and the crash drill restores rank 0's snapshot
    on every rank."""
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
    mesh_chunk = (None if mesh is None
                  else args.chunk_size or MESH_SMOKE_CHUNK)

    def specs():
        return [
            TenantSpec(name="count",
                       spec={"class": "MasticCount", "args": [bits]},
                       ctx=b"smoke count", verify_key=vk,
                       thresholds={"default": 2},
                       chunk_size=mesh_chunk or args.chunk_size),
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
                       thresholds={"default": 2}, epoch_deadline=0.0,
                       chunk_size=mesh_chunk),
        ]

    config = ServiceConfig(page_size=3, max_buffered=64,
                           max_pending_epochs=2,
                           shed_policy="reject-newest",
                           quarantine_limit=16,
                           epoch_deadline=600.0)
    svc = CollectorService(specs(), config=config, mesh=mesh,
                           device=device)

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
    if mesh is not None:
        blob = mesh.broadcast(blob)
    del svc
    svc2 = CollectorService.from_bytes(blob, config=config, mesh=mesh,
                                       device=device)
    drain(svc2)
    mx2 = svc2.metrics()["tenants"]
    resumed_rec = mx2["count"]["epochs"][1]
    if resumed_rec["truncated"] \
            or sorted(resumed_rec["result"]) != expected_hitters:
        fail(f"resumed epoch wrong: {resumed_rec}")
    if not mx2["count"]["counters"]["resumes"]:
        fail("resume not counted")

    return {
        "mode": "smoke",
        "platform": device.type,
        "mesh_devices": args.mesh or 1,
        "wall_seconds": round(time.time() - t_start, 1),
        "tenants": {name: t["counters"]
                    for (name, t) in mx2.items()},
        "scheduler_rounds": steps,
        "status_port": status.port if status is not None else None,
        "ok": True,
    }


# -- the drills ---------------------------------------------------------

def child_env(fault=None) -> dict:
    """A drill child's environment: this one's, with `fault` as its
    MASTIC_FAULTS (none by default) and no network shaping."""
    env = dict(os.environ)
    env.pop("MASTIC_FAULTS", None)
    env.pop("MASTIC_NET_SHAPE", None)
    if fault is not None:
        env["MASTIC_FAULTS"] = fault
    return env


def load_kernels(device) -> None:
    """On a card, every kernel library loaded in this process (from the
    armed store, or built) before a drill starts a child, so that no
    child is the first to build one: a child killed mid-build would
    leave nothing torn (`ops.kernels.build` renames each library from a
    per-process temporary), but would pay nvcc's time."""
    if device.type == "cuda":
        from mastic_tpu_torch.ops import kernels

        kernels.preload()


def run_overlap_drill(args, device) -> dict:
    """The overlapped-epoch drill:

    1. concurrent submit burst — 4 client threads stream uploads into
       2 tenants through a live ingest front (3 workers, a 16-deep
       bounded queue): every submission must be accounted exactly
       once (admitted + shed == submitted, the buffered pages hold
       exactly the admitted blobs — zero lost, zero duplicated), and
       the burst must never block on the scheduler;
    2. kill-9 + --resume — the default two-tenant serve scenario runs
       as child processes with `--overlap 2 --ingest-threads 2` on
       `--device`: a clean run, a run hard-killed mid-drain by the
       injector at the scheduler's epoch_round checkpoint (the two side
       by side: they share nothing), and a `--resume` from the killed
       run's snapshot, whose results must equal the clean run's bit for
       bit.
    """
    import subprocess
    import tempfile
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mastic_tpu_torch.drivers import faults
    from mastic_tpu_torch.drivers.service import (QUEUED, SHED,
                                                  CollectorService,
                                                  ServiceConfig, TenantSpec,
                                                  encode_upload)
    from mastic_tpu_torch.backend.mastic import MasticCount

    t_start = time.time()
    load_kernels(device)
    bits = 2
    m = MasticCount(bits)
    rng = np.random.default_rng(args.seed)
    vk = bytes(rng.integers(0, 256, m.VERIFY_KEY_SIZE, dtype="uint8"))
    specs = [
        TenantSpec(name=f"t{i}",
                   spec={"class": "MasticCount", "args": [bits]},
                   ctx=b"drill", verify_key=vk,
                   thresholds={"default": 2}, max_buffered=64)
        for i in range(2)
    ]
    cfg = ServiceConfig(page_size=4, max_buffered=64,
                        shed_policy="reject-newest",
                        overlap=2, ingest_threads=3, ingest_queue=16,
                        epoch_deadline=600.0)
    svc = CollectorService(specs, config=cfg, device=device)
    per_thread = 10
    blobs = [encode_upload(m, r)
             for r in build_reports(m, b"drill", rng,
                                    [0] * per_thread, bits)]
    outcomes: list = []
    mu = threading.Lock()

    def feed(tenant: str) -> None:
        got = [svc.submit(tenant, b) for b in blobs]
        with mu:
            outcomes.extend(got)

    threads = [threading.Thread(target=feed, args=(f"t{i % 2}",))
               for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    svc.flush_ingest()
    queued = sum(1 for o in outcomes if o[0] == QUEUED)
    shed_at_queue = sum(1 for o in outcomes
                        if o == (SHED, "ingest-queue-full"))
    if queued + shed_at_queue != 4 * per_thread:
        fail(f"burst outcomes unaccounted: {queued} queued + "
             f"{shed_at_queue} queue-shed != {4 * per_thread}")
    mx = svc.metrics()["tenants"]
    landed = 0
    queue_shed_counted = 0
    for name in ("t0", "t1"):
        c = mx[name]["counters"]
        qshed = c["shed_reasons"].get("ingest-queue-full", 0)
        queue_shed_counted += qshed
        landed += c["admitted"] + c["quarantined"] \
            + (c["shed"] - qshed)
        if c["admitted"] != mx[name]["buffered_reports"]:
            fail(f"{name}: admitted {c['admitted']} != buffered "
                 f"{mx[name]['buffered_reports']} (lost/dup pages)")
    if queue_shed_counted != shed_at_queue:
        fail(f"queue-full sheds miscounted: counters say "
             f"{queue_shed_counted}, callers saw {shed_at_queue}")
    if landed + shed_at_queue != 4 * per_thread:
        fail(f"burst accounting: {landed} landed + {shed_at_queue} "
             f"queue-shed != {4 * per_thread}")
    svc.stop_ingest()

    # 2. kill-9 + --resume with overlap + ingest armed, as children.
    tmp = tempfile.mkdtemp(prefix="mastic_overlap_drill_")

    def run_child(extra, fault=None, expect_rc=0):
        # All three children run the parser-default seed: the drill
        # needs them deterministic relative to EACH OTHER, nothing
        # else (and argv stays free of anything seed-derived).
        cmd = [sys.executable, "-m", "mastic_tpu_torch.tools.serve",
               "--reports", "4", "--overlap", "2", "--ingest-threads",
               "2", "--device", args.device] + extra
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=1800, env=child_env(fault),
                              cwd=REPO_ROOT)
        if proc.returncode != expect_rc:
            fail(f"drill child {extra} rc={proc.returncode} "
                 f"(wanted {expect_rc}): {proc.stderr[-1500:]}")
        return proc

    snap = os.path.join(tmp, "killed.snap")
    with ThreadPoolExecutor(2) as pool:
        clean = pool.submit(
            run_child, ["--snapshot", os.path.join(tmp, "clean.snap")])
        killed = pool.submit(
            run_child, ["--snapshot", snap],
            fault="kill:party=collector:step=epoch_round:nth=2",
            expect_rc=faults.KILL_EXIT_CODE)
        clean_out = json.loads(clean.result().stdout.strip()
                               .splitlines()[-1])
        killed.result()
    if not os.path.exists(snap):
        fail("killed child left no snapshot")
    resumed = run_child(["--snapshot", snap, "--resume"])
    resumed_out = json.loads(resumed.stdout.strip().splitlines()[-1])
    if resumed_out["results"] != clean_out["results"]:
        fail(f"overlap kill-9 resume diverged: "
             f"{resumed_out['results']} != {clean_out['results']}")

    return {
        "mode": "overlap-drill",
        "platform": device.type,
        "burst_submitted": 4 * per_thread,
        "burst_admitted": landed,
        "burst_queue_shed": shed_at_queue,
        "kill9_resume_bit_identical": True,
        "wall_seconds": round(time.time() - t_start, 1),
        "ok": True,
    }


def chaos_schedule(seed: int) -> str:
    """A seeded random fault schedule (the JAX drill's, rule for rule),
    all rules addressed to the collector (whose injector the drill
    audits after the run): at least one hard drop (so
    reconnect-and-replay provably runs), a guaranteed-firing
    tls_handshake delay, and a random tail of partitions / extra drops /
    stalled writers."""
    r = random.Random(seed)
    rules = [
        f"conn_drop:party=collector:step=upload"
        f":nth={r.randint(1, 2)}",
        f"delay:party=collector:step=tls_handshake:nth=1"
        f":delay={r.uniform(0.1, 0.3):.2f}",
    ]
    extras = r.randint(1, 2)
    for _ in range(extras):
        pick = r.choice(("partition", "conn_drop", "slow_loris"))
        if pick == "partition":
            rules.append(
                f"partition:party=collector:step=agg_param"
                f":nth={r.randint(1, 4)}"
                f":delay={r.uniform(0.3, 0.8):.2f}")
        elif pick == "conn_drop":
            rules.append(
                f"conn_drop:party=collector:step=agg_param"
                f":nth={r.randint(1, 4)}")
        else:
            rules.append(
                f"slow_loris:party=collector:step=upload"
                f":nth={r.randint(1, 2)}"
                f":delay={r.uniform(0.2, 0.5):.2f}")
    # Distinct (step, nth) per rule — two rules on one occurrence
    # would leave the later one unfired and the audit ambiguous.
    seen = set()
    out = []
    for rule in rules:
        key = tuple(sorted(
            kv for kv in rule.split(":")
            if kv.startswith(("step=", "nth="))))
        if key in seen:
            continue
        seen.add(key)
        out.append(rule)
    return ";".join(out)


class ChaosDrill:
    """The chaos drill's collection (MasticCount(2), four seeded reports
    from `seed`, threshold 2), certificates under `tmp`, and its runs on
    `device`: the loopback baseline, a TCP+mTLS pair, and one chaos
    schedule with its audit."""

    BITS = 2

    def __init__(self, seed: int, device: str, tmp: str):
        import numpy as np

        from mastic_tpu_torch.backend.mastic import MasticCount
        from mastic_tpu_torch.drivers.session import SessionConfig
        from mastic_tpu_torch.net.transport import TlsConfig
        from mastic_tpu_torch.tools import certs as certs_mod

        self.m = MasticCount(self.BITS)
        self.spec = {"class": "MasticCount", "args": [self.BITS]}
        self.ctx = b"chaos drill"
        rng = np.random.default_rng(seed)
        self.vk = bytes(rng.integers(0, 256, self.m.VERIFY_KEY_SIZE,
                                     dtype="uint8"))
        self.reports = build_reports(self.m, self.ctx, rng, [0, 0, 3, 3],
                                     self.BITS)
        self.thresholds = {"default": 2}
        self.cfg = SessionConfig(connect_timeout=30.0,
                                 exchange_timeout=240.0, ack_timeout=60.0,
                                 round_deadline=600.0, shutdown_timeout=5.0,
                                 retries=2, backoff=0.2)
        self.device = device
        self.tmp = tmp
        self.certdir = certs_mod.mint_party_set(os.path.join(tmp, "certs"))
        self.tls = TlsConfig(str(self.certdir / "collector.pem"),
                             str(self.certdir / "collector.key"),
                             str(self.certdir / "ca.pem"))

    def session(self, **kw):
        from mastic_tpu_torch.drivers.parties import AggregationSession

        return AggregationSession(self.m, self.spec, self.ctx, self.vk,
                                  config=self.cfg, device=self.device, **kw)

    def walk(self, sess) -> tuple:
        """Full threshold-pruned heavy-hitters collection; returns
        (hitters, per-round records, metrics records)."""
        from mastic_tpu_torch.drivers.heavy_hitters import get_threshold

        rounds = []
        metrics: list = []
        try:
            sess.upload(self.reports)
            prefixes = [(False,), (True,)]
            for level in range(self.BITS):
                param = (level, tuple(prefixes), level == 0)
                (result, accept, shares) = sess.round(
                    param, metrics_out=metrics)
                rounds.append((list(result),
                               [bool(x) for x in accept], shares))
                survivors = [p for (p, c) in zip(prefixes, result)
                             if c >= get_threshold(self.thresholds, p)]
                prefixes = (survivors if level == self.BITS - 1 else
                            [p + (b,) for p in survivors
                             for b in (False, True)])
        finally:
            sess.close()
        return (sorted(prefixes), rounds, metrics)

    def spawn_pair(self, tag: str) -> tuple:
        """Two standalone mTLS parties (`tools.party serve`) on distinct
        listen addresses; returns (procs, connect map)."""
        import subprocess

        pdir = os.path.join(self.tmp, tag)
        os.makedirs(pdir, exist_ok=True)
        procs = []
        for (name, extra) in (("leader",
                               ["--peer-listen", "127.0.0.1:0"]),
                              ("helper", [])):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mastic_tpu_torch.tools.party",
                 "serve", "--listen", "127.0.0.1:0",
                 "--device", self.device,
                 "--tls-cert", str(self.certdir / f"{name}.pem"),
                 "--tls-key", str(self.certdir / f"{name}.key"),
                 "--tls-ca", str(self.certdir / "ca.pem"),
                 "--port-file", os.path.join(pdir, f"{name}.ports")]
                + extra,
                env=child_env(), cwd=REPO_ROOT, stdout=sys.stderr,
                stderr=sys.stderr))

        def ports(name):
            path = os.path.join(pdir, f"{name}.ports")
            give_up = time.monotonic() + 120.0
            while time.monotonic() < give_up:
                try:
                    with open(path) as f:
                        return json.load(f)
                except (FileNotFoundError, ValueError):
                    time.sleep(0.1)
            self.reap(procs)
            fail(f"party {name} never published its ports ({tag})")

        (lp, hp) = (ports("leader"), ports("helper"))
        connect = {"leader": ("127.0.0.1", lp["listen"]),
                   "helper": ("127.0.0.1", hp["listen"]),
                   "leader_peer": ("127.0.0.1", lp["peer_listen"])}
        return (procs, connect)

    @staticmethod
    def reap(procs) -> None:
        import subprocess

        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def baseline(self) -> tuple:
        """The loopback (spawn path) collection: the bit-identity
        target."""
        return self.walk(self.session())

    def tcp(self, base: tuple) -> None:
        """An undisturbed TCP+mTLS pair must reproduce `base`."""
        (procs, connect) = self.spawn_pair("undisturbed")
        try:
            got = self.walk(self.session(connect=connect, tls=self.tls))
        finally:
            self.reap(procs)
        if got[:2] != base[:2]:
            fail(f"TCP+mTLS pair diverged from loopback: {got[:2]} != "
                 f"{base[:2]}")

    def run_seed(self, seed: int, base: tuple) -> dict:
        """A fresh pair under `chaos_schedule(seed)`, audited: equal to
        `base`, every rule fired, reconnects >= drops, frames replayed,
        nothing quarantined, recovery attributed in the last round's
        RoundMetrics.  Returns the run's record."""
        spec_str = chaos_schedule(seed)
        drops = sum(1 for r in spec_str.split(";")
                    if r.startswith(("conn_drop", "partition")))
        (procs, connect) = self.spawn_pair(f"seed{seed}")
        sess = self.session(faults_spec=spec_str, connect=connect,
                            tls=self.tls)
        try:
            chaos = self.walk(sess)
            rel = sess.coll.reliability_counters()
            unfired = [f"{r.action}:{r.step}:nth={r.nth}"
                       for r in sess.coll.injector.rules
                       if not r.fired]
            quarantined = dict(sess.coll.quarantine)
        finally:
            self.reap(procs)
        if chaos[:2] != base[:2]:
            fail(f"seed {seed}: chaos run diverged: {chaos[:2]} != "
                 f"{base[:2]}")
        if unfired:
            fail(f"seed {seed}: injected rules never fired: "
                 f"{unfired} (schedule {spec_str})")
        if rel["reconnects"] < drops:
            fail(f"seed {seed}: {drops} drops/partitions injected "
                 f"but only {rel['reconnects']} reconnects counted")
        if rel["replayed_frames"] < 1:
            fail(f"seed {seed}: no frames replayed despite "
                 f"{drops} drops — recovery path not exercised")
        if quarantined:
            fail(f"seed {seed}: uploads quarantined under chaos: "
                 f"{quarantined}")
        last = chaos[2][-1]
        if last.reconnects < drops or last.replayed_frames < 1:
            fail(f"seed {seed}: RoundMetrics missing recovery "
                 f"attribution: reconnects={last.reconnects} "
                 f"replayed_frames={last.replayed_frames}")
        print(f"chaos: seed {seed} ok — schedule [{spec_str}] "
              f"reconnects={rel['reconnects']} "
              f"replayed={rel['replayed_frames']}",
              file=sys.stderr, flush=True)
        return {"seed": seed, "schedule": spec_str,
                "reconnects": rel["reconnects"],
                "replayed_frames": rel["replayed_frames"]}


def run_chaos_drill(args, device) -> dict:
    """The seeded network-chaos campaign (`--chaos-drill SEED`), its
    parties on `--device`:

    1. loopback baseline — the spawn-path AggregationSession walks a
       full heavy-hitters collection; its per-round results, accept
       masks and raw share bytes are the bit-identity target;
    2. TCP+mTLS pair — two standalone `tools.party serve`
       processes on distinct listen addresses (certs minted by
       tools/certs.py), collector in connect mode; must reproduce
       the loopback collection byte for byte;
    3. chaos runs — for each of `--chaos-seeds` seeds, a fresh party
       pair runs the same collection under a seeded random schedule
       of conn_drop / partition / slow_loris / tls_handshake-delay
       faults.  Every run must be bit-identical, every injected rule
       must have fired, every recovery must be attributed
       (RoundMetrics.reconnects / replayed_frames and the
       mastic_session_reconnects_total / mastic_frames_replayed_total
       series nonzero), and zero uploads lost or duplicated
       (quarantine empty, accept masks identical).
    """
    import shutil
    import tempfile

    from mastic_tpu_torch.obs.registry import get_registry

    t_start = time.time()
    load_kernels(device)
    tmp = tempfile.mkdtemp(prefix="mastic_chaos_")
    try:
        drill = ChaosDrill(args.seed, args.device, tmp)
        # 1. loopback baseline (the spawn path).
        base = drill.baseline()
        print(f"chaos: loopback baseline hitters={base[0]}",
              file=sys.stderr, flush=True)
        # 2. undisturbed TCP+mTLS pair on distinct listen addresses.
        drill.tcp(base)
        print("chaos: TCP+mTLS pair bit-identical to loopback",
              file=sys.stderr, flush=True)
        # 3. the seeded chaos campaign.
        seeds = list(range(args.chaos_drill,
                           args.chaos_drill + args.chaos_seeds))
        runs = [drill.run_seed(seed, base) for seed in seeds]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    reg = get_registry()
    if not reg.counter("mastic_session_reconnects_total",
                       tenant="").value():
        fail("mastic_session_reconnects_total never incremented")
    if not reg.counter("mastic_frames_replayed_total",
                       tenant="").value():
        fail("mastic_frames_replayed_total never incremented")
    return {
        "mode": "chaos-drill",
        "platform": device.type,
        "seeds": seeds,
        "tcp_mtls_bit_identical": True,
        "runs": runs,
        "hitters": [[bool(b) for b in p] for p in base[0]],
        "wall_seconds": round(time.time() - t_start, 1),
        "ok": True,
    }


# The WAL's kill checkpoints, in the order a record passes them.
WAL_CHECKPOINTS = ("wal_append", "wal_fsync", "wal_ack")


def wal_schedule(seed: int) -> tuple:
    """The WAL drill's seeded disk-fault schedule (the JAX drill's, draw
    for draw): (kind, MASTIC_FAULTS rule, lethal) with kind "kill",
    "short_write" (a torn tail, then a kill) or "enospc" (a brownout the
    collector survives)."""
    r = random.Random(seed)
    kind = r.choice(["kill", "kill", "short_write", "enospc"])
    nth = r.randint(2, 5)
    if kind == "kill":
        step = r.choice(list(WAL_CHECKPOINTS))
        return (kind, f"kill:party=collector:step={step}:nth={nth}", True)
    if kind == "short_write":
        cut = r.randint(1, 24)
        return (kind, f"short_write:party=collector:step=wal_append"
                      f":nth={nth}:cut={cut}", True)
    return (kind, f"enospc:party=collector:step=wal_append:nth={nth}",
            False)


class WalDrill:
    """The WAL drill's six uploads (MasticCount(2) values 0, 0, 0, 3, 3,
    3 sharded from `seed`), its collector children (`tools.serve
    --upload-port 0 --snapshot`, pages of 2, on `device`) with their
    files under `tmp`, and one schedule's run (`run_schedule`)."""

    UPLOADS = 6

    def __init__(self, seed: int, device: str, tmp: str):
        import numpy as np

        from mastic_tpu_torch.backend.mastic import MasticCount
        from mastic_tpu_torch.drivers.service import encode_upload

        self.bits = 2
        m = MasticCount(self.bits)
        scalar = m.scalar()
        rng = np.random.default_rng(seed)
        self.blobs = []
        for value in [0, 0, 0, 3, 3, 3]:
            alpha = scalar.vidpf.test_index_from_int(value, self.bits)
            nonce = bytes(rng.integers(0, 256, m.NONCE_SIZE,
                                       dtype="uint8"))
            rand = bytes(rng.integers(0, 256, m.RAND_SIZE,
                                      dtype="uint8"))
            (ps, shares) = scalar.shard(b"serve count", (alpha, True),
                                        nonce, rand)
            self.blobs.append(encode_upload(m, (nonce, ps, shares)))
        self.device = device
        self.tmp = tmp

    def spawn(self, tag, fault=None, resume=False, snap_tag=None):
        import subprocess

        pf = os.path.join(self.tmp, f"{tag}.port")
        snap = os.path.join(self.tmp, f"{snap_tag or tag}.snap")
        env = child_env(fault)
        env["PYTHONFAULTHANDLER"] = "1"
        cmd = [sys.executable, "-m", "mastic_tpu_torch.tools.serve",
               "--reports", str(self.UPLOADS), "--bits", str(self.bits),
               "--page-size", "2", "--upload-port", "0",
               "--upload-window", "120", "--port-file", pf,
               "--snapshot", snap, "--device", self.device]
        if resume:
            cmd.append("--resume")
        proc = subprocess.Popen(cmd, env=env, text=True, cwd=REPO_ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        return (proc, pf, snap)

    @staticmethod
    def wait_port(proc, path, deadline_s=120.0):
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:
                with open(path) as f:
                    return json.load(f)["upload_port"]
            except (OSError, ValueError, KeyError):
                if proc.poll() is not None:
                    fail(f"wal drill: the child exited with "
                         f"{proc.returncode} before its port file: "
                         f"{proc.stderr.read()[-1500:]}")
                time.sleep(0.05)
        proc.kill()
        fail(f"wal drill: no port file at {path}")

    @staticmethod
    def put_one(port, blob):
        """One PUT; returns (status_code, retry_after) — status None
        when the collector died mid-request."""
        from http.client import HTTPConnection

        from mastic_tpu_torch.net.ingest import MEDIA_TYPE

        try:
            conn = HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("PUT", "/v1/tenants/count/reports",
                         body=blob,
                         headers={"Content-Type": MEDIA_TYPE})
            resp = conn.getresponse()
            resp.read()
            retry_after = resp.getheader("Retry-After")
            conn.close()
            return (resp.status, retry_after)
        except OSError:
            return (None, None)

    def put_all(self, port, send, brownouts=None):
        """PUT each (index, blob); 503s honor Retry-After and retry
        in place (the brownout contract); a dead socket stops the
        loop — the tail is the client's to retry after resume."""
        acked = []
        for (i, blob) in send:
            while True:
                (code, retry_after) = self.put_one(port, blob)
                if code == 503:
                    if brownouts is not None:
                        brownouts.append(i)
                        if retry_after is None:
                            fail(f"wal drill: 503 without "
                                 f"Retry-After on upload {i}")
                    time.sleep(min(float(retry_after or 1), 2.0))
                    continue
                break
            if code in (201, 202):
                acked.append(i)
            elif code is None:
                break
            else:
                fail(f"wal drill: upload {i} got {code}")
        return acked

    @staticmethod
    def cut_and_drain(port):
        from http.client import HTTPConnection

        conn = HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/v1/tenants/count/epoch",
                     headers={"Content-Length": "0"})
        conn.getresponse().read()
        conn.request("POST", "/v1/admin/drain",
                     headers={"Content-Length": "0"})
        conn.getresponse().read()
        conn.close()

    @staticmethod
    def finish(proc, tag, expect_rc=0):
        (out, err) = proc.communicate(timeout=1500)
        if proc.returncode != expect_rc:
            fail(f"wal drill {tag}: rc={proc.returncode} (wanted "
                 f"{expect_rc}): {err[-1500:]}")
        if expect_rc != 0:
            return {}
        return json.loads(out.strip().splitlines()[-1])

    def run_schedule(self, tag, fault, lethal):
        """One campaign entry: run under `fault`; if `lethal`, the
        child must die with the kill exit code and a resumed child
        finishes the collection (the client retrying every upload it
        holds no ack for).  Returns (the final run's JSON line, the
        acked upload indices, the uploads answered 503)."""
        from mastic_tpu_torch.drivers import faults

        (proc, pf, _snap) = self.spawn(tag, fault=fault)
        port = self.wait_port(proc, pf)
        brownouts = []
        acked = self.put_all(port, list(enumerate(self.blobs)),
                             brownouts=brownouts)
        if not lethal:
            if len(acked) != self.UPLOADS:
                proc.kill()
                fail(f"wal drill {tag}: acked {acked}, wanted all "
                     f"{self.UPLOADS}")
            self.cut_and_drain(port)
            return (self.finish(proc, tag), acked, brownouts)
        self.finish(proc, tag, expect_rc=faults.KILL_EXIT_CODE)
        (proc, pf2, _s) = self.spawn(f"{tag}-resumed", resume=True,
                                     snap_tag=tag)
        port = self.wait_port(proc, pf2)
        retries = [(i, self.blobs[i]) for i in range(self.UPLOADS)
                   if i not in acked]
        re_acked = self.put_all(port, retries)
        if len(re_acked) != len(retries):
            proc.kill()
            fail(f"wal drill {tag}: retries {re_acked} of "
                 f"{[i for (i, _b) in retries]}")
        self.cut_and_drain(port)
        return (self.finish(proc, f"{tag}-resumed"), acked + re_acked,
                brownouts)


def admitted_total(result: dict) -> int:
    return result["metrics"]["tenants"]["count"]["counters"]["admitted"]


def run_wal_drill(args, device) -> dict:
    """The disk-fault leg of the seeded chaos campaign: drive the HTTP
    ingest path with the WAL armed
    and (a) kill -9 at EVERY WAL checkpoint — `wal_append` (before
    the record's write), `wal_fsync` (written, not yet durable),
    `wal_ack` (durable, not yet acked) — then (b) `--wal-seeds`
    randomized schedules drawn from the disk-fault vocabulary
    (kill-at-checkpoint, short_write torn tail, ENOSPC brownout).
    Every schedule must end bit-identical to the undisturbed run
    with EXACTLY the clean run's reports admitted: zero acked-but-
    lost, zero duplicates.  Recovery must attribute itself (replayed
    / torn_tail counts and wall time in the resumed child's JSON)."""
    import shutil
    import tempfile

    t_start = time.time()
    load_kernels(device)
    tmp = tempfile.mkdtemp(prefix="mastic-wal-drill-")
    drill = WalDrill(args.wal_drill, args.device, tmp)

    # Undisturbed baseline.
    (clean, _acked, _b) = drill.run_schedule("clean", None, False)
    clean_admitted = admitted_total(clean)

    runs = []
    # (a) kill -9 at every WAL checkpoint, deterministically.
    for step in WAL_CHECKPOINTS:
        tag = f"kill-{step}"
        fault = f"kill:party=collector:step={step}:nth=4"
        (result, _acked, _b) = drill.run_schedule(tag, fault, True)
        if result["results"]["count"] != clean["results"]["count"]:
            print(json.dumps(result), file=sys.stderr, flush=True)
            fail(f"wal drill {tag}: results diverge\n"
                 f"  clean: {clean['results']['count']}\n"
                 f"  {tag}: {result['results']['count']}")
        if admitted_total(result) != clean_admitted:
            fail(f"wal drill {tag}: {admitted_total(result)} "
                 f"admitted, wanted {clean_admitted} (lost or "
                 f"duplicated)")
        wal_info = result.get("wal") or {}
        if "recovery_wall_ms" not in wal_info:
            fail(f"wal drill {tag}: resumed child did not stamp "
                 f"recovery attribution: {wal_info}")
        runs.append({"schedule": fault,
                     "replayed": wal_info.get("replayed_records"),
                     "recovery_wall_ms":
                         wal_info.get("recovery_wall_ms")})

    # (b) seeded randomized disk-fault schedules.
    seeds = list(range(args.wal_drill,
                       args.wal_drill + args.wal_seeds))
    for seed in seeds:
        (kind, fault, lethal) = wal_schedule(seed)
        (result, _acked, brownouts) = drill.run_schedule(
            f"seed-{seed}", fault, lethal)
        if result["results"]["count"] != clean["results"]["count"]:
            fail(f"wal drill seed {seed}: results diverge under "
                 f"[{fault}]\n"
                 f"  clean: {clean['results']['count']}\n"
                 f"  seed-{seed}: {result['results']['count']}")
        if admitted_total(result) != clean_admitted:
            fail(f"wal drill seed {seed}: "
                 f"{admitted_total(result)} admitted, wanted "
                 f"{clean_admitted} under [{fault}] (lost or "
                 f"duplicated)")
        rec = {"seed": seed, "schedule": fault}
        if kind == "enospc":
            if not brownouts:
                fail(f"wal drill seed {seed}: injected ENOSPC but "
                     f"no 503 brownout was observed")
            shed = result["metrics"]["tenants"]["count"][
                "counters"]["shed_reasons"]
            if not shed.get("wal-full"):
                fail(f"wal drill seed {seed}: brownout not "
                     f"attributed as wal-full: {shed}")
            rec["brownouts"] = len(brownouts)
        if kind == "short_write":
            torn = (result.get("wal") or {}).get(
                "recovery", {}).get("torn_tail", 0)
            if not torn:
                fail(f"wal drill seed {seed}: injected torn tail "
                     f"was not counted at recovery: "
                     f"{result.get('wal')}")
            rec["torn_tail"] = torn
        if lethal:
            rec["recovery_wall_ms"] = (result.get("wal") or {}).get(
                "recovery_wall_ms")
        runs.append(rec)
        print(f"wal drill: seed {seed} ok — [{fault}]",
              file=sys.stderr, flush=True)

    shutil.rmtree(tmp, ignore_errors=True)
    return {
        "mode": "wal-drill",
        "platform": device.type,
        "seeds": seeds,
        "checkpoints": list(WAL_CHECKPOINTS),
        "admitted": clean_admitted,
        "bit_identical": True,
        "runs": runs,
        "wall_seconds": round(time.time() - t_start, 1),
        "ok": True,
    }


if __name__ == "__main__":
    main()
