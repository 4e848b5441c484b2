"""The collector service (port of `mastic_tpu/drivers/service.py`): a
long-lived, supervised, multi-tenant collector in front of the runs.

Every other driver runs one offline batch; this one takes a stream of
uploads for several tenants and runs their epochs on the card:

* **paged report buffers**: admitted uploads append to fixed-size
  pages (`ReportPage`; the ragged tail page seals at the epoch cut),
  each sealed behind a SHA-256 digest of its framed payload that is
  checked before the page feeds a round or after it crosses a
  snapshot;

* **admission control**: every upload blob is decoded at the door
  against both parties' views (`decode_upload`, one blob at a time on
  the host); a malformed blob quarantines with the party layer's
  reason codes (`drivers/parties.REASON_*`), and a tenant whose
  quarantine count passes its limit is suspended (its later uploads
  shed with reason ``tenant-quarantined``);

* **backpressure, never silent**: per-tenant buffered reports are
  bounded (`MASTIC_SERVICE_MAX_BUFFERED`), and an over-quota upload
  sheds under `MASTIC_SERVICE_SHED_POLICY` (``reject-newest`` refuses
  it, ``oldest-epoch-first`` drops the oldest pending epoch); every
  shed lands in `ServiceCounters.shed_reasons`;

* **the epoch scheduler**: `begin_epoch` seals the tenant's pages into
  an epoch; `step()` runs one round of one tenant's active epoch,
  round-robin over the tenants, through the runs' `step_begin` /
  `step_finish` interface (`HeavyHittersRun`, `AttributeMetricsRun`);
  with `MASTIC_SERVICE_OVERLAP` = K >= 2 up to K tenants' rounds are
  in flight: tenant B's round is staged while tenant A's computes on
  the card, and a tenant's own rounds never overlap, so its results
  equal the serial schedule's.  A round whose handle is ``atomic``
  (the chunked runners) ran whole in its stage slot;

* **deadlines and supervision**: an epoch past its `Deadline` finishes
  at its last completed round with the run's `frontier()`, marked
  ``truncated``; a round that raises is retried on a rebuilt run a
  bounded number of times before the epoch fails, and the other
  tenants keep their schedule;

* **the concurrent ingest front** (`MASTIC_SERVICE_INGEST_THREADS`):
  `submit()` enqueues into a bounded queue (a full queue sheds with
  ``ingest-queue-full``) and worker threads decode on the host and
  land verdicts under the tenant's admission lock.  No worker touches
  a CUDA tensor: rounds run on the scheduler's thread only;

* **crash-resume**: `to_bytes()` writes the JAX package's snapshot
  layout (length-prefixed JSON header + npz: pages, queued and active
  epochs with the active run's own checkpoint, counters), and
  `from_bytes()` restores a service that continues bit-identically.
  The write-ahead log (`drivers/wal.py`) covers what arrived after the
  last snapshot.

Where the port differs from the JAX package: an epoch's report batch
is parsed on the device from the surviving pages' bytes (both views
through `BatchedMastic.marshal_party_blobs`) instead of decoding every
blob a second time in Python, and the run gets a lazy `reports`
sequence (`_EpochReports`) that decodes a lane's blob only when the
XOF-rejection splice reads it.  `_preload_artifacts` loads and probes
the kernel libraries from the kernel store (`drivers/artifacts.py`,
armed by `MASTIC_ARTIFACT_DIR`) at boot and at tenant admission, on a
CUDA device only: the libraries belong to the process, so every tenant
after the first finds them loaded.

Fault injection (`MASTIC_FAULTS`, party ``collector``) plugs in at the
ingest seams as in the JAX package: checkpoint ``admit`` per admission
attempt, ``page_flush`` per page seal (``corrupt`` / ``truncate``
mutate the stored bytes after the digest is taken), and
``epoch_start`` / ``epoch_round`` / ``snapshot`` in the scheduler.
"""

import abc
import hashlib
import json
import queue as queue_mod
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import resolve_device, wire
from ..metrics import ServiceCounters
from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from . import faults as faults_mod
from .pipeline import overlap_efficiency
from .session import Deadline, _env_float, _env_int
from .parties import (REASON_MALFORMED, REASON_NAMES, REASON_RANGE,
                      instantiate)
from .attribute_metrics import AttributeMetricsRun
from .heavy_hitters import HeavyHittersRun

# Page-integrity failure: the page's stored bytes no longer match the
# digest taken at seal time (storage corruption; the `page_flush`
# fault models it).  Extends the party layer's per-report reason codes.
REASON_PAGE_CORRUPT = 3
SERVICE_REASON_NAMES = dict(REASON_NAMES)
SERVICE_REASON_NAMES[REASON_PAGE_CORRUPT] = "page-corrupt"

SHED_POLICIES = ("reject-newest", "oldest-epoch-first")

# submit() outcomes.
ADMITTED = "admitted"
QUARANTINED = "quarantined"
SHED = "shed"
# With the concurrent ingest front armed, submit() enqueues and the
# admission verdict lands asynchronously (in the counters / events);
# a caller that needs the verdict synchronously runs with the front
# off, exactly as before.
QUEUED = "queued"

_SNAPSHOT_VERSION = 1


# -- the scheduler-facing run interface -------------------------------

class CollectionRun(abc.ABC):
    """What the epoch scheduler needs from a collection run — the one
    interface the heavy-hitters multi-round loop, the chunked
    streaming loop (both via `HeavyHittersRun`), and the
    attribute-metrics single round (`AttributeMetricsRun`) all stand
    behind.  `HeavyHittersRun` predates this ABC and is registered as
    a virtual subclass; its checkpoint machinery is the bit-identity
    contract the service snapshot rides on.
    """

    done: bool
    metrics: list

    @abc.abstractmethod
    def step(self) -> bool:
        """Run one round; True while more rounds remain."""

    @abc.abstractmethod
    def result(self):
        """The collection's final output (valid once `done`)."""

    @abc.abstractmethod
    def frontier(self) -> list:
        """The truncated-but-correct output after the last COMPLETED
        round — what a deadline-missed epoch reports.  Every entry
        passed all checks of every completed round; nothing about
        rounds that never ran is claimed."""

    @abc.abstractmethod
    def rounds_completed(self) -> int:
        """Rounds completed over the run's LIFETIME — unlike
        `len(metrics)`, this survives checkpoint-resume (the metrics
        list only covers rounds run in this process)."""

    @abc.abstractmethod
    def to_bytes(self) -> bytes:
        """Checkpoint between rounds (resume must be bit-identical)."""

    # Optional split-phase protocol: runs that can split a
    # round at the stage/collect seam additionally provide
    #   step_begin() -> handle | None   (dispatch, non-blocking; the
    #                                    handle's "atomic" flag is
    #                                    True when the round ran
    #                                    outright instead)
    #   step_finish(handle) -> bool     (blocking sync + advance)
    # with step() == step_begin()+step_finish().  The overlapped
    # epoch executor feature-detects them (getattr) so legacy run
    # kinds — and test stubs — keep working atomically.


CollectionRun.register(HeavyHittersRun)
CollectionRun.register(AttributeMetricsRun)

MODES = ("heavy_hitters", "attribute_metrics")


# -- configuration ----------------------------------------------------

def _env_str(name: str, default: str) -> str:
    import os

    raw = os.environ.get(name)
    return default if raw is None or not raw.strip() else raw.strip()


@dataclass
class ServiceConfig:
    """Service-wide levers (env forms in USAGE.md "Collector
    service").  Per-tenant overrides live on `TenantSpec`."""

    page_size: int = 64           # reports per buffer page
    max_buffered: int = 4096      # per-tenant admitted-but-unfinished
    max_pending_epochs: int = 4   # per-tenant queued (not running)
    shed_policy: str = "reject-newest"
    quarantine_limit: int = 64    # per-tenant; past it, suspend
    epoch_deadline: float = 1800.0
    epoch_retries: int = 1        # extra attempts for a failing round
    overlap: int = 0              # tenants' rounds in flight (<2 =
    #                               serial round-robin)
    ingest_threads: int = 0       # concurrent ingest front (0 = off:
    #                               submit() admits in-process)
    ingest_queue: int = 256       # bounded ingest queue (uploads)

    def __post_init__(self):
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"unknown shed policy {self.shed_policy!r} (must be "
                f"one of {', '.join(SHED_POLICIES)})")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.ingest_queue < 1:
            raise ValueError("ingest_queue must be >= 1")
        if self.overlap < 0 or self.ingest_threads < 0:
            raise ValueError("overlap / ingest_threads must be >= 0")

    @classmethod
    def from_env(cls) -> "ServiceConfig":
        return cls(
            page_size=_env_int("MASTIC_SERVICE_PAGE_SIZE", 64),
            max_buffered=_env_int("MASTIC_SERVICE_MAX_BUFFERED", 4096),
            max_pending_epochs=_env_int("MASTIC_SERVICE_MAX_EPOCHS", 4),
            shed_policy=_env_str("MASTIC_SERVICE_SHED_POLICY",
                                 "reject-newest"),
            quarantine_limit=_env_int("MASTIC_SERVICE_QUARANTINE_LIMIT",
                                      64),
            epoch_deadline=_env_float(
                "MASTIC_SERVICE_EPOCH_DEADLINE",
                _env_float("MASTIC_ROUND_DEADLINE", 1800.0)),
            epoch_retries=_env_int("MASTIC_SERVICE_EPOCH_RETRIES", 1),
            overlap=_env_int("MASTIC_SERVICE_OVERLAP", 0),
            ingest_threads=_env_int("MASTIC_SERVICE_INGEST_THREADS",
                                    0),
            ingest_queue=_env_int("MASTIC_SERVICE_INGEST_QUEUE", 256),
        )


@dataclass
class TenantSpec:
    """One collection instance (tenant) the service multiplexes.

    `spec` is the party layer's instantiation record
    ({"class": "MasticCount", "args": [8]}); `mode` picks the run
    kind; `thresholds` (heavy hitters) / `attributes` (attribute
    metrics) parameterize it.  Optional overrides fall back to the
    service config."""

    name: str
    spec: dict
    ctx: bytes
    verify_key: bytes
    mode: str = "heavy_hitters"
    thresholds: Optional[dict] = None
    attributes: Optional[list] = None
    chunk_size: Optional[int] = None
    page_size: Optional[int] = None
    max_buffered: Optional[int] = None
    epoch_deadline: Optional[float] = None
    quarantine_limit: Optional[int] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown tenant mode {self.mode!r} "
                             f"(must be one of {', '.join(MODES)})")
        if self.mode == "heavy_hitters" and not self.thresholds:
            raise ValueError(f"tenant {self.name}: heavy_hitters mode "
                             f"needs thresholds")
        if self.mode == "attribute_metrics" and not self.attributes:
            raise ValueError(f"tenant {self.name}: attribute_metrics "
                             f"mode needs attributes")

    def to_json(self) -> dict:
        return {
            "name": self.name, "spec": self.spec,
            "ctx": self.ctx.hex(), "verify_key": self.verify_key.hex(),
            "mode": self.mode,
            "thresholds": (None if self.thresholds is None
                           else thresholds_to_json(self.thresholds)),
            "attributes": self.attributes,
            "chunk_size": self.chunk_size,
            "page_size": self.page_size,
            "max_buffered": self.max_buffered,
            "epoch_deadline": self.epoch_deadline,
            "quarantine_limit": self.quarantine_limit,
        }

    @classmethod
    def from_json(cls, data: dict) -> "TenantSpec":
        return cls(
            name=data["name"], spec=data["spec"],
            ctx=bytes.fromhex(data["ctx"]),
            verify_key=bytes.fromhex(data["verify_key"]),
            mode=data["mode"],
            thresholds=(None if data["thresholds"] is None
                        else thresholds_from_json(data["thresholds"])),
            attributes=data["attributes"],
            chunk_size=data["chunk_size"],
            page_size=data["page_size"],
            max_buffered=data["max_buffered"],
            epoch_deadline=data["epoch_deadline"],
            quarantine_limit=data["quarantine_limit"],
        )


def thresholds_to_json(thresholds: dict) -> dict:
    """Prefix-tuple keys -> bit strings ("default" passes through)."""
    out = {}
    for (k, v) in thresholds.items():
        if k == "default":
            out[k] = v
        else:
            out["".join("1" if b else "0" for b in k)] = v
    return out


def thresholds_from_json(data: dict) -> dict:
    out = {}
    for (k, v) in data.items():
        if k == "default":
            out[k] = v
        else:
            out[tuple(c == "1" for c in k)] = v
    return out


# -- upload codec (both parties' views in one blob) -------------------

def encode_upload(mastic, report) -> bytes:
    """One client upload as the service ingests it: both aggregators'
    wire-encoded views, framed back to back (clients talk to the
    aggregators directly in a full deployment; the service here is
    the ingest door of the co-located pair)."""
    (nonce, public_share, input_shares) = report
    return (wire.frame(wire.encode_report(mastic, 0, nonce,
                                          public_share,
                                          input_shares[0]))
            + wire.frame(wire.encode_report(mastic, 1, nonce,
                                            public_share,
                                            input_shares[1])))


def decode_upload(mastic, blob: bytes) -> tuple:
    """Validate + decode one upload blob into the drivers' report
    tuple.  Raises ValueError on any malformation — the admission
    path turns that into a reason-coded quarantine."""
    (b0, rest) = wire.unframe(blob)
    (b1, rest) = wire.unframe(rest)
    if rest:
        raise ValueError(f"{len(rest)} trailing bytes after the "
                         f"helper view")
    (nonce0, ps0, share0) = wire.decode_report(mastic, 0, b0)
    (nonce1, _ps1, share1) = wire.decode_report(mastic, 1, b1)
    if nonce0 != nonce1:
        raise ValueError("nonce mismatch between the party views")
    head = mastic.NONCE_SIZE + wire.public_share_size(mastic)
    if b0[:head] != b1[:head]:
        raise ValueError("public share mismatch between the party "
                         "views")
    return (nonce0, ps0, [share0, share1])


def _decode_reason(exc: Exception) -> int:
    """The party layer's reason taxonomy (drivers/parties.load_reports)."""
    return (REASON_RANGE if "out of range" in str(exc)
            else REASON_MALFORMED)


# -- paged report buffers ---------------------------------------------

class ReportPage:
    """A fixed-size page of admitted upload blobs.  Open pages accept
    appends; `seal()` freezes the page behind a SHA-256 digest of its
    framed payload, verified every time the page's bytes feed a round
    or cross a snapshot — a corrupted page is detected and dropped,
    never silently aggregated."""

    __slots__ = ("blobs", "count", "payload", "digest")

    def __init__(self):
        self.blobs: list = []
        self.count = 0
        self.payload: Optional[bytes] = None
        self.digest: Optional[bytes] = None

    def append(self, blob: bytes) -> None:
        if self.payload is not None:
            raise ValueError("page is sealed")
        self.blobs.append(blob)
        self.count += 1

    def seal(self) -> None:
        if self.payload is not None:
            return
        self.payload = b"".join(wire.frame(b) for b in self.blobs)
        self.digest = hashlib.sha256(self.payload).digest()
        self.blobs = []

    def verify(self) -> bool:
        if self.payload is None:
            return True   # open page: bytes never left this process
        return hashlib.sha256(self.payload).digest() == self.digest

    def decode_blobs(self) -> list:
        """The page's upload blobs (sealed pages unframe their stored
        payload; digest must be verified by the caller first)."""
        if self.payload is None:
            return list(self.blobs)
        (out, rest) = ([], self.payload)
        while rest:
            (blob, rest) = wire.unframe(rest)
            out.append(blob)
        return out

    @classmethod
    def from_payload(cls, payload: bytes, digest: bytes,
                     count: int) -> "ReportPage":
        page = cls()
        page.payload = payload
        page.digest = digest
        page.count = count
        return page


def page_views(mastic, pages: list) -> tuple:
    """Both aggregators' views of every upload in `pages` (sealed pages
    whose digests were checked, or open ones), as two uint8 arrays
    (R, report size of that view).  An admitted upload is
    frame(leader view) || frame(helper view) of fixed sizes, so a page
    of them is a fixed-stride record array; the frame headers are
    checked, and a page that does not parse raises (admission let
    through nothing else)."""
    sizes = [wire.report_size(mastic, a) for a in range(2)]
    rec = 4 + (4 + sizes[0]) + (4 + sizes[1])
    parts = []
    for page in pages:
        payload = (page.payload if page.payload is not None
                   else b"".join(wire.frame(b) for b in page.blobs))
        if len(payload) != page.count * rec:
            raise ValueError(f"page of {page.count} uploads holds "
                             f"{len(payload)} bytes, not "
                             f"{page.count * rec}")
        parts.append(np.frombuffer(payload, np.uint8).reshape(-1, rec))
    rows = np.concatenate(parts) if parts else np.zeros((0, rec), np.uint8)
    heads = np.ascontiguousarray(
        rows[:, [0, 1, 2, 3, 4, 5, 6, 7, 8 + sizes[0], 9 + sizes[0],
                 10 + sizes[0], 11 + sizes[0]]]).view("<u4")
    want = np.array([8 + sizes[0] + sizes[1], sizes[0], sizes[1]], "<u4")
    if not (heads == want).all():
        raise ValueError("an upload in the epoch's pages is not two "
                         "framed views of the report sizes")
    return (rows[:, 8:8 + sizes[0]],
            rows[:, 12 + sizes[0]:12 + sizes[0] + sizes[1]])


def batch_from_views(mastic, views: tuple, device):
    """The ReportBatch of both views, parsed on `device` with no report
    decoded in Python (`BatchedMastic.marshal_party_blobs` per view).
    Raises when a view refuses, or the views disagree on the nonce or
    the public share (`decode_upload` would have refused the blob)."""
    from ..backend.mastic import BatchedMastic, ReportBatch

    bm = BatchedMastic(mastic)
    head = mastic.NONCE_SIZE + wire.public_share_size(mastic)
    if not np.array_equal(views[0][:, :head], views[1][:, :head]):
        raise ValueError("nonce or public share mismatch between the "
                         "party views")
    parsed = []
    for a in range(2):
        (arrays, well_formed) = bm.marshal_party_blobs(
            a, np.ascontiguousarray(views[a]), device)
        if not bool(well_formed.all()):
            raise ValueError(f"aggregator {a}'s view of an admitted "
                             f"upload does not parse")
        parsed.append(arrays)
    (lead, help_) = parsed
    jr = mastic.valid.JOINT_RAND_LEN > 0
    return ReportBatch(
        nonces=lead["nonces"], cws=lead["cws"],
        keys=torch.stack([lead["keys"], help_["keys"]], dim=1),
        leader_proofs=lead["proof_shares"], helper_seeds=help_["seeds"],
        leader_seeds=lead["seeds"] if jr else None,
        peer_parts=((lead["peer_jr_parts"], help_["peer_jr_parts"]) if jr
                    else (None, None)))


class _EpochReports:
    """The scalar reports behind an epoch's batch, each decoded from its
    upload bytes (`decode_upload`) on first access: the XOF-rejection
    splice reads only the lanes whose sampling fired."""

    def __init__(self, mastic, views: tuple):
        self.m = mastic
        self.views = views
        self.decoded: dict = {}

    def __len__(self) -> int:
        return len(self.views[0])

    def blob(self, r: int) -> bytes:
        return (wire.frame(self.views[0][r].tobytes())
                + wire.frame(self.views[1][r].tobytes()))

    def __getitem__(self, r: int) -> tuple:
        if r not in self.decoded:
            self.decoded[r] = decode_upload(self.m, self.blob(r))
        return self.decoded[r]


class _Epoch:
    """One sealed collection epoch: the pages cut from the tenant's
    buffer at begin_epoch, plus (once scheduled) the live run."""

    __slots__ = ("epoch_id", "pages", "run", "batch", "reports",
                 "parse_ms", "deadline", "failures", "started_at",
                 "reports_lost", "span")

    def __init__(self, epoch_id: int, pages: list):
        self.epoch_id = epoch_id
        self.pages = pages
        self.run = None
        self.batch = None       # the ReportBatch, parsed at start
        self.reports = None     # its lazy scalar view (_EpochReports)
        self.parse_ms: Optional[float] = None
        self.deadline: Optional[Deadline] = None
        self.failures = 0
        self.started_at: Optional[float] = None
        self.reports_lost = 0   # dropped by page-corruption detection
        self.span = None        # open "epoch" trace span while active

    def report_count(self) -> int:
        return sum(p.count for p in self.pages)


class _Tenant:
    """One tenant's state AND its admission path: the
    quota / quarantine / page machinery lives here, on the tenant,
    because ingest workers and the scheduler thread both walk it —
    every buffer mutation happens under `self.lock`, the effective
    limits are resolved once at construction (spec override falling
    back to the service config), and the ServiceCounters ledger locks
    itself."""

    __slots__ = ("spec", "mastic", "open_page", "sealed", "pending",
                 "active", "completed", "counters", "epoch_seq",
                 "suspended", "last_timeline", "lock",
                 "eff_page_size", "eff_max_buffered",
                 "eff_quarantine_limit", "eff_epoch_deadline",
                 "eff_shed_policy", "replay_digests")

    def __init__(self, spec: TenantSpec, config: ServiceConfig):
        self.spec = spec
        self.mastic = instantiate(spec.spec)
        self.open_page = ReportPage()
        self.sealed: list = []      # sealed pages awaiting an epoch
        self.pending: list = []     # [_Epoch] queued, oldest first
        self.active: Optional[_Epoch] = None
        self.completed: list = []   # epoch result records (dicts)
        self.counters = ServiceCounters(tenant=spec.name)
        # Every tenant's Prometheus series exist from boot (at zero)
        # so a scrape before the first event still sees the family.
        self.counters.export_registry()
        self.epoch_seq = 0
        self.suspended = False
        self.last_timeline: Optional[list] = None  # statusz surface
        # The admission lock: every mutation of the
        # tenant's buffer state (open_page, sealed, pending,
        # suspended, active) happens under it — ingest workers land
        # pages while the scheduler thread cuts epochs and retires
        # them.  Pure reads (occupancy gauges) stay lock-free.
        self.lock = threading.Lock()
        # Effective limits, resolved once: admission never has to
        # reach back into the (main-thread-owned) service config.
        self.eff_page_size = spec.page_size or config.page_size
        self.eff_max_buffered = (spec.max_buffered
                                 or config.max_buffered)
        self.eff_quarantine_limit = (
            spec.quarantine_limit
            if spec.quarantine_limit is not None
            else config.quarantine_limit)
        self.eff_epoch_deadline = (
            spec.epoch_deadline if spec.epoch_deadline is not None
            else config.epoch_deadline)
        self.eff_shed_policy = config.shed_policy
        # SHA-256 digests of reports the WAL replayed at recovery:
        # a client retrying an upload that was durable
        # but never acked lands here and gets an idempotent ADMITTED
        # ack instead of a duplicate buffer entry.  Empty except in
        # a freshly recovered process, so the hot path costs one
        # truthiness check.
        self.replay_digests: set = set()

    def buffered_reports(self) -> int:
        """Reports the tenant holds admitted-but-unfinished — the
        number the admission quota bounds (open + sealed pages,
        queued epochs, and the running epoch)."""
        total = self.open_page.count \
            + sum(p.count for p in self.sealed) \
            + sum(ep.report_count() for ep in self.pending)
        if self.active is not None:
            total += self.active.report_count()
        return total

    # -- admission (any thread) --------------------------

    def admit_decoded(self, blob: bytes,
                      decode_exc: Optional[Exception],
                      injector=None) -> tuple:
        """The admission verdict, under the tenant's lock: suspended
        -> shed; malformed -> reason-coded quarantine (suspension
        past the limit); over-quota -> shed policy; else land in the
        open page.  Trace events emit after the lock releases, and a
        full page seals outside it (the digest hash and the
        page_flush fault — which may legitimately stall — must not
        hold up concurrent admission)."""
        name = self.spec.name
        events: list = []
        to_seal: Optional[ReportPage] = None
        with self.lock:
            if self.suspended:
                self.counters.inc("shed")
                self.counters.bump_shed("tenant-quarantined")
                verdict = (SHED, "tenant-quarantined")
                events.append(
                    ("shed", {"tenant": name,
                              "reason": "tenant-quarantined"}))
            elif decode_exc is not None:
                reason = SERVICE_REASON_NAMES[
                    _decode_reason(decode_exc)]
                self.counters.inc("quarantined")
                self.counters.bump_quarantine(reason)
                events.append(("quarantine", {"tenant": name,
                                              "reason": reason}))
                if self.counters.quarantined \
                        >= self.eff_quarantine_limit:
                    self.suspended = True
                    events.append((
                        "tenant_suspended",
                        {"tenant": name,
                         "quarantined": self.counters.quarantined}))
                verdict = (QUARANTINED, reason)
            else:
                verdict = None
                if self.buffered_reports() >= self.eff_max_buffered:
                    # oldest-epoch-first may make room by dropping a
                    # queued epoch; if the buffer is still over quota
                    # after that (or the policy is reject-newest),
                    # the incoming upload sheds.
                    self.shed_oldest()
                    if self.buffered_reports() \
                            >= self.eff_max_buffered:
                        self.counters.inc("shed")
                        self.counters.bump_shed("reject-newest")
                        events.append(
                            ("shed", {"tenant": name,
                                      "reason": "reject-newest"}))
                        verdict = (SHED, "reject-newest")
                if verdict is None:
                    self.open_page.append(blob)
                    self.counters.inc("admitted")
                    if self.open_page.count >= self.eff_page_size:
                        to_seal = self.open_page
                        self.open_page = ReportPage()
                    verdict = (ADMITTED, "")
        if to_seal is not None:
            self.seal_page(to_seal, injector)
        for (ev_name, attrs) in events:
            obs_trace.event(ev_name, **attrs)
        return verdict

    def shed_oldest(self) -> Optional[str]:
        """Over-quota relief under the tenant's effective policy
        (caller holds `self.lock`).  Returns the shed detail when
        room was made (oldest-epoch-first), None when the incoming
        upload itself must be rejected."""
        if self.eff_shed_policy != "oldest-epoch-first" \
                or not self.pending:
            return None
        victim = self.pending.pop(0)
        lost = victim.report_count()
        self.counters.inc("shed", lost)
        self.counters.bump_shed("oldest-epoch-first", lost)
        obs_trace.event("shed", tenant=self.spec.name,
                        reason="oldest-epoch-first", reports=lost,
                        epoch=victim.epoch_id)
        return f"oldest-epoch-first dropped epoch {victim.epoch_id} " \
               f"({lost} reports)"

    def count_front_shed(self, reason: str, n: int = 1) -> None:
        """One front-door (network-admission) refusal into
        this tenant's shed ledger — rate limit, connection ceiling,
        body-size gate, truncated body.  The door's policy decisions
        and the service's read as one accounting (the ledger locks
        itself; buffer state is untouched)."""
        self.counters.inc("shed", n)
        self.counters.bump_shed(reason, n)
        obs_trace.event("shed", tenant=self.spec.name, reason=reason)

    def seal_page(self, page: ReportPage, injector=None) -> None:
        """Seal one just-swapped-out page behind its digest and
        append it to the sealed list.  Called WITHOUT the lock — the
        page left the open slot atomically, so no other thread can
        reach it, and the `page_flush` fault's delay/hang actions
        must stall only this admission, not the tenant."""
        page.seal()
        if injector is not None:
            # One fault event per seal: kill/hang/delay fire as
            # process faults, truncate/corrupt mutate the stored
            # bytes AFTER the digest (storage-corruption model — the
            # verify() gate must catch it downstream).
            page.payload = injector.on_blob("page_flush",
                                            page.payload)
        with self.lock:
            self.sealed.append(page)
        self.counters.inc("pages_sealed")


# -- the concurrent ingest front --------------------------------------

class _IngestFront:
    """The admission thread pool: `submit()` enqueues raw
    upload blobs into a BOUNDED queue and returns immediately;
    workers pop, decode-validate both party views (the expensive wire
    work, outside any lock), and land the verdict through the
    tenant's admission lock — so admission never blocks on round
    execution and the scheduler thread never pays upload decode.

    Bounds and failure behavior: the queue holds at most
    `ServiceConfig.ingest_queue` uploads (a full queue is the
    caller's shed, reason ``ingest-queue-full`` — counted by
    `CollectorService.submit`, never silent); `flush()` blocks until
    every queued upload has fully landed (the epoch-cut barrier);
    `stop()` retires the workers.  Workers are daemon threads: a
    crashing process never hangs on them, and the service snapshot
    flushes first so no admitted upload is in limbo at snapshot
    time."""

    def __init__(self, svc: "CollectorService", threads: int,
                 queue_bound: int):
        self._svc = svc
        self.queue: queue_mod.Queue = queue_mod.Queue(
            maxsize=max(1, queue_bound))
        self._stop = threading.Event()
        self.threads = [
            threading.Thread(target=self._worker,
                             name=f"mastic-ingest-{i}", daemon=True)
            for i in range(max(1, threads))
        ]
        for th in self.threads:
            th.start()

    def offer(self, tenant: str, blob: bytes) -> bool:
        """Enqueue one upload; False when the bounded queue is full
        (the caller sheds, attributed)."""
        try:
            self.queue.put_nowait((tenant, blob))
            return True
        except queue_mod.Full:
            return False

    def _worker(self) -> None:
        # The 0.1 s poll bounds the loop (stop() lands within one
        # tick); queue.get itself carries the timeout, so a stopped
        # front never wedges on an empty queue.
        while not self._stop.is_set():
            try:
                item = self.queue.get(timeout=0.1)
            except queue_mod.Empty:
                item = None
            if item is None:
                continue
            (tenant, blob) = item
            try:
                self._svc._ingest_one(tenant, blob)
            except Exception as exc:
                # A worker must survive anything one hostile upload
                # can throw — the blob is dropped ATTRIBUTED (decode
                # errors proper are quarantined inside _ingest_one;
                # this is the belt over it).
                obs_trace.event("ingest_error", tenant=tenant,
                                error=type(exc).__name__)
            finally:
                self.queue.task_done()

    def flush(self) -> None:
        """Block until every enqueued upload has fully landed (pages
        appended, counters settled) — the barrier `begin_epoch` and
        the snapshot run before touching buffered state."""
        self.queue.join()

    def stop(self) -> None:
        self._stop.set()
        for th in self.threads:
            th.join(timeout=5.0)


# -- the service ------------------------------------------------------

class CollectorService:
    """The long-lived, supervised multi-tenant collector (module
    docstring has the full story).  Single-threaded by design: one
    `step()` is one scheduler quantum (one round of one tenant's
    active epoch), and `submit()` may be called between quanta —
    admission lands in the open page, so uploads arriving while
    rounds are in flight join the NEXT epoch."""

    def __init__(self, tenants: list, config: Optional[ServiceConfig]
                 = None, injector=None, mesh=None, device="cuda"):
        # The runs' device: a card unless the caller asks for the CPU
        # (raises without one; nothing falls back).
        self.device = resolve_device(device)
        self.config = config or ServiceConfig.from_env()
        self.mesh = mesh
        self.injector = (injector if injector is not None
                         else faults_mod.injector_from_env("collector"))
        self.tenants: dict = {}
        for spec in tenants:
            if spec.name in self.tenants:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            self.tenants[spec.name] = _Tenant(spec, self.config)
        self._rr = 0   # round-robin cursor over tenant order
        self.resumed = False
        # Guards the tenant table itself: add_tenant publishes a new
        # entry while ingest workers look tenants up by name.
        self._tenants_mu = threading.Lock()
        # Overlapped epoch executor state: in-flight
        # staged rounds, oldest first — owned by the scheduler
        # thread; at most one entry per tenant.
        self._inflight: list = []
        self._sched_window: Optional[dict] = None
        # Concurrent ingest front: armed by config, stoppable
        # (stop_ingest) so tests and drains can quiesce it.
        self._ingest: Optional[_IngestFront] = None
        if self.config.ingest_threads > 0:
            self._ingest = _IngestFront(self,
                                        self.config.ingest_threads,
                                        self.config.ingest_queue)
        # The kernel store: load and probe the libraries at boot, so the
        # first round pays no load.
        for t in self.tenants.values():
            self._preload_artifacts(t)

    def stop_ingest(self) -> None:
        """Quiesce the ingest front: land everything queued, retire
        the workers.  Idempotent; submit() admits in-process after.
        The unpublish happens under the control-plane mutex — an
        HTTP handler thread may be mid-submit reading `_ingest`,
        and a torn read there would route its upload
        around the queue the caller just flushed."""
        if self._ingest is not None:
            self._ingest.flush()
            self._ingest.stop()
            with self._tenants_mu:
                self._ingest = None

    def flush_ingest(self) -> None:
        """Barrier: every upload submitted so far has fully landed
        (admitted / quarantined / shed) when this returns."""
        if self._ingest is not None:
            self._ingest.flush()

    def inflight_rounds(self) -> int:
        """Staged-but-uncollected rounds (0 outside overlap mode —
        the serve.py snapshot cadence keys on this)."""
        return len(self._inflight)

    def add_tenant(self, spec: TenantSpec) -> None:
        """Admit a new collection tenant into the running service
        (fresh buffers/counters; uploads may `submit()` immediately).
        Its artifact family preloads right here, so with a baked
        store the new tenant's first round pays disk loads at
        admission time, not a trace at epoch time."""
        if spec.name in self.tenants:
            raise ValueError(f"duplicate tenant {spec.name!r}")
        t = _Tenant(spec, self.config)
        with self._tenants_mu:
            self.tenants[spec.name] = t
        self._preload_artifacts(t)

    def _preload_artifacts(self, t: _Tenant) -> None:
        """Load and probe every kernel library from the armed kernel
        store (artifacts.ArtifactStore.load: digest, runtime, probe)
        into the process (`ops.kernels.preload`: a library that fails
        its gates is built inline now, or raises without nvcc); every
        outcome lands in mastic_artifact_loads_total and in one
        `artifact_preload` event.  The runs of every tenant launch the
        same libraries, so a preload after the first is in-process
        hits.  On the CPU nothing is opened."""
        from ..ops import kernels
        from . import artifacts

        if self.device.type != "cuda":
            return
        store = artifacts.store_from_env()
        if store is None:
            return
        with torch.cuda.device(self.device):
            counts = store.preload()
            kernels.preload()
        obs_trace.event("artifact_preload", tenant=t.spec.name,
                        store=store.path, **counts)

    def _checkpoint(self, step: str) -> None:
        if self.injector is not None:
            self.injector.checkpoint(step)

    # -- admission -------------------------------------------------

    def submit(self, tenant: str, blob: bytes) -> tuple:
        """Admit one upload blob for `tenant`.  Returns (status,
        detail): ADMITTED, QUARANTINED (detail = reason name), SHED
        (detail = policy / reason), or — with the concurrent ingest
        front armed — QUEUED (the verdict lands asynchronously in the
        counters).  Never raises for bad input — a hostile upload
        must cost the service one decode, not an exception path."""
        t = self.tenants[tenant]
        if t.replay_digests:
            # Post-recovery only: a retry of an upload the
            # WAL already replayed must ack exactly-once, not buffer
            # a duplicate.
            digest = hashlib.sha256(blob).digest()
            with t.lock:
                duplicate = digest in t.replay_digests
            if duplicate:
                obs_trace.event("duplicate_ack", tenant=tenant)
                return (ADMITTED, "duplicate")
        if self._ingest is not None:
            # The front path: enqueue only.  submit() never blocks on
            # decode OR round execution; a full queue is explicit
            # backpressure, shed with its own reason.
            if self._ingest.offer(tenant, blob):
                return (QUEUED, "")
            t.count_front_shed("ingest-queue-full")
            return (SHED, "ingest-queue-full")
        return self._ingest_one(tenant, blob)

    def shed_external(self, tenant: str, reason: str,
                      n: int = 1) -> None:
        """One front-door refusal (the network admission
        layer) attributed into the tenant's shed ledger exactly like
        an in-service shed — `_Tenant.count_front_shed` has the
        story.  Unknown tenants can't reach here (the front 404s
        before a ledger exists to blame)."""
        self.tenants[tenant].count_front_shed(reason, n)

    def report_digests(self, tenant: str) -> set:
        """SHA-256 digests of every upload blob the tenant currently
        buffers (open page, sealed pages, queued and active epochs) —
        the WAL recovery dedup baseline: a record both in the restored
        snapshot and in the log must not be buffered twice.  Pages
        failing their digest check contribute nothing (their reports
        are already lost to the corruption-drop path)."""
        t = self.tenants[tenant]
        with t.lock:
            pages = [t.open_page] + list(t.sealed)
            for ep in t.pending:
                pages.extend(ep.pages)
            if t.active is not None:
                pages.extend(t.active.pages)
            digests = set()
            for page in pages:
                if not page.verify():
                    continue
                for blob in page.decode_blobs():
                    digests.add(hashlib.sha256(blob).digest())
        return digests

    def note_replayed(self, tenant: str, digest: bytes) -> None:
        """Register one WAL-replayed report digest for retry dedup
        (see `_Tenant.replay_digests`)."""
        t = self.tenants[tenant]
        with t.lock:
            t.replay_digests.add(digest)

    def _ingest_one(self, tenant: str, blob: bytes) -> tuple:
        """Decode-validate one upload and land the verdict — the
        in-process submit body, also the ingest workers' unit of
        work.  Decode runs OUTSIDE the admission lock (it is the
        expensive part and touches no shared state); everything that
        mutates tenant buffers goes through _Tenant.admit_decoded."""
        t = self.tenants[tenant]
        self._checkpoint("admit")
        decode_exc: Optional[Exception] = None
        if not t.suspended:
            # Racy pre-check only — it saves the decode for a
            # suspended tenant; admit_decoded re-checks under the
            # lock either way.
            try:
                decode_upload(t.mastic, blob)
            except (ValueError, EOFError) as exc:
                decode_exc = exc
        return t.admit_decoded(blob, decode_exc,
                               injector=self.injector)

    # -- epochs ----------------------------------------------------

    def begin_epoch(self, tenant: str) -> Optional[int]:
        """Cut the tenant's buffered pages into a new pending epoch.
        Returns the epoch id, or None when there is nothing buffered
        or the pending queue is full under reject-newest (the pages
        stay buffered for a later cut).  With the ingest front armed
        the cut flushes the queue first, so every upload submitted
        before the cut is in or ahead of this epoch — never lost in
        the queue."""
        t = self.tenants[tenant]
        self.flush_ingest()
        with t.lock:
            to_seal: Optional[ReportPage] = None
            if t.open_page.count:
                to_seal = t.open_page
                t.open_page = ReportPage()
        if to_seal is not None:
            t.seal_page(to_seal, self.injector)
        with t.lock:
            if not t.sealed:
                return None
            if len(t.pending) >= self.config.max_pending_epochs:
                if t.shed_oldest() is None:
                    # reject-newest: the cut is refused (pages stay
                    # buffered for a later attempt), counted, not
                    # silent.
                    t.counters.inc("epochs_refused")
                    return None
            epoch = _Epoch(t.epoch_seq, t.sealed)
            t.epoch_seq += 1
            t.sealed = []
            t.pending.append(epoch)
            return epoch.epoch_id

    def _build_run(self, t: _Tenant, epoch: _Epoch) -> CollectionRun:
        spec = t.spec
        if spec.mode == "heavy_hitters":
            run = HeavyHittersRun(
                t.mastic, spec.ctx, spec.thresholds, spec.verify_key,
                epoch.batch, device=self.device, reports=epoch.reports,
                chunk_size=spec.chunk_size, mesh=self.mesh)
        else:
            run = AttributeMetricsRun(
                t.mastic, spec.ctx, spec.attributes, spec.verify_key,
                epoch.batch, device=self.device, reports=epoch.reports,
                chunk_size=spec.chunk_size, mesh=self.mesh)
        # The run's round spans / registry series carry this tenant.
        run.obs_tenant = spec.name
        return run

    def _restore_run(self, t: _Tenant, epoch: _Epoch,
                     blob: bytes) -> CollectionRun:
        spec = t.spec
        if spec.mode == "heavy_hitters":
            run = HeavyHittersRun.from_bytes(
                t.mastic, spec.ctx, spec.thresholds, spec.verify_key,
                epoch.batch, blob, device=self.device,
                reports=epoch.reports, mesh=self.mesh)
        else:
            run = AttributeMetricsRun.from_bytes(
                t.mastic, spec.ctx, spec.attributes, spec.verify_key,
                epoch.batch, blob, device=self.device,
                reports=epoch.reports, chunk_size=spec.chunk_size,
                mesh=self.mesh)
        run.obs_tenant = spec.name
        return run

    def _epoch_reports(self, t: _Tenant, epoch: _Epoch) -> int:
        """Parse the epoch's pages into the run's report batch on the
        device (`epoch.batch`, with the lazy scalar view
        `epoch.reports`), dropping (and counting) any page whose digest
        check fails — a corrupted page degrades the epoch, never
        poisons it.  Returns the number of surviving reports."""
        t0 = time.perf_counter()
        surviving = []
        for page in epoch.pages:
            if not page.verify():
                epoch.reports_lost += page.count
                t.counters.inc("pages_corrupt")
                t.counters.inc("quarantined", page.count)
                t.counters.bump_quarantine(
                    SERVICE_REASON_NAMES[REASON_PAGE_CORRUPT],
                    page.count)
                obs_trace.event(
                    "page_corrupt", tenant=t.spec.name,
                    epoch=epoch.epoch_id, reports=page.count)
                continue
            surviving.append(page)
        with t.lock:
            # The page list feeds report_count(), which ingest
            # workers read through the admission quota.
            epoch.pages = surviving
        if not surviving:
            return 0
        # The run consumes exactly the persisted bytes: both views of
        # every surviving upload, parsed on the device.
        views = page_views(t.mastic, surviving)
        epoch.batch = batch_from_views(t.mastic, views, self.device)
        epoch.reports = _EpochReports(t.mastic, views)
        epoch.parse_ms = (time.perf_counter() - t0) * 1e3
        return len(epoch.reports)

    def _start_epoch(self, t: _Tenant) -> None:
        with t.lock:
            epoch = t.pending.pop(0)
        self._checkpoint("epoch_start")
        epoch.span = obs_trace.get_tracer().start_detached_span(
            "epoch", tenant=t.spec.name, epoch=epoch.epoch_id,
            reports=epoch.report_count())
        if not self._epoch_reports(t, epoch):
            # Every page was corrupt (or the epoch was empty): an
            # immediately-final degraded epoch, counted, not raised.
            t.counters.inc("epochs_started")
            t.counters.inc("epochs_failed")
            t.completed.append(self._record(t, epoch, result=[],
                                            truncated=True,
                                            levels=0, error="no "
                                            "surviving reports"))
            return
        t.counters.inc("epochs_started")
        try:
            epoch.run = self._build_run(t, epoch)
        except Exception as exc:
            # Run construction can refuse (e.g. a memory-envelope
            # gate for the tenant's chunk config): a config-sick
            # tenant fails ITS epoch, attributably — not the service.
            t.counters.inc("epochs_failed")
            t.completed.append(self._record(
                t, epoch, result=[], truncated=True, levels=0,
                error=f"{type(exc).__name__}: {exc}"))
            return
        epoch.deadline = Deadline(t.eff_epoch_deadline)
        epoch.started_at = time.monotonic()
        with t.lock:
            t.active = epoch

    def _record(self, t: _Tenant, epoch: _Epoch, result,
                truncated: bool, levels: int,
                error: Optional[str] = None) -> dict:
        rec = {
            "tenant": t.spec.name,
            "epoch": epoch.epoch_id,
            "reports": epoch.report_count(),
            "reports_lost": epoch.reports_lost,
            "result": _jsonable(result),
            "truncated": truncated,
            "levels_completed": levels,
        }
        if epoch.run is not None and epoch.run.metrics:
            # Compile accounting over the epoch's rounds (this
            # process's): the zero-steady-state-compile claim is
            # checkable per epoch record, not just per live run —
            # bench.py --service-overlap asserts it.
            inline = 0
            compile_ms = 0.0
            for mx in epoch.run.metrics:
                art = mx.extra.get("artifacts") or {}
                inline += int(art.get("inline_compiles", 0))
                pipe = mx.extra.get("pipeline") or {}
                compile_ms += float(pipe.get("compile_inline_ms",
                                             0.0))
                for chunk in mx.extra.get("chunks") or ():
                    compile_ms += float(
                        chunk.get("phases", {}).get("compile_ms",
                                                    0.0))
            rec["inline_compiles"] = inline
            rec["compile_ms"] = round(compile_ms, 2)
        if epoch.started_at is not None:
            rec["wall_s"] = round(time.monotonic() - epoch.started_at,
                                  3)
        if epoch.parse_ms is not None:
            # The port's own: the device parse of the epoch's pages.
            rec["parse_ms"] = round(epoch.parse_ms, 3)
        if error is not None:
            rec["error"] = error
        if epoch.span is not None:
            # The epoch's trace span closes with its outcome; every
            # round span of the epoch parented to it.
            epoch.span.set(truncated=truncated, levels=levels,
                           **({"error": error} if error else {}))
            obs_trace.get_tracer().end_span(epoch.span)
            epoch.span = None
        return rec

    # -- the scheduler ---------------------------------------------

    def step(self) -> bool:
        """One scheduler quantum.  Serial (overlap < 2): pick the
        next tenant (round-robin) with work, run one round of its
        active epoch (starting the oldest pending epoch if none is
        active).  Overlapped (overlap = K >= 2): keep up to K
        tenants' rounds in flight — stage rounds into the in-flight
        window round-robin, then collect the oldest staged round's
        blocking sync, so tenant B's host-side stage (page decode,
        upload prep, AOT program fetch, dispatch) runs while tenant
        A's dispatched round computes on device.  Returns whether any
        tenant still has epoch work queued, running, or in flight."""
        if self.config.overlap >= 2:
            return self._step_overlapped()
        names = list(self.tenants)
        for off in range(len(names)):
            t = self.tenants[names[(self._rr + off) % len(names)]]
            if t.active is None and t.pending:
                self._start_epoch(t)
            if t.active is None:
                continue
            self._rr = (self._rr + off + 1) % len(names)
            self._run_one_round(t)
            break
        self._publish_sched_gauges()
        return any(t.active is not None or t.pending
                   for t in self.tenants.values())

    def _step_overlapped(self) -> bool:
        """One overlapped quantum: fill the in-flight window (at most
        one staged round per tenant — a tenant's rounds never overlap
        each other, which is what keeps its results bit-identical to
        the serial path), then collect the OLDEST in-flight round.
        Atomic run kinds (no split seam) execute whole during their
        stage slot; the device still computes another tenant's staged
        round underneath them."""
        names = list(self.tenants)
        staged = {name for (name, _e) in self._inflight}
        for off in range(len(names)):
            if len(self._inflight) >= self.config.overlap:
                break
            name = names[(self._rr + off) % len(names)]
            if name in staged:
                continue
            t = self.tenants[name]
            if t.active is None and t.pending:
                self._start_epoch(t)
            if t.active is None:
                continue
            entry = self._stage_quantum(t)
            if entry is not None:
                self._inflight.append((name, entry))
                staged.add(name)
        if len(names):
            self._rr = (self._rr + 1) % len(names)
        if self._inflight:
            (name, entry) = self._inflight.pop(0)
            t = self.tenants[name]
            entry["gap_ms"] = (time.perf_counter()
                               - entry["staged_at"]) * 1e3
            self._collect_quantum(t, entry)
        self._publish_sched_gauges()
        return bool(self._inflight) \
            or any(t.active is not None or t.pending
                   for t in self.tenants.values())

    def _stage_quantum(self, t: _Tenant) -> Optional[dict]:
        """Stage one round of the tenant's active epoch: deadline
        gate, then `step_begin` under the epoch span.  Returns the
        in-flight entry, or None when the quantum resolved inline
        (deadline truncation, atomic round, epoch completion, or a
        supervised failure)."""
        epoch = t.active
        self._checkpoint("epoch_round")
        tracer = obs_trace.get_tracer()
        if epoch.deadline.expired():
            self._truncate_epoch(t, epoch)
            return None
        t0 = time.perf_counter()
        before = len(epoch.run.metrics)
        begin = getattr(epoch.run, "step_begin", None)
        try:
            with tracer.use_parent(epoch.span):
                if begin is None:
                    # Legacy / stub run kind: no split seam — run the
                    # whole round as one atomic quantum.
                    more = epoch.run.step()
                    self._after_round(t, epoch, before, t0, more)
                    self._sched_busy((time.perf_counter() - t0) * 1e3)
                    return None
                handle = begin()
        except Exception as exc:   # supervised: fail the epoch, not
            # the service — other tenants keep their schedule
            self._round_failed(t, epoch, exc)
            return None
        stage_ms = (time.perf_counter() - t0) * 1e3
        self._sched_busy(stage_ms)
        if handle is None:
            # The run had no round left (a resumed, already-final
            # run): the epoch completes without touching the device.
            self._complete_epoch(t, epoch)
            return None
        entry = {"handle": handle, "t0": t0, "before": before,
                 "staged_at": time.perf_counter(), "gap_ms": 0.0}
        if handle.get("atomic"):
            # The whole round already ran inside begin (chunked runs
            # own their sync discipline): finish it now — deferring
            # would only delay the frontier advance.
            self._collect_quantum(t, entry)
            return None
        return entry

    def _collect_quantum(self, t: _Tenant, entry: dict) -> None:
        """Collect one staged round: `step_finish` (the round's one
        blocking sync) under the epoch span, then the shared
        post-round bookkeeping."""
        epoch = t.active
        tracer = obs_trace.get_tracer()
        t0 = time.perf_counter()
        try:
            with tracer.use_parent(epoch.span):
                more = epoch.run.step_finish(entry["handle"])
        except Exception as exc:
            self._round_failed(t, epoch, exc)
            return
        collect_ms = (time.perf_counter() - t0) * 1e3
        self._sched_busy(collect_ms + entry["gap_ms"])
        self._after_round(t, epoch, entry["before"], entry["t0"],
                          more)

    def _run_one_round(self, t: _Tenant) -> None:
        epoch = t.active
        self._checkpoint("epoch_round")
        tracer = obs_trace.get_tracer()
        if epoch.deadline.expired():
            self._truncate_epoch(t, epoch)
            return
        t0 = time.perf_counter()
        before = len(epoch.run.metrics)
        try:
            # The run's own round span (HeavyHittersRun.step /
            # AttributeMetricsRun.step) parents to this tenant's open
            # epoch span — NOT to whatever epoch started last.
            with tracer.use_parent(epoch.span):
                more = epoch.run.step()
        except Exception as exc:   # supervised: fail the epoch, not
            # the service — other tenants keep their schedule
            self._round_failed(t, epoch, exc)
            return
        self._after_round(t, epoch, before, t0, more)

    def _truncate_epoch(self, t: _Tenant, epoch: _Epoch) -> None:
        """Graceful degradation: finish at the last completed level;
        the frontier is correct for every round that ran."""
        t.counters.inc("deadline_misses")
        t.counters.inc("epochs_truncated")
        if epoch.span is not None:
            epoch.span.event("deadline_miss",
                             levels=epoch.run.rounds_completed())
        t.completed.append(self._record(
            t, epoch, result=epoch.run.frontier(),
            truncated=True,
            levels=epoch.run.rounds_completed()))
        with t.lock:
            t.active = None

    def _round_failed(self, t: _Tenant, epoch: _Epoch,
                      exc: Exception) -> None:
        """Supervision: count the failure; past the retry budget the
        epoch fails with its truncated frontier, otherwise the run is
        REBUILT from the epoch's pages — a round that raises
        mid-execution (staged or collected) can leave the runner's
        device carries inconsistent, and prep is a pure function of
        the reports, so the restart is bit-identical (completed
        levels recompute; the party layer's respawn-and-replay model applied
        in-process)."""
        epoch.failures += 1
        if epoch.failures > self.config.epoch_retries:
            t.counters.inc("epochs_failed")
            t.completed.append(self._record(
                t, epoch, result=epoch.run.frontier(),
                truncated=True,
                levels=epoch.run.rounds_completed(),
                error=f"{type(exc).__name__}: {exc}"))
            with t.lock:
                t.active = None
        else:
            if epoch.span is not None:
                epoch.span.event(
                    "epoch_retry", attempt=epoch.failures,
                    cause=f"{type(exc).__name__}: {exc}"[:200])
            get_registry().counter(
                "mastic_session_retries_total",
                tenant=t.spec.name).inc()
            epoch.run = self._build_run(t, epoch)

    def _after_round(self, t: _Tenant, epoch: _Epoch, before: int,
                     t0: float, more: bool) -> None:
        """Shared post-round bookkeeping for the serial and
        overlapped paths: counters, the per-round service block,
        occupancy gauges, epoch completion."""
        t.counters.inc("rounds")
        quantum_ms = (time.perf_counter() - t0) * 1e3
        reg = get_registry()
        for mx in epoch.run.metrics[before:]:
            round_ms = mx.extra.get("round_wall_ms", 0.0)
            sched_ms = round(max(0.0, quantum_ms - round_ms), 3)
            mx.extra["service"] = {
                "tenant": t.spec.name,
                "epoch": epoch.epoch_id,
                "sched_overhead_ms": sched_ms,
                "buffered_reports": t.buffered_reports(),
                "pending_epochs": len(t.pending),
                # Overlap context: staged rounds in flight when this
                # round retired (0 = the serial schedule).
                "overlap_inflight": len(self._inflight),
            }
            # The service block joins the unified extra schema
            # (re-stamp: the driver already validated its own blocks).
            mx.validate_extra()
            reg.counter("mastic_sched_overhead_ms_total",
                        tenant=t.spec.name).inc(sched_ms)
            if mx.extra.get("chunks"):
                t.last_timeline = mx.extra["chunks"]
        reg.gauge("mastic_buffered_reports",
                  tenant=t.spec.name).set(t.buffered_reports())
        reg.gauge("mastic_pending_epochs",
                  tenant=t.spec.name).set(len(t.pending))
        if not more:
            self._complete_epoch(t, epoch)

    def _complete_epoch(self, t: _Tenant, epoch: _Epoch) -> None:
        t.counters.inc("epochs_completed")
        t.completed.append(self._record(
            t, epoch, result=epoch.run.result(), truncated=False,
            levels=epoch.run.rounds_completed()))
        with t.lock:
            t.active = None

    # -- overlap accounting (occupancy + efficiency series) --------

    def _sched_busy(self, ms: float) -> None:
        """Accumulate scheduler busy time (stage work, collect work,
        and in-flight device windows) into the current overlap
        window.  Windows open at the first staged work and close when
        the scheduler drains; busy > wall means staged device time
        was hidden under other tenants' work."""
        w = self._sched_window
        if w is None:
            w = self._sched_window = {"t0": time.perf_counter(),
                                      "busy_ms": 0.0}
        w["busy_ms"] += ms

    def _publish_sched_gauges(self) -> None:
        reg = get_registry()
        occupancy = len(self._inflight)
        reg.gauge("mastic_scheduler_occupancy").set(occupancy)
        if self._ingest is not None:
            reg.gauge("mastic_ingest_queue_depth").set(
                self._ingest.queue.qsize())
        if self._sched_window is not None and not self._inflight \
                and not any(t.active is not None or t.pending
                            for t in self.tenants.values()):
            # Window closed: stamp the structural overlap efficiency
            # (pipeline.overlap_efficiency semantics — 0.0 when
            # nothing overlapped, the hidden fraction otherwise).
            w = self._sched_window
            wall_ms = (time.perf_counter() - w["t0"]) * 1e3
            eff = overlap_efficiency(
                [{"phases": {"busy_ms": w["busy_ms"]}}], wall_ms)
            reg.gauge("mastic_sched_overlap_efficiency").set(eff)
            self._sched_window = None

    def run_until_drained(self,
                          deadline: Optional[Deadline] = None) -> bool:
        """Drive the scheduler until no epoch work remains.  Returns
        False when `deadline` expired first (remaining work stays
        queued — snapshot and resume, or keep stepping)."""
        while self.step():
            if deadline is not None and deadline.expired():
                return False
        return True

    def drained(self) -> bool:
        return not self._inflight \
            and not any(t.active is not None or t.pending
                        for t in self.tenants.values())

    def _drain_inflight(self) -> None:
        """Collect every staged round (oldest first) so the service
        reaches a quiescent point — the snapshot precondition: a
        half-staged round serializes neither consistently nor
        portably, so `to_bytes` retires them first (the same rounds
        would recompute bit-identically after a crash anyway)."""
        pending = list(self._inflight)
        self._inflight = []
        for (name, entry) in pending:
            t = self.tenants[name]
            entry["gap_ms"] = (time.perf_counter()
                               - entry["staged_at"]) * 1e3
            self._collect_quantum(t, entry)

    # -- observability ---------------------------------------------

    def metrics(self) -> dict:
        """The service metrics JSON: per-tenant counters, buffer
        occupancy, quarantine/shed reason tables, epoch records."""
        out = {"policy": self.config.shed_policy,
               "resumed": self.resumed,
               "overlap": self.config.overlap,
               "ingest_threads": self.config.ingest_threads,
               "inflight_rounds": len(self._inflight),
               "tenants": {}}
        for (name, t) in self.tenants.items():
            out["tenants"][name] = {
                "buffered_reports": t.buffered_reports(),
                "open_page": t.open_page.count,
                "sealed_pages": len(t.sealed),
                "pending_epochs": len(t.pending),
                "active_epoch": (t.active.epoch_id
                                 if t.active is not None else None),
                "suspended": t.suspended,
                "counters": t.counters.as_dict(),
                "epochs": list(t.completed),
                # The statusz last-round timeline (per-chunk phases
                # of the tenant's most recent chunked round).
                "last_round_timeline": t.last_timeline,
            }
        return out

    # -- snapshot / resume -----------------------------------------

    def to_bytes(self) -> bytes:
        """Snapshot everything a crash must not lose: buffered pages
        (open + sealed), queued epochs, the active epoch's pages and
        its run checkpoint, completed results, and counters — the party
        layer's snapshot format (length-prefixed JSON binding header + npz
        payload), extended to the ingest layer.  The snapshot is a
        quiescent point: the ingest queue flushes first
        (every upload submitted before the snapshot fully lands),
        in-flight overlapped rounds collect (a half-staged round's
        device futures serialize neither consistently nor portably —
        and would recompute bit-identically after a crash anyway),
        and each tenant's buffers then serialize under its admission
        lock so a concurrent submit can never tear a page across the
        npz arrays."""
        import io

        self.flush_ingest()
        self._drain_inflight()
        self._checkpoint("snapshot")
        header = json.dumps({
            "version": _SNAPSHOT_VERSION,
            "policy": self.config.shed_policy,
            "tenants": [t.spec.to_json()
                        for t in self.tenants.values()],
        }, sort_keys=True).encode()
        data: dict = {"meta": np.array(
            [_SNAPSHOT_VERSION, len(self.tenants)], np.int64)}

        def put_page(prefix: str, page: ReportPage) -> None:
            sealed = page.payload is not None
            payload = (page.payload if sealed
                       else b"".join(wire.frame(b)
                                     for b in page.blobs))
            data[prefix] = np.frombuffer(payload, np.uint8)
            data[prefix + "_meta"] = np.array(
                [page.count, int(sealed)], np.int64)
            data[prefix + "_digest"] = np.frombuffer(
                page.digest if sealed else b"\x00" * 32, np.uint8)

        def put_epoch(prefix: str, epoch: _Epoch) -> None:
            data[prefix + "_meta"] = np.array(
                [epoch.epoch_id, len(epoch.pages),
                 epoch.reports_lost], np.int64)
            for (j, page) in enumerate(epoch.pages):
                put_page(f"{prefix}_pg{j}", page)

        for (i, t) in enumerate(self.tenants.values()):
            with t.lock:
                data[f"t{i}_state"] = np.array(
                    [t.epoch_seq, int(t.suspended), len(t.sealed),
                     len(t.pending), int(t.active is not None)],
                    np.int64)
                data[f"t{i}_counters"] = np.frombuffer(
                    json.dumps(t.counters.as_dict()).encode(),
                    np.uint8)
                data[f"t{i}_completed"] = np.frombuffer(
                    json.dumps(t.completed).encode(), np.uint8)
                put_page(f"t{i}_open", t.open_page)
                for (j, page) in enumerate(t.sealed):
                    put_page(f"t{i}_s{j}", page)
                for (k, epoch) in enumerate(t.pending):
                    put_epoch(f"t{i}_p{k}", epoch)
                if t.active is not None:
                    put_epoch(f"t{i}_active", t.active)
                    data[f"t{i}_active_run"] = np.frombuffer(
                        t.active.run.to_bytes(), np.uint8)
        buf = io.BytesIO()
        np.savez(buf, **data)
        return (len(header).to_bytes(4, "little") + header
                + buf.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes,
                   config: Optional[ServiceConfig] = None,
                   injector=None, mesh=None,
                   device="cuda") -> "CollectorService":
        """Restore a snapshotted service.  Page digests are verified
        as epochs start (a snapshot corrupted in storage degrades the
        affected epoch, detected, instead of aggregating garbage);
        the active epoch's run resumes bit-identically from its own
        checkpoint blob.  Its deadline restarts fresh — the budget
        bounds compute per process lifetime."""
        import io

        hlen = int.from_bytes(data[:4], "little")
        try:
            header = json.loads(data[4:4 + hlen])
        except ValueError:
            raise ValueError(
                "service snapshot has no JSON binding header — not a "
                "snapshot written by CollectorService.to_bytes")
        if header.get("version") != _SNAPSHOT_VERSION:
            raise ValueError(f"unknown service snapshot version "
                             f"{header.get('version')}")
        arrays = np.load(io.BytesIO(data[4 + hlen:]),
                         allow_pickle=False)
        specs = [TenantSpec.from_json(d) for d in header["tenants"]]
        if config is None:
            config = ServiceConfig.from_env()
        config.shed_policy = header["policy"]
        svc = cls(specs, config=config, injector=injector, mesh=mesh,
                  device=device)
        svc.resumed = True

        def get_page(prefix: str) -> ReportPage:
            payload = arrays[prefix].tobytes()
            (count, sealed) = [int(x)
                               for x in arrays[prefix + "_meta"]]
            digest = arrays[prefix + "_digest"].tobytes()
            if sealed:
                return ReportPage.from_payload(payload, digest, count)
            page = ReportPage()
            rest = payload
            while rest:   # mastic-allow: RB005 — bounded by the
                # stored open-page payload length
                (blob, rest) = wire.unframe(rest)
                page.append(blob)
            return page

        def get_epoch(prefix: str) -> _Epoch:
            (epoch_id, npages, lost) = [
                int(x) for x in arrays[prefix + "_meta"]]
            epoch = _Epoch(epoch_id, [get_page(f"{prefix}_pg{j}")
                                      for j in range(npages)])
            epoch.reports_lost = lost
            return epoch

        for (i, t) in enumerate(svc.tenants.values()):
            (seq, susp, nsealed, npending, has_active) = [
                int(x) for x in arrays[f"t{i}_state"]]
            # Under the admission lock: a restored service's ingest
            # front is already live, so the buffer swap must be
            # atomic against a concurrent submit.
            with t.lock:
                t.epoch_seq = seq
                t.suspended = bool(susp)
                restored = json.loads(
                    arrays[f"t{i}_counters"].tobytes())
                # Older snapshots carry no tenant label.
                restored.setdefault("tenant", t.spec.name)
                t.counters = ServiceCounters.from_dict(restored)
                t.counters.resumes += 1
                t.completed = json.loads(
                    arrays[f"t{i}_completed"].tobytes())
                t.open_page = get_page(f"t{i}_open")
                t.sealed = [get_page(f"t{i}_s{j}")
                            for j in range(nsealed)]
                t.pending = [get_epoch(f"t{i}_p{k}")
                             for k in range(npending)]
            # Republish the persisted totals so the Prometheus series
            # continue where the crashed process left them.
            t.counters.export_registry()
            if has_active:
                epoch = get_epoch(f"t{i}_active")
                if not svc._epoch_reports(t, epoch):
                    t.counters.inc("epochs_failed")
                    t.completed.append(svc._record(
                        t, epoch, result=[], truncated=True,
                        levels=0, error="no surviving reports after "
                        "resume"))
                else:
                    epoch.run = svc._restore_run(
                        t, epoch, arrays[f"t{i}_active_run"].tobytes())
                    epoch.deadline = Deadline(t.eff_epoch_deadline)
                    epoch.started_at = time.monotonic()
                    epoch.span = obs_trace.get_tracer() \
                        .start_detached_span(
                            "epoch", tenant=t.spec.name,
                            epoch=epoch.epoch_id,
                            reports=epoch.report_count(),
                            resumed=True)
                    with t.lock:
                        t.active = epoch
        return svc


def _jsonable(result):
    """Epoch results as JSON-safe values (heavy-hitter prefixes are
    bool tuples; attribute aggregates are (name, value) pairs)."""
    if isinstance(result, (list, tuple)):
        return [_jsonable(x) for x in result]
    if isinstance(result, (bool, np.bool_)):
        return bool(result)
    if isinstance(result, (int, np.integer)):
        return int(result)
    return result
