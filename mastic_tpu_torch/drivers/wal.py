"""Durable write-ahead admission log (copy of `mastic_tpu/drivers/wal.py`;
its segment bytes are the JAX package's, so either package recovers
the other's log).

The collector's exactly-once ingest contract used to hang off
snapshot-before-ack: every 2xx waited for a FULL service snapshot —
O(service-state) per report and a single write path with no disk-fault
story.  This module is the replacement durability substrate: an
append-only, segment-rotated WAL sits under admission, each acked
upload is one small checksummed record, fsync is batched (group
commit), and the service snapshot becomes a periodic COMPACTION
artifact rather than the ack path.

Record wire format (little-endian)::

    u32 payload_len | u32 crc32(payload) | payload
    payload = u64 seq | u8 kind | u16 tenant_len | tenant | blob

Kinds: ``KIND_REPORT`` (an admitted upload body, replayed through the
``CollectorService.submit()`` seam at recovery) and
``KIND_EPOCH_CUT`` (a scheduler epoch-cut marker, replayed via
``begin_epoch``).  ``seq`` is a monotone record number spanning
segment rotation, which is what the compaction covered-marker refers
to.

Durability policy (`MASTIC_WAL_FSYNC`):

* ``always`` — every append fsyncs inline before the ack releases;
* ``group:<ms>`` — appends enqueue on the current segment and a
  committer thread fsyncs once per interval, releasing every waiter
  that batch covered.  An ack NEVER precedes its record's fsync —
  the waiter blocks until the committer confirms (tested under an
  injected fsync delay).

Recovery (`AdmissionWal.recover`) scans segments in order, tolerating
a torn tail — a record whose header or payload runs past EOF is
truncated away and counted ``outcome="torn_tail"``, a full-length
record failing its CRC is skipped and counted ``outcome="corrupt"``;
recovery NEVER refuses.  Records at or below the covered marker's
``seq`` are skipped (``covered``) — but only when the marker's
recorded snapshot digest matches the snapshot actually restored;
otherwise the marker is distrusted and replay falls back to per-report
digest dedup against what the snapshot already buffers (``deduped``).

Failure is reason-coded, never silent: ENOSPC flips the log to the
``wal-full`` brownout, any other write/fsync error to
``wal-degraded`` — appends raise :class:`WalUnavailable` (the HTTP
front maps it to 503-with-Retry-After) and the next append attempts
revival by rotating to a fresh segment.

Everything here is stdlib-only so the network layer
can import the exception type for free.
"""

import json
import os
import re
import struct
import threading
import time
import zlib
from hashlib import sha256
from typing import Optional

from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from ..obs.trace import get_tracer

KIND_REPORT = 1
KIND_EPOCH_CUT = 2
_KIND_NAMES = {KIND_REPORT: "report", KIND_EPOCH_CUT: "epoch_cut"}

_REC_HDR = struct.Struct("<II")       # payload_len, crc32(payload)
_PAYLOAD_HDR = struct.Struct("<QBH")  # seq, kind, tenant_len

_SEG_RE = re.compile(r"^wal-(\d{8})\.seg$")
_MARKER_NAME = "covered.json"

# Brownout reason codes (counted at the ingest front's shed sink).
REASON_WAL_FULL = "wal-full"
REASON_WAL_DEGRADED = "wal-degraded"

# Retry-After seconds a brownout 503 advertises: long enough to shed
# the hot retry loop, short enough that a transient fsync error heals
# within one client backoff step.
RETRY_AFTER_S = 1

# A group-commit waiter gives up after this long without its fsync —
# far past any sane group interval; hitting it means the committer
# died, which must surface as an attributed 503, not a hung ack.
_GROUP_WAIT_S = 30.0

# Per-append fsync-wait samples kept for stats() quantiles.
_SAMPLE_CAP = 8192


class WalUnavailable(RuntimeError):
    """Append could not be made durable.  `reason` is the brownout
    reason code (`wal-full` for ENOSPC, `wal-degraded` otherwise);
    the ingest plane maps this to a 503 with Retry-After and keeps
    serving reads/status — degradation is attributed, never silent."""

    def __init__(self, reason: str, retry_after: int = RETRY_AFTER_S):
        super().__init__(f"WAL unavailable: {reason}")
        self.reason = reason
        self.retry_after = retry_after


class WalConfig:
    """Durability levers: `MASTIC_WAL_FSYNC`
    (`always` | `group:<ms>`) and `MASTIC_WAL_SEGMENT_BYTES` (segment
    rotation bound)."""

    def __init__(self, fsync: str = "group", group_ms: float = 2.0,
                 segment_bytes: int = 8 * 1024 * 1024):
        if fsync not in ("always", "group"):
            raise ValueError(f"unknown WAL fsync policy {fsync!r} "
                             f"(want always or group)")
        if group_ms <= 0:
            raise ValueError("group interval must be positive")
        if segment_bytes <= 0:
            raise ValueError("segment bound must be positive")
        self.fsync = fsync
        self.group_ms = float(group_ms)
        self.segment_bytes = int(segment_bytes)

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "WalConfig":
        env = os.environ if env is None else env
        cfg = cls()
        spec = env.get("MASTIC_WAL_FSYNC", "").strip()
        if spec:
            if spec == "always":
                cfg = cls(fsync="always",
                          segment_bytes=cfg.segment_bytes)
            elif spec.startswith("group:"):
                cfg = cls(fsync="group",
                          group_ms=float(spec[len("group:"):]),
                          segment_bytes=cfg.segment_bytes)
            else:
                raise ValueError(
                    f"MASTIC_WAL_FSYNC={spec!r} (want always or "
                    f"group:<ms>)")
        seg = env.get("MASTIC_WAL_SEGMENT_BYTES", "").strip()
        if seg:
            cfg = cls(fsync=cfg.fsync, group_ms=cfg.group_ms,
                      segment_bytes=int(seg))
        return cfg


def fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed/created entry survives a
    power cut (the tail of the tmp → fsync → replace → fsync(dir)
    atomic-write sequence; RB006's good idiom)."""
    fd = os.open(path or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Waiter:
    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[str] = None


class AdmissionWal:
    """The append-only admission log over one directory of
    ``wal-NNNNNNNN.seg`` segments plus the ``covered.json`` compaction
    marker.  Thread-safe: handler threads append concurrently; the
    scheduler thread marks coverage; one committer thread (group
    policy) owns the batched fsync."""

    def __init__(self, path: str, config: Optional[WalConfig] = None,
                 injector=None, registry=None, fresh: bool = False):
        self.path = path
        self._cfg = config or WalConfig.from_env()
        self._injector = injector
        self._registry = registry or get_registry()
        self._mu = threading.Lock()
        # Raw fd, not a buffered file object: every byte handed to
        # os.write is visible to a post-crash scan (no library buffer
        # between the record and the OS), and the open/write calls
        # stay out of the analyzer's blocking-under-lock set.
        self._fd: Optional[int] = None
        self._seg_fmt = os.path.join(path, "wal-{:08d}.seg")
        self._seg_path: Optional[str] = None
        self._seg_size = 0
        self._seg_last_seq: dict = {}   # segment path -> last seq in it
        self._pending: list = []        # group-commit waiters
        self._degraded: Optional[str] = None
        self._closed = False
        self._samples: list = []        # recent fsync-wait ms
        self._appends = 0
        os.makedirs(path, exist_ok=True)
        if fresh:
            for name in os.listdir(path):
                if _SEG_RE.match(name) or name == _MARKER_NAME:
                    os.remove(os.path.join(path, name))
            fsync_dir(path)
        existing = self._segment_names()
        self._seg_index = (
            int(_SEG_RE.match(existing[-1]).group(1)) + 1 if existing
            else 0)
        # Appends need a seq watermark; a fresh log starts at 0, an
        # existing one must be recover()ed first (which also replays).
        self._next_seq: Optional[int] = 0 if (fresh or not existing) \
            else None
        marker = self._read_marker()
        if marker is not None and self._next_seq is not None:
            self._next_seq = max(self._next_seq,
                                 int(marker.get("seq", -1)) + 1)
        self._committer: Optional[threading.Thread] = None
        if self._cfg.fsync == "group":
            self._committer = threading.Thread(
                target=self._committer_loop, daemon=True,
                name="wal-committer")
            self._committer.start()

    # -- append path -----------------------------------------------

    def append_report(self, tenant: str, blob: bytes) -> int:
        """Log one admitted upload body; returns its seq.  Blocks
        until the record is fsync-durable (inline or via the group
        committer) — the caller's ack must not outrun this return."""
        return self._append(KIND_REPORT, tenant, blob)

    def append_epoch_cut(self, tenant: str) -> int:
        """Log a scheduler epoch-cut marker for `tenant`."""
        return self._append(KIND_EPOCH_CUT, tenant, b"")

    def _append(self, kind: int, tenant: str, blob: bytes) -> int:
        t0 = time.monotonic()
        tenant_b = tenant.encode("utf-8")
        inj = self._injector
        with self._mu:
            if self._closed:
                raise WalUnavailable(REASON_WAL_DEGRADED)
            if self._next_seq is None:
                raise RuntimeError(
                    "append before recover() on an existing WAL dir — "
                    "recovery owns the seq watermark")
            if self._degraded is not None:
                self._revive_locked()
            if self._fd is None:
                self._guard_os_locked(self._open_segment_locked)
            elif self._seg_size >= self._cfg.segment_bytes:
                self._guard_os_locked(self._rotate_locked)
            seq = self._next_seq
            payload = _PAYLOAD_HDR.pack(seq, kind, len(tenant_b)) \
                + tenant_b + blob
            rec = _REC_HDR.pack(len(payload), zlib.crc32(payload)) \
                + payload
            after = None

            def write_record():
                nonlocal rec, after
                if inj is not None:
                    (rec, after) = inj.on_disk("wal_append", rec)
                view = memoryview(rec)
                while view:
                    view = view[os.write(self._fd, view):]

            self._guard_os_locked(write_record)
            if after == "kill":
                # short-write/torn-tail fault: the truncated bytes
                # reached the OS (raw os.write, no library buffer),
                # the process dies before fsync and before any ack —
                # recovery must truncate-and-count this tail.
                os._exit(17)
            self._next_seq = seq + 1
            self._seg_size += len(rec)
            self._seg_last_seq[self._seg_path] = seq
            seg_size = self._seg_size
            if self._cfg.fsync == "always":
                self._guard_os_locked(self._fsync_locked)
                waiter = None
            else:
                waiter = _Waiter()
                self._pending.append(waiter)
        if waiter is not None:
            if not waiter.event.wait(timeout=_GROUP_WAIT_S):
                raise WalUnavailable(REASON_WAL_DEGRADED)
            if waiter.error is not None:
                raise WalUnavailable(waiter.error)
        if inj is not None:
            # kill-after-fsync-before-ack: the record is durable but
            # the client never sees the 2xx — recovery replays it and
            # the client's retry must dedup, not duplicate.
            inj.checkpoint("wal_ack")
        wait_ms = (time.monotonic() - t0) * 1000.0
        with self._mu:
            self._appends += 1
            self._samples.append(wait_ms)
            if len(self._samples) > _SAMPLE_CAP:
                del self._samples[:len(self._samples) - _SAMPLE_CAP]
        self._registry.counter("mastic_wal_appends_total",
                               tenant=tenant,
                               kind=_KIND_NAMES[kind]).inc()
        self._registry.histogram("mastic_wal_fsync_ms").observe(
            wait_ms)
        self._registry.gauge("mastic_wal_segment_bytes").set(seg_size)
        get_tracer().record_span("wal.append", duration_ms=wait_ms,
                                 tenant=tenant,
                                 kind=_KIND_NAMES[kind], seq=seq)
        return seq

    def _guard_os_locked(self, op) -> None:
        """Run one OS-touching step; an OSError flips the log to the
        reason-coded brownout and surfaces as WalUnavailable."""
        try:
            op()
        except OSError as err:
            reason = self._set_degraded_locked(err)
            raise WalUnavailable(reason) from err

    def _set_degraded_locked(self, err: OSError) -> str:
        import errno as _errno
        reason = (REASON_WAL_FULL
                  if err.errno == _errno.ENOSPC else
                  REASON_WAL_DEGRADED)
        self._degraded = reason
        obs_trace.event("wal_degraded", reason=reason,
                        error=str(err))
        return reason

    def _revive_locked(self) -> None:
        """A degraded log heals by rotating to a fresh segment (a
        later write may succeed where the wedged fd cannot — and for
        real ENOSPC the rotation itself keeps failing, so the 503
        brownout persists honestly)."""
        reason = self._degraded

        def reopen():
            self._rotate_locked()

        try:
            reopen()
        except OSError as err:
            self._set_degraded_locked(err)
            raise WalUnavailable(self._degraded or reason) from err
        self._degraded = None
        obs_trace.event("wal_recovered_from_degraded", reason=reason)

    def _open_segment_locked(self) -> None:
        path = self._seg_fmt.format(self._seg_index)
        self._seg_index += 1
        self._fd = os.open(path,
                           os.O_CREAT | os.O_WRONLY | os.O_APPEND,
                           0o644)
        self._seg_path = path
        self._seg_size = os.fstat(self._fd).st_size
        fsync_dir(self.path)

    def _rotate_locked(self) -> None:
        """Seal the current segment (commit anything pending on it)
        and open the next — every record lives wholly in one file."""
        if self._fd is not None:
            self._fsync_locked()
            self._release_pending_locked(None)
            os.close(self._fd)
            self._fd = None
        self._open_segment_locked()

    def _fsync_locked(self) -> None:
        if self._injector is not None:
            self._injector.on_disk("wal_fsync", b"")
        os.fsync(self._fd)

    def _release_pending_locked(self, error: Optional[str]) -> None:
        waiters = self._pending
        self._pending = []
        for w in waiters:
            w.error = error
            w.event.set()

    def _committer_loop(self) -> None:
        interval = self._cfg.group_ms / 1000.0
        while True:
            time.sleep(interval)
            with self._mu:
                if self._closed:
                    self._release_pending_locked(REASON_WAL_DEGRADED)
                    return
                if not self._pending or self._fd is None:
                    continue
                try:
                    self._fsync_locked()
                    self._release_pending_locked(None)
                except OSError as err:
                    reason = self._set_degraded_locked(err)
                    self._release_pending_locked(reason)

    # -- recovery ---------------------------------------------------

    def recover(self, service, snapshot_sha256: Optional[str] = None) \
            -> dict:
        """Scan every segment and replay what the restored snapshot
        does not cover; returns the outcome counts plus recovery wall
        time.  Never refuses: torn tails are truncated and counted,
        CRC failures skipped and counted.  `snapshot_sha256` is the
        digest of the snapshot bytes actually restored — the covered
        marker is honored only if it names the same digest (satellite:
        re-verify the snapshot before preferring it over replay)."""
        t0 = time.monotonic()
        counts = {"replayed": 0, "covered": 0, "deduped": 0,
                  "torn_tail": 0, "corrupt": 0, "epoch_cut": 0,
                  "rejected": 0}
        marker = self._read_marker()
        covered_seq = -1
        if marker is not None:
            if snapshot_sha256 is not None and \
                    marker.get("snapshot_sha256") == snapshot_sha256:
                covered_seq = int(marker.get("seq", -1))
            else:
                obs_trace.event("wal_marker_distrusted",
                                marker_seq=marker.get("seq"))
        next_seq = covered_seq + 1
        baseline: dict = {}
        for name in self._segment_names():
            seg = os.path.join(self.path, name)
            (records, good_len, tail) = self._scan_segment(seg)
            size = os.path.getsize(seg)
            if tail == "torn" and good_len < size:
                os.truncate(seg, good_len)
                fsync_dir(self.path)
                counts["torn_tail"] += 1
            counts["corrupt"] += sum(
                1 for r in records if r is None)
            for rec in records:
                if rec is None:
                    continue
                (seq, kind, tenant, blob) = rec
                next_seq = max(next_seq, seq + 1)
                self._seg_last_seq[seg] = seq
                if seq <= covered_seq:
                    counts["covered"] += 1
                    continue
                if tenant not in getattr(service, "tenants", {}):
                    counts["rejected"] += 1
                    continue
                if kind == KIND_EPOCH_CUT:
                    service.begin_epoch(tenant)
                    counts["epoch_cut"] += 1
                    continue
                digest = sha256(blob).digest()
                if tenant not in baseline:
                    baseline[tenant] = service.report_digests(tenant)
                if digest in baseline[tenant]:
                    # Double-covered: the snapshot already buffers
                    # this report (stale/distrusted marker) — ack
                    # idempotently on retry, do not re-buffer.
                    service.note_replayed(tenant, digest)
                    counts["deduped"] += 1
                    continue
                (status, _detail) = service.submit(tenant, blob)
                service.note_replayed(tenant, digest)
                baseline[tenant].add(digest)
                if status in ("admitted", "queued"):
                    counts["replayed"] += 1
                else:
                    counts["rejected"] += 1
        self._next_seq = max(next_seq, 0)
        for (outcome, n) in counts.items():
            if n:
                self._registry.counter(
                    "mastic_wal_recovered_records_total",
                    outcome=outcome).inc(n)
        wall_ms = (time.monotonic() - t0) * 1000.0
        get_tracer().record_span("wal.recover", duration_ms=wall_ms,
                                 **counts)
        stats = dict(counts)
        stats["recovery_wall_ms"] = wall_ms
        stats["next_seq"] = self._next_seq
        return stats

    def _scan_segment(self, path: str):
        """Parse one segment.  Returns (records, good_len, tail)
        where records holds (seq, kind, tenant, blob) tuples — None
        for a full-length record whose CRC failed (bit-flip
        post-checksum: detected, attributed, skipped) — good_len is
        the byte offset of the torn tail (== file size when clean)
        and tail is "torn" or None."""
        with open(path, "rb") as f:
            data = f.read()
        records: list = []
        off = 0
        while off < len(data):
            if len(data) - off < _REC_HDR.size:
                return (records, off, "torn")
            (plen, crc) = _REC_HDR.unpack_from(data, off)
            start = off + _REC_HDR.size
            if len(data) - start < plen:
                return (records, off, "torn")
            payload = data[start:start + plen]
            off = start + plen
            if zlib.crc32(payload) != crc or \
                    plen < _PAYLOAD_HDR.size:
                records.append(None)
                continue
            (seq, kind, tlen) = _PAYLOAD_HDR.unpack_from(payload, 0)
            body = payload[_PAYLOAD_HDR.size:]
            if len(body) < tlen or kind not in _KIND_NAMES:
                records.append(None)
                continue
            tenant = body[:tlen].decode("utf-8", "replace")
            records.append((seq, kind, tenant, body[tlen:]))
        return (records, off, None)

    # -- compaction -------------------------------------------------

    def tail_seq(self) -> int:
        """Highest seq appended so far (-1 when empty) — capture this
        BEFORE serializing a snapshot: every record at or below it is
        in the snapshot, so covering less than reality stays safe."""
        with self._mu:
            return (self._next_seq or 0) - 1

    def mark_covered(self, seq: int, snapshot_sha256: str) -> int:
        """Record that a durable snapshot (of the given digest) covers
        every record with seq <= `seq`, then delete the segments that
        are wholly covered.  Returns the number of segments dropped."""
        marker = {"seq": int(seq), "snapshot_sha256": snapshot_sha256}
        tmp = os.path.join(self.path, _MARKER_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(marker, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.path, _MARKER_NAME))
        fsync_dir(self.path)
        dropped = 0
        candidates = [os.path.join(self.path, name)
                      for name in self._segment_names()]
        with self._mu:
            current = self._seg_path
            for seg in candidates:
                if seg == current:
                    continue
                last = self._seg_last_seq.get(seg)
                if last is None:
                    (records, _len, _tail) = self._scan_segment(seg)
                    real = [r for r in records if r is not None]
                    last = real[-1][0] if real else -1
                if last <= seq:
                    os.remove(seg)
                    dropped += 1
                    self._seg_last_seq.pop(seg, None)
        if dropped:
            fsync_dir(self.path)
            obs_trace.event("wal_compacted", dropped=dropped,
                            covered_seq=int(seq))
        return dropped

    # -- bookkeeping ------------------------------------------------

    def _segment_names(self) -> list:
        return sorted(n for n in os.listdir(self.path)
                      if _SEG_RE.match(n))

    def _read_marker(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.path, _MARKER_NAME)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stats(self) -> dict:
        """Append/fsync accounting for benches and drill JSON."""
        with self._mu:
            samples = sorted(self._samples)
            appends = self._appends
            degraded = self._degraded

        def pct(p: float) -> Optional[float]:
            if not samples:
                return None
            i = min(len(samples) - 1, int(p * (len(samples) - 1)))
            return samples[i]

        return {"appends": appends,
                "fsync_wait_ms_p50": pct(0.50),
                "fsync_wait_ms_p99": pct(0.99),
                "segments": len(self._segment_names()),
                "degraded": degraded}

    def close(self) -> None:
        with self._mu:
            if self._closed:
                return
            self._closed = True
            if self._fd is not None:
                try:
                    self._fsync_locked()
                    self._release_pending_locked(None)
                except OSError:
                    self._release_pending_locked(REASON_WAL_DEGRADED)
                os.close(self._fd)
                self._fd = None
