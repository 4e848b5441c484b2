"""Deterministic fault injection for aggregation sessions (copy of
`mastic_tpu/drivers/faults.py`; the `MASTIC_FAULTS` lever).

The session layer's claims — bounded-time failure, party-attributed
errors, no fault ever yielding a silently wrong aggregate — are only
as good as the faults they were tested against.  This harness injects
the faults real transports produce, deterministically, at these seams:

* **outbound frames** (`FaultInjector.on_send`, called by
  `session.Channel.send_msg` on the fully framed bytes): drop,
  delay, truncate, corrupt, duplicate, hang — transport-level
  mutations, so e.g. `truncate` leaves the receiver waiting on a
  frame whose header promises more bytes than ever arrive;
* **protocol checkpoints** (`FaultInjector.checkpoint`, called by the
  party main loop and the collector between steps): kill (hard
  process exit), hang, delay — crash-at-step faults;
* **the reliable transport** (`FaultInjector.on_net`, fired by
  `net.transport.TcpTransport` once per outbound session frame, after
  the frame enters the replay buffer): ``conn_drop`` (drop the
  connection now), ``partition`` (drop it and refuse redial for
  ``delay`` seconds, both directions) and ``slow_loris`` (stall the
  writer mid-frame for ``delay`` seconds), so recovery exercises
  reconnect-and-replay, never silent loss; the ``tls_handshake``
  checkpoint fires in the dial/accept paths;
* **content** (`on_blob`, `split_report_blob`) and **durable storage**
  (`on_disk`: ``short_write``, ``enospc``, ``fsync_error``), the seams
  of the collector service's pages and write-ahead log.

A fault spec is one or more `;`-separated rules:

    <action>:party=<leader|helper|collector>:step=<step>[:nth=N]
            [:delay=SECONDS][:cut=BYTES][:xor=BYTE][:offset=BYTES]

e.g. ``kill:party=helper:step=round_start`` or
``corrupt:party=leader:step=prep_share:offset=4:xor=1``.  `nth` is the
1-based occurrence of the (party, step) event the rule fires on
(default 1); each rule fires exactly once, so injection is
deterministic and replayable.  Step names are the wire labels of
drivers/parties.py (hello, leader_port, upload, upload_report,
upload_ack, agg_param, prep_share, resolution, agg_share, shutdown)
plus the process checkpoints (spawn, reports_loaded, round_start,
prep_done, resolve_done, confirm_done), ``net_send`` on a shaped link
and the collector service's checkpoints (admit, page_flush,
epoch_start, epoch_round, snapshot, http_accept, http_body,
wal_append, wal_fsync, wal_ack).

Each process parses `MASTIC_FAULTS` itself and keeps only the rules
addressed to its own party name, so one env var arms the whole
session (the collector passes it through to the party processes).
"""

import os
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..obs import trace as obs_trace
from ..obs.registry import get_registry

ACTIONS = ("drop", "delay", "truncate", "corrupt", "duplicate",
           "hang", "kill",
           # Network-fault actions (the reliable-transport seam,
           # FaultInjector.on_net): a dropped connection, a
           # partition lasting `delay` seconds both directions, and
           # a writer that stalls mid-frame for `delay` seconds.
           "conn_drop", "partition", "slow_loris",
           # Disk-fault actions (the write-ahead log's seam,
           # FaultInjector.on_disk): a write that lands `cut` bytes
           # short and dies before fsync (torn tail), a full disk,
           # and an fsync that errors.
           "short_write", "enospc", "fsync_error")
PARTIES = ("leader", "helper", "collector")

# The actions only the reliable-transport seam implements (a plain
# channel cannot recover from them; the TcpTransport reconnects).
NET_ACTIONS = ("conn_drop", "partition", "slow_loris")

# The actions only the durable-storage seam implements
# (FaultInjector.on_disk — the WAL append/fsync path).
DISK_ACTIONS = ("short_write", "enospc", "fsync_error")

# `hang` sleeps this long — far past any configured deadline, short
# enough that an orphaned hung process eventually dies on its own.
HANG_SECONDS = 3600.0

# Exit code a killed party dies with (distinct from 1 = structured
# session error, so the collector can tell "injected kill" from
# "party hit an error" in test assertions).
KILL_EXIT_CODE = 17


@dataclass
class FaultRule:
    action: str
    party: str
    step: str
    nth: int = 1
    delay: float = 5.0     # seconds, for delay
    cut: int = 1           # trailing bytes removed, for truncate
    xor: int = 0x01        # byte mask, for corrupt
    offset: int = 4        # frame offset for corrupt (4 = first
    #                        payload byte; 0..3 hits the length header)
    fired: bool = field(default=False, repr=False)


def parse_faults(text: Optional[str]) -> list:
    """Parse a `;`-separated MASTIC_FAULTS spec into FaultRules.
    Unknown actions/parties/keys are errors: a typo'd fault spec that
    silently injects nothing would make the whole matrix vacuous."""
    rules = []
    for chunk in (text or "").split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        parts = chunk.split(":")
        action = parts[0].strip()
        if action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (must be one of "
                f"{', '.join(ACTIONS)})")
        kwargs: dict = {}
        for kv in parts[1:]:
            if "=" not in kv:
                raise ValueError(f"malformed fault field {kv!r} "
                                 f"(want key=value)")
            (key, val) = kv.split("=", 1)
            key = key.strip()
            val = val.strip()
            if key == "party":
                if val not in PARTIES:
                    raise ValueError(
                        f"unknown fault party {val!r} (must be one "
                        f"of {', '.join(PARTIES)})")
                kwargs["party"] = val
            elif key == "step":
                kwargs["step"] = val
            elif key in ("nth", "cut", "offset"):
                kwargs[key] = int(val)
            elif key == "delay":
                kwargs[key] = float(val)
            elif key == "xor":
                kwargs[key] = int(val, 0) & 0xFF
            else:
                raise ValueError(f"unknown fault field {key!r}")
        if "party" not in kwargs or "step" not in kwargs:
            raise ValueError(
                f"fault rule {chunk!r} needs party= and step=")
        rules.append(FaultRule(action=action, **kwargs))
    return rules


class FaultInjector:
    """Applies the rules addressed to one party.  Counting is per
    (rule), matched against this party's (step) events in order, so a
    spec replays identically run to run.

    The occurrence counters are lock-guarded: the collector
    service's ingest front fires the ``admit`` / ``page_flush``
    checkpoints from its worker threads while the scheduler thread
    fires the epoch checkpoints, and an unlocked read-modify-write of
    the per-step count would let two concurrent events claim the same
    nth (a rule firing twice, or never)."""

    def __init__(self, rules: list, party: str):
        self.party = party
        self.rules = [r for r in rules if r.party == party]
        self._event_counts: dict = {}
        self._mu = threading.Lock()

    def _match(self, step: str) -> Optional[FaultRule]:
        """One event of (party, step) happened; the rule whose nth it
        is fires.  Events are counted per step regardless of whether
        any rule fires, so several rules can target different
        occurrences of the same step.  A firing rule lands in the
        trace and the registry BEFORE its action runs, so even a
        `kill` is visible in the JSONL trace (an injected fault must
        be findable in the telemetry, not inferred)."""
        with self._mu:
            n = self._event_counts.get(step, 0) + 1
            self._event_counts[step] = n
            fired = None
            for rule in self.rules:
                if rule.step == step and not rule.fired \
                        and rule.nth == n:
                    rule.fired = True
                    fired = rule
                    break
        if fired is not None:
            obs_trace.event("fault_injected", action=fired.action,
                            party=fired.party, step=step, nth=n)
            get_registry().counter(
                "mastic_faults_injected_total",
                action=fired.action, step=step).inc()
        return fired

    # -- outbound frames (Channel.send_msg) ------------------------

    def on_send(self, step: str, frame: bytes) -> list:
        """Transform one outbound frame (header + payload) into the
        list of byte strings actually written."""
        rule = self._match(step)
        if rule is None:
            return [frame]
        if rule.action == "drop":
            return []
        if rule.action == "duplicate":
            return [frame, frame]
        if rule.action == "truncate":
            return [frame[:max(0, len(frame) - rule.cut)]]
        if rule.action == "corrupt":
            off = min(rule.offset, len(frame) - 1)
            mutated = bytearray(frame)
            mutated[off] ^= (rule.xor or 0x01)
            return [bytes(mutated)]
        if rule.action == "delay":
            time.sleep(rule.delay)
            return [frame]
        if rule.action == "hang":
            time.sleep(HANG_SECONDS)
            return [frame]
        if rule.action == "kill":
            os._exit(KILL_EXIT_CODE)
        raise AssertionError(f"unhandled fault action {rule.action}")

    # -- protocol checkpoints --------------------------------------

    def checkpoint(self, step: str) -> None:
        """Crash-at-step seam: kill/hang/delay fire here; the frame
        mutations are meaningless between messages and ignored."""
        rule = self._match(step)
        if rule is None:
            return
        if rule.action == "kill":
            os._exit(KILL_EXIT_CODE)
        elif rule.action == "hang":
            time.sleep(HANG_SECONDS)
        elif rule.action == "delay":
            time.sleep(rule.delay)

    def on_net(self, step: str) -> Optional[FaultRule]:
        """The reliable-transport seam: fired by
        `net.transport.TcpTransport` once per outbound session frame,
        AFTER the frame enters the replay buffer and BEFORE the
        write — so a fired `conn_drop` forces the frame through the
        reconnect-and-replay path, which is the point.  kill/hang/
        delay behave as at any checkpoint; the NET_ACTIONS return the
        rule for the transport to enact (it owns the socket); the
        frame-mutation actions are meaningless below the seq/ack
        framing and ignored here."""
        rule = self._match(step)
        if rule is None:
            return None
        if rule.action == "kill":
            os._exit(KILL_EXIT_CODE)
        if rule.action == "hang":
            time.sleep(HANG_SECONDS)
            return None
        if rule.action == "delay":
            time.sleep(rule.delay)
            return None
        if rule.action in NET_ACTIONS:
            return rule
        return None

    def on_blob(self, step: str, blob: bytes) -> bytes:
        """Combined checkpoint + content seam for a blob-producing
        step (the service's `page_flush`): ONE (party, step) event,
        so a rule's `nth` counts seals, not internal hook calls.
        kill/hang/delay fire as process faults; truncate/corrupt
        mutate the produced bytes (modeling storage corruption —
        applied AFTER the caller's digest, which must catch it)."""
        rule = self._match(step)
        if rule is None:
            return blob
        if rule.action == "kill":
            os._exit(KILL_EXIT_CODE)
        if rule.action == "hang":
            time.sleep(HANG_SECONDS)
            return blob
        if rule.action == "delay":
            time.sleep(rule.delay)
            return blob
        if rule.action == "truncate":
            return blob[:max(0, len(blob) - rule.cut)]
        if rule.action == "corrupt":
            off = min(rule.offset, len(blob) - 1)
            mutated = bytearray(blob)
            mutated[off] ^= (rule.xor or 0x01)
            return bytes(mutated)
        raise ValueError(
            f"fault action {rule.action!r} does not apply to "
            f"step {step!r}")

    def on_disk(self, step: str, data: bytes) -> tuple:
        """Durable-storage seam: fired by the admission
        WAL once per write (`wal_append`, `data` = the encoded
        record) and once per fsync (`wal_fsync`, `data` empty).
        Returns ``(bytes_to_write, after)`` where `after` is
        ``"kill"`` when the process must die immediately after the
        (possibly shortened) bytes reach the OS — the short-write/
        torn-tail fault, which recovery must truncate-and-count.
        ``enospc``/``fsync_error`` raise the matching OSError so the
        WAL's reason-coded brownout path runs; ``corrupt`` flips a
        byte AFTER the record's CRC was computed (recovery must
        detect, attribute, and skip — never admit garbage);
        kill/hang/delay behave as at any checkpoint."""
        import errno

        rule = self._match(step)
        if rule is None:
            return (data, None)
        if rule.action == "kill":
            os._exit(KILL_EXIT_CODE)
        if rule.action == "hang":
            time.sleep(HANG_SECONDS)
            return (data, None)
        if rule.action == "delay":
            time.sleep(rule.delay)
            return (data, None)
        if rule.action == "short_write":
            return (data[:max(0, len(data) - rule.cut)], "kill")
        if rule.action == "enospc":
            raise OSError(errno.ENOSPC, "injected ENOSPC")
        if rule.action == "fsync_error":
            raise OSError(errno.EIO, "injected fsync failure")
        if rule.action == "corrupt":
            off = min(rule.offset, len(data) - 1)
            mutated = bytearray(data)
            mutated[off] ^= (rule.xor or 0x01)
            return (bytes(mutated), None)
        raise ValueError(
            f"fault action {rule.action!r} does not apply to "
            f"step {step!r}")

    def split_report_blob(self, step: str, blob: bytes) -> bytes:
        """Content-level mutation of ONE report blob inside the upload
        body (quarantine-path testing): truncate/corrupt apply to the
        bare blob, not a frame — so `offset` counts from byte 0."""
        rule = self._match(step)
        if rule is None:
            return blob
        if rule.action == "truncate":
            return blob[:max(0, len(blob) - rule.cut)]
        if rule.action == "corrupt":
            off = min(rule.offset, len(blob) - 1)
            mutated = bytearray(blob)
            mutated[off] ^= (rule.xor or 0x01)
            return bytes(mutated)
        raise ValueError(
            f"fault action {rule.action!r} does not apply to "
            f"step {step!r} (use truncate or corrupt)")


def injector_from_env(party: str) -> Optional[FaultInjector]:
    """The process's injector, or None when MASTIC_FAULTS is unset /
    names no rule for this party (the common, zero-overhead case)."""
    spec = os.environ.get("MASTIC_FAULTS")
    if not spec:
        return None
    inj = FaultInjector(parse_faults(spec), party)
    return inj if inj.rules else None


def frame_of(payload: bytes) -> bytes:
    """The framed form of a payload (for tests asserting what a fault
    does to the wire bytes)."""
    return struct.pack("<I", len(payload)) + payload
