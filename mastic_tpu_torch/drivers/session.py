"""Session layer for the process-separated parties (copy of
`mastic_tpu/drivers/session.py`): deadlines, structured errors, bounded
retry, and the reliable channel.

Everything the transport can do to an aggregation session — a peer
that hangs, dies, truncates, or floods — must surface as a
`SessionError` naming the party and the protocol step, in bounded
time.  This module is that contract:

* `SessionError` — the one exception type the session layer raises for
  transport/protocol faults, carrying (party, step, kind) so the
  collector can attribute and the supervisor can decide retryability;
* `Deadline` — a monotonic budget threaded through every blocking call
  of a round, so N sequential exchanges share one bound instead of
  multiplying per-call timeouts;
* `SessionConfig` — the timeout/retry lever set (`MASTIC_SESSION_*`,
  `MASTIC_ROUND_DEADLINE`, `MASTIC_RETRY_BACKOFF`);
* `Channel` — a framed socket channel (same 4-byte LE length framing
  as `wire.frame`) whose every send/recv takes a deadline; the only
  place in the drivers that touches a raw socket read;
* `with_retries` — bounded exponential backoff for the idempotent
  exchanges (upload, agg-param dispatch, agg-share fetch — prep shares
  are recomputable from the marshaled report arrays, so a round
  restart is always safe);
* `ReliableChannel` — the same API over `net.transport.TcpTransport`:
  sequence-numbered, acked, replay-buffered frames that survive a
  dropped connection by reconnect-and-replay, optionally over mutual
  TLS (`reliable_connect` / `reliable_accept`).

The fault-injection harness (`drivers/faults.py`) plugs in at the
Channel seam: an injector mutates outbound frames and fires at
protocol checkpoints, which is how the fault tests drive every failure
class through this layer.
"""

import os
import socket
import struct
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..obs import trace as obs_trace
from ..obs.registry import get_registry

# Error kinds a SessionError carries.  `timeout` and `closed` are the
# retryable transport kinds (the peer may come back after a respawn);
# `malformed`, `crashed` and `protocol` are terminal for the attempt
# but still retryable at the session level after a respawn.  `tls` is
# terminal outright: a wrong-CA, expired or misnamed credential does
# not heal on redial, so retrying would only hammer the listener
# (the refusal reason code rides in the detail, `tls-*`).
KIND_TIMEOUT = "timeout"
KIND_CLOSED = "closed"
KIND_MALFORMED = "malformed"
KIND_CRASHED = "crashed"
KIND_PROTOCOL = "protocol"
KIND_TLS = "tls"

RETRYABLE_KINDS = (KIND_TIMEOUT, KIND_CLOSED, KIND_CRASHED)


class SessionError(RuntimeError):
    """A transport or protocol fault, attributed to a party and a
    protocol step.  Replaces the bare `assert`s the session layer
    used to have (asserts vanish under ``python -O`` and attribute
    nothing)."""

    def __init__(self, party: str, step: str, kind: str,
                 detail: str = ""):
        self.party = party
        self.step = step
        self.kind = kind
        self.detail = detail
        super().__init__(
            f"[party={party} step={step} kind={kind}]"
            + (f" {detail}" if detail else ""))

    def retryable(self) -> bool:
        return self.kind in RETRYABLE_KINDS


class Deadline:
    """Monotonic time budget shared by a sequence of blocking calls.

    `None` seconds means unbounded (remaining() returns None); an
    expired deadline makes the next blocking call fail immediately
    instead of granting it a fresh per-call timeout.
    """

    __slots__ = ("_end",)

    def __init__(self, seconds: Optional[float]):
        self._end = (None if seconds is None
                     else time.monotonic() + seconds)

    def remaining(self) -> Optional[float]:
        if self._end is None:
            return None
        return max(0.0, self._end - time.monotonic())

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw)
    except ValueError:
        raise ValueError(f"{name} must be a number, got {raw!r}")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name} must be an integer, got {raw!r}")


@dataclass
class SessionConfig:
    """Timeout/retry levers (env forms in `from_env`).

    `exchange_timeout` bounds ONE blocking send/recv; `round_deadline`
    is the whole-round budget the collector threads through every
    exchange of a round (a first round that builds the kernels
    legitimately takes minutes — the defaults leave room for that;
    the fault tests shrink them to seconds).
    """

    connect_timeout: float = 60.0     # accept()/create_connection
    exchange_timeout: float = 600.0   # one send/recv on a channel
    ack_timeout: float = 60.0         # upload-ack window (marshaling
    #                                   is cheap next to prep compile)
    round_deadline: float = 1800.0    # budget for one whole round
    shutdown_timeout: float = 30.0    # proc.wait at close()
    retries: int = 2                  # extra attempts per exchange
    backoff: float = 0.25             # base of the exponential backoff

    @classmethod
    def from_env(cls) -> "SessionConfig":
        exchange = _env_float("MASTIC_SESSION_TIMEOUT", 600.0)
        return cls(
            connect_timeout=min(60.0, exchange),
            exchange_timeout=exchange,
            ack_timeout=min(60.0, exchange),
            round_deadline=_env_float("MASTIC_ROUND_DEADLINE", 1800.0),
            shutdown_timeout=min(30.0, exchange),
            retries=_env_int("MASTIC_SESSION_RETRIES", 2),
            backoff=_env_float("MASTIC_RETRY_BACKOFF", 0.25),
        )

    def child_env(self) -> dict:
        """Env overrides that make spawned party processes obey this
        config (they rebuild it with from_env)."""
        return {
            "MASTIC_SESSION_TIMEOUT": str(self.exchange_timeout),
            "MASTIC_ROUND_DEADLINE": str(self.round_deadline),
            "MASTIC_SESSION_RETRIES": str(self.retries),
            "MASTIC_RETRY_BACKOFF": str(self.backoff),
        }


class Channel:
    """Framed messages over a socket, every call deadline-bounded.

    `remote` names the peer for error attribution ("leader", "helper",
    "collector"); `injector` (drivers/faults.py) mutates outbound
    frames when the MASTIC_FAULTS lever is armed.  Framing matches
    `wire.frame`: 4-byte LE length prefix.

    `transport` (`net/transport.py`) owns HOW a
    framed byte string reaches the socket: None is the plain inline
    sendall; a `ShapedTransport` paces every frame by the configured
    bandwidth/RTT/jitter (`MASTIC_NET_SHAPE`) and fires the
    `net_send` fault checkpoint — network-separated parties over a
    link with wide-area realism.  `sent_bytes`/`recv_bytes` count
    wire traffic either way (`ProcessCollector.wire_bytes`
    reads them).
    """

    def __init__(self, sock: socket.socket, remote: str,
                 timeout: float = 600.0, injector=None,
                 transport=None):
        self.sock = sock
        self.remote = remote
        self.timeout = timeout
        self.injector = injector
        self.transport = transport
        self.sent_bytes = 0
        self.recv_bytes = 0
        # Blocking sockets with per-call settimeout; disable Nagle so
        # small protocol messages don't wait on the ack clock.
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            self._note_best_effort("setsockopt")

    # -- plumbing --------------------------------------------------

    def _note_best_effort(self, what: str) -> None:
        """Best-effort socket options may fail on exotic transports
        (AF_UNIX socketpairs in the tests); record, don't fail."""
        self._best_effort_failure = what

    def _budget(self, deadline: Optional[Deadline], step: str,
                timeout: Optional[float] = None) -> float:
        per_call = self.timeout if timeout is None else timeout
        if deadline is None:
            return per_call
        rem = deadline.remaining()
        if rem is None:
            return per_call
        if rem <= 0.0:
            raise SessionError(self.remote, step, KIND_TIMEOUT,
                               "session deadline exhausted")
        return min(rem, per_call)

    def _recv_exact(self, n: int, step: str,
                    deadline: Optional[Deadline],
                    timeout: Optional[float] = None) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            self.sock.settimeout(
                self._budget(deadline, step, timeout))
            try:
                chunk = self.sock.recv(n - len(buf))
            except socket.timeout:
                raise SessionError(
                    self.remote, step, KIND_TIMEOUT,
                    f"no data for {self.timeout:.1f}s "
                    f"({len(buf)}/{n} bytes of the current frame)")
            except OSError as exc:
                raise SessionError(self.remote, step, KIND_CLOSED,
                                   f"socket error: {exc}")
            if not chunk:
                raise SessionError(
                    self.remote, step, KIND_CLOSED,
                    f"connection closed mid-frame "
                    f"({len(buf)}/{n} bytes)")
            buf += chunk
            self.recv_bytes += len(chunk)
        return bytes(buf)

    # -- framed messages -------------------------------------------

    def send_msg(self, payload: bytes, step: str = "send",
                 deadline: Optional[Deadline] = None) -> None:
        frames = [struct.pack("<I", len(payload)) + payload]
        if self.injector is not None:
            frames = self.injector.on_send(step, frames[0])
        for frame in frames:
            self.sock.settimeout(self._budget(deadline, step))
            try:
                if self.transport is not None:
                    self.transport.send(frame)
                else:
                    self.sock.sendall(frame)
                self.sent_bytes += len(frame)
            except socket.timeout:
                raise SessionError(self.remote, step, KIND_TIMEOUT,
                                   "send blocked past the deadline")
            except OSError as exc:
                raise SessionError(self.remote, step, KIND_CLOSED,
                                   f"send failed: {exc}")

    def recv_msg(self, step: str = "recv",
                 deadline: Optional[Deadline] = None,
                 timeout: Optional[float] = None
                 ) -> Optional[bytes]:
        """One framed message; None on clean EOF at a frame boundary
        (the peer closed between messages — a legal shutdown).
        `timeout` overrides the channel's per-call timeout for this
        read (e.g. the short upload-ack window vs the long round
        reply)."""
        budget = self._budget(deadline, step, timeout)
        self.sock.settimeout(budget)
        try:
            first = self.sock.recv(4)
        except socket.timeout:
            raise SessionError(self.remote, step, KIND_TIMEOUT,
                               f"no message for {budget:.1f}s")
        except OSError as exc:
            raise SessionError(self.remote, step, KIND_CLOSED,
                               f"socket error: {exc}")
        if not first:
            return None
        self.recv_bytes += len(first)
        header = first if len(first) == 4 else \
            first + self._recv_exact(4 - len(first), step, deadline,
                                     timeout)
        (length,) = struct.unpack("<I", header)
        return self._recv_exact(length, step, deadline, timeout)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            self._note_best_effort("close")


def _make_transport(sock: socket.socket, shaper, injector):
    """Wrap a just-built channel socket in a shaped transport when a
    link shape is armed (None stays the plain inline path)."""
    if shaper is None:
        return None
    from ..net.transport import for_socket

    return for_socket(sock, shaper, injector)


def connect(host: str, port: int, remote: str, timeout: float,
            exchange_timeout: float, injector=None,
            shaper=None) -> Channel:
    """Deadline-bounded create_connection -> Channel.  `shaper` is a
    `net.transport.LinkShape` (MASTIC_NET_SHAPE) applied to this
    end's sends."""
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except socket.timeout:
        raise SessionError(remote, "connect", KIND_TIMEOUT,
                           f"no connection to {host}:{port} within "
                           f"{timeout:.1f}s")
    except OSError as exc:
        raise SessionError(remote, "connect", KIND_CLOSED,
                           f"connect to {host}:{port} failed: {exc}")
    return Channel(sock, remote, exchange_timeout, injector,
                   transport=_make_transport(sock, shaper, injector))


def accept(server: socket.socket, remote: str, timeout: float,
           exchange_timeout: float, injector=None,
           shaper=None) -> Channel:
    """Deadline-bounded server.accept() -> Channel."""
    server.settimeout(timeout)
    try:
        (sock, _addr) = server.accept()
    except socket.timeout:
        raise SessionError(remote, "accept", KIND_TIMEOUT,
                           f"no connection within {timeout:.1f}s")
    except OSError as exc:
        raise SessionError(remote, "accept", KIND_CLOSED,
                           f"accept failed: {exc}")
    return Channel(sock, remote, exchange_timeout, injector,
                   transport=_make_transport(sock, shaper, injector))


def with_retries(fn: Callable, attempts: int, backoff: float,
                 on_retry: Optional[Callable] = None,
                 deadline: Optional[Deadline] = None,
                 event: str = "session_retry",
                 extra: Optional[Callable] = None):
    """Run `fn()` with up to `attempts` retries on retryable
    SessionErrors, sleeping backoff * 2^i between attempts.
    `on_retry(err, attempt)` observes each retry (the metrics
    counters hook in here).

    With a `deadline`, the backoff sleep is clamped to the remaining
    budget, and an exhausted budget fails fast with the last error's
    attribution instead of sleeping through it — previously the loop
    slept the FULL exponential backoff even when the deadline had
    less remaining, so a caller's bounded operation could overrun
    its budget by up to the whole backoff ladder.

    Telemetry: every retry lands as a span event carrying
    the cause (party/step/kind/detail), the backoff actually slept
    and the remaining deadline budget — previously the cause was
    handed to `on_retry` and then LOST unless that callback kept it;
    the trace now shows the whole chain.  An exhausted budget emits
    `<event>_exhausted` before the attributed failure.

    `event` names the span event: protocol
    retries emit the default ``session_retry``; the reliable
    transport's redial ladder passes ``session_reconnect`` so traces
    separate transport recovery from protocol retry — `extra()` then
    contributes the transport's redial/replay attribution (e.g.
    `frames_replayed`) to every emitted event.  Only protocol
    retries feed the `mastic_session_retries_total` /
    `_timeouts_total` series; completed reconnects have their own
    counters, incremented by the channel when the link is back."""
    attempt = 0
    while True:
        try:
            return fn()
        except SessionError as err:
            if not err.retryable() or attempt >= attempts:
                raise
            pause = backoff * (2 ** attempt)
            rem = (deadline.remaining() if deadline is not None
                   else None)
            fields = dict(extra()) if extra is not None else {}
            if rem is not None:
                if rem <= 0.0:
                    obs_trace.event(
                        f"{event}_exhausted",
                        party=err.party, step=err.step,
                        kind=err.kind, attempts=attempt + 1,
                        **fields)
                    raise SessionError(
                        err.party, err.step, KIND_TIMEOUT,
                        f"retry budget exhausted after "
                        f"{attempt + 1} attempt(s); last error: "
                        f"[{err.kind}] {err.detail}")
                pause = min(pause, rem)
            obs_trace.event(
                event, party=err.party, step=err.step,
                kind=err.kind, detail=err.detail[:200],
                attempt=attempt + 1, backoff_s=round(pause, 4),
                deadline_remaining_s=(None if rem is None
                                      else round(rem, 3)),
                **fields)
            if event == "session_retry":
                get_registry().counter(
                    "mastic_session_retries_total", tenant="").inc()
                if err.kind == KIND_TIMEOUT:
                    get_registry().counter(
                        "mastic_session_timeouts_total",
                        tenant="").inc()
            if on_retry is not None:
                on_retry(err, attempt)
            time.sleep(pause)
            attempt += 1


# ---------------------------------------------------------------------
# Reconnect-and-replay sessions: the Channel API over the
# reliable TCP/mTLS transport.
# ---------------------------------------------------------------------

class ReliableChannel:
    """Channel-compatible framing over `net.transport.TcpTransport`:
    every payload rides a sequence-numbered, acked, replay-buffered
    frame, so a dropped connection or a healed partition costs a
    redial — never the round.

    On a dead link the channel redials through `with_retries`
    (exponential backoff, clamped to the caller's round `Deadline`,
    `session_reconnect` span events) and resumes from the last acked
    frame; the peer's `recv_next` cursor discards replayed duplicates,
    so delivery after any number of reconnects is exactly-once and a
    disturbed collection is bit-identical to an undisturbed one.
    Recovery is attributed: `reconnects` / `replayed_frames` feed
    `RoundMetrics` and the `mastic_session_reconnects_total` /
    `mastic_frames_replayed_total` series.

    A recv TIMEOUT does not redial — a peer deep in a prep compile is
    slow, not gone; only a dead socket (EOF, reset, refused) enters
    the reconnect path.  `shutdown` sends are fire-and-forget: the
    peer may already be gone, and redialing to deliver a goodbye
    would invert the teardown contract."""

    def __init__(self, transport, remote: str,
                 config: "SessionConfig"):
        self.tp = transport
        self.remote = remote
        self.config = config
        self.timeout = config.exchange_timeout
        self._established_once = False

    # -- Channel-API surface ---------------------------------------

    @property
    def sent_bytes(self) -> int:
        return self.tp.bytes_sent

    @property
    def recv_bytes(self) -> int:
        return self.tp.bytes_received

    @property
    def reconnects(self) -> int:
        return self.tp.reconnects

    @property
    def replayed_frames(self) -> int:
        return self.tp.replayed_frames

    def close(self) -> None:
        self.tp.close()

    # -- connection management -------------------------------------

    def _budget(self, deadline: Optional[Deadline], step: str,
                timeout: Optional[float] = None) -> float:
        per_call = self.timeout if timeout is None else timeout
        if deadline is None:
            return per_call
        rem = deadline.remaining()
        if rem is None:
            return per_call
        if rem <= 0.0:
            raise SessionError(self.remote, step, KIND_TIMEOUT,
                               "session deadline exhausted")
        return min(rem, per_call)

    def ensure_connected(self,
                         deadline: Optional[Deadline] = None,
                         step: str = "connect") -> None:
        if not self.tp.connected():
            self._reconnect(deadline, step)

    def _reconnect(self, deadline: Optional[Deadline],
                   step: str) -> None:
        """Redial (or re-accept) + resume, under the caller's
        deadline, with `session_reconnect` events per failed attempt
        and one summary event once the link is back."""
        from ..net.transport import RECONNECT_ATTEMPTS

        tp = self.tp
        first = not self._established_once

        def attempt():
            budget = self._budget(deadline, step,
                                  self.config.connect_timeout)
            return tp.establish(handshake_timeout=budget)

        replayed = with_retries(
            attempt, RECONNECT_ATTEMPTS, self.config.backoff,
            deadline=deadline, event="session_reconnect",
            extra=lambda: {"remote": self.remote,
                           "frames_replayed": tp.replayed_frames})
        self._established_once = True
        if first:
            return
        tp.reconnects += 1
        obs_trace.event(
            "session_reconnect", party=self.remote, step=step,
            kind="resumed", gen=tp.gen, redials=tp.reconnects,
            frames_replayed_now=replayed,
            frames_replayed=tp.replayed_frames)
        get_registry().counter("mastic_session_reconnects_total",
                               tenant="").inc()
        if replayed:
            get_registry().counter("mastic_frames_replayed_total",
                                   tenant="").inc(replayed)

    # -- framed messages -------------------------------------------

    def send_msg(self, payload: bytes, step: str = "send",
                 deadline: Optional[Deadline] = None) -> None:
        tp = self.tp
        if step == "shutdown":
            try:
                if tp.connected():
                    seq = tp.buffer_payload(payload)
                    tp.push(seq, self._budget(deadline, step))
            except (OSError, socket.timeout) as exc:
                raise SessionError(self.remote, step, KIND_CLOSED,
                                   f"send failed: {exc}")
            return
        seq = tp.buffer_payload(payload)
        # The fault seam fires with the frame already in the replay
        # buffer: an injected conn_drop/partition recovers through
        # reconnect-and-replay, never by losing the frame.
        tp.apply_net_fault(step)
        while True:
            self.ensure_connected(deadline, step)
            try:
                tp.push(seq, self._budget(deadline, step))
                return
            except socket.timeout:
                raise SessionError(self.remote, step, KIND_TIMEOUT,
                                   "send blocked past the deadline")
            except OSError:
                tp.kill_socket()   # dead link: redial and replay

    def recv_msg(self, step: str = "recv",
                 deadline: Optional[Deadline] = None,
                 timeout: Optional[float] = None
                 ) -> Optional[bytes]:
        tp = self.tp
        while True:
            self.ensure_connected(deadline, step)
            budget = self._budget(deadline, step, timeout)
            try:
                payload = tp.pull(budget)
            except socket.timeout:
                raise SessionError(self.remote, step, KIND_TIMEOUT,
                                   f"no message for {budget:.1f}s")
            except OSError:
                tp.kill_socket()   # dead link: redial, peer replays
                continue
            if payload is not None:
                return payload


def reliable_connect(host: str, port: int, remote: str,
                     config: SessionConfig, tls=None, injector=None,
                     shaper=None,
                     deadline: Optional[Deadline] = None
                     ) -> ReliableChannel:
    """Dial a party's reliable listener: fresh session id, mTLS when
    `tls` is armed (a `net.transport.TlsConfig` expecting `remote`'s
    certified name), reconnect-and-replay owned by the returned
    channel for the rest of the session."""
    from ..net.transport import TcpTransport, tcp_dial

    tls_for_peer = tls.expecting(remote) if tls is not None else None

    def dial():
        return tcp_dial(host, port, remote, config.connect_timeout,
                        tls=tls_for_peer, injector=injector)

    tp = TcpTransport(dial, remote, injector=injector, shape=shaper,
                      session_id=os.urandom(8))
    chan = ReliableChannel(tp, remote, config)
    chan.ensure_connected(deadline, "connect")
    return chan


def reliable_accept(listener, remote: str, config: SessionConfig,
                    injector=None, shaper=None,
                    deadline: Optional[Deadline] = None,
                    restart=None) -> ReliableChannel:
    """The accept side of a reliable link: the retained
    `net.transport.TcpListener` re-authenticates every (re)dial; the
    transport adopts the dialer's session id on first RESUME.  A
    `net.transport.SessionRestart` (`restart`) seeds the channel
    with the live socket and already-consumed RESUME of a peer that
    opened a NEW session, so a server loop hands over without losing
    the connection."""
    from ..net.transport import TcpTransport

    def reaccept():
        return listener.accept(remote, config.connect_timeout)

    adopt = None
    session_id = None
    if restart is not None:
        session_id = restart.session_id
        adopt = (restart.sock, restart.session_id, restart.gen,
                 restart.recv_next)
    tp = TcpTransport(reaccept, remote, injector=injector,
                      shape=shaper, session_id=session_id,
                      accept_side=True, adopt=adopt)
    chan = ReliableChannel(tp, remote, config)
    chan.ensure_connected(deadline, "accept")
    return chan
