"""Link transports under the session `Channel` (copy of
`mastic_tpu/net/transport.py`): the plain socket path, plus a
`ShapedTransport` that injects bandwidth, RTT and jitter so the
process-separated parties run over a link with wide-area realism
instead of an infinitely fast loopback, and the hostile-network-grade
`TcpTransport`: listener + dialer wrapped in stdlib-`ssl` mutual TLS
(per-party certs from `tools/certs.py`, CA pinning, both-ways name
check), carrying
sequence-numbered acked frames that survive a dropped connection
(`drivers/session.ReliableChannel` owns the redial policy; this layer
owns the wire state that makes replay after reconnect exactly-once).

The session layer stays the owner of framing, deadlines and fault
injection; a transport only decides HOW a fully framed byte string
reaches the socket.  `ShapedTransport` models the link on the send
side (both ends shape their own sends, so a bidirectional exchange
pays the shape in both directions):

    delay(frame) = rtt/2 + U(0, jitter) + len(frame)/bandwidth

with the jitter drawn from a SEEDED generator per transport — a
shaped run is replayable, exactly like the fault harness whose clock
(`time.sleep`) it borrows.  The `net_send` fault checkpoint fires per
frame before any pacing, so the whole drop/delay/truncate/corrupt/
hang matrix composes with shaping at the same seam.

`MASTIC_NET_SHAPE` arms it process-wide (every process of a session
parses the lever itself, like `MASTIC_FAULTS`):

    MASTIC_NET_SHAPE="bw=1m:rtt=20ms:jitter=2ms[:seed=N]"

bw is BYTES/second with optional k/m/g multiplier (0 = unlimited);
rtt/jitter accept a trailing "ms" or "s" (plain numbers are seconds).
"""

import contextlib
import os
import random
import socket
import ssl
import struct
import time
from dataclasses import dataclass
from typing import Callable, Optional


@dataclass
class LinkShape:
    """One direction of a shaped link (each end applies it to its own
    sends)."""

    bandwidth: float = 0.0   # bytes/second; 0 = unlimited
    rtt: float = 0.0         # full round-trip seconds (rtt/2 a send)
    jitter: float = 0.0      # max extra seconds, uniform, seeded
    seed: int = 0

    def __post_init__(self):
        if self.bandwidth < 0 or self.rtt < 0 or self.jitter < 0:
            raise ValueError("link shape values must be >= 0")


_BW_UNITS = {"k": 1e3, "m": 1e6, "g": 1e9}


def _parse_seconds(val: str, field: str) -> float:
    val = val.strip().lower()
    scale = 1.0
    if val.endswith("ms"):
        (val, scale) = (val[:-2], 1e-3)
    elif val.endswith("s"):
        val = val[:-1]
    try:
        return float(val) * scale
    except ValueError:
        raise ValueError(f"link shape {field} must be seconds or "
                         f"'<n>ms', got {val!r}")


def parse_shape(text: Optional[str]) -> Optional[LinkShape]:
    """Parse a MASTIC_NET_SHAPE spec; None/empty means unshaped.
    Unknown keys are errors — a typo'd shape that silently runs at
    loopback speed would make every WAN number vacuous (the
    parse_faults stance)."""
    if text is None or not text.strip():
        return None
    kwargs: dict = {}
    for chunk in text.split(":"):
        chunk = chunk.strip()
        if not chunk:
            continue
        if "=" not in chunk:
            raise ValueError(f"malformed link-shape field {chunk!r} "
                             f"(want key=value)")
        (key, val) = chunk.split("=", 1)
        key = key.strip()
        val = val.strip().lower()
        if key == "bw":
            scale = 1.0
            if val and val[-1] in _BW_UNITS:
                scale = _BW_UNITS[val[-1]]
                val = val[:-1]
            try:
                kwargs["bandwidth"] = float(val) * scale
            except ValueError:
                raise ValueError(f"link shape bw must be bytes/s "
                                 f"with optional k/m/g, got {val!r}")
        elif key in ("rtt", "jitter"):
            kwargs[key] = _parse_seconds(val, key)
        elif key == "seed":
            kwargs["seed"] = int(val)
        else:
            raise ValueError(f"unknown link-shape key {key!r} (must "
                             f"be bw, rtt, jitter or seed)")
    return LinkShape(**kwargs)


def shape_from_env() -> Optional[LinkShape]:
    return parse_shape(os.environ.get("MASTIC_NET_SHAPE"))


class Transport:
    """The plain path: frames go straight to the socket.  Counts
    bytes so callers can attribute wire traffic."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.bytes_sent = 0
        self.frames_sent = 0

    def send(self, frame: bytes) -> None:
        self.sock.sendall(frame)
        self.bytes_sent += len(frame)
        self.frames_sent += 1


class ShapedTransport(Transport):
    """Bandwidth/RTT/jitter pacing ahead of every frame, plus the
    `net_send` fault checkpoint — the link-layer twin of the
    checkpoints the party main loops fire between protocol steps."""

    def __init__(self, sock: socket.socket, shape: LinkShape,
                 injector=None):
        super().__init__(sock)
        self.shape = shape
        self.injector = injector
        self._rng = random.Random(shape.seed)
        self.slept_s = 0.0

    def send(self, frame: bytes) -> None:
        if self.injector is not None:
            self.injector.checkpoint("net_send")
        shape = self.shape
        delay = shape.rtt / 2.0
        if shape.jitter > 0:
            delay += self._rng.uniform(0.0, shape.jitter)
        if shape.bandwidth > 0:
            delay += len(frame) / shape.bandwidth
        if delay > 0:
            time.sleep(delay)
            self.slept_s += delay
        super().send(frame)


def for_socket(sock: socket.socket,
               shape: Optional[LinkShape] = None,
               injector=None) -> Optional[Transport]:
    """The transport for a just-built channel socket: None when
    unshaped (the Channel's inline sendall is the plain path — no
    wrapper object per frame on the fast path), a ShapedTransport
    when a shape is armed."""
    if shape is None:
        return None
    return ShapedTransport(sock, shape, injector)


# ---------------------------------------------------------------------
# Mutual TLS: per-party certs (tools/certs.py), CA pinning,
# name check on BOTH ends, every refusal reason-coded.
# ---------------------------------------------------------------------

# Reason codes a refused handshake carries in its SessionError detail
# (prefix form "reason: ..."); the mTLS negative-path tests assert
# each one.
TLS_WRONG_CA = "tls-wrong-ca"
TLS_EXPIRED = "tls-expired-cert"
TLS_NAME_MISMATCH = "tls-hostname-mismatch"
TLS_PLAINTEXT = "tls-plaintext"
TLS_TRUNCATED = "tls-truncated-handshake"
TLS_PEER_REFUSED = "tls-peer-refused"
TLS_FAILED = "tls-handshake-failed"

# OpenSSL X509 verify codes -> reason (ssl.SSLCertVerificationError
# .verify_code; the numeric codes are stable across OpenSSL 1.1/3.x).
_VERIFY_CODE_REASONS = {
    10: TLS_EXPIRED,            # certificate has expired
    62: TLS_NAME_MISMATCH,      # hostname mismatch
    18: TLS_WRONG_CA,           # self-signed certificate
    19: TLS_WRONG_CA,           # self-signed in chain
    20: TLS_WRONG_CA,           # no local certificate of the signer
    21: TLS_WRONG_CA,           # unable to verify leaf signature
}


def tls_reason(exc: BaseException) -> str:
    """Map a handshake exception to its refusal reason code."""
    if isinstance(exc, ssl.SSLCertVerificationError):
        reason = _VERIFY_CODE_REASONS.get(
            getattr(exc, "verify_code", None))
        if reason is not None:
            return reason
        msg = (getattr(exc, "verify_message", "") or str(exc)).lower()
        if "expired" in msg:
            return TLS_EXPIRED
        if "hostname" in msg:
            return TLS_NAME_MISMATCH
        return TLS_WRONG_CA
    if isinstance(exc, ssl.SSLEOFError):
        return TLS_TRUNCATED
    if isinstance(exc, ssl.SSLError):
        text = str(exc).upper()
        if "WRONG_VERSION_NUMBER" in text \
                or "UNKNOWN_PROTOCOL" in text \
                or "HTTP_REQUEST" in text or "HTTPS_PROXY" in text:
            return TLS_PLAINTEXT
        if "ALERT" in text:
            # The peer's verifier refused OUR credential (its own
            # reason code lands on its side); locally this is the
            # alert it sent back.
            return TLS_PEER_REFUSED
        if "EOF" in text:
            return TLS_TRUNCATED
        return TLS_FAILED
    if isinstance(exc, (ConnectionError, EOFError)):
        return TLS_TRUNCATED
    return TLS_FAILED


@dataclass
class TlsConfig:
    """One endpoint's mutual-TLS identity: its own cert/key pair, the
    pinned CA bundle every peer must chain to, and the peer NAME it
    expects on the other end of each link (the cert's CN/SAN as
    minted by tools/certs.py — "leader", "helper", "collector").

    Env form (`MASTIC_NET_TLS_CERT` / `_KEY` / `_CA`, optional
    `MASTIC_NET_TLS_NAME` override for the expected peer): unset cert
    means TLS is unarmed and `from_env` returns None — a PARTIAL set
    is an error, because a session that silently ran plaintext when
    the operator thought it armed TLS would be the worst outcome
    (the parse_faults stance)."""

    cert_file: str
    key_file: str
    ca_file: str
    peer_name: Optional[str] = None

    @classmethod
    def from_env(cls) -> Optional["TlsConfig"]:
        cert = os.environ.get("MASTIC_NET_TLS_CERT", "").strip()
        key = os.environ.get("MASTIC_NET_TLS_KEY", "").strip()
        ca = os.environ.get("MASTIC_NET_TLS_CA", "").strip()
        if not (cert or key or ca):
            return None
        if not (cert and key and ca):
            raise ValueError(
                "partial MASTIC_NET_TLS_* set: cert, key and ca must "
                "all be present (or none, for plaintext)")
        name = os.environ.get("MASTIC_NET_TLS_NAME", "").strip()
        return cls(cert, key, ca, peer_name=name or None)

    def expecting(self, peer_name: str) -> "TlsConfig":
        """This identity, pinned to expect `peer_name` on the link
        being built (one TlsConfig serves links to several peers)."""
        return TlsConfig(self.cert_file, self.key_file, self.ca_file,
                         peer_name=peer_name)

    def _load(self, ctx: ssl.SSLContext) -> None:
        ctx.load_cert_chain(self.cert_file, self.key_file)
        ctx.load_verify_locations(self.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED

    def server_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        self._load(ctx)
        return ctx

    def client_context(self) -> ssl.SSLContext:
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        self._load(ctx)
        ctx.check_hostname = True
        return ctx


def _cert_names(cert: dict) -> list:
    """CN + DNS SANs of a (verified) peer cert dict."""
    names = [v for (k, v) in cert.get("subjectAltName", ())
             if k == "DNS"]
    for rdn in cert.get("subject", ()):
        for (k, v) in rdn:
            if k == "commonName":
                names.append(v)
    return names


def _session_error(remote: str, step: str, kind: str, detail: str):
    from ..drivers import session as session_mod

    return session_mod.SessionError(remote, step, kind, detail)


def _refusal(remote: str, exc: BaseException, side: str):
    """A handshake failure as a reason-coded SessionError (kind
    `tls`, terminal — a bad credential does not heal on retry)."""
    from ..drivers import session as session_mod

    reason = tls_reason(exc)
    err = _session_error(remote, "tls_handshake",
                         session_mod.KIND_TLS,
                         f"{reason}: {side} handshake refused "
                         f"({type(exc).__name__}: {str(exc)[:160]})")
    err.reason = reason
    return err


def _count_refusal(reason: str, side: str) -> None:
    from ..obs.registry import get_registry

    get_registry().counter("mastic_tls_refusals_total",
                           reason=reason, side=side).inc()


class TcpListener:
    """A bound TCP listener whose accept path optionally terminates
    mutual TLS: handshake + client-cert CA pinning + peer-name check
    happen before any frame is read, every refusal reason-coded (and
    counted in `mastic_tls_refusals_total`) — a plaintext, wrong-CA,
    expired or misnamed dialer never gets a byte of session state."""

    def __init__(self, host: str, port: int,
                 tls: Optional[TlsConfig] = None, injector=None):
        self.sock = socket.create_server((host, port))
        self.tls = tls
        self.injector = injector
        self._ctx = tls.server_context() if tls is not None else None
        self.refusals: dict = {}   # reason -> count (tests read this)

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def close(self) -> None:
        with contextlib.suppress(OSError):   # idempotent teardown
            self.sock.close()

    def _note_refusal(self, reason: str) -> None:
        self.refusals[reason] = self.refusals.get(reason, 0) + 1
        _count_refusal(reason, "server")

    def accept(self, remote: str, timeout: float,
               handshake_timeout: float = 10.0) -> socket.socket:
        """One authenticated connection (raw when TLS is unarmed).
        Raises the reason-coded refusal instead of returning a
        half-trusted socket; the listener itself stays usable (the
        caller decides whether to keep accepting)."""
        from ..drivers import session as session_mod

        if self.injector is not None:
            self.injector.checkpoint("tls_handshake")
        self.sock.settimeout(timeout)
        try:
            (sock, _addr) = self.sock.accept()
        except socket.timeout:
            raise _session_error(remote, "accept",
                                 session_mod.KIND_TIMEOUT,
                                 f"no connection within {timeout:.1f}s")
        except OSError as exc:
            raise _session_error(remote, "accept",
                                 session_mod.KIND_CLOSED,
                                 f"accept failed: {exc}")
        if self._ctx is None:
            return sock
        try:
            sock.settimeout(handshake_timeout)
            tls_sock = self._ctx.wrap_socket(sock, server_side=True)
        except (ssl.SSLError, OSError, EOFError) as exc:
            sock.close()
            err = _refusal(remote, exc, "server")
            self._note_refusal(err.reason)
            raise err
        except BaseException:
            # Anything outside the reason-coded tuple (an injector
            # fault, KeyboardInterrupt mid-handshake) must not strand
            # the accepted fd on the floor.
            sock.close()
            raise
        try:
            names = _cert_names(tls_sock.getpeercert() or {})
            expected = self.tls.peer_name
            if expected is not None and expected not in names:
                err = _session_error(
                    remote, "tls_handshake", session_mod.KIND_TLS,
                    f"{TLS_NAME_MISMATCH}: peer cert names {names} do "
                    f"not include expected {expected!r}")
                err.reason = TLS_NAME_MISMATCH
                self._note_refusal(TLS_NAME_MISMATCH)
                raise err
        except BaseException:
            # The refusal (or any surprise past the handshake) closes
            # the wrapped socket — wrap_socket owns `sock` from here.
            tls_sock.close()
            raise
        return tls_sock


def tcp_dial(host: str, port: int, remote: str, timeout: float,
             tls: Optional[TlsConfig] = None,
             injector=None) -> socket.socket:
    """Deadline-bounded dial, TLS-wrapped when armed: CA pinning +
    server-name check (`ssl` SNI/hostname machinery over the party
    name the cert was minted for), refusals reason-coded."""
    from ..drivers import session as session_mod

    if injector is not None:
        injector.checkpoint("tls_handshake")
    try:
        sock = socket.create_connection((host, port), timeout=timeout)
    except socket.timeout:
        raise _session_error(remote, "connect",
                             session_mod.KIND_TIMEOUT,
                             f"no connection to {host}:{port} within "
                             f"{timeout:.1f}s")
    except OSError as exc:
        raise _session_error(remote, "connect",
                             session_mod.KIND_CLOSED,
                             f"connect to {host}:{port} failed: {exc}")
    if tls is None:
        return sock
    server_name = tls.peer_name or remote
    try:
        return tls.client_context().wrap_socket(
            sock, server_hostname=server_name)
    except (ssl.SSLError, OSError, EOFError) as exc:
        sock.close()
        err = _refusal(remote, exc, "client")
        _count_refusal(err.reason, "client")
        raise err


# ---------------------------------------------------------------------
# Sequence-numbered acked framing: the reliable link state
# that makes reconnect-and-replay exactly-once.
# ---------------------------------------------------------------------

# Frame types.  Every (re)connection opens with one RESUME in each
# direction; DATA frames carry (gen, seq, payload); ACK carries the
# receiver's cumulative next-expected seq (everything below it is
# delivered and may leave the replay buffer).
FRAME_RESUME = 0x01
FRAME_DATA = 0x02
FRAME_ACK = 0x03

_RESUME_FMT = "<B8sIQ"           # type, session id, gen, recv_next
_DATA_HDR_FMT = "<BIQI"          # type, gen, seq, payload length
_ACK_FMT = "<BIQ"                # type, gen, recv_next

# Replay-buffer sanity bound: the alternating session protocol keeps
# a handful of frames in flight; hitting this means a protocol bug,
# not load — fail loudly instead of growing.
MAX_UNACKED = 1024

# A dropped link redials up to this many times (exponential backoff,
# clamped to the round deadline) before the failure propagates; more
# generous than the protocol-retry budget because a partition is
# expected to HEAL, while a protocol error is not.
RECONNECT_ATTEMPTS = 8


class SessionRestart(Exception):
    """An accept-side resume handshake met a NEW session id: the peer
    abandoned the old session (collector respawn) and is opening a
    fresh one.  Carries the live, already-authenticated socket and
    the peer's RESUME fields so the server loop can adopt it without
    losing the connection."""

    def __init__(self, sock: socket.socket, session_id: bytes,
                 gen: int, recv_next: int):
        super().__init__("peer opened a new session")
        self.sock = sock
        self.session_id = session_id
        self.gen = gen
        self.recv_next = recv_next


def pack_resume(session_id: bytes, gen: int, seq: int) -> bytes:
    return struct.pack(_RESUME_FMT, FRAME_RESUME, session_id, gen,
                       seq)


def pack_data(gen: int, seq: int, payload: bytes) -> bytes:
    return struct.pack(_DATA_HDR_FMT, FRAME_DATA, gen, seq,
                       len(payload)) + payload


def pack_ack(gen: int, recv_next: int) -> bytes:
    return struct.pack(_ACK_FMT, FRAME_ACK, gen, recv_next)


class TcpTransport:
    """One end of a reliable, reconnecting party link.

    Owns: the live socket, the send-side sequence counter and replay
    buffer (unacked DATA frames), the receive-side `recv_next` cursor
    that makes redelivery after a reconnect exactly-once, and the
    (re)connect handshake.  `connect` is the one policy hook — a
    callable returning a fresh CONNECTED (and TLS-authenticated)
    socket: the dialing end redials, the accepting end re-accepts on
    its retained listener; this class cannot tell and does not care.

    The session layer (`drivers/session.ReliableChannel`) supplies
    attribution (remote/step), deadlines and the redial/backoff
    policy; fault injection reaches this layer through the
    `on_net` seam (conn_drop / partition / slow_loris) plus the
    `tls_handshake` checkpoint inside the connect callables.
    """

    def __init__(self, connect: Callable, remote: str,
                 injector=None, shape: Optional[LinkShape] = None,
                 session_id: Optional[bytes] = None,
                 accept_side: bool = False,
                 adopt: Optional[tuple] = None):
        self.connect = connect
        self.remote = remote
        self.injector = injector
        self.shape = shape
        self._shape_rng = (random.Random(shape.seed)
                          if shape is not None else None)
        # The dialer names the session (8 random bytes); the accept
        # side starts with None and adopts the dialer's id from its
        # first RESUME.  `adopt` seeds the first establish() with an
        # already-accepted socket whose RESUME was consumed (the
        # SessionRestart handoff): (sock, session, gen, recv_next).
        self.session_id = session_id
        self.accept_side = accept_side
        self._adopted = adopt
        self.sock: Optional[socket.socket] = None
        self.gen = 0
        self.send_seq = 0            # last assigned outbound seq
        self.recv_next = 1           # next inbound seq expected
        self.peer_acked = 1          # peer's cumulative next-expected
        self.unacked: dict = {}      # seq -> payload bytes
        self._inbound: list = []     # DATA payloads read while
        #                              draining acks out of order
        self.reconnects = 0
        self.replayed_frames = 0
        self.bytes_sent = 0
        self.bytes_received = 0
        self.partition_until = 0.0   # injected partition healing time
        self._loris_delay = 0.0      # injected stalled-writer delay

    # -- low-level I/O ---------------------------------------------

    def _write_raw(self, data: bytes) -> None:
        if self.shape is not None:
            delay = self.shape.rtt / 2.0
            if self.shape.jitter > 0:
                delay += self._shape_rng.uniform(
                    0.0, self.shape.jitter)
            if self.shape.bandwidth > 0:
                delay += len(data) / self.shape.bandwidth
            if delay > 0:
                time.sleep(delay)
        if self._loris_delay > 0:
            # Injected slow-loris: the writer stalls mid-frame, so
            # the reader sits on a half-delivered frame for the
            # stall — exactly the shape a wedged peer produces.
            stall = self._loris_delay
            self._loris_delay = 0.0
            self.sock.sendall(data[:1])
            time.sleep(stall)
            data = data[1:]
        self.sock.sendall(data)
        self.bytes_sent += len(data)

    def _read_exact(self, n: int, timeout: float) -> bytes:
        """n bytes or an exception; '' mid-read is a dropped link."""
        buf = bytearray()
        while len(buf) < n:
            self.sock.settimeout(timeout)
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionResetError(
                    f"link closed mid-frame ({len(buf)}/{n})")
            buf += chunk
            self.bytes_received += len(chunk)
        return bytes(buf)

    def _read_frame(self, timeout: float) -> tuple:
        """-> (frame type, fields...).  Raises OSError flavors on a
        dead link, socket.timeout on an idle one."""
        head = self._read_exact(1, timeout)
        kind = head[0]
        if kind == FRAME_DATA:
            rest = self._read_exact(
                struct.calcsize(_DATA_HDR_FMT) - 1, timeout)
            (gen, seq, length) = struct.unpack("<IQI", rest)
            payload = self._read_exact(length, timeout) if length \
                else b""
            return (FRAME_DATA, gen, seq, payload)
        if kind == FRAME_ACK:
            rest = self._read_exact(
                struct.calcsize(_ACK_FMT) - 1, timeout)
            (gen, recv_next) = struct.unpack("<IQ", rest)
            return (FRAME_ACK, gen, recv_next)
        if kind == FRAME_RESUME:
            rest = self._read_exact(
                struct.calcsize(_RESUME_FMT) - 1, timeout)
            (session_id, gen, recv_next) = struct.unpack("<8sIQ",
                                                         rest)
            return (FRAME_RESUME, session_id, gen, recv_next)
        raise ConnectionResetError(f"unknown frame type {kind:#x}")

    # -- connection lifecycle --------------------------------------

    def connected(self) -> bool:
        return self.sock is not None

    def kill_socket(self) -> None:
        """Drop the link NOW (fault injection and teardown): the next
        send/recv sees a dead socket and runs the resume path."""
        if self.sock is not None:
            # Idempotent kill of a possibly-dead socket; the
            # reconnect machinery is the recorded outcome.
            with contextlib.suppress(OSError):
                self.sock.close()
            self.sock = None

    def establish(self, handshake_timeout: float) -> int:
        """Connect (or re-accept) + RESUME handshake + replay.
        Returns the number of frames replayed.

        The dialer speaks first (send RESUME, read the reply); the
        accept side reads first, so it can tell a RESUMING peer from
        one opening a NEW session BEFORE committing a reply — the
        latter raises SessionRestart carrying the live socket and
        the consumed RESUME for the server loop to adopt."""
        if time.monotonic() < self.partition_until:
            raise _session_error(
                self.remote, "reconnect", _kind_closed(),
                f"link partitioned for another "
                f"{self.partition_until - time.monotonic():.2f}s")
        old = self.sock
        self.sock = None
        if old is not None:
            with contextlib.suppress(OSError):
                old.close()   # superseded socket
        if self._adopted is not None:
            (sock, peer_session, _peer_gen, peer_next) = \
                self._adopted
            self._adopted = None
            frame_read = True
        else:
            sock = self.connect()
            frame_read = False
        try:
            sock.settimeout(handshake_timeout)
            self.sock = sock   # _read_frame/_write_raw target
            if not self.accept_side:
                sock.sendall(pack_resume(self.session_id,
                                         self.gen + 1,
                                         self.recv_next))
            if not frame_read:
                frame = self._read_frame(handshake_timeout)
                if frame[0] != FRAME_RESUME:
                    self.sock = None
                    sock.close()
                    raise _session_error(
                        self.remote, "reconnect", _kind_protocol(),
                        f"peer opened with frame type "
                        f"{frame[0]:#x}, not RESUME")
                (_kind, peer_session, _peer_gen, peer_next) = frame
            if self.accept_side:
                if self.session_id is None:
                    self.session_id = peer_session
                elif peer_session != self.session_id:
                    self.sock = None
                    raise SessionRestart(sock, peer_session,
                                         _peer_gen, peer_next)
                sock.sendall(pack_resume(self.session_id,
                                         self.gen + 1,
                                         self.recv_next))
            elif peer_session != self.session_id:
                self.sock = None
                sock.close()
                raise _session_error(
                    self.remote, "reconnect", _kind_protocol(),
                    "peer answered with a different session id")
        except ssl.SSLError as exc:
            # TLS 1.3 lets the dialer "finish" before the listener's
            # verdict: a refused credential surfaces as an alert on
            # the first post-handshake read/write.  Classify it as
            # the terminal TLS refusal it is — redialing with the
            # same bad credential would only hammer the listener.
            self.sock = None
            sock.close()
            raise _refusal(self.remote, exc, "client")
        except (OSError, socket.timeout) as exc:
            self.sock = None
            sock.close()
            raise _session_error(
                self.remote, "reconnect", _kind_closed(),
                f"resume handshake failed: {exc}")
        self.gen += 1
        # Everything the peer already holds leaves the replay buffer;
        # the rest replays in order — the peer's recv_next cursor
        # discards any duplicate, so redelivery is exactly-once.
        self.peer_acked = max(self.peer_acked, peer_next)
        for seq in sorted(self.unacked):
            if seq < peer_next:
                del self.unacked[seq]
        replayed = 0
        try:
            for seq in sorted(self.unacked):
                self._write_raw(pack_data(self.gen, seq,
                                          self.unacked[seq]))
                replayed += 1
        except (OSError, socket.timeout) as exc:
            self.kill_socket()
            raise _session_error(
                self.remote, "reconnect", _kind_closed(),
                f"replay failed after resume: {exc}")
        self.replayed_frames += replayed
        return replayed

    # -- fault seam ------------------------------------------------

    def apply_net_fault(self, step: str) -> None:
        """Fire the per-send network fault seam (faults.on_net):
        conn_drop kills the link, partition kills it and refuses
        redial for `delay` seconds (both directions die with the
        socket), slow_loris stalls the next write mid-frame."""
        if self.injector is None:
            return
        rule = self.injector.on_net(step)
        if rule is None:
            return
        if rule.action == "conn_drop":
            self.kill_socket()
        elif rule.action == "partition":
            self.kill_socket()
            self.partition_until = time.monotonic() + rule.delay
        elif rule.action == "slow_loris":
            self._loris_delay = rule.delay

    # -- the reliable send/recv the channel builds on --------------

    def buffer_payload(self, payload: bytes) -> int:
        """Assign the next seq and enter the payload into the replay
        buffer; the caller then pushes it (and owns reconnects)."""
        if len(self.unacked) >= MAX_UNACKED:
            raise _session_error(
                self.remote, "send", _kind_protocol(),
                f"replay buffer exceeded {MAX_UNACKED} frames — "
                f"the peer is not acking")
        self.send_seq += 1
        self.unacked[self.send_seq] = payload
        return self.send_seq

    def push(self, seq: int, timeout: float) -> None:
        """Write one buffered frame (raises on a dead link; the
        caller reconnects and the frame replays from the buffer)."""
        self.sock.settimeout(timeout)
        self._write_raw(pack_data(self.gen, seq, self.unacked[seq]))

    def pull(self, timeout: float) -> Optional[bytes]:
        """One in-order DATA payload (acking it), or None when only
        bookkeeping frames arrived within this read (caller loops).
        Duplicates from a replay are acked and discarded."""
        if self._inbound:
            return self._inbound.pop(0)
        frame = self._read_frame(timeout)
        if frame[0] == FRAME_ACK:
            (_kind, _gen, peer_next) = frame
            self.peer_acked = max(self.peer_acked, peer_next)
            for seq in sorted(self.unacked):
                if seq < peer_next:
                    del self.unacked[seq]
            return None
        if frame[0] == FRAME_DATA:
            (_kind, _gen, seq, payload) = frame
            if seq < self.recv_next:         # replayed duplicate
                self._send_ack(timeout)
                return None
            if seq != self.recv_next:
                raise _session_error(
                    self.remote, "recv", _kind_protocol(),
                    f"sequence gap: got {seq}, expected "
                    f"{self.recv_next} (frames lost inside a "
                    f"connection)")
            self.recv_next += 1
            self._send_ack(timeout)
            return payload
        raise _session_error(
            self.remote, "recv", _kind_protocol(),
            "RESUME frame mid-connection")

    def _send_ack(self, timeout: float) -> None:
        try:
            self.sock.settimeout(timeout)
            self._write_raw(pack_ack(self.gen, self.recv_next))
        except (OSError, socket.timeout):
            # The payload is already delivered locally; a failed ack
            # only means the peer replays it after reconnect and the
            # recv_next cursor discards the duplicate.
            self.kill_socket()

    def close(self) -> None:
        self.kill_socket()


def _kind_closed() -> str:
    from ..drivers import session as session_mod

    return session_mod.KIND_CLOSED


def _kind_protocol() -> str:
    from ..drivers import session as session_mod

    return session_mod.KIND_PROTOCOL
