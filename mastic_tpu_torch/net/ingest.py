"""The DAP-shaped upload endpoint (copy of `mastic_tpu/net/ingest.py`): a
threaded HTTP front that turns `CollectorService.submit()` into a
network service.

Framing follows the DAP upload flow shape (draft-ietf-ppm-dap: the
client PUTs one media-typed report to a per-task resource and gets a
status code, never a body it must parse to learn success):

    PUT /v1/tenants/{tenant}/reports
        Content-Type: application/mastic-report-bundle
        <wire.frame(leader view) || wire.frame(helper view)>

    201 admitted        {"status": "admitted"}
    202 queued          {"status": "queued"}     (ingest front armed:
                        the verdict lands asynchronously in counters)
    400 quarantined     {"error": "quarantined", "reason": <reason code>}
    404 unknown tenant  {"error": "unknown-tenant"}
    411 no length       {"error": "length-required"}
    413 oversized       {"error": "body-too-large", "limit_bytes": N}
    415 wrong media     {"error": "unsupported-media-type", ...}
    429 shed            {"error": "shed", "reason": <shed reason>}
                        + Retry-After     (quota, queue-full, rate)
    503 overloaded      {"error": "shed", "reason":
                        "connections-exhausted"} + Retry-After
    503 brownout        {"error": "shed", "reason": "wal-full" |
                        "wal-degraded"} + Retry-After  (the
                        admission WAL cannot make the upload durable —
                        ENOSPC / fsync failure; reads and status keep
                        serving, acked reports stay safe)

Every error body is structured JSON built from FIXED strings, the
reason-code names and integer limits — nothing derived from tenant
key material or report contents crosses back out (the SF004
secret-flow pass covers this module; the error path is proven
secret-free, not assumed).  Every refusal lands in the tenant's
`ServiceCounters.shed_reasons` / quarantine ledger via the service
seam, and every request increments
`mastic_net_http_requests_total{code}` and observes
`mastic_net_admission_latency_ms` — the door is never silent.

Fault injection (`MASTIC_FAULTS`, party ``collector``) reaches this
edge: checkpoint ``http_accept`` fires per request (kill/hang/delay),
and ``http_body`` is an `on_blob` content seam over the received body
(truncate/corrupt model a mangled upload in flight — which must
quarantine with an attributed reason, never admit).

The server is a stdlib `ThreadingHTTPServer` (the statusz idiom): a
daemon thread per connection, every socket read deadline-bounded
(`NetConfig.io_timeout`), concurrency bounded by the admission
controller's connection ceiling.  TLS termination is the fronting
proxy's job in a real deployment — exactly where DAP puts it.
"""

import json
import math
import re
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


class _IdleTimeout(Exception):
    """Whole-body idle budget exhausted mid-read (shed reason
    `idle-timeout`)."""

from ..drivers import faults as faults_mod
from ..drivers.service import ADMITTED, QUARANTINED, QUEUED, SHED
from ..drivers.wal import (REASON_WAL_DEGRADED, REASON_WAL_FULL,
                           WalUnavailable)
from ..obs import trace as obs_trace
from ..obs.registry import get_registry
from .admission import (AdmissionController, NetConfig,
                        REASON_BODY_TOO_LARGE, REASON_CONNS_EXHAUSTED,
                        REASON_IDLE_TIMEOUT, REASON_INCOMPLETE_BODY,
                        REASON_RATE_LIMITED)

MEDIA_TYPE = "application/mastic-report-bundle"
API_VERSION = 1

_REPORTS_RE = re.compile(r"^/v1/tenants/([A-Za-z0-9_.-]{1,64})"
                         r"/reports$")
_EPOCH_RE = re.compile(r"^/v1/tenants/([A-Za-z0-9_.-]{1,64})"
                       r"/epoch$")
_DRAIN_PATH = "/v1/admin/drain"

# submit() verdict -> (HTTP code, body builder).
_STATUS_CODES = {ADMITTED: 201, QUEUED: 202, QUARANTINED: 400,
                 SHED: 429}


class _UploadHandler(BaseHTTPRequestHandler):
    server_version = "mastic-upload/1"
    protocol_version = "HTTP/1.1"
    # Small request/response pairs on keep-alive connections hit the
    # Nagle x delayed-ACK interaction hard (a measured, uniform
    # ~40 ms floor on loopback); admission latency is the SLO metric,
    # so the artifact would dominate every quantile.
    disable_nagle_algorithm = True

    # -- plumbing --------------------------------------------------

    def setup(self) -> None:
        super().setup()
        # Every read/write on this connection is deadline-bounded: a
        # client that stalls mid-body costs one handler thread for
        # io_timeout, never forever.
        front: "UploadFront" = self.server.front  # type: ignore
        self.connection.settimeout(front.cfg.io_timeout)
        self._body_consumed = True

    def _respond(self, code: int, body: dict,
                 retry_after: Optional[float] = None) -> None:
        data = json.dumps(body, sort_keys=True).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after is not None:
            self.send_header("Retry-After",
                             str(max(1, math.ceil(retry_after))))
        if not self._body_consumed:
            # Keep-alive would misparse the unread request body as
            # the next request line; refuse-and-close is the honest
            # framing.
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt: str, *args) -> None:
        """Per-request stderr chatter off; the registry series and
        the net.request span are the record."""

    # -- routes ----------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path.split("?", 1)[0] == "/healthz":
            self._respond(200, {"status": "ok"})
        else:
            self._respond(404, {"error": "unknown-route"})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        """Operator-plane controls (epoch cut, drain) — armed only
        when the embedding process opts in (`admin=True`); a public
        front 404s them indistinguishably from unknown routes.

        Controls are REQUESTS, not executions: the handler thread
        only enqueues; the embedding process's scheduler thread pops
        and acts (`UploadFront.pop_epoch_requests`).  Scheduler-plane
        state is therefore never touched from a server thread — the
        same plane separation the statusz surface keeps, and what
        the CC001 whole-program pass holds this module to."""
        front: "UploadFront" = self.server.front  # type: ignore
        path = self.path.split("?", 1)[0]
        if not front.admin:
            self._respond(404, {"error": "unknown-route"})
            return
        m = _EPOCH_RE.match(path)
        if m is not None:
            tenant = m.group(1)
            if tenant not in front.service.tenants:
                self._respond(404, {"error": "unknown-tenant"})
                return
            if front.request_epoch(tenant):
                self._respond(202, {"status": "epoch-requested"})
            else:
                self._respond(429, {"error": "shed",
                                    "reason": "control-queue-full"},
                              retry_after=1.0)
            return
        if path == _DRAIN_PATH:
            front.drain_requested.set()
            self._respond(202, {"status": "draining"})
            return
        self._respond(404, {"error": "unknown-route"})

    def do_PUT(self) -> None:  # noqa: N802 (http.server API)
        front: "UploadFront" = self.server.front  # type: ignore
        if not front.controller.try_acquire_connection():
            self._body_consumed = False
            front.count_request(503)
            front.shed(self._path_tenant(), REASON_CONNS_EXHAUSTED)
            self._respond(503, {"error": "shed",
                                "reason": REASON_CONNS_EXHAUSTED},
                          retry_after=1.0)
            return
        front.publish_connections()
        try:
            self._serve_put(front)
        except Exception:
            # A handler must survive anything one hostile request can
            # throw; the response carries NO detail (error internals
            # could echo request bytes) — the trace event is the
            # diagnostic record.
            obs_trace.event("net_internal_error")
            try:
                self._body_consumed = False
                front.count_request(500)
                self._respond(500, {"error": "internal"})
            except OSError:
                # Client already gone; nothing to tell it — but the
                # drop is recorded, not silent.
                obs_trace.event("net_client_gone")
        finally:
            front.controller.release_connection()
            front.publish_connections()

    def _read_body(self, front: "UploadFront", length: int) -> bytes:
        """The request body under ONE whole-body idle budget
        (`NetConfig.idle_timeout` / `MASTIC_NET_IDLE_TIMEOUT`): each
        chunk read is still bounded by io_timeout, but the budget is
        shared, so trickling a byte every few seconds cannot hold the
        connection slot past the budget.  Raises `_IdleTimeout` when
        the budget is gone with bytes still owed."""
        from ..drivers.session import Deadline

        cfg = front.cfg
        deadline = Deadline(cfg.idle_timeout)
        buf = bytearray()
        while len(buf) < length:
            rem = deadline.remaining()
            if rem <= 0.0:
                raise _IdleTimeout()
            self.connection.settimeout(min(rem, cfg.io_timeout))
            try:
                chunk = self.rfile.read(min(length - len(buf),
                                            1 << 16))
            except (TimeoutError, socket.timeout):
                raise _IdleTimeout()
            if not chunk:
                break   # EOF short of the promise: incomplete-body
            buf += chunk
        return bytes(buf)

    def _path_tenant(self) -> Optional[str]:
        m = _REPORTS_RE.match(self.path.split("?", 1)[0])
        return m.group(1) if m is not None else None

    def _client_ip(self, front: "UploadFront") -> str:
        if front.cfg.trust_forwarded:
            fwd = self.headers.get("X-Forwarded-For")
            if fwd:
                return fwd.split(",")[0].strip()
        return self.client_address[0]

    def _serve_put(self, front: "UploadFront") -> None:
        front._checkpoint("http_accept")
        t0 = time.perf_counter()
        self._body_consumed = False
        code = 500
        try:
            (code, body, retry_after) = self._admit(front)
            self._respond(code, body, retry_after=retry_after)
        finally:
            latency_ms = (time.perf_counter() - t0) * 1e3
            front.count_request(code, latency_ms)
            # The request's span, via the single-call finished
            # form (record_span): handler threads never mutate a
            # live span, so the tracer's ownership discipline holds
            # at this edge too.
            obs_trace.get_tracer().record_span(
                "net.request", duration_ms=latency_ms,
                method="PUT", code=code)

    def _admit(self, front: "UploadFront") -> tuple:
        """The whole door, in gate order; returns (code, body,
        retry_after)."""
        cfg = front.cfg
        tenant = self._path_tenant()
        if tenant is None:
            return (404, {"error": "unknown-route"}, None)
        if tenant not in front.service.tenants:
            return (404, {"error": "unknown-tenant"}, None)

        ctype = (self.headers.get("Content-Type") or "").strip()
        base = ctype.split(";", 1)[0].strip().lower()
        if base != MEDIA_TYPE:
            return (415, {"error": "unsupported-media-type",
                          "expect": MEDIA_TYPE}, None)

        raw_len = self.headers.get("Content-Length")
        try:
            length = int(raw_len)
        except (TypeError, ValueError):
            return (411, {"error": "length-required"}, None)
        if length < 0:
            return (411, {"error": "length-required"}, None)
        if length > cfg.max_body:
            front.shed(tenant, REASON_BODY_TOO_LARGE)
            return (413, {"error": "body-too-large",
                          "limit_bytes": cfg.max_body}, None)

        (ok, retry_after) = front.controller.admit(
            self._client_ip(front))
        if not ok:
            front.shed(tenant, REASON_RATE_LIMITED)
            return (429, {"error": "shed",
                          "reason": REASON_RATE_LIMITED}, retry_after)

        try:
            body = self._read_body(front, length)
        except _IdleTimeout:
            # A client trickling bytes under the
            # per-read io_timeout used to hold a connection-ceiling
            # slot indefinitely; the whole-body idle budget sheds it
            # reason-coded instead (tests prove with a slow-loris).
            front.shed(tenant, REASON_IDLE_TIMEOUT)
            return (408, {"error": "shed",
                          "reason": REASON_IDLE_TIMEOUT}, None)
        except OSError:
            body = b""
        if len(body) != length:
            # The client promised more bytes than it delivered; the
            # connection closes (keep-alive framing is gone either
            # way) and the drop is attributed, not silent.
            front.shed(tenant, REASON_INCOMPLETE_BODY)
            return (400, {"error": REASON_INCOMPLETE_BODY}, None)
        self._body_consumed = True
        if front.injector is not None:
            # The in-flight mutation seam: a truncated/corrupted body
            # reaches submit() below and must quarantine with an
            # attributed reason — never admit.
            body = front.injector.on_blob("http_body", body)

        if front._persist is not None:
            # Durability gate: the upload body goes into
            # the admission WAL and this thread blocks until its
            # record's fsync — BEFORE submit, so a failed append is
            # a clean reason-coded 503 with no half-admitted state,
            # and a crash after this point leaves a record recovery
            # replays (the client's retry then acks idempotently).
            try:
                front._persist(tenant, body)
            except WalUnavailable as exc:
                if exc.reason == REASON_WAL_FULL:
                    front.shed(tenant, REASON_WAL_FULL)
                    return (503, {"error": "shed",
                                  "reason": REASON_WAL_FULL},
                            exc.retry_after)
                front.shed(tenant, REASON_WAL_DEGRADED)
                return (503, {"error": "shed",
                              "reason": REASON_WAL_DEGRADED},
                        exc.retry_after)

        (status, detail) = front.service.submit(tenant, body)
        code = _STATUS_CODES[status]
        if status in (ADMITTED, QUEUED):
            # Durability hook (serve.py --snapshot): the embedding
            # process persists BEFORE the ack leaves, so a client
            # that got a 2xx never loses that upload to a crash.
            front.notify_admitted(tenant)
            return (code, {"status": status}, None)
        if status == QUARANTINED:
            return (code, {"error": "quarantined", "reason": detail},
                    None)
        return (code, {"error": "shed", "reason": detail}, 1.0)


class UploadFront:
    """The embedding process's handle (the StatusServer idiom):
    construct over a live `CollectorService`, `start()` binds and
    serves on a daemon thread, `stop()` shuts the listener down.
    Port 0 binds an ephemeral port (`self.port` has the real one)."""

    def __init__(self, service, config: Optional[NetConfig] = None,
                 port: int = 0, host: str = "127.0.0.1",
                 injector=None, admin: bool = False,
                 on_admitted=None, registry=None, persist=None):
        self.service = service
        # `cfg`, not `config`: see AdmissionController.
        self.cfg = config or NetConfig.from_env()
        self.controller = AdmissionController(self.cfg)
        self.injector = (injector if injector is not None
                         else faults_mod.injector_from_env("collector"))
        self.admin = admin
        self.registry = (registry if registry is not None
                         else get_registry())
        self.drain_requested = threading.Event()
        self.requested_port = port
        self.host = host
        self.port: Optional[int] = None
        self._on_admitted = on_admitted
        # Durability gate: `(tenant, body) -> None`,
        # called before submit(); blocks until the upload is
        # fsync-durable, raises WalUnavailable for the reason-coded
        # brownout 503.  serve.py passes AdmissionWal.append_report.
        self._persist = persist
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        # Epoch-cut requests the admin endpoint queued (BOUNDED: a
        # hammered control endpoint sheds, it does not grow), popped
        # and executed by the embedding scheduler thread.
        self._control_mu = threading.Lock()
        self._epoch_requests: list = []
        self._control_bound = 64

    # -- lifecycle -------------------------------------------------

    def start(self) -> "UploadFront":
        self._httpd = ThreadingHTTPServer(
            (self.host, self.requested_port), _UploadHandler)
        # Publication handoff (the StatusServer pattern): `front` is
        # written once, strictly before Thread.start() below, and
        # never reassigned; handler-thread reads are ordered after
        # the start() happens-before edge.
        self._httpd.front = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mastic-upload-front", daemon=True)
        self._thread.start()
        self.publish_connections()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- seams the handler threads call ----------------------------

    def _checkpoint(self, step: str) -> None:
        if self.injector is not None:
            self.injector.checkpoint(step)

    def count_request(self, code: int,
                      latency_ms: Optional[float] = None) -> None:
        self.registry.counter("mastic_net_http_requests_total",
                              code=str(code)).inc()
        if latency_ms is not None:
            self.registry.histogram(
                "mastic_net_admission_latency_ms").observe(latency_ms)

    def publish_connections(self) -> None:
        self.registry.gauge("mastic_net_active_connections").set(
            self.controller.active_connections())

    def shed(self, tenant: Optional[str], reason: str) -> None:
        """One front-door refusal into the service's shed ledger
        (tenant-attributed when the path parsed that far)."""
        if tenant is not None:
            self.service.shed_external(tenant, reason)
        else:
            obs_trace.event("shed", tenant="", reason=reason)

    def notify_admitted(self, tenant: str) -> None:
        if self._on_admitted is not None:
            self._on_admitted(tenant)

    # -- the operator-plane request queue --------------------------

    def request_epoch(self, tenant: str) -> bool:
        """Queue one epoch-cut request; False when the bounded
        control queue is full (the handler sheds it, attributed)."""
        with self._control_mu:
            if len(self._epoch_requests) >= self._control_bound:
                return False
            self._epoch_requests.append(tenant)
            return True

    def pop_epoch_requests(self) -> list:
        """Drain the queued cut requests — called by the EMBEDDING
        thread, which owns every `begin_epoch` call."""
        with self._control_mu:
            out = self._epoch_requests
            self._epoch_requests = []
            return out
