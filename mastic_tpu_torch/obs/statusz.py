"""The live status surface (copy of `mastic_tpu/obs/statusz.py`): a stdlib
`http.server` thread serving

    /metrics   Prometheus text exposition (the registry)
    /statusz   human-readable service status (per-tenant occupancy,
               epoch queue depths, shed/quarantine totals, the last
               round's timeline)
    /varz      one JSON object: registry snapshot + tracer state +
               whatever dict the embedding process publishes

The scheduler (`tools/serve.py`) is single-threaded by design, so the
server NEVER calls into live service objects: the embedding process
publishes an immutable snapshot dict after each scheduler quantum
(`StatusServer.publish`, copy-on-write under a lock), and request
handlers only read the latest published snapshot plus the registry
(whose own operations are lock-protected).  A scrape can therefore
never race a round or observe a half-updated tenant table.

Port 0 binds an ephemeral port (`server.port` reports the real one) —
how the smoke gate and the tests avoid collisions.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .registry import get_registry
from .trace import get_tracer


def render_statusz(snapshot: dict) -> str:
    """The human text page from a published service snapshot (the
    `CollectorService.metrics()` shape).  Tolerates an empty snapshot
    (server up before the first quantum)."""
    lines = ["mastic collector statusz", ""]
    if not snapshot:
        lines.append("(no snapshot published yet)")
        return "\n".join(lines) + "\n"
    lines.append(f"shed policy: {snapshot.get('policy', '?')}   "
                 f"resumed: {snapshot.get('resumed', False)}")
    for (name, t) in sorted(snapshot.get("tenants", {}).items()):
        c = t.get("counters", {})
        lines.append("")
        lines.append(f"tenant {name}"
                     + ("   [SUSPENDED]" if t.get("suspended")
                        else ""))
        lines.append(
            f"  occupancy: {t.get('buffered_reports', 0)} buffered "
            f"({t.get('open_page', 0)} open-page, "
            f"{t.get('sealed_pages', 0)} sealed pages), "
            f"{t.get('pending_epochs', 0)} pending epochs, "
            f"active={t.get('active_epoch')}")
        lines.append(
            f"  counters: admitted={c.get('admitted', 0)} "
            f"rounds={c.get('rounds', 0)} "
            f"quarantined={c.get('quarantined', 0)} "
            f"shed={c.get('shed', 0)} "
            f"deadline_misses={c.get('deadline_misses', 0)} "
            f"resumes={c.get('resumes', 0)}")
        for (table, label) in (("shed_reasons", "shed"),
                               ("quarantine_reasons", "quarantine")):
            reasons = c.get(table) or {}
            if reasons:
                body = ", ".join(f"{k}={v}" for (k, v)
                                 in sorted(reasons.items()))
                lines.append(f"  {label} reasons: {body}")
        epochs = t.get("epochs") or []
        if epochs:
            last = epochs[-1]
            lines.append(
                f"  last epoch: id={last.get('epoch')} "
                f"reports={last.get('reports')} "
                f"truncated={last.get('truncated')} "
                f"levels={last.get('levels_completed')} "
                f"wall_s={last.get('wall_s', '?')}")
        timeline = t.get("last_round_timeline")
        if timeline:
            lines.append("  last round timeline (per chunk, ms):")
            for rec in timeline:
                phases = rec.get("phases", {})
                body = " ".join(f"{k[:-3]}={v:.1f}" for (k, v)
                                in sorted(phases.items()))
                lines.append(f"    chunk {rec.get('chunk')}: "
                             f"wall={rec.get('wall_ms', 0)} {body}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "mastic-statusz/1"

    def _send(self, code: int, body: str,
              ctype: str = "text/plain; charset=utf-8") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        owner: "StatusServer" = self.server.owner  # type: ignore
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            self._send(200, owner.registry.prometheus_text(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif path == "/varz":
            self._send(200, json.dumps(owner.varz(), sort_keys=True),
                       "application/json")
        elif path in ("/statusz", "/"):
            self._send(200, render_statusz(owner.snapshot()))
        else:
            self._send(404, f"no route {path}\n")

    def log_message(self, fmt: str, *args) -> None:
        """Scrapes are high-frequency; stderr chatter off by
        default."""


class StatusServer:
    """The embedding process's handle: start() binds and spawns the
    daemon thread, publish() swaps in a new snapshot, stop() shuts
    the listener down (tests; the service normally lives as long as
    the process)."""

    def __init__(self, port: int = 0, registry=None, tracer=None):
        self.requested_port = port
        self.registry = (registry if registry is not None
                         else get_registry())
        self.tracer = tracer if tracer is not None else get_tracer()
        self._lock = threading.Lock()
        self._snapshot: dict = {}
        self._extra_varz: dict = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.port: Optional[int] = None

    def start(self) -> "StatusServer":
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", self.requested_port), _Handler)
        # mastic-allow: CC001 — publication handoff: `owner` is
        # written once, strictly before Thread.start() below, and
        # never reassigned; the server thread's reads are ordered
        # after the start() happens-before edge, so no lock is needed
        self._httpd.owner = self  # type: ignore[attr-defined]
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="mastic-statusz", daemon=True)
        self._thread.start()
        return self

    def publish(self, snapshot: dict,
                extra_varz: Optional[dict] = None) -> None:
        """Swap in the scheduler's latest snapshot (the dict is
        adopted, not copied — pass a fresh one each quantum)."""
        with self._lock:
            self._snapshot = snapshot
            if extra_varz is not None:
                self._extra_varz = extra_varz

    def snapshot(self) -> dict:
        # Snapshot OUT, not the guarded reference: the scheduler
        # swaps whole dicts in publish(), but handing the live object
        # across the lock boundary would let a future mutation race a
        # scrape (copy-on-write means a copy leaves the lock).
        with self._lock:
            return dict(self._snapshot)

    def varz(self) -> dict:
        with self._lock:
            extra = dict(self._extra_varz)
            snap = dict(self._snapshot)
        return {
            "metrics": self.registry.snapshot(),
            "trace": self.tracer.snapshot(),
            "service": snap,
            **extra,
        }

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
