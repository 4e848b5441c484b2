"""Network-admission layer for the upload front (copy of
`mastic_tpu/net/admission.py`): per-IP
token buckets, a connection ceiling, and the body-size gate — the
defenses that must fire BEFORE a request costs the service a decode.

The collector service already defends itself per tenant (quotas,
quarantine, shed policies); this layer defends the *door*: a single
hostile address cannot monopolize the listener's threads or bandwidth,
and every refusal here is reason-coded so it composes with the
service's shed accounting (`CollectorService.shed_external`) instead
of vanishing at the HTTP layer.

Memory is bounded by construction: the per-IP bucket table holds at
most `max_tracked_ips` entries, LRU-evicted (a hostile address stream
recycles bucket slots, never grows the table), and evictions are
counted.  All state mutates under one lock — the HTTP server runs a
thread per connection, so the controller is the one place their
admission decisions serialize.

Levers (env forms): `MASTIC_NET_MAX_BODY`,
`MASTIC_NET_MAX_CONNS`, `MASTIC_NET_RATE`, `MASTIC_NET_BURST`,
`MASTIC_NET_TRUST_FORWARDED`, `MASTIC_NET_MAX_TRACKED_IPS`,
`MASTIC_NET_IO_TIMEOUT`, `MASTIC_NET_IDLE_TIMEOUT`.
"""

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from ..drivers.session import _env_float, _env_int

# Reason codes the admission layer sheds with (they land in
# ServiceCounters.shed_reasons next to the service's own policies).
REASON_RATE_LIMITED = "rate-limited"
REASON_CONNS_EXHAUSTED = "connections-exhausted"
REASON_BODY_TOO_LARGE = "body-too-large"
REASON_INCOMPLETE_BODY = "incomplete-body"
REASON_IDLE_TIMEOUT = "idle-timeout"


def _env_bool(name: str, default: bool) -> bool:
    import os

    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    return raw.strip() not in ("0", "false", "no")


@dataclass
class NetConfig:
    """Upload-front levers.  `rate`/`burst` are per client address:
    sustained uploads/s and bucket depth (rate 0 disables the bucket
    — admission is then bounded only by connections and the service's
    own quotas).  `trust_forwarded` honors X-Forwarded-For as the
    client address — ONLY for deployments behind a trusted proxy (and
    for the load generator, which simulates 10^5 client addresses
    through loopback)."""

    max_body: int = 1 << 20        # bytes; PUT bodies past it -> 413
    max_connections: int = 64      # concurrent requests being served
    rate: float = 0.0              # per-IP uploads/s (0 = unlimited)
    burst: float = 32.0            # per-IP bucket depth
    trust_forwarded: bool = False  # X-Forwarded-For as client addr
    max_tracked_ips: int = 4096    # bucket-table bound (LRU evicted)
    io_timeout: float = 30.0       # per-socket read/write deadline
    idle_timeout: float = 30.0     # whole-request-body deadline: a
    #                                client trickling bytes under the
    #                                per-read io_timeout can no longer
    #                                hold a connection slot forever —
    #                                past this budget it sheds
    #                                reason-coded `idle-timeout`

    def __post_init__(self):
        if self.max_body < 1:
            raise ValueError("max_body must be >= 1")
        if self.max_connections < 1:
            raise ValueError("max_connections must be >= 1")
        if self.max_tracked_ips < 1:
            raise ValueError("max_tracked_ips must be >= 1")
        if self.rate < 0 or self.burst <= 0:
            raise ValueError("rate must be >= 0 and burst > 0")
        if self.idle_timeout <= 0:
            raise ValueError("idle_timeout must be > 0")

    @classmethod
    def from_env(cls) -> "NetConfig":
        return cls(
            max_body=_env_int("MASTIC_NET_MAX_BODY", 1 << 20),
            max_connections=_env_int("MASTIC_NET_MAX_CONNS", 64),
            rate=_env_float("MASTIC_NET_RATE", 0.0),
            burst=_env_float("MASTIC_NET_BURST", 32.0),
            trust_forwarded=_env_bool("MASTIC_NET_TRUST_FORWARDED",
                                      False),
            max_tracked_ips=_env_int("MASTIC_NET_MAX_TRACKED_IPS",
                                     4096),
            io_timeout=_env_float("MASTIC_NET_IO_TIMEOUT", 30.0),
            idle_timeout=_env_float("MASTIC_NET_IDLE_TIMEOUT", 30.0),
        )


class AdmissionController:
    """The door's shared state: one instance per upload front, called
    from every handler thread.  `clock` is injectable so the bucket
    math is unit-testable without sleeping."""

    def __init__(self, config: NetConfig, clock=time.monotonic):
        # Attr named `cfg`, as in the JAX package's copy.
        self.cfg = config
        self._clock = clock
        self._mu = threading.Lock()
        # ip -> [tokens, last refill time]; ordered for LRU eviction.
        self._buckets: OrderedDict = OrderedDict()
        self.evictions = 0
        self._active = 0

    # -- connection ceiling ----------------------------------------

    def try_acquire_connection(self) -> bool:
        """One request wants serving; False past the ceiling (the
        caller answers 503 + Retry-After, counted)."""
        with self._mu:
            if self._active >= self.cfg.max_connections:
                return False
            self._active += 1
            return True

    def release_connection(self) -> None:
        with self._mu:
            self._active = max(0, self._active - 1)

    def active_connections(self) -> int:
        with self._mu:
            return self._active

    # -- per-IP token bucket ---------------------------------------

    def admit(self, ip: str) -> tuple:
        """Spend one token for `ip`.  Returns (admitted, retry_after
        seconds — 0.0 when admitted).  Bucket table is LRU-bounded;
        an evicted address starts over with a full bucket (generous
        to the reborn, bounded for everyone)."""
        cfg = self.cfg
        if cfg.rate <= 0:
            return (True, 0.0)
        now = self._clock()
        with self._mu:
            slot = self._buckets.get(ip)
            if slot is None:
                if len(self._buckets) >= cfg.max_tracked_ips:
                    self._buckets.popitem(last=False)
                    self.evictions += 1
                slot = [cfg.burst, now]
                self._buckets[ip] = slot
            else:
                self._buckets.move_to_end(ip)
            (tokens, last) = slot
            tokens = min(cfg.burst, tokens + (now - last) * cfg.rate)
            if tokens >= 1.0:
                slot[0] = tokens - 1.0
                slot[1] = now
                return (True, 0.0)
            slot[0] = tokens
            slot[1] = now
            return (False, (1.0 - tokens) / cfg.rate)

    def tracked_ips(self) -> int:
        with self._mu:
            return len(self._buckets)
