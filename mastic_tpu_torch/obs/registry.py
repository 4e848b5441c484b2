"""Metrics registry (copy of `mastic_tpu/obs/registry.py`): named
counters, gauges and histograms with label sets, exported as
Prometheus text and as a JSON snapshot.

The session, fault and transport layers count their outcomes here
(`mastic_session_retries_total`, `mastic_faults_injected_total`,
`mastic_tls_refusals_total`, ...); the declared series of the
service layer are kept so that it registers into the same table.

Cardinality is bounded by construction: each metric accepts at most
`max_label_sets` distinct label-value tuples (default 64); past the
cap, new label sets collapse into one reserved
``{"overflow": "true"}`` child and `mastic_obs_label_overflow_total`
counts the collapses — a hostile tenant name stream degrades one
series, never memory.

Every series a shipped code path registers is DECLARED up front in
`DECLARED` below (name -> kind, help, label names).  Ad-hoc metrics
(tests) may be created without declaring.
"""

import json
import threading
from bisect import bisect_left
from typing import Optional, Sequence

DEFAULT_MAX_LABEL_SETS = 64

# Default histogram buckets, in milliseconds: the phase times range
# from sub-ms host folds to multi-minute cold compiles.
DEFAULT_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0,
                      30000.0, 60000.0, 120000.0, 300000.0)

_OVERFLOW_LABELS = ("overflow",)
_OVERFLOW_VALUES = ("true",)

# name -> (kind, help, label names): the shipped series.
DECLARED = {
    "mastic_reports_admitted_total":
        ("counter", "reports admitted by the collector service",
         ("tenant",)),
    "mastic_reports_quarantined_total":
        ("counter", "reports refused at the door, by reason",
         ("tenant", "reason")),
    "mastic_reports_shed_total":
        ("counter", "reports dropped by backpressure, by reason",
         ("tenant", "reason")),
    "mastic_pages_sealed_total":
        ("counter", "buffer pages sealed behind a digest",
         ("tenant",)),
    "mastic_pages_corrupt_total":
        ("counter", "sealed pages whose digest check failed",
         ("tenant",)),
    "mastic_epochs_total":
        ("counter", "epoch outcomes (completed/truncated/failed/"
         "refused)", ("tenant", "outcome")),
    "mastic_deadline_misses_total":
        ("counter", "epoch deadline expiries", ("tenant",)),
    "mastic_rounds_total":
        ("counter", "aggregation rounds completed", ("tenant",)),
    "mastic_reports_accepted_total":
        ("counter", "per-round accepted reports, summed",
         ("tenant",)),
    "mastic_reports_rejected_total":
        ("counter", "per-round rejected reports, by first failing "
         "check", ("tenant", "check")),
    "mastic_session_retries_total":
        ("counter", "session-layer retries (with_retries)",
         ("tenant",)),
    "mastic_session_timeouts_total":
        ("counter", "session-layer deadline expiries", ("tenant",)),
    "mastic_session_reconnects_total":
        ("counter", "party links redialed and resumed mid-session "
         "(reconnect-and-replay; ReliableChannel)", ("tenant",)),
    "mastic_frames_replayed_total":
        ("counter", "session frames redelivered after a reconnect "
         "(deduped by sequence number on the receiver)", ("tenant",)),
    "mastic_tls_refusals_total":
        ("counter", "mTLS handshakes refused, by reason code and "
         "side (tls-wrong-ca / tls-expired-cert / "
         "tls-hostname-mismatch / tls-plaintext / ...)",
         ("reason", "side")),
    "mastic_faults_injected_total":
        ("counter", "MASTIC_FAULTS rules fired",
         ("action", "step")),
    "mastic_buffered_reports":
        ("gauge", "reports admitted but not yet finished",
         ("tenant",)),
    "mastic_pending_epochs":
        ("gauge", "epochs queued behind the active one", ("tenant",)),
    "mastic_round_wall_ms":
        ("histogram", "wall time of one aggregation round",
         ("tenant",)),
    "mastic_chunk_phase_ms":
        ("histogram", "per-chunk phase wall time (upload/compile/"
         "dispatch/compute_wait/download/host)", ("phase",)),
    "mastic_device_time_ms_total":
        ("counter", "device-time attribution: inline compile wait vs "
         "execute wait, milliseconds", ("kind",)),
    "mastic_sched_overhead_ms_total":
        ("counter", "scheduler overhead on top of raw rounds, "
         "milliseconds", ("tenant",)),
    "mastic_trace_spans_total":
        ("counter", "spans finished by the tracer", ()),
    "mastic_trace_spans_dropped_total":
        ("counter", "spans evicted from the tracer ring", ()),
    "mastic_obs_label_overflow_total":
        ("counter", "label sets collapsed by the cardinality cap",
         ("metric",)),
    "mastic_artifact_loads_total":
        ("counter", "AOT artifact-store load attempts, by gate "
         "outcome (hit/miss/probe_fail/version_skew/corrupt)",
         ("outcome",)),
    "mastic_scheduler_occupancy":
        ("gauge", "staged tenant rounds in flight at the end of the "
         "last scheduler quantum (0 = serial round-robin)", ()),
    "mastic_sched_overlap_efficiency":
        ("gauge", "structural overlap of the last drained scheduler "
         "window: fraction of staged round time hidden behind other "
         "tenants' work (pipeline.overlap_efficiency semantics)", ()),
    "mastic_ingest_queue_depth":
        ("gauge", "uploads waiting in the concurrent ingest front's "
         "bounded queue", ()),
    "mastic_net_http_requests_total":
        ("counter", "upload-front HTTP requests by response code "
         "(the service layer's upload front)", ("code",)),
    "mastic_net_admission_latency_ms":
        ("histogram", "upload-front request latency: accept to "
         "verdict written, per PUT", ()),
    "mastic_net_active_connections":
        ("gauge", "upload-front requests currently being served "
         "(bounded by MASTIC_NET_MAX_CONNS)", ()),
    "mastic_wal_appends_total":
        ("counter", "admission-WAL records appended and made "
         "durable, by tenant and record kind (report/epoch_cut)",
         ("tenant", "kind")),
    "mastic_wal_fsync_ms":
        ("histogram", "per-ack durability wait: append start to "
         "fsync-confirmed, milliseconds (group commit batches "
         "these)", ()),
    "mastic_wal_recovered_records_total":
        ("counter", "WAL records handled at recovery, by outcome "
         "(replayed/covered/deduped/torn_tail/corrupt/epoch_cut/"
         "rejected)", ("outcome",)),
    "mastic_wal_segment_bytes":
        ("gauge", "bytes in the WAL's current open segment (resets "
         "on rotation at MASTIC_WAL_SEGMENT_BYTES)", ()),
}


class _Metric:
    """One named metric family: children keyed by label-value
    tuples.  Value shape depends on kind: counters/gauges hold a
    float; histograms hold [bucket counts..., +inf count, sum]."""

    __slots__ = ("name", "kind", "help", "label_names", "buckets",
                 "children", "overflowed")

    def __init__(self, name: str, kind: str, help_text: str,
                 label_names: tuple, buckets: Optional[tuple]):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.label_names = label_names
        self.buckets = buckets
        self.children: dict = {}
        self.overflowed = 0


class _Handle:
    """A (metric, label values) pair the call sites hold; operations
    lock the registry so any thread may record."""

    __slots__ = ("_reg", "_metric", "_values")

    def __init__(self, reg: "MetricsRegistry", metric: _Metric,
                 values: tuple):
        self._reg = reg
        self._metric = metric
        self._values = values

    def inc(self, n: float = 1.0) -> None:
        self._reg._add(self._metric, self._values, n)

    def set(self, value: float) -> None:
        if self._metric.kind != "gauge":
            raise ValueError(
                f"{self._metric.name} is a {self._metric.kind}; only "
                f"gauges support set()")
        self._reg._set(self._metric, self._values, value)

    def set_total(self, value: float) -> None:
        """Publish an externally-accumulated monotone total (the
        ServiceCounters bridge after a snapshot restore): counters
        stay increment-only for call sites, but a resumed ledger must
        re-export its persisted totals."""
        self._reg._set(self._metric, self._values, value)

    def observe(self, value: float) -> None:
        if self._metric.kind != "histogram":
            raise ValueError(
                f"{self._metric.name} is a {self._metric.kind}; only "
                f"histograms support observe()")
        self._reg._observe(self._metric, self._values, value)

    def value(self):
        return self._reg._value(self._metric, self._values)


class MetricsRegistry:
    """The process-wide metric store (singleton via `get_registry`;
    tests build private instances)."""

    def __init__(self, max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self.max_label_sets = max_label_sets

    # -- creation --------------------------------------------------

    def _get_metric(self, name: str, kind: str, help_text: str,
                    labels: Sequence[str],
                    buckets: Optional[tuple] = None) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                declared = DECLARED.get(name)
                if declared is not None:
                    (kind, help_text, labels) = declared
                m = _Metric(name, kind, help_text or "",
                            tuple(labels),
                            (tuple(buckets or DEFAULT_BUCKETS_MS)
                             if kind == "histogram" else None))
                self._metrics[name] = m
            if m.kind != kind:
                raise ValueError(
                    f"metric {name} already registered as {m.kind}, "
                    f"requested {kind}")
            return m

    def _handle(self, m: _Metric, label_values: dict) -> _Handle:
        extra = set(label_values) - set(m.label_names)
        if extra:
            raise ValueError(
                f"metric {m.name} has labels {m.label_names}; "
                f"unexpected {sorted(extra)}")
        values = tuple(str(label_values.get(ln, ""))
                       for ln in m.label_names)
        return _Handle(self, m, values)

    def counter(self, name: str, help_text: str = "",
                **labels) -> _Handle:
        return self._handle(
            self._get_metric(name, "counter", help_text,
                             tuple(labels)), labels)

    def gauge(self, name: str, help_text: str = "",
              **labels) -> _Handle:
        return self._handle(
            self._get_metric(name, "gauge", help_text,
                             tuple(labels)), labels)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> _Handle:
        return self._handle(
            self._get_metric(name, "histogram", help_text,
                             tuple(labels),
                             tuple(buckets) if buckets else None),
            labels)

    # -- the cardinality cap ---------------------------------------

    def _child(self, m: _Metric, values: tuple):
        """The child slot for a label-value tuple, collapsing to the
        overflow child past the cap."""
        child = m.children.get(values)
        if child is not None:
            return values
        if len(m.children) >= self.max_label_sets:
            m.overflowed += 1
            over_name = "mastic_obs_label_overflow_total"
            if m.name != over_name:
                over = self._metrics.get(over_name)
                if over is None:
                    (kind, help_text, labels) = DECLARED[over_name]
                    over = _Metric(over_name, kind, help_text,
                                   labels, None)
                    self._metrics[over_name] = over
                slot = over.children.setdefault((m.name,), [0.0])
                slot[0] += 1
            return _OVERFLOW_VALUES
        if m.kind == "histogram":
            m.children[values] = [0] * (len(m.buckets) + 1) + [0.0]
        else:
            m.children[values] = [0.0]
        return values

    def _ensure_overflow_child(self, m: _Metric) -> None:
        if _OVERFLOW_VALUES not in m.children:
            if m.kind == "histogram":
                m.children[_OVERFLOW_VALUES] = \
                    [0] * (len(m.buckets) + 1) + [0.0]
            else:
                m.children[_OVERFLOW_VALUES] = [0.0]

    # -- recording -------------------------------------------------

    def _add(self, m: _Metric, values: tuple, n: float) -> None:
        with self._lock:
            key = self._child(m, values)
            if key is _OVERFLOW_VALUES:
                self._ensure_overflow_child(m)
            m.children[key][-1] += n

    def _set(self, m: _Metric, values: tuple, value: float) -> None:
        with self._lock:
            key = self._child(m, values)
            if key is _OVERFLOW_VALUES:
                self._ensure_overflow_child(m)
            m.children[key][-1] = value

    def _observe(self, m: _Metric, values: tuple,
                 value: float) -> None:
        with self._lock:
            key = self._child(m, values)
            if key is _OVERFLOW_VALUES:
                self._ensure_overflow_child(m)
            child = m.children[key]
            idx = bisect_left(m.buckets, value)
            child[idx] += 1
            child[-1] += value

    def _value(self, m: _Metric, values: tuple):
        with self._lock:
            child = m.children.get(values)
            if child is None:
                return None
            if m.kind == "histogram":
                return {"count": sum(child[:-1]), "sum": child[-1]}
            return child[-1]

    # -- export ----------------------------------------------------

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (v0.0.4): HELP/TYPE
        headers, one sample line per child; histograms expand to
        cumulative _bucket{le=...} plus _sum/_count."""
        out: list = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                out.append(f"# HELP {name} {m.help}")
                out.append(f"# TYPE {name} {m.kind}")
                label_names = (m.label_names
                               if _OVERFLOW_VALUES not in m.children
                               else m.label_names or _OVERFLOW_LABELS)
                for values in sorted(m.children):
                    if values == _OVERFLOW_VALUES \
                            and m.label_names != _OVERFLOW_LABELS:
                        pairs = 'overflow="true"'
                    else:
                        pairs = ",".join(
                            f'{ln}="{_escape(v)}"'
                            for (ln, v) in zip(label_names, values))
                    child = m.children[values]
                    if m.kind == "histogram":
                        cum = 0
                        for (le, cnt) in zip(m.buckets, child):
                            cum += cnt
                            lbl = (pairs + "," if pairs else "") \
                                + f'le="{_fmt(le)}"'
                            out.append(
                                f"{name}_bucket{{{lbl}}} {cum}")
                        cum += child[len(m.buckets)]
                        lbl = (pairs + "," if pairs else "") \
                            + 'le="+Inf"'
                        out.append(f"{name}_bucket{{{lbl}}} {cum}")
                        brace = f"{{{pairs}}}" if pairs else ""
                        out.append(
                            f"{name}_sum{brace} {_fmt(child[-1])}")
                        out.append(f"{name}_count{brace} {cum}")
                    else:
                        brace = f"{{{pairs}}}" if pairs else ""
                        out.append(
                            f"{name}{brace} {_fmt(child[-1])}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot for /varz: name -> {kind, help,
        series: [{labels, value | {count,sum}}]}."""
        out: dict = {}
        with self._lock:
            for (name, m) in sorted(self._metrics.items()):
                series = []
                for (values, child) in sorted(m.children.items()):
                    if values == _OVERFLOW_VALUES \
                            and m.label_names != _OVERFLOW_LABELS:
                        labels = {"overflow": "true"}
                    else:
                        labels = dict(zip(m.label_names, values))
                    if m.kind == "histogram":
                        val = {"count": sum(child[:-1]),
                               "sum": round(child[-1], 3)}
                    else:
                        val = child[-1]
                    series.append({"labels": labels, "value": val})
                out[name] = {"kind": m.kind, "help": m.help,
                             "series": series,
                             "overflowed": m.overflowed}
        return out

    def metric_names(self) -> list:
        with self._lock:
            return sorted(self._metrics)


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"") \
        .replace("\n", r"\n")


def _fmt(x: float) -> str:
    if isinstance(x, float) and x == int(x) and abs(x) < 1e15:
        return str(int(x))
    return repr(x)


def declared_metric_names() -> list:
    """Every shipped series name."""
    return sorted(DECLARED)


def snapshot_json(registry: Optional[MetricsRegistry] = None) -> str:
    reg = registry if registry is not None else get_registry()
    return json.dumps(reg.snapshot(), sort_keys=True)


# -- the process-wide singleton ---------------------------------------

_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def configure(max_label_sets: int = DEFAULT_MAX_LABEL_SETS
              ) -> MetricsRegistry:
    """Rebuild the singleton (tests)."""
    global _registry
    with _registry_lock:
        _registry = MetricsRegistry(max_label_sets=max_label_sets)
    return _registry
