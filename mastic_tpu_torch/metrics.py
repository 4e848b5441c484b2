"""Round metrics (port of the round records of `mastic_tpu/metrics.py`).

Every round, incremental or from the root, produces one `RoundMetrics`
record with

* verdict counters: reports accepted, and rejected attributed to the
  first failing check in protocol order (VIDPF eval proof, then FLP
  weight check, then joint-rand confirmation);
* structural op counters: node evaluations, fixed-key AES blocks,
  Keccak node-proof permutations, derived from the public round
  structure (prefix set, level, instantiation), not sampled from the
  device: the round evaluates exactly the scheduled grid;
* bytes per channel: upload, prep share broadcast, prep messages,
  aggregate shares, from the wire size formulas (`wire.py`).

The fields are the JAX package's, so `as_dict()` has its keys.  The
session and transport counters (timeouts, retries, quarantined,
respawns, reconnects, replayed frames) are filled by the party layer's
collector (`drivers/parties.py::ProcessCollector.round_metrics`).  The
collector service (`drivers/service.py`) keeps its per-tenant ledger in
`ServiceCounters`, whose increments mirror into the registry
(tenant-labelled `mastic_*` series, exported at `/metrics`), and
`RoundMetrics.validate_extra()` holds every producer of the "chunks",
"pipeline", "mesh" and "service" blocks to the one versioned schema
(`obs/schema.py`).  `extra` holds, besides the JAX package's key-setup
counts, the port's own entries: "excluded_invalid" (lanes left out
because the caller's `valid` was False: never sharded correctly, so
not recomputed), "rejected_fallback_by" (the checks the recomputed
reports failed), the scalar splice's time ("splice_ms"), on the
incremental rounds the plan, dispatch and wait times ("phases") and the
JAX package's "pipeline" block (mode "resident-deferred"), and
"round_wall_ms".  The chunked rounds add the JAX package's "chunks",
"memory" and "pipeline" blocks (`drivers/pipeline.py`), and a run on a
report mesh its "mesh" block (`parallel/mesh.py::mesh_block`); the
JAX package's "artifacts" block has no counterpart (the port compiles
no programs).  Under a mesh every counter is global: each round's
masks are gathered over the ranks before they are counted.
"""

import threading
from dataclasses import asdict, dataclass, field

import numpy as np

from . import wire
from .obs.registry import get_registry


@dataclass
class RoundMetrics:
    level: int
    frontier_width: int          # number of candidate prefixes
    padded_width: int            # device grid width (incremental) or
    #                              total child-grid nodes (from-root)
    reports_total: int
    accepted: int = 0
    rejected_eval_proof: int = 0
    rejected_weight_check: int = 0
    rejected_joint_rand: int = 0
    rejected_fallback: int = 0   # rejected by the scalar fallback path
    xof_fallbacks: int = 0       # lanes recomputed via the scalar path
    # session fault-tolerance counters (party layer):
    timeouts: int = 0
    retries: int = 0
    quarantined: int = 0
    respawns: int = 0
    # transport-recovery counters (network layer):
    reconnects: int = 0
    replayed_frames: int = 0
    # structural op counts, summed over both aggregators:
    node_evals: int = 0
    aes_extend_blocks: int = 0
    aes_convert_blocks: int = 0
    keccak_node_proofs: int = 0
    # bytes per channel for this round:
    bytes_upload: int = 0        # client -> one aggregator (x2 parties)
    bytes_prep_shares: int = 0   # aggregator <-> aggregator
    bytes_prep_msgs: int = 0     # leader -> helper
    bytes_agg_shares: int = 0    # aggregators -> collector
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return asdict(self)

    def validate_extra(self) -> None:
        """Hold this record's observability blocks to the unified
        schema and stamp `extra["schema"]` (obs/schema.py).  Every
        stamping driver calls this before appending the record, so a
        producer that drifts from the schema fails its own round."""
        from .obs import schema

        schema.stamp(self.extra)


# ServiceCounters field -> (registry series, outcome label).  Fields
# not listed either have no Prometheus twin or are owned by another
# producer (`rounds` is fed per round by obs/devtime.observe_round —
# mirroring it here too would double-count the series).
_SERVICE_SERIES = {
    "admitted": ("mastic_reports_admitted_total", None),
    "pages_sealed": ("mastic_pages_sealed_total", None),
    "pages_corrupt": ("mastic_pages_corrupt_total", None),
    "deadline_misses": ("mastic_deadline_misses_total", None),
    "epochs_completed": ("mastic_epochs_total", "completed"),
    "epochs_truncated": ("mastic_epochs_total", "truncated"),
    "epochs_failed": ("mastic_epochs_total", "failed"),
    "epochs_refused": ("mastic_epochs_total", "refused"),
    "epochs_started": ("mastic_epochs_total", "started"),
}


@dataclass
class ServiceCounters:
    """Per-tenant ledger of the collector service's defensive
    decisions (drivers/service.py; a copy of the JAX package's).
    Everything the service refuses, drops, truncates, or retries
    lands here — backpressure and
    degradation are surfaced, never silent.  `shed_reasons` /
    `quarantine_reasons` break the totals down by policy / reason
    name (the party layer's reason-code taxonomy plus the service's
    page-corrupt and tenant-quarantined entries).

    Increments route through `inc()` and the `bump_*`
    helpers, which mirror into the telemetry registry
    (tenant-labelled `mastic_*` series, exported at `/metrics`); the
    dataclass remains the snapshot/serialization ledger.
    `export_registry()` republishes the persisted totals after a
    snapshot restore so a resumed service's series continue from
    where the crashed process left them.

    The concurrent ingest front increments these from its
    worker threads while the scheduler thread increments and
    snapshots them, so every mutation (and `as_dict`, which iterates
    the reason dicts) runs under the ledger's own lock.  The registry
    mirror calls stay OUTSIDE the lock — the registry locks itself,
    and nesting the two would couple their lock orders for nothing."""

    tenant: str = ""             # registry label; "" = unattributed
    admitted: int = 0
    quarantined: int = 0         # reports refused at the door
    shed: int = 0                # reports dropped by backpressure
    pages_sealed: int = 0
    pages_corrupt: int = 0       # digest-check failures (detected)
    epochs_started: int = 0
    epochs_completed: int = 0
    epochs_truncated: int = 0    # deadline-missed, degraded output
    epochs_failed: int = 0       # supervision gave up after retries
    epochs_refused: int = 0      # begin_epoch hit the queue bound
    deadline_misses: int = 0
    rounds: int = 0              # scheduler quanta executed
    resumes: int = 0             # snapshot restores of this tenant
    quarantine_reasons: dict = field(default_factory=dict)
    shed_reasons: dict = field(default_factory=dict)

    def __post_init__(self):
        # Not a dataclass field: the lock never serializes (asdict
        # walks fields only) and a restored ledger builds a fresh one.
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        """Increment one counter field, mirroring into the registry
        when the field has a Prometheus twin (_SERVICE_SERIES)."""
        with self._lock:
            setattr(self, name, getattr(self, name) + n)
        series = _SERVICE_SERIES.get(name)
        if series is not None:
            (metric, outcome) = series
            labels = {"tenant": self.tenant}
            if outcome is not None:
                labels["outcome"] = outcome
            get_registry().counter(metric, **labels).inc(n)

    def bump_quarantine(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.quarantine_reasons[reason] = \
                self.quarantine_reasons.get(reason, 0) + n
        get_registry().counter("mastic_reports_quarantined_total",
                               tenant=self.tenant,
                               reason=reason).inc(n)

    def bump_shed(self, reason: str, n: int = 1) -> None:
        with self._lock:
            self.shed_reasons[reason] = \
                self.shed_reasons.get(reason, 0) + n
        get_registry().counter("mastic_reports_shed_total",
                               tenant=self.tenant,
                               reason=reason).inc(n)

    def export_registry(self) -> None:
        """(Re)publish this ledger's totals into the registry —
        called at tenant construction (so every tenant's series exist
        from boot, at zero) and after a snapshot restore (so the
        series continue from the persisted totals instead of
        restarting at zero)."""
        reg = get_registry()
        for (name, (metric, outcome)) in _SERVICE_SERIES.items():
            labels = {"tenant": self.tenant}
            if outcome is not None:
                labels["outcome"] = outcome
            reg.counter(metric, **labels).set_total(
                getattr(self, name))
        for (reason, n) in self.quarantine_reasons.items():
            reg.counter("mastic_reports_quarantined_total",
                        tenant=self.tenant,
                        reason=reason).set_total(n)
        for (reason, n) in self.shed_reasons.items():
            reg.counter("mastic_reports_shed_total",
                        tenant=self.tenant,
                        reason=reason).set_total(n)
        reg.counter("mastic_rounds_total",
                    tenant=self.tenant).set_total(self.rounds)
        reg.counter("mastic_session_retries_total",
                    tenant=self.tenant).inc(0)
        reg.gauge("mastic_buffered_reports",
                  tenant=self.tenant).set(0)
        reg.gauge("mastic_pending_epochs",
                  tenant=self.tenant).set(0)

    def as_dict(self) -> dict:
        # Under the lock: asdict deep-copies the reason dicts, and an
        # ingest worker bumping one mid-iteration would otherwise
        # tear the snapshot (RuntimeError at best, torn ledger at
        # worst).
        with self._lock:
            return asdict(self)

    @classmethod
    def from_dict(cls, data: dict) -> "ServiceCounters":
        return cls(**data)


def attribute_rejections(metrics: RoundMetrics, eval_proof_ok,
                         weight_check_ok=None, joint_rand_ok=None,
                         device_ok=None) -> np.ndarray:
    """Fill the verdict counters from per-report check masks; returns
    the combined accept mask.  Attribution is to the first failing
    check in protocol order.  Lanes where `device_ok` is False carried
    garbage through the device checks; they are left out here and
    attributed by the caller."""
    eval_proof_ok = np.asarray(eval_proof_ok, bool)
    valid = (np.ones_like(eval_proof_ok) if device_ok is None
             else np.asarray(device_ok, bool))
    accept = eval_proof_ok & valid
    metrics.rejected_eval_proof = int((valid & ~eval_proof_ok).sum())
    if weight_check_ok is not None:
        weight_check_ok = np.asarray(weight_check_ok, bool)
        metrics.rejected_weight_check = int(
            (valid & eval_proof_ok & ~weight_check_ok).sum())
        accept &= weight_check_ok
    if joint_rand_ok is not None:
        joint_rand_ok = np.asarray(joint_rand_ok, bool)
        metrics.rejected_joint_rand = int((accept & ~joint_rand_ok).sum())
        accept &= joint_rand_ok
    metrics.accepted = int(accept.sum())
    return accept


def count_round_ops(metrics: RoundMetrics, mastic, num_reports: int,
                    nodes_evaluated: int,
                    include_key_setup: bool = False) -> None:
    """Structural op counts for one aggregator's round, doubled for the
    pair: per node eval 1 extend block, 1 + ceil(VALUE_LEN * elem / 16)
    convert blocks and 1 node-proof permutation.  `nodes_evaluated` is
    the per-report child-node count the round materialises."""
    payload_bytes = mastic.value_len * mastic.field.ENCODED_SIZE
    convert_blocks = 1 + (payload_bytes + 15) // 16
    per_agg = num_reports * nodes_evaluated
    metrics.node_evals = 2 * per_agg
    # extend: one 2-block AES call per parent = 1 block per child.
    metrics.aes_extend_blocks = 2 * per_agg
    metrics.aes_convert_blocks = 2 * per_agg * convert_blocks
    metrics.keccak_node_proofs = 2 * per_agg
    if include_key_setup:
        metrics.extra["aes_key_schedules"] = 4 * num_reports
        metrics.extra["fixed_key_derivations"] = 4 * num_reports


def count_round_bytes(metrics: RoundMetrics, mastic, agg_param,
                      num_reports: int) -> None:
    use_jr = mastic.valid.JOINT_RAND_LEN > 0
    (_level, _prefixes, do_weight_check) = agg_param
    # Uploads are paid once per collection, on the round the reports
    # enter it, which the drivers mark with the weight check.
    if do_weight_check:
        metrics.bytes_upload = num_reports * upload_bytes(mastic)
    metrics.bytes_prep_shares = \
        2 * num_reports * wire.prep_share_size(mastic, agg_param)
    if do_weight_check and use_jr:
        metrics.bytes_prep_msgs = num_reports * wire.SEED_SIZE
    metrics.bytes_agg_shares = 2 * wire.agg_share_size(mastic, agg_param)


def upload_bytes(mastic) -> int:
    """Per-report upload to one aggregator pair: the public share (the
    packed ctrl bits, then per level a seed, a proof and a payload
    correction word) and both input shares."""
    bits = mastic.bits
    elem = mastic.field.ENCODED_SIZE
    public = (2 * bits + 7) // 8 + bits * (16 + 32) \
        + bits * mastic.value_len * elem
    return public + wire.input_share_size(mastic, 0) \
        + wire.input_share_size(mastic, 1)
