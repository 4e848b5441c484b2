"""The ONE versioned schema for `RoundMetrics.extra` (copy of
`mastic_tpu/obs/schema.py`: the three `extra` schemas unified).

Before this module, three layers stamped `extra` blocks with
incompatible key sets: the chunked heavy-hitters runner, the resident
runner and the chunked attribute-metrics round each invented their
own `pipeline` record (some with `round_wall_ms`, some without; the
attribute path's chunk records lacked `wall_ms` entirely), and the
collector service appended a fourth shape on top.  Nothing validated
any of them, so a consumer (bench JSON diffing, the statusz last-round
timeline) had to special-case every producer.

This module is the contract:

* `SCHEMA_VERSION` — bumped whenever a required key is added or a
  type changes; stamped into `extra["schema"]` by `stamp()`;
* required key sets per block (chunks / pipeline / mesh / service) —
  the INTERSECTION every producer must stamp.  Producers may add
  optional keys (the chunked runner's node-eval rates, the resident
  runner's phase record), but serial-fallback and pipelined rounds of
  one producer must stamp the SAME required set, which
  `validate_extra` enforces;
* `validate_extra(extra)` — returns a list of problem strings (empty
  when valid); `stamp(extra)` raises on problems and writes the
  version.  `RoundMetrics.validate_extra()` delegates here, and every
  driver calls it right before appending the metrics record, so a
  drifting producer fails its own tests instead of surprising a
  consumer.

Block shapes (all times float milliseconds):

  extra["chunks"]   [ {chunk, stage_start_ms, stage_end_ms,
                       collect_start_ms, collect_end_ms, phases,
                       host_syncs, reports, wall_ms, ...} ]
                    phases holds at least {upload_ms, dispatch_ms,
                    compute_wait_ms, download_ms, host_ms}
                    (compile_ms where an AOT cache is in play)
  extra["pipeline"] {mode, fallback, round_wall_ms,
                     overlap_efficiency, ...}
                    mode in {"pipelined", "serial",
                    "resident-deferred"}; fallback is None or the
                    named degrade reason
  extra["mesh"]     {report_shards, psum_bytes_per_round,
                     shard_wait_skew_ms_p50, shard_wait_skew_ms_max,
                     ...}
  extra["service"]  {tenant, epoch, sched_overhead_ms,
                     buffered_reports, pending_epochs}
  extra["artifacts"] {store, hits, inline_compiles, ...}
                    the AOT artifact-store stamp: store path
                    (None = no store armed), per-round artifact
                    hits vs inline compiles
"""

from typing import Optional

SCHEMA_VERSION = 1

CHUNK_REQUIRED = frozenset((
    "chunk", "stage_start_ms", "stage_end_ms", "collect_start_ms",
    "collect_end_ms", "phases", "host_syncs", "reports", "wall_ms"))

PHASE_REQUIRED = frozenset((
    "upload_ms", "dispatch_ms", "compute_wait_ms", "download_ms",
    "host_ms"))

PIPELINE_REQUIRED = frozenset((
    "mode", "fallback", "round_wall_ms", "overlap_efficiency"))

PIPELINE_MODES = ("pipelined", "serial", "resident-deferred")

MESH_REQUIRED = frozenset((
    "report_shards", "psum_bytes_per_round",
    "shard_wait_skew_ms_p50", "shard_wait_skew_ms_max"))

SERVICE_REQUIRED = frozenset((
    "tenant", "epoch", "sched_overhead_ms", "buffered_reports",
    "pending_epochs"))

# The kernel-store stamp (drivers/artifacts.py): per-round store hits
# vs inline nvcc builds of the kernel libraries, and which store served
# them (None = no store consulted).  Every round producer (resident,
# chunked and from-root) stamps it.
ARTIFACTS_REQUIRED = frozenset((
    "store", "hits", "inline_compiles"))


def _missing(block: dict, required: frozenset) -> Optional[str]:
    missing = sorted(required - set(block))
    return ", ".join(missing) if missing else None


def _num(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def validate_extra(extra: dict) -> list:
    """Problems with the observability blocks of one metrics record
    (empty list = valid).  Only the four owned blocks are checked;
    other extra keys (round_wall_ms, memory, quarantine, ...) are the
    producers' own."""
    problems: list = []
    chunks = extra.get("chunks")
    if chunks is not None:
        if not isinstance(chunks, list):
            problems.append("chunks: must be a list of chunk records")
        else:
            for (i, rec) in enumerate(chunks):
                miss = _missing(rec, CHUNK_REQUIRED)
                if miss:
                    problems.append(f"chunks[{i}]: missing {miss}")
                    continue
                phases = rec["phases"]
                if not isinstance(phases, dict):
                    problems.append(f"chunks[{i}].phases: must be a "
                                    f"dict of phase -> ms")
                    continue
                miss = _missing(phases, PHASE_REQUIRED)
                if miss:
                    problems.append(
                        f"chunks[{i}].phases: missing {miss}")
                bad = [k for (k, v) in phases.items() if not _num(v)]
                if bad:
                    problems.append(
                        f"chunks[{i}].phases: non-numeric "
                        f"{sorted(bad)}")
    pipeline = extra.get("pipeline")
    if pipeline is not None:
        miss = _missing(pipeline, PIPELINE_REQUIRED)
        if miss:
            problems.append(f"pipeline: missing {miss}")
        else:
            if pipeline["mode"] not in PIPELINE_MODES:
                problems.append(
                    f"pipeline.mode: {pipeline['mode']!r} not in "
                    f"{PIPELINE_MODES}")
            fb = pipeline["fallback"]
            if fb is not None and not isinstance(fb, str):
                problems.append("pipeline.fallback: must be None or "
                                "the named degrade reason")
            if not _num(pipeline["round_wall_ms"]):
                problems.append("pipeline.round_wall_ms: non-numeric")
    mesh = extra.get("mesh")
    if mesh is not None:
        miss = _missing(mesh, MESH_REQUIRED)
        if miss:
            problems.append(f"mesh: missing {miss}")
    artifacts = extra.get("artifacts")
    if artifacts is not None:
        miss = _missing(artifacts, ARTIFACTS_REQUIRED)
        if miss:
            problems.append(f"artifacts: missing {miss}")
        else:
            store = artifacts["store"]
            if store is not None and not isinstance(store, str):
                problems.append("artifacts.store: must be None or "
                                "the store path")
            for field in ("hits", "inline_compiles"):
                if not _num(artifacts[field]):
                    problems.append(f"artifacts.{field}: non-numeric")
    service = extra.get("service")
    if service is not None:
        miss = _missing(service, SERVICE_REQUIRED)
        if miss:
            problems.append(f"service: missing {miss}")
        elif not isinstance(service["tenant"], str):
            problems.append("service.tenant: must be the tenant name")
    version = extra.get("schema")
    if version is not None and version != SCHEMA_VERSION:
        problems.append(f"schema: version {version} != "
                        f"{SCHEMA_VERSION}")
    return problems


def stamp(extra: dict) -> None:
    """Validate and version-stamp one metrics record's extra dict;
    raises ValueError naming every problem (a drifting producer must
    fail its own round, not a downstream consumer)."""
    problems = validate_extra(extra)
    if problems:
        raise ValueError("RoundMetrics.extra schema violation: "
                         + "; ".join(problems))
    extra["schema"] = SCHEMA_VERSION
