"""The port's observability layer against the JAX package's: the extra
schema (`obs/schema.py`), device-time attribution (`obs/devtime.py`),
the service ledger (`metrics.ServiceCounters`), the status surface
(`obs/statusz.py`), the one-shot profile lever, and the runs' round
telemetry (the "round" spans, every producer's blocks through the
schema).  Everything here is strings, counters and dicts: compared
exactly.  No JAX program is compiled."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from mastic_tpu import metrics as jmetrics
from mastic_tpu.obs import devtime as jdevtime
from mastic_tpu.obs import registry as jregistry
from mastic_tpu.obs import schema as jschema
from mastic_tpu.obs import statusz as jstatusz
import mastic_tpu_torch.backend.mastic as tbm
from mastic_tpu_torch import metrics as tmetrics
from mastic_tpu_torch.drivers.attribute_metrics import (AttributeMetricsRun,
                                                        hash_attribute)
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
from mastic_tpu_torch.obs import devtime as tdevtime
from mastic_tpu_torch.obs import registry as tregistry
from mastic_tpu_torch.obs import schema as tschema
from mastic_tpu_torch.obs import statusz as tstatusz
from mastic_tpu_torch.obs import trace as ttrace

CTX = b"torch obs"
VK = bytes(range(32))


@pytest.fixture()
def registries():
    """Fresh registries in both packages, restored afterwards."""
    pair = (jregistry.configure(), tregistry.configure())
    yield pair
    jregistry.configure()
    tregistry.configure()


def _chunk(i=0):
    return {"chunk": i, "stage_start_ms": 0.0, "stage_end_ms": 1.0,
            "collect_start_ms": 1.0, "collect_end_ms": 2.0,
            "phases": {"upload_ms": 0.1, "dispatch_ms": 0.2,
                       "compute_wait_ms": 0.3, "download_ms": 0.1,
                       "host_ms": 0.1},
            "host_syncs": 1, "reports": 4, "wall_ms": 2.0}


def _extra():
    return {
        "chunks": [_chunk(0), _chunk(1)],
        "pipeline": {"mode": "pipelined", "fallback": None,
                     "round_wall_ms": 4.0, "overlap_efficiency": 0.4},
        "mesh": {"report_shards": 2, "psum_bytes_per_round": 128,
                 "shard_wait_skew_ms_p50": 0.0,
                 "shard_wait_skew_ms_max": 0.1},
        "service": {"tenant": "a", "epoch": 0, "sched_overhead_ms": 0.2,
                    "buffered_reports": 0, "pending_epochs": 0},
        "artifacts": {"store": None, "hits": 0, "inline_compiles": 0},
    }


def _set(key, value):
    def mutate(e):
        (block, _, field) = key.partition(".")
        target = e[block][0] if block == "chunks" else e[block]
        if field.startswith("phases."):
            target = target["phases"]
            field = field[len("phases."):]
        target[field] = value
    return mutate


def _pop(key):
    def mutate(e):
        (block, _, field) = key.partition(".")
        target = e[block][0] if block == "chunks" else e[block]
        if field.startswith("phases."):
            target = target["phases"]
            field = field[len("phases."):]
        target.pop(field)
    return mutate


@pytest.mark.parametrize("mutate", [
    lambda e: None,
    _pop("chunks.wall_ms"),
    _pop("chunks.phases.host_ms"),
    _set("chunks.phases.upload_ms", "fast"),
    _set("chunks.phases", [1, 2]),
    lambda e: e.__setitem__("chunks", {"not": "a list"}),
    _pop("pipeline.round_wall_ms"),
    _set("pipeline.mode", "warp"),
    _set("pipeline.fallback", 3),
    _set("pipeline.round_wall_ms", "slow"),
    _pop("mesh.report_shards"),
    _pop("service.tenant"),
    _set("service.tenant", 7),
    _pop("artifacts.hits"),
    _set("artifacts.store", 5),
    _set("artifacts.inline_compiles", True),
    lambda e: e.pop("artifacts"),
    lambda e: e.__setitem__("schema", 99),
], ids=["valid", "chunk-wall", "chunk-phase", "phase-type", "phases-type",
        "chunks-type", "pipeline-wall", "pipeline-mode", "pipeline-fallback",
        "pipeline-wall-type", "mesh-key", "service-key", "service-tenant",
        "artifacts-key", "artifacts-store", "artifacts-bool", "no-artifacts",
        "version"])
def test_schema_matrix_equals_jax(mutate):
    """The accept and reject matrix: the port's validate_extra names the
    JAX package's problems for every drifted record, and stamp accepts
    or refuses the same records."""
    (ej, et) = (_extra(), _extra())
    mutate(ej)
    mutate(et)
    problems = jschema.validate_extra(ej)
    assert tschema.validate_extra(et) == problems
    if problems:
        with pytest.raises(ValueError, match="schema violation"):
            tschema.stamp(et)
    else:
        tschema.stamp(et)
        assert et["schema"] == jschema.SCHEMA_VERSION
    for name in ("CHUNK_REQUIRED", "PHASE_REQUIRED", "PIPELINE_REQUIRED",
                 "PIPELINE_MODES", "MESH_REQUIRED", "SERVICE_REQUIRED",
                 "ARTIFACTS_REQUIRED", "SCHEMA_VERSION"):
        assert getattr(tschema, name) == getattr(jschema, name)


def test_round_metrics_validate_extra_stamps():
    mx = tmetrics.RoundMetrics(level=0, frontier_width=2, padded_width=4,
                               reports_total=3)
    mx.extra["pipeline"] = {"mode": "serial", "fallback": None,
                            "round_wall_ms": 1.0, "overlap_efficiency": 0.0}
    mx.validate_extra()
    assert mx.extra["schema"] == tschema.SCHEMA_VERSION
    mx.extra["pipeline"].pop("mode")
    with pytest.raises(ValueError, match="pipeline: missing mode"):
        mx.validate_extra()


def _fill(cls, seed: int):
    """A RoundMetrics record with the same random counters and blocks in
    either package."""
    rng = np.random.default_rng(seed)
    mx = cls(level=1, frontier_width=4, padded_width=8, reports_total=100,
             accepted=int(rng.integers(50, 90)))
    mx.rejected_eval_proof = int(rng.integers(0, 3))
    mx.rejected_weight_check = int(rng.integers(0, 3))
    mx.rejected_fallback = int(rng.integers(0, 2))
    mx.extra["round_wall_ms"] = float(rng.integers(1, 100))
    chunk = _chunk()
    chunk["phases"]["compile_ms"] = 5.0
    mx.extra["chunks"] = [chunk]
    mx.extra["pipeline"] = {"mode": "resident-deferred", "fallback": None,
                            "round_wall_ms": 3.0, "overlap_efficiency": 0.0,
                            "phases": {"upload_ms": 0.5, "dispatch_ms": 1.5,
                                       "compute_wait_ms": 2.0,
                                       "host_ms": 0.25}}
    return mx


def test_observe_round_series_equal_jax(registries):
    (jreg, treg) = registries
    for seed in range(3):
        jdevtime.observe_round(_fill(jmetrics.RoundMetrics, seed),
                               tenant=f"t{seed % 2}")
        tdevtime.observe_round(_fill(tmetrics.RoundMetrics, seed),
                               tenant=f"t{seed % 2}")
    assert treg.prometheus_text() == jreg.prometheus_text()
    assert treg.snapshot() == jreg.snapshot()


def test_service_counters_and_export_equal_jax(registries):
    (jreg, treg) = registries
    ledgers = []
    for (mod, reg) in ((jmetrics, jreg), (tmetrics, treg)):
        c = mod.ServiceCounters(tenant="acme")
        c.export_registry()
        for (name, n) in (("admitted", 5), ("quarantined", 2), ("shed", 3),
                          ("pages_sealed", 2), ("epochs_started", 1),
                          ("epochs_completed", 1), ("rounds", 4),
                          ("deadline_misses", 1), ("pages_corrupt", 1)):
            c.inc(name, n)
        c.bump_quarantine("malformed", 2)
        c.bump_shed("reject-newest", 2)
        c.bump_shed("ingest-queue-full")
        restored = mod.ServiceCounters.from_dict(c.as_dict())
        restored.resumes += 1
        restored.export_registry()
        ledgers.append((c.as_dict(), restored.as_dict(),
                        reg.prometheus_text()))
    assert ledgers[1] == ledgers[0]
    assert tmetrics._SERVICE_SERIES == jmetrics._SERVICE_SERIES


def _snapshot() -> dict:
    """One published service snapshot (the `metrics()` shape), with a
    suspended tenant, reason tables, an epoch and a chunk timeline."""
    counters = tmetrics.ServiceCounters(
        tenant="count", admitted=9, quarantined=2, shed=4,
        quarantine_reasons={"malformed": 2},
        shed_reasons={"reject-newest": 4})
    return {"policy": "reject-newest", "resumed": True, "overlap": 2,
            "ingest_threads": 1, "inflight_rounds": 0, "tenants": {
                "count": {"buffered_reports": 3, "open_page": 1,
                          "sealed_pages": 1, "pending_epochs": 0,
                          "active_epoch": None, "suspended": False,
                          "counters": counters.as_dict(),
                          "epochs": [{"epoch": 0, "reports": 6,
                                      "truncated": False,
                                      "levels_completed": 2,
                                      "wall_s": 0.5}],
                          "last_round_timeline": [_chunk(0), _chunk(1)]},
                "flood": {"buffered_reports": 0, "suspended": True,
                          "counters": {"admitted": 0},
                          "epochs": [], "last_round_timeline": None}}}


def test_render_statusz_equals_jax():
    snap = _snapshot()
    assert tstatusz.render_statusz(snap) == jstatusz.render_statusz(snap)
    assert tstatusz.render_statusz({}) == jstatusz.render_statusz({})


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return (resp.status, resp.read().decode())
    except urllib.error.HTTPError as exc:
        return (exc.code, exc.read().decode())


def test_status_server_endpoints_equal_jax(registries):
    """Both packages' status servers over HTTP, each over its own
    registry holding the same series and the same published snapshot:
    equal /metrics and /statusz, /varz with the same keys, 404 alike."""
    (jreg, treg) = registries
    for (mod, reg) in ((jmetrics, jreg), (tmetrics, treg)):
        c = mod.ServiceCounters(tenant="count")
        c.export_registry()
        c.inc("admitted", 3)
    servers = [jstatusz.StatusServer(port=0).start(),
               tstatusz.StatusServer(port=0).start()]
    try:
        for s in servers:
            s.publish(_snapshot())
        got = [{path: _get(s.port, path) for path in
                ("/metrics", "/statusz", "/nosuch")} for s in servers]
        for g in got:
            # The port's help strings name its own modules.
            g["/metrics"] = (g["/metrics"][0], [
                line for line in g["/metrics"][1].splitlines()
                if not line.startswith("# HELP")])
        assert got[1] == got[0]
        assert got[1]["/nosuch"][0] == 404
        varz = [json.loads(_get(s.port, "/varz")[1]) for s in servers]
        assert sorted(varz[1]) == sorted(varz[0])
        assert varz[1]["service"] == varz[0]["service"]
        assert varz[1]["metrics"] == varz[0]["metrics"]
    finally:
        for s in servers:
            s.stop()


def _count_reports(bits: int, values: list, seed: int = 0) -> tuple:
    m = tbm.MasticCount(bits)
    rng = np.random.default_rng(seed)
    reports = []
    for v in values:
        alpha = tuple(bool((v >> (bits - 1 - i)) & 1) for i in range(bits))
        (nonce, rand) = (rng.bytes(16), rng.bytes(m.RAND_SIZE))
        reports.append((nonce,) + m.scalar().shard(CTX, (alpha, True),
                                                   nonce, rand))
    return (m, reports)


def test_profile_lever_is_one_shot(monkeypatch, tmp_path):
    """MASTIC_TORCH_PROFILE brackets the first round stepped after it is
    armed in torch.profiler and writes one Chrome trace; later rounds
    run unprofiled, and the JAX package's lever is not read."""
    monkeypatch.delenv("MASTIC_TORCH_PROFILE", raising=False)
    monkeypatch.setenv("MASTIC_JAX_PROFILE", str(tmp_path / "jax"))
    tdevtime.reset_profile_lever()
    assert tdevtime.take_profile_dir() is None
    monkeypatch.setenv("MASTIC_TORCH_PROFILE", str(tmp_path / "prof"))
    assert tdevtime.take_profile_dir() == str(tmp_path / "prof")
    assert tdevtime.take_profile_dir() is None
    tdevtime.reset_profile_lever()
    (m, reports) = _count_reports(2, [0, 3, 3])
    run = HeavyHittersRun(m, CTX, {"default": 2}, VK, device="cpu",
                          reports=reports)
    handle = run.step_begin()
    assert handle["prof"] is not None
    run.step_finish(handle)
    assert handle["profile_trace"].startswith(str(tmp_path / "prof"))
    traces = list((tmp_path / "prof").glob("round-*.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
    run.step()
    assert len(list((tmp_path / "prof").glob("*.json"))) == 1
    assert not (tmp_path / "jax").exists()
    tdevtime.reset_profile_lever()


def test_runs_stamp_schema_and_round_spans(registries, tmp_path):
    """Every producer of the port passes the schema: the resident runner
    (its "pipeline" block, mode resident-deferred), the chunked runner
    ("chunks", "pipeline"), the from-root engine and both attribute
    rounds; each round lands a detached "round" span with the JAX
    package's attributes, and the registry series per tenant."""
    (_jreg, treg) = registries
    path = tmp_path / "trace.jsonl"
    ttrace.configure(trace_file=str(path))
    try:
        (m, reports) = _count_reports(3, [0, 0, 5, 5, 7, 1])
        records = []
        for kwargs in ({}, {"chunk_size": 4}, {"incremental": False}):
            run = HeavyHittersRun(m, CTX, {"default": 2}, VK, device="cpu",
                                  reports=reports, **kwargs)
            run.obs_tenant = "hh"
            while run.step():
                pass
            records += run.metrics
        resident = [mx.extra["pipeline"] for mx in records[:3]]
        assert all(p["mode"] == "resident-deferred"
                   and set(p["phases"]) == {"upload_ms", "dispatch_ms",
                                            "compute_wait_ms", "host_ms"}
                   for p in resident)
        assert all(mx.extra["chunks"] for mx in records[3:6])
        ms = tbm.MasticSum(4, 7)
        attrs = ["a", "b"]
        rng = np.random.default_rng(1)
        areps = []
        for (a, w) in (("a", 3), ("b", 5), ("a", 7)):
            (nonce, rand) = (rng.bytes(16), rng.bytes(ms.RAND_SIZE))
            areps.append((nonce,) + ms.scalar().shard(
                CTX, (hash_attribute(ms, a), w), nonce, rand))
        for chunk_size in (None, 2):
            run = AttributeMetricsRun(ms, CTX, attrs, VK, device="cpu",
                                      reports=areps, chunk_size=chunk_size)
            run.obs_tenant = "attrs"
            run.step()
            assert run.result() == [("a", 10), ("b", 5)]
            records += run.metrics
        assert all(mx.extra["schema"] == tschema.SCHEMA_VERSION
                   for mx in records)
        assert all(tschema.validate_extra(mx.extra) == [] for mx in records)
        spans = [s for s in ttrace.read_jsonl(str(path))
                 if s["name"] == "round"]
        assert len(spans) == 9 + 2
        assert all(set(s["attrs"]) == {"tenant", "round", "level",
                                       "frontier_width", "reports",
                                       "profiled"} for s in spans)
        assert [s["attrs"]["level"] for s in spans[:3]] == [0, 1, 2]
        assert spans[-1]["attrs"] == {"tenant": "attrs", "round": 0,
                                      "level": 3, "frontier_width": 2,
                                      "reports": 3, "profiled": False}
        assert treg.counter("mastic_rounds_total", tenant="hh").value() == 9
        assert treg.counter("mastic_rounds_total",
                            tenant="attrs").value() == 2
        assert treg.histogram("mastic_round_wall_ms",
                              tenant="attrs").value()["count"] == 2
        # The resident and chunked phases feed the phase histogram; the
        # port compiles nothing, so no compile time is attributed.
        assert treg.histogram("mastic_chunk_phase_ms",
                              phase="host").value()["count"] >= 6
        assert not treg.counter("mastic_device_time_ms_total",
                                kind="compile").value()
    finally:
        ttrace.configure(trace_file="")


def test_span_closes_with_the_error_when_a_round_raises(registries):
    (m, reports) = _count_reports(2, [0, 3])
    run = HeavyHittersRun(m, CTX, {"default": 2}, VK, device="cpu",
                          reports=reports)
    tracer = ttrace.configure()
    handle = run.step_begin()
    handle["agg_param"] = (0, (), True)   # the collect cannot unpack it
    handle.pop("plan")
    with pytest.raises(KeyError):
        run.step_finish(handle)
    (span,) = [s for s in tracer.spans() if s.name == "round"]
    assert span.attrs["error"] == "KeyError"
    assert span.duration_ms is not None
