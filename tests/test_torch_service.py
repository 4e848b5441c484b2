"""The port's collector service (`drivers/service.py`) against the JAX
package's and against the port's offline runs.

* Host machinery: the same uploads into JAX's `CollectorService` and
  the port's (device "cpu"), no round stepped, give equal verdicts,
  `metrics()`, page payloads and digests, and snapshot arrays: malformed
  uploads, quotas under both shed policies, suspension, a full ingest
  queue, and corrupted and truncated page flushes (an epoch of only
  corrupt pages fails alike in both, with no round).
* End to end: the port's service over a MasticCount(2) heavy-hitters
  tenant and a MasticSum(4, 15) attribute tenant equals the port's
  offline `HeavyHittersRun` and `aggregate_by_attribute`, serially and
  at overlap 2, across a mid-epoch `to_bytes` / `from_bytes`; a
  snapshot the JAX package's service writes mid-epoch resumes in the
  port to the same result.
* The run interface: `frontier()` and `rounds_completed()` equal JAX's
  at every level, through checkpoints; which handles are atomic.
* The tools: `tools.serve --smoke` on the CPU, and no fallback without
  a card.

Bytes, counters and field values throughout: compared exactly.  The
JAX side runs no round here except in the slow case (its first round
compiles for about a minute on the CPU); it restores runs from
checkpoints, which compiles nothing."""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mastic_tpu.drivers.service as jservice
import mastic_tpu.mastic as jm
from mastic_tpu.drivers.heavy_hitters import HeavyHittersRun as JaxRun
from mastic_tpu.net import loadgen as jloadgen
from mastic_tpu.obs import registry as jregistry
import mastic_tpu_torch.backend.mastic as tbm
import mastic_tpu_torch.drivers.faults as tfaults
import mastic_tpu_torch.drivers.service as tservice
from mastic_tpu.drivers import faults as jfaults
from mastic_tpu_torch.drivers.attribute_metrics import (
    aggregate_by_attribute, hash_attribute)
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
from mastic_tpu_torch.obs import registry as tregistry

CTX = b"torch service"
VK = bytes(range(32))
COUNT2 = {"class": "MasticCount", "args": [2]}
SUM4 = {"class": "MasticSum", "args": [4, 15]}
ATTRS = ["checkout", "landing", "search"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(port: bool):
    return (tservice, tfaults) if port else (jservice, jfaults)


def _service(port: bool, specs: list, injector=None, **cfg):
    (mod, _f) = _pkg(port)
    base = dict(page_size=3, max_buffered=64, max_pending_epochs=4,
                quarantine_limit=16, epoch_deadline=600.0)
    base.update(cfg)
    kwargs = {"device": "cpu"} if port else {}
    return mod.CollectorService(
        [mod.TenantSpec(**s) for s in specs],
        config=mod.ServiceConfig(**base), injector=injector, **kwargs)


def _spec(name: str, **over) -> dict:
    out = dict(name=name, spec=COUNT2, ctx=CTX, verify_key=VK,
               thresholds={"default": 2})
    out.update(over)
    return out


def _blobs(count: int, replay: int) -> list:
    return jloadgen.build_blob_pool(jm.MasticCount(2), CTX, count, 2,
                                    replay=replay)


def _pages(svc) -> dict:
    """Every tenant's page bytes: open blobs, sealed payloads and
    digests, queued epochs' pages."""
    def page(p):
        return (p.count, p.payload, p.digest, list(p.blobs))
    out = {}
    for (name, t) in svc.tenants.items():
        out[name] = {"open": page(t.open_page),
                     "sealed": [page(p) for p in t.sealed],
                     "pending": [(ep.epoch_id, [page(p) for p in ep.pages])
                                 for ep in t.pending],
                     "suspended": t.suspended}
    return out


def _snapshot_arrays(blob: bytes) -> tuple:
    hlen = int.from_bytes(blob[:4], "little")
    arrays = np.load(io.BytesIO(blob[4 + hlen:]), allow_pickle=False)
    return (json.loads(blob[4:4 + hlen]),
            {k: arrays[k].tobytes() for k in sorted(arrays.files)})


def _admission_script(port: bool, policy: str) -> tuple:
    """Malformed uploads, quotas, suspension and epoch cuts, no round."""
    (_mod, faults) = _pkg(port)
    specs = [_spec("count"), _spec("flood", max_buffered=4),
             _spec("bad", quarantine_limit=2)]
    svc = _service(port, specs, shed_policy=policy)
    good = _blobs(12, 1)
    verdicts = [svc.submit("count", b) for b in good[:5]]
    verdicts += [svc.submit("count", b) for b in (b"", b"\x07garbage",
                                                  good[0][:-3])]
    verdicts += [svc.submit("flood", b) for b in good[:3]]
    verdicts.append(svc.begin_epoch("flood"))
    verdicts += [svc.submit("flood", b) for b in good[3:9]]
    verdicts.append(svc.begin_epoch("flood"))
    verdicts += [svc.submit("bad", b) for b in (b"x", b"y", good[0])]
    verdicts += [svc.begin_epoch("count"), svc.begin_epoch("bad")]
    verdicts.append(sorted(svc.report_digests("count")))
    return (verdicts, svc.metrics(), _pages(svc),
            _snapshot_arrays(svc.to_bytes()))


@pytest.mark.parametrize("policy", ["reject-newest", "oldest-epoch-first"])
def test_admission_machinery_equals_jax(policy):
    """Verdicts, metrics, pages and snapshot arrays equal JAX's."""
    jregistry.configure()
    tregistry.configure()
    want = _admission_script(False, policy)
    got = _admission_script(True, policy)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    shed = want[1]["tenants"]["flood"]["counters"]["shed_reasons"]
    assert shed.get(policy) or shed.get("reject-newest")
    assert want[1]["tenants"]["bad"]["suspended"]


def _queue_full(port: bool) -> tuple:
    """A stopped ingest worker behind a queue of one: the first upload
    queues, the rest shed ingest-queue-full, counted."""
    svc = _service(port, [_spec("count")], ingest_threads=1, ingest_queue=1)
    front = svc._ingest
    front._stop.set()
    for th in front.threads:
        th.join(timeout=5.0)
    out = [svc.submit("count", b) for b in _blobs(3, 2)]
    counters = svc.metrics()["tenants"]["count"]["counters"]
    front.queue.get_nowait()
    front.queue.task_done()
    svc._ingest = None
    return (out, counters)


def test_queue_full_equals_jax():
    jregistry.configure()
    tregistry.configure()
    want = _queue_full(False)
    assert _queue_full(True) == want
    assert want[0][1] == ("shed", "ingest-queue-full")


def _corrupt_pages(port: bool) -> tuple:
    """Every page of an epoch corrupted or truncated after its digest:
    the cut and the step detect them, and the epoch fails with no
    surviving report (no round runs)."""
    (_mod, faults) = _pkg(port)
    inj = faults.FaultInjector(faults.parse_faults(
        "corrupt:party=collector:step=page_flush:nth=1:offset=9;"
        "truncate:party=collector:step=page_flush:nth=2:cut=5"),
        "collector")
    svc = _service(port, [_spec("count")], injector=inj, page_size=2)
    for b in _blobs(4, 3):
        svc.submit("count", b)
    pages = _pages(svc)
    epoch = svc.begin_epoch("count")
    arrays = _snapshot_arrays(svc.to_bytes())
    more = svc.step()
    mx = svc.metrics()
    for rec in mx["tenants"]["count"]["epochs"]:
        rec.pop("wall_s", None)
    return (pages, epoch, arrays, more, mx)


def test_corrupt_and_truncated_pages_equal_jax():
    jregistry.configure()
    tregistry.configure()
    want = _corrupt_pages(False)
    assert _corrupt_pages(True) == want
    rec = want[4]["tenants"]["count"]
    assert rec["counters"]["pages_corrupt"] == 2
    assert rec["epochs"][0]["error"] == "no surviving reports"


# -- end to end on the port -------------------------------------------

def _path(v: int, bits: int) -> tuple:
    return tuple(bool((v >> (bits - 1 - i)) & 1) for i in range(bits))


@pytest.fixture(scope="module")
def e2e():
    """The two tenants' scalar reports and the port's offline results."""
    rng = np.random.default_rng(7)
    m = tbm.MasticCount(2)
    count = []
    for v in [0, 3, 3, 1, 3, 0, 2, 0]:
        (nonce, rand) = (rng.bytes(16), rng.bytes(m.RAND_SIZE))
        count.append((nonce,) + m.scalar().shard(CTX, (_path(v, 2), True),
                                                 nonce, rand))
    ms = tbm.MasticSum(4, 15)
    attrs = []
    for (a, w) in [("checkout", 3), ("landing", 5), ("checkout", 15),
                   ("other", 9), ("search", 1), ("landing", 0)]:
        (nonce, rand) = (rng.bytes(16), rng.bytes(ms.RAND_SIZE))
        attrs.append((nonce,) + ms.scalar().shard(
            CTX, (hash_attribute(ms, a), w), nonce, rand))
    run = HeavyHittersRun(m, CTX, {"default": 2}, VK, device="cpu",
                          reports=count)
    while run.step():
        pass
    want_attrs = aggregate_by_attribute(ms, CTX, ATTRS, VK, device="cpu",
                                        reports=attrs)
    return {"m": m, "ms": ms, "count": count, "attrs": attrs,
            "hitters": [list(p) for p in run.result()],
            "attr_sums": [[a, v] for (a, v) in want_attrs]}


def _e2e_specs() -> list:
    return [_spec("count"),
            _spec("attrs", spec=SUM4, mode="attribute_metrics",
                  thresholds=None, attributes=ATTRS)]


def _strip(records: list) -> list:
    out = []
    for rec in records:
        rec = dict(rec)
        for key in ("wall_s", "parse_ms", "compile_ms", "inline_compiles"):
            rec.pop(key, None)
        out.append(rec)
    return out


def _admit_all(svc, e2e) -> None:
    for r in e2e["count"]:
        assert svc.submit("count", tservice.encode_upload(e2e["m"], r))[0] \
            == "admitted"
    for r in e2e["attrs"]:
        assert svc.submit("attrs", tservice.encode_upload(e2e["ms"], r))[0] \
            == "admitted"
    assert svc.begin_epoch("count") == 0
    assert svc.begin_epoch("attrs") == 0


def _records(svc) -> dict:
    return {name: _strip(t["epochs"])
            for (name, t) in svc.metrics()["tenants"].items()}


@pytest.mark.parametrize("overlap", [0, 2])
def test_service_equals_offline_runs_across_a_snapshot(e2e, overlap):
    """Both tenants' epochs equal the offline runs, and a service
    restored from a mid-epoch snapshot continues to the same records and
    counters."""
    tregistry.configure()
    svc = _service(True, _e2e_specs(), overlap=overlap)
    _admit_all(svc, e2e)
    svc.step()
    assert svc.tenants["count"].active.run.rounds_completed() >= 1
    blob = svc.to_bytes()
    assert svc.inflight_rounds() == 0
    assert svc.run_until_drained()
    restored = tservice.CollectorService.from_bytes(
        blob, config=tservice.ServiceConfig(overlap=overlap), device="cpu")
    assert restored.resumed
    assert restored.run_until_drained()
    (a, b) = (_records(svc), _records(restored))
    assert a == b
    assert a["count"][0]["result"] == e2e["hitters"]
    assert a["count"][0]["levels_completed"] == 2
    assert a["attrs"][0]["result"] == e2e["attr_sums"]
    ca = svc.metrics()["tenants"]["count"]["counters"]
    cb = restored.metrics()["tenants"]["count"]["counters"]
    assert (cb.pop("resumes"), ca.pop("resumes")) == (1, 0)
    assert ca == cb
    assert ca["rounds"] == 2 and ca["epochs_completed"] == 1


def test_lazy_reports_decode_the_page_bytes(e2e):
    """The epoch's batch is parsed from the pages' bytes, and its lazy
    scalar view gives exactly decode_upload's report for each lane."""
    svc = _service(True, _e2e_specs())
    _admit_all(svc, e2e)
    t = svc.tenants["count"]
    with t.lock:
        epoch = t.pending[0]
    assert svc._epoch_reports(t, epoch) == len(e2e["count"])
    want = tbm.BatchedMastic(e2e["m"]).marshal_reports(e2e["count"], "cpu")
    for (x, y) in zip(epoch.batch, want):
        if isinstance(y, tuple):
            for (u, v) in zip(x, y):
                assert (u is None and v is None) or bool((u == v).all())
        elif y is not None:
            assert bool((x == y).all())
    for r in (0, 5, 7):
        assert epoch.reports[r] == tservice.decode_upload(
            e2e["m"], tservice.encode_upload(e2e["m"], e2e["count"][r]))
    assert len(epoch.reports.decoded) == 3


def test_jax_service_snapshot_resumes_in_the_port(e2e):
    """A snapshot the JAX package's service writes mid-epoch (count level
    0 done, its active run restored from a checkpoint, so JAX runs no
    round) has the port's layout and resumes in the port to the port's
    own result."""
    tregistry.configure()
    jregistry.configure()
    svc = _service(True, _e2e_specs())
    _admit_all(svc, e2e)
    while svc.tenants["count"].active is None \
            or svc.tenants["count"].active.run.rounds_completed() < 1:
        svc.step()
    blob = svc.to_bytes()
    jsvc = jservice.CollectorService.from_bytes(
        blob, config=jservice.ServiceConfig())
    jblob = jsvc.to_bytes()
    (jheader, jarrays) = _snapshot_arrays(jblob)
    (theader, tarrays) = _snapshot_arrays(blob)
    assert jheader == theader
    # The counters gained JAX's resume; the active run's checkpoint is
    # the JAX package's serialization of the same state.
    assert set(jarrays) == set(tarrays)
    assert [k for k in tarrays if jarrays[k] != tarrays[k]] \
        == ["t0_active_run", "t0_counters", "t1_counters"]
    restored = tservice.CollectorService.from_bytes(jblob, device="cpu")
    assert restored.run_until_drained()
    svc.run_until_drained()
    assert _records(restored) == _records(svc)
    assert restored.metrics()["tenants"]["count"]["counters"]["resumes"] == 2


@pytest.mark.slow
def test_jax_stepped_snapshot_resumes_in_the_port(e2e):
    """JAX's own service steps level 0 (compiling its round, about a
    minute on the CPU) and snapshots; the port resumes it, and its
    result equals JAX's finishing the same epoch."""
    jregistry.configure()
    tregistry.configure()
    jsvc = jservice.CollectorService(
        [jservice.TenantSpec(**_spec("count"))],
        config=jservice.ServiceConfig(page_size=3))
    jmm = jm.MasticCount(2)
    for r in e2e["count"]:
        jsvc.submit("count", jservice.encode_upload(jmm, r))
    jsvc.begin_epoch("count")
    jsvc.step()
    blob = jsvc.to_bytes()
    restored = tservice.CollectorService.from_bytes(blob, device="cpu")
    assert restored.run_until_drained()
    jsvc.run_until_drained()
    assert _records(restored)["count"] == _records(jsvc)["count"]
    assert _records(restored)["count"][0]["result"] == e2e["hitters"]


# -- the run interface ------------------------------------------------

def test_frontier_and_rounds_equal_jax_through_checkpoints():
    """At every level of a MasticCount(3) run, the port's frontier() and
    rounds_completed() equal those of JAX's HeavyHittersRun restored from
    the port's checkpoint there; a port run restored from it agrees."""
    rng = np.random.default_rng(3)
    m = tbm.MasticCount(3)
    reports = []
    for v in [0, 0, 1, 5, 5, 5, 7, 2]:
        (nonce, rand) = (rng.bytes(16), rng.bytes(m.RAND_SIZE))
        reports.append((nonce,) + m.scalar().shard(
            CTX, (_path(v, 3), True), nonce, rand))
    run = HeavyHittersRun(m, CTX, {"default": 2}, VK, device="cpu",
                          reports=reports)
    seen = []
    while True:
        blob = run.to_bytes()
        jr = JaxRun.from_bytes(jm.MasticCount(3), CTX, {"default": 2},
                               reports, VK, blob)
        back = HeavyHittersRun.from_bytes(m, CTX, {"default": 2}, VK, None,
                                          blob, device="cpu",
                                          reports=reports)
        assert (run.frontier(), run.rounds_completed()) \
            == (jr.frontier(), jr.rounds_completed()) \
            == (back.frontier(), back.rounds_completed())
        seen.append((run.rounds_completed(), len(run.frontier())))
        if not run.step():
            break
    blob = run.to_bytes()
    jr = JaxRun.from_bytes(jm.MasticCount(3), CTX, {"default": 2}, reports,
                           VK, blob)
    assert (run.frontier(), run.rounds_completed()) \
        == (jr.frontier(), jr.rounds_completed()) == (run.result(), 3)
    assert seen[0] == (0, 0) and [s[0] for s in seen] == [0, 1, 2]


def test_atomic_handles():
    """The chunked runners run a round whole in step_begin (atomic); the
    resident and the from-root rounds are staged (not atomic)."""
    rng = np.random.default_rng(4)
    m = tbm.MasticCount(2)
    reports = []
    for v in [0, 3, 3]:
        (nonce, rand) = (rng.bytes(16), rng.bytes(m.RAND_SIZE))
        reports.append((nonce,) + m.scalar().shard(
            CTX, (_path(v, 2), True), nonce, rand))
    for (kwargs, atomic) in (({}, False), ({"incremental": False}, False),
                             ({"chunk_size": 2}, True)):
        run = HeavyHittersRun(m, CTX, {"default": 2}, VK, device="cpu",
                              reports=reports, **kwargs)
        handle = run.step_begin()
        assert handle["atomic"] is atomic
        assert run.rounds_completed() == 0 and run.frontier() == []
        run.step_finish(handle)
        assert run.rounds_completed() == 1
        assert run.frontier() == [(True,)]


# -- the tools ----------------------------------------------------------

def _tool(args: list, timeout: float = 300.0) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("MASTIC_FAULTS", None)
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_serve_smoke_on_the_cpu():
    proc = _tool(["mastic_tpu_torch.tools.serve", "--smoke",
                  "--status-port", "0", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is True and out["platform"] == "cpu"
    assert out["tenants"]["count"]["resumes"] == 1


@pytest.mark.parametrize("tool", ["serve", "loadgen"])
def test_tools_refuse_cuda_without_a_card(tool):
    """Asked for the default cuda with no card, the tools exit non-zero
    and name the missing card: nothing moves to the CPU on its own."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = ["--smoke"] if tool == "serve" else ["--duration", "0.1"]
    proc = _tool([f"mastic_tpu_torch.tools.{tool}"] + args, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    with pytest.raises(RuntimeError, match="is_available"):
        tservice.CollectorService([tservice.TenantSpec(**_spec("count"))])
