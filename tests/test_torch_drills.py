"""The collector service under a report mesh, the serve tool's `--mesh`
and drills, and the loadgen tool's WAL bench, on the CPU.

No JAX program runs here: the single-device service is held against the
JAX package by test_torch_service.py, and this file holds the meshed
service against it.  JAX's drills are read, not run: their schedule code
is taken out of tools/serve.py with `ast` and executed alone.

* `CollectorService(mesh=)` over 2 gloo ranks (`parallel.spawn`, the
  rank program `parallel/jobs.py::service`) against `mesh=None`, with a
  resident tenant (6 reports), a chunked one (chunk_size 3: each chunk
  pads to 4, 2 rows a rank) and an attribute tenant: serially, at
  overlap 2, with rank 0 alone admitting, across a mid-epoch snapshot
  (rank 0 writes it, both ranks restore that file; equal to the
  unbroken run), and with an epoch deadline only rank 0 sees expire
  (both ranks truncate at the same level).  Epoch records compared
  exactly, wall times stripped.
* The tools as children: `serve --mesh 2 --backend gloo` gives the
  single-device run's results in the default mode, through the HTTP
  door (rank 0 owns it) and across a kill -9 (exit code 17) and
  `--resume`; `--smoke` under the mesh exits 0; `--backend nccl` on the
  CPU is a parser error; the overlap drill passes.
* `chaos_schedule` and `wal_schedule` give the JAX drill's strings for
  the same seeds; one chaos schedule over a CPU party pair passes the
  audit; one lethal WAL checkpoint (`wal_fsync`) and one ENOSPC
  schedule recover bit-identical to the clean run.
* The WAL bench's three modes at 200 uploads ack every upload (the
  >= 5x gate is the card machine's run).
* Slow: the whole chaos and WAL drills as the tool runs them.

Every `spawn` gets a timeout of at most 120 s, so that a deadlocked
collective fails the test instead of eating the tier's time.  The tool
children run three at a time while the in-process cases run."""

import ast
import json
import os
import pathlib
import random
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mastic_tpu_torch.backend.mastic import MasticCount, MasticSum
from mastic_tpu_torch.drivers import faults
from mastic_tpu_torch.drivers.attribute_metrics import hash_attribute
from mastic_tpu_torch.drivers.service import encode_upload
from mastic_tpu_torch.obs import registry
from mastic_tpu_torch.parallel import jobs, spawn
from mastic_tpu_torch.tools import loadgen, serve

REPO = pathlib.Path(__file__).resolve().parents[1]
CTX = b"torch drills"
VK = bytes(range(16))
ATTRS = ["checkout", "landing", "search"]
SPAWN_TIMEOUT_S = 120.0


def _uploads() -> dict:
    """Each tenant's seeded upload blobs (the port's scalar shard)."""
    rng = np.random.default_rng(5)
    m = MasticCount(2)
    count = [encode_upload(m, r) for r in serve.build_reports(
        m, CTX, rng, [0, 3, 3, 1, 3, 0], 2)]
    ms = MasticSum(4, 15)
    attrs = []
    for (a, w) in [("checkout", 3), ("landing", 5), ("checkout", 15),
                   ("other", 9), ("search", 1)]:
        (nonce, rand) = (rng.bytes(16), rng.bytes(ms.RAND_SIZE))
        attrs.append(encode_upload(ms, (nonce,) + ms.scalar().shard(
            CTX, (hash_attribute(ms, a), w), nonce, rand)))
    return {"resident": count, "chunked": count, "attrs": attrs}


def _tenants(attrs: bool = True) -> list:
    base = dict(spec={"class": "MasticCount", "args": [2]}, ctx=CTX,
                verify_key=VK, thresholds={"default": 2})
    out = [dict(base, name="resident"),
           dict(base, name="chunked", chunk_size=3)]
    if attrs:
        out.append(dict(name="attrs", spec={"class": "MasticSum",
                                            "args": [4, 15]},
                        ctx=CTX, verify_key=VK, mode="attribute_metrics",
                        attributes=ATTRS))
    return out


def _case(tmp: str, name: str, overlap: int = 0, attrs: bool = True,
          **extra) -> dict:
    uploads = _uploads()
    if not attrs:
        del uploads["attrs"]
    case = {"tenants": _tenants(attrs), "uploads": uploads,
            "config": dict(page_size=2, max_buffered=64, epoch_deadline=600.0,
                           overlap=overlap),
            "device": "cpu", "snapshot": os.path.join(tmp, f"{name}.snap")}
    case.update(extra)
    return case


CASES = {
    "serial": dict(),
    "overlap": dict(overlap=2),
    "lead_admits": dict(overlap=2, lead_admits=True),
    "snapshot": dict(attrs=False, split=1),
    "snapshot_overlap": dict(attrs=False, overlap=2, split=1),
    "deadline": dict(attrs=False, expire=("resident", 1)),
}


@pytest.fixture(scope="module")
def meshed():
    """Every case over one group of 2 gloo ranks: [(rank 0's summary,
    rank 1's)] by case name."""
    tmp = tempfile.mkdtemp(prefix="mastic_drills_")
    cases = [("service", _case(tmp, name, **kw))
             for (name, kw) in CASES.items()]
    ranks = spawn(jobs.run_all, 2, "gloo", "cpu", cases,
                  timeout_s=SPAWN_TIMEOUT_S)
    return {name: (ranks[0][0][i][0], ranks[1][0][i][0])
            for (i, name) in enumerate(CASES)}


def _single(name: str) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        return jobs.service(None, _case(tmp, name, **CASES[name]))


@pytest.mark.parametrize("name", ["serial", "overlap", "lead_admits"])
def test_mesh_service_equals_single_device(meshed, name):
    """Both ranks' epoch records equal the single-device service's, and
    every tenant's epoch completed: the resident tenant's rows divide
    over the ranks, the chunked tenant's chunks pad."""
    (r0, r1) = meshed[name]
    want = _single(name)
    assert r0["records"] == r1["records"] == want["records"]
    assert r0["quanta"] == r1["quanta"]
    for tenant in ("resident", "chunked"):
        (rec,) = want["records"][tenant]
        assert rec["result"] == [[False, False], [True, True]]
        assert not rec["truncated"] and rec["levels_completed"] == 2
    assert want["records"]["attrs"][0]["result"] == [
        ["checkout", 18], ["landing", 5], ["search", 1]]


@pytest.mark.parametrize("name", ["snapshot", "snapshot_overlap"])
def test_mesh_snapshot_mid_epoch(meshed, name):
    """`to_bytes` on both ranks after one quantum, rank 0's bytes written,
    `from_bytes` of that file on both: the drained records equal the
    unbroken meshed and single-device runs'."""
    (r0, r1) = meshed[name]
    unbroken = meshed["serial" if name == "snapshot" else "overlap"][0]
    assert r0["records"] == r1["records"]
    for tenant in ("resident", "chunked"):
        assert r0["records"][tenant] == unbroken["records"][tenant]
    assert r0["records"] == _single(name)["records"]


def test_mesh_deadline_seen_by_rank_zero_alone(meshed):
    """Rank 0 alone finds the resident epoch's deadline expired after
    level 0 (the other rank's is 600 s away): both ranks truncate it at
    that level, as the single-device service does, and neither hangs."""
    (r0, r1) = meshed["deadline"]
    assert r0["records"] == r1["records"] == _single("deadline")["records"]
    (rec,) = r0["records"]["resident"]
    assert rec["truncated"] and rec["levels_completed"] == 1
    assert rec["result"] == [[False], [True]]
    assert not r0["records"]["chunked"][0]["truncated"]


def test_resident_tenant_that_does_not_divide_fails_its_epoch():
    """A resident epoch of 5 reports cannot shard over 2 ranks: its epoch
    fails on both ranks with the mesh's reason (the chunked tenant pads
    and completes); the service goes on."""
    with tempfile.TemporaryDirectory() as tmp:
        case = _case(tmp, "odd", attrs=False)
        case["uploads"] = {k: v[:5] for (k, v) in case["uploads"].items()}
        ranks = spawn(jobs.service, 2, "gloo", "cpu", case,
                      timeout_s=SPAWN_TIMEOUT_S)
    (r0, r1) = (ranks[0][0], ranks[1][0])
    assert r0["records"] == r1["records"]
    (rec,) = r0["records"]["resident"]
    assert rec["truncated"] and rec["levels_completed"] == 0
    assert "divisible by the mesh" in rec["error"]
    assert r0["records"]["chunked"][0]["levels_completed"] == 2


# -- the tools as children ---------------------------------------------------

def _tool(args: list, env: dict = None, timeout: float = 300.0):
    env = dict(os.environ if env is None else env)
    env.pop("MASTIC_FAULTS", None)
    return subprocess.run([sys.executable, "-m"] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _line(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


SERVE = "mastic_tpu_torch.tools.serve"
MESH2 = ["--mesh", "2", "--backend", "gloo"]


def _serve(args: list, **kw):
    return _tool([SERVE, "--device", "cpu"] + args, **kw)


def _door_child(tmp: str, tag: str, extra: list, fault=None):
    """A serve child with its HTTP door (and WAL) open; (process, port
    file)."""
    pf = os.path.join(tmp, f"{tag}.port")
    proc = subprocess.Popen(
        [sys.executable, "-m", SERVE, "--device", "cpu", "--reports", "6",
         "--page-size", "2", "--upload-port", "0", "--upload-window", "120",
         "--snapshot-every", "0.2", "--port-file", pf, "--snapshot",
         os.path.join(tmp, "door.snap")] + extra,
        cwd=REPO, env=serve.child_env(fault), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    return (proc, pf)


def _door(tmp: str, tag: str, extra: list) -> dict:
    """The WAL drill's six uploads PUT to a door child, the epoch cut and
    the window closed by the admin control; its JSON line."""
    tmp = os.path.join(tmp, tag)
    os.makedirs(tmp)
    drill = serve.WalDrill(7, "cpu", tmp)
    (proc, pf) = _door_child(tmp, tag, extra)
    try:
        port = drill.wait_port(proc, pf)
        acked = drill.put_all(port, list(enumerate(drill.blobs[:3])))
        time.sleep(0.5)   # a compaction snapshot or two in the window
        acked += drill.put_all(port, list(enumerate(drill.blobs[3:], 3)))
        assert acked == list(range(6))
        drill.cut_and_drain(port)
        return drill.finish(proc, tag)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _door_kill_and_resume(tmp: str) -> tuple:
    """Rank 0 alone killed at its fourth WAL append (the other rank waits
    in a collective), then `--resume` on the mesh, the client retrying
    what it holds no ack for: (killed rc, its stderr, acked before the
    kill, the resumed line)."""
    tmp = os.path.join(tmp, "door_kill")
    os.makedirs(tmp)
    drill = serve.WalDrill(7, "cpu", tmp)
    (proc, pf) = _door_child(tmp, "killed", MESH2,
                             fault="kill:party=collector:step=wal_append"
                                   ":nth=4")
    port = drill.wait_port(proc, pf)
    acked = drill.put_all(port, list(enumerate(drill.blobs)))
    (_out, err) = proc.communicate(timeout=120)
    killed_rc = proc.returncode
    (proc, pf) = _door_child(tmp, "resumed", MESH2 + ["--resume"])
    try:
        port = drill.wait_port(proc, pf)
        drill.put_all(port, [(i, drill.blobs[i]) for i in range(6)
                             if i not in acked])
        drill.cut_and_drain(port)
        return (killed_rc, err, acked, drill.finish(proc, "resumed"))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _kill_and_resume(tmp: str) -> tuple:
    snap = os.path.join(tmp, "killed.snap")
    env = dict(os.environ)
    env["MASTIC_FAULTS"] = "kill:party=collector:step=epoch_round:nth=2"
    killed = subprocess.run(
        [sys.executable, "-m", SERVE, "--device", "cpu", "--snapshot", snap]
        + MESH2, cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    resumed = _serve(["--snapshot", snap, "--resume"] + MESH2)
    return (killed, resumed)


@pytest.fixture(scope="module", autouse=True)
def tools():
    """The tool children, three at a time, started before the module's
    first test so that they run beside the in-process cases: futures by
    name."""
    tmp = tempfile.mkdtemp(prefix="mastic_drill_tools_")
    jobs_ = {
        "mesh_default": lambda: _serve(MESH2),
        "single_default": lambda: _serve([]),
        "mesh_smoke": lambda: _serve(["--smoke", "--status-port", "0"]
                                     + MESH2),
        "overlap_drill": lambda: _serve(["--overlap-drill"]),
        "door_mesh": lambda: _door(tmp, "door_mesh", MESH2),
        "door_single": lambda: _door(tmp, "door_single", []),
        "kill_resume": lambda: _kill_and_resume(tmp),
        "door_kill_resume": lambda: _door_kill_and_resume(tmp),
    }
    with ThreadPoolExecutor(3) as pool:
        yield {name: pool.submit(fn) for (name, fn) in jobs_.items()}


def test_serve_mesh_default_equals_single_device(tools):
    mesh = _line(tools["mesh_default"].result())
    single = _line(tools["single_default"].result())
    assert mesh["results"] == single["results"]
    assert mesh["mesh_devices"] == 2 and single["mesh_devices"] == 1
    assert len(mesh["rank_launches"]) == 2
    assert mesh["results"]["count"][0]["result"] == [[False, False],
                                                     [True, True]]


def test_serve_mesh_smoke(tools):
    out = _line(tools["mesh_smoke"].result())
    assert out["ok"] is True and out["mesh_devices"] == 2
    assert out["tenants"]["count"]["resumes"] == 1
    assert out["status_port"]


def test_serve_mesh_http_door_equals_single_device(tools):
    """Rank 0 owns the door, the WAL and the port file: the same PUTs to
    a meshed and a single-device child give the same results."""
    mesh = tools["door_mesh"].result()
    single = tools["door_single"].result()
    assert mesh["results"] == single["results"]
    assert mesh["upload_port"] and mesh["mesh_devices"] == 2
    assert mesh["wal"]["appends"] >= 6
    counters = mesh["metrics"]["tenants"]["count"]["counters"]
    assert counters["admitted"] == 6
    assert mesh["results"]["count"][0]["reports"] == 6


def test_serve_mesh_kill_and_resume(tools):
    """A rank killed by the injector makes the tool exit with the kill
    code; `--resume` on the mesh finishes with the single-device
    results."""
    (killed, resumed) = tools["kill_resume"].result()
    assert killed.returncode == faults.KILL_EXIT_CODE, killed.stderr[-2000:]
    assert "exited with code" in killed.stderr
    single = _line(tools["single_default"].result())
    assert _line(resumed)["results"] == single["results"]


def test_serve_mesh_rank_zero_killed_at_the_wal(tools):
    """Rank 0 alone dies at a WAL checkpoint while the other waits in a
    collective: the tool exits with the kill code (the cause, not the
    other rank's broken collective), and the resumed mesh replays rank
    0's WAL and admits exactly the six uploads."""
    (rc, err, acked, resumed) = tools["door_kill_resume"].result()
    assert rc == faults.KILL_EXIT_CODE, err[-2000:]
    assert "rank 0 exited with code" in err
    assert acked == [0, 1, 2]
    single = tools["door_single"].result()
    assert resumed["results"] == single["results"]
    assert resumed["wal"]["replayed_records"] == 3
    assert resumed["metrics"]["tenants"]["count"]["counters"][
        "admitted"] == 6


def test_overlap_drill(tools):
    out = _line(tools["overlap_drill"].result())
    assert out["ok"] is True and out["kill9_resume_bit_identical"]
    assert out["burst_admitted"] + out["burst_queue_shed"] \
        == out["burst_submitted"] == 40


def test_nccl_on_the_cpu_is_a_parser_error(capsys):
    with pytest.raises(SystemExit) as err:
        serve.parse_args(["--mesh", "2", "--backend", "nccl", "--device",
                          "cpu"])
    assert err.value.code == 2
    assert "--backend nccl needs a card" in capsys.readouterr().err
    args = serve.parse_args(["--mesh", "2", "--backend", "gloo", "--device",
                             "cpu"])
    assert (args.mesh, args.backend) == (2, "gloo")


# -- the schedules against the JAX drills' -----------------------------------

def _jax_drill(name: str) -> ast.FunctionDef:
    tree = ast.parse((REPO / "tools" / "serve.py").read_text())
    return next(node for node in tree.body
                if isinstance(node, ast.FunctionDef) and node.name == name)


def test_chaos_schedule_equals_jax_drill():
    """The JAX drill's nested `chaos_schedule`, taken out of
    tools/serve.py and run alone (it needs only `random`)."""
    fn = next(node for node in ast.walk(_jax_drill("run_chaos_drill"))
              if isinstance(node, ast.FunctionDef)
              and node.name == "chaos_schedule")
    scope = {"random_mod": random}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), "<jax>", "exec"),
         scope)
    for seed in range(10):
        assert serve.chaos_schedule(seed) == scope["chaos_schedule"](seed)
    assert serve.chaos_schedule(7).startswith(
        "conn_drop:party=collector:step=upload:nth=")


def test_wal_schedule_equals_jax_drill():
    """The statements of the JAX drill's seeded loop before it calls
    run_schedule (the draws, `kind`, `fault`, `lethal`), run alone for
    each seed."""
    loop = next(node for node in ast.walk(_jax_drill("run_wal_drill"))
                if isinstance(node, ast.For)
                and getattr(node.target, "id", None) == "seed")
    head = []
    for stmt in loop.body:
        if "run_schedule" in ast.unparse(stmt):
            break
        head.append(stmt)
    code = compile(ast.Module(body=head, type_ignores=[]), "<jax>", "exec")
    kinds = set()
    for seed in range(20):
        scope = {"random": random, "seed": seed}
        exec(code, scope)
        assert serve.wal_schedule(seed) == (scope["kind"], scope["fault"],
                                            scope["lethal"])
        kinds.add(scope["kind"])
    assert kinds == {"kill", "short_write", "enospc"}
    assert [serve.wal_schedule(s)[0] for s in (7, 8, 9)] == [
        "short_write", "kill", "enospc"]


# -- one chaos schedule, two WAL schedules, the WAL bench ------------------

def test_chaos_schedule_over_a_party_pair():
    """The loopback baseline, then seed 7's schedule over a fresh mTLS
    party pair on the CPU, audited as the drill audits it."""
    registry.configure()
    with tempfile.TemporaryDirectory() as tmp:
        drill = serve.ChaosDrill(0, "cpu", tmp)
        base = drill.baseline()
        run = drill.run_seed(7, base)
    assert base[0] == [(False, False), (True, True)]
    assert run["schedule"] == serve.chaos_schedule(7)
    assert run["reconnects"] >= 1 and run["replayed_frames"] >= 1
    reg = registry.get_registry()
    assert reg.counter("mastic_session_reconnects_total", tenant="").value()
    assert reg.counter("mastic_frames_replayed_total", tenant="").value()


def test_wal_drill_schedules():
    """A kill -9 at `wal_fsync` (resumed, the unacked uploads retried)
    and an ENOSPC brownout each end with the clean run's results and
    admitted count; recovery and the brownout are attributed."""
    with tempfile.TemporaryDirectory() as tmp:
        drill = serve.WalDrill(7, "cpu", tmp)
        with ThreadPoolExecutor(3) as pool:
            clean = pool.submit(drill.run_schedule, "clean", None, False)
            killed = pool.submit(
                drill.run_schedule, "kill-wal_fsync",
                "kill:party=collector:step=wal_fsync:nth=4", True)
            enospc = pool.submit(
                drill.run_schedule, "enospc",
                "enospc:party=collector:step=wal_append:nth=4", False)
            (clean, killed, enospc) = (clean.result(), killed.result(),
                                       enospc.result())
    want = clean[0]["results"]["count"]
    for (result, acked, _brownouts) in (killed, enospc):
        assert result["results"]["count"] == want
        assert serve.admitted_total(result) == serve.admitted_total(
            clean[0]) == 6
        assert sorted(acked) == list(range(6))
    wal = killed[0]["wal"]
    assert "recovery_wall_ms" in wal and wal["replayed_records"] >= 1
    (result, _acked, brownouts) = enospc
    assert brownouts
    shed = result["metrics"]["tenants"]["count"]["counters"]["shed_reasons"]
    assert shed.get("wal-full")


def test_wal_bench_modes_account_exactly():
    modes = loadgen.measure_wal_modes(torch.device("cpu"), 200, 8)
    assert set(modes) == {"snapshot_before_ack", "wal_always", "wal_group"}
    for rec in modes.values():
        assert rec["acked"] == 200 and rec["rate_rps"] > 0
    assert modes["snapshot_before_ack"]["settles"] >= 1
    for key in ("wal_always", "wal_group"):
        assert modes[key]["appends"] == 200
    assert modes["wal_group"]["group_ms"] == 2.0


# -- slow: the whole campaigns as the tool runs them ------------------------

@pytest.mark.slow
def test_chaos_drill_campaign():
    out = _line(_serve(["--chaos-drill", "7", "--chaos-seeds", "3"],
                       timeout=900))
    assert out["ok"] and out["seeds"] == [7, 8, 9]
    assert [r["schedule"] for r in out["runs"]] == [
        serve.chaos_schedule(s) for s in (7, 8, 9)]


@pytest.mark.slow
def test_wal_drill_campaign():
    out = _line(_serve(["--wal-drill", "7", "--wal-seeds", "3"],
                       timeout=900))
    assert out["ok"] and out["admitted"] == 6
    assert len(out["runs"]) == 6
