"""The port's report mesh (`mastic_tpu_torch.parallel`) under the
heavy-hitters runners, against the JAX package's mesh, compared exactly
(tolerance 0).  test_torch_mesh_rounds.py holds the client shard, the
round from the root and the attribute round; the two files split the
JAX package's compiles between two test workers.

The port's ranks run over gloo on the CPU, one process each
(`parallel.launch.spawn`, the rank programs of `parallel/jobs.py`): one
group of 2 ranks and one of 3, each running all its cases.  One JAX
program set is compiled in this module: `HeavyHittersRun(mesh=
make_mesh(2), chunk_size=4)` on the 8 virtual CPU devices of
tests/conftest.py (serially, `MASTIC_PIPELINE=0`, as in
test_torch_chunked.py).  The reports come from both packages' scalar
layers with the same nonces and randomness: the multichip tool's ten,
report 6 tampered.

* `HeavyHittersRun` over a mesh, chunked (2 and 3 ranks, chunk_size 4,
  a padded tail) and resident (2 ranks): the result and every level's
  aggregates equal JAX's meshed run and the port's unsharded run; the
  chunked runs' counters, `fallback` mask, final state arrays and
  `extra["mesh"]` row arithmetic equal JAX's, the resident run's equal
  the port's unsharded resident run (which test_torch_checkpoint.py
  holds against JAX's) and JAX's rule for a resident mesh block.  The
  checkpoint after 2 levels equals JAX's meshed run's (which the JAX
  package's multichip tool holds equal to its unsharded run's) and the
  port's unsharded run's, array by array; JAX's chunked checkpoint and
  the port's unsharded resident one resume on a 2-rank port mesh.
  Every level's observability blocks pass JAX's `validate_extra`.
* A lane forced to the XOF fallback on rank 1 gives the unsharded run's
  result.
* The envelope's per-shard fields have JAX's keys and row arithmetic.
* The multichip tool passes; a `nodes_axis` that does not divide the
  world, a resident batch that does not divide over the ranks, and a
  mesh or tool left to its default device without a card raise.
* A spawned rank holds nothing of jax or mastic_tpu.
"""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.drivers import chunked as jchunked
from mastic_tpu.drivers.heavy_hitters import HeavyHittersRun as JRun
from mastic_tpu.obs.schema import validate_extra
from mastic_tpu.parallel import make_mesh as jmake_mesh
from mastic_tpu_torch.drivers import chunked
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
from mastic_tpu_torch.parallel import (ReportMesh, jobs, make_mesh,
                                       shard_incremental_runner, spawn)
from mastic_tpu_torch.tools import multichip

CTX = b"mesh test"
VK = bytes(range(32))
BITS = 3
TAMPERED = 6
SPLIT = 2
# The multichip tool's values, thresholds and chunk size.
THRESHOLDS = {"default": 2}
CHUNK = 4
# The lane forced on the resident mesh: rank 1's (rows 5-9), level 1.
FORCED = 8
FORCED_LEVEL = 1


def _reports(spec: tuple, meas: list, seed: int,
             tampered=None) -> tuple:
    """The same reports from the port's scalar layer and the JAX
    package's: (port reports, JAX reports), `tampered`'s leader key
    with its first byte flipped."""
    rng = np.random.default_rng(seed)
    (port, ref) = (jobs.mastic_of(spec).scalar(), getattr(jm, spec[0])(
        *spec[1]))
    out = ([], [])
    for m in meas:
        (nonce, rand) = (rng.bytes(16), rng.bytes(port.RAND_SIZE))
        for (dst, mastic) in zip(out, (port, ref)):
            dst.append((nonce,) + mastic.shard(CTX, m, nonce, rand))
    if tampered is not None:
        for dst in out:
            (nonce, public_share, shares) = dst[tampered]
            (key, proof, seed_, part) = shares[0]
            dst[tampered] = (nonce, public_share, [
                (bytes([key[0] ^ 1]) + key[1:], proof, seed_, part),
                shares[1]])
    return out


def _count_meas(values: list) -> list:
    vid = tbm.MasticCount(BITS).scalar().vidpf
    return [(vid.test_index_from_int(v, BITS), 1) for v in values]


def _arrays(data: bytes) -> dict:
    arrays = np.load(io.BytesIO(data), allow_pickle=False)
    return {k: arrays[k] for k in arrays.files}


def _counters(m) -> dict:
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if f.name != "extra"}


def _steps(run, levels=None) -> list:
    """Step a run (the JAX or the port's) to the end, or `levels`
    levels: [(prefixes, aggregates)] per level."""
    out = []
    while levels is None or len(out) < levels:
        handle = run.step_begin()
        if handle is None:
            break
        more = run.step_finish(handle)
        out.append((list(handle["agg_param"][1]),
                    handle["result"] if "result" in handle
                    else run.level_results[-1][1]))
        if not more:
            break
    return out


def _hh_case(chunk_size=None, **extra) -> tuple:
    (reports, jreports) = _reports(("MasticCount", (BITS,)),
                                   _count_meas(list(multichip.VALUES)), 3,
                                   TAMPERED)
    case = {"mastic": ("MasticCount", (BITS,)), "ctx": CTX,
            "verify_key": VK, "thresholds": THRESHOLDS, "reports": reports,
            "chunk_size": chunk_size, "split": SPLIT}
    case.update(extra)
    return (case, jreports)


@pytest.fixture(scope="module")
def cases() -> dict:
    (resident, jreports) = _hh_case()
    (chunked_case, _same) = _hh_case(CHUNK)
    return {"resident": resident, "chunked": chunked_case,
            "jreports": jreports}


@pytest.fixture(scope="module")
def jax_side(cases) -> dict:
    """JAX's meshed chunked run, checkpointed after SPLIT levels and
    carried on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        run = JRun(jm.MasticCount(BITS), CTX, THRESHOLDS, cases["jreports"],
                   verify_key=VK, mesh=jmake_mesh(2, nodes_axis=1),
                   chunk_size=CHUNK)
        levels = _steps(run, SPLIT)
        ckpt = run.to_bytes()
        levels += _steps(run)
    return {"run": run, "levels": levels, "checkpoint": ckpt,
            "final": run.to_bytes()}


def _unsharded(case: dict) -> HeavyHittersRun:
    run = HeavyHittersRun(jobs.mastic_of(case["mastic"]), CTX,
                          case["thresholds"], VK, device="cpu",
                          reports=case["reports"],
                          chunk_size=case["chunk_size"])
    _steps(run, SPLIT)
    run.checkpoint = run.to_bytes()
    _steps(run)
    return run


@pytest.fixture(scope="module")
def port(cases, jax_side) -> dict:
    """The port's side: the unsharded runs in this process, then one
    group of 2 ranks and one of 3, each running all its cases."""
    unsharded = {name: _unsharded(cases[name])
                 for name in ("resident", "chunked")}
    two = {"resident": cases["resident"], "chunked": cases["chunked"],
           "forced": dict(cases["resident"], split=None,
                          force=(cases["resident"]["reports"][FORCED][0],
                                 FORCED_LEVEL)),
           "resumed_resident": dict(cases["resident"], split=None,
                                    resume=unsharded["resident"]
                                    .checkpoint),
           "resumed_chunked": dict(cases["chunked"], split=None,
                                   resume=jax_side["checkpoint"])}
    got2 = spawn(jobs.run_all, 2, "gloo", "cpu",
                 [("heavy_hitters", case) for case in two.values()])
    got3 = spawn(jobs.run_all, 3, "gloo", "cpu",
                 [("heavy_hitters", cases["chunked"]), ("modules", None)])
    out = {k: [r[0][i][0] for r in got2] for (i, k) in enumerate(two)}
    out["chunked3"] = [r[0][0][0] for r in got3]
    out["modules3"] = [r[0][1][0] for r in got3]
    out["launches"] = [launches for r in got2 + got3
                       for (_result, launches) in r[0]]
    out["unsharded"] = unsharded
    return out


def _same_on_every_rank(results: list) -> dict:
    """Rank 0's result, after checking that every rank returned the same
    (but for the host timings and the arrival skews of the `pipeline`
    and `mesh` blocks and the other observability records)."""
    def fixed(result: dict) -> str:
        rows = [None if b is None else
                {k: v for (k, v) in b.items() if "skew" not in k}
                for b in result["mesh"]]
        return repr(({k: v for (k, v) in result.items()
                      if k not in ("pipeline", "mesh", "extras")}, rows))

    for other in results[1:]:
        assert fixed(other) == fixed(results[0])
    return results[0]


def _same_arrays(got: bytes, want: bytes) -> None:
    (a, b) = (_arrays(got), _arrays(want))
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("name", ["resident", "chunked", "chunked3"])
def test_heavy_hitters_match_jax_and_unsharded(port, jax_side, name):
    """The result and every level's aggregates equal JAX's meshed run
    and the port's unsharded run; the counters, the fallback mask and
    the final state arrays equal JAX's (chunked) or the unsharded
    resident run's; report 6 is rejected at every level."""
    got = _same_on_every_rank(port[name])
    base = name.rstrip("3")
    unsharded = port["unsharded"][base]
    assert got["levels"] == jax_side["levels"] == unsharded.level_results
    assert got["result"] == jax_side["run"].result() == unsharded.result()
    assert got["result"]
    assert got["counters"] == [_counters(m) for m in unsharded.metrics]
    if base == "chunked":
        assert got["counters"] == [_counters(m)
                                   for m in jax_side["run"].metrics]
        _same_arrays(got["final"], jax_side["final"])
        assert all(p["mode"] == "pipelined" for p in got["pipeline"])
    _same_arrays(got["final"], unsharded.to_bytes())
    assert all(c["rejected_eval_proof"] == 1 for c in got["counters"])
    assert not _arrays(got["final"])["fallback"].any()


@pytest.mark.parametrize("name", ["resident", "chunked", "chunked3"])
def test_mesh_block_row_arithmetic(port, jax_side, name):
    """extra["mesh"] has JAX's keys, and its shards and rows are JAX's:
    the chunked run's as JAX's meshed run has them (at 3 ranks, chunks
    of 4 pad to 6 rows, 2 a rank), the resident run's by JAX's rule
    (the whole batch, split evenly)."""
    got = _same_on_every_rank(port[name])["mesh"]
    want = [m.extra["mesh"] for m in jax_side["run"].metrics]
    rows = ("report_shards", "device_rows_per_chunk", "rows_per_shard")
    assert [set(b) for b in got] == [set(b) for b in want]
    expect = {"chunked": None, "chunked3": (3, 6, 2),
              "resident": (2, 10, 5)}[name]
    if expect is None:
        assert [[b[k] for k in rows] for b in got] == \
            [[b[k] for k in rows] for b in want]
    else:
        assert {tuple(b[k] for k in rows) for b in got} == {expect}
    assert all(b["psum_bytes_per_round"] > 0 for b in got)


@pytest.mark.parametrize("name", ["resident", "chunked", "chunked3"])
def test_observability_blocks_pass_jax_schema(port, name):
    """Every level's extra (the meshed ranks' and the unsharded run's)
    passes the JAX package's `validate_extra`: a chunk's phases keep
    `download_ms` (the wait-to-host interval), and the exchange is
    `gather_ms` beside it."""
    extras = [e for r in port[name] for e in r["extras"]]
    extras += [m.extra for m in port["unsharded"][name.rstrip("3")]
               .metrics]
    for extra in extras:
        assert validate_extra(extra) == []
    if name != "resident":
        phases = [rec["phases"] for r in port[name] for e in r["extras"]
                  for rec in e["chunks"]]
        assert phases and all({"download_ms", "gather_ms"} <= set(p)
                              for p in phases)


@pytest.mark.parametrize("name", ["resident", "chunked"])
def test_checkpoint_after_two_levels_matches_jax(port, jax_side, name):
    """The meshed run's checkpoint after 2 levels (every rank's carries
    gathered) equals the port's unsharded run's (and, chunked, JAX's
    meshed run's), array by array, and is the same bytes on every
    rank."""
    got = _same_on_every_rank(port[name])["checkpoint"]
    _same_arrays(got, port["unsharded"][name].checkpoint)
    if name == "chunked":
        _same_arrays(got, jax_side["checkpoint"])


@pytest.mark.parametrize("name", ["resident", "chunked"])
def test_jax_checkpoint_resumes_on_the_mesh(port, jax_side, name):
    """JAX's chunked checkpoint, and the port's unsharded resident one
    (equal to JAX's, test_torch_checkpoint.py), resume on 2 ranks and
    finish as JAX's run does."""
    got = _same_on_every_rank(port["resumed_" + name])
    assert got["levels"] == jax_side["levels"][SPLIT:]
    assert got["result"] == jax_side["run"].result()
    _same_arrays(got["final"], (jax_side["final"] if name == "chunked"
                                else port["unsharded"][name].to_bytes()))


def test_forced_lane_on_rank_1_is_spliced(port):
    """Report 8 (rank 1's rows) forced to the XOF fallback at level 1:
    every level equals the unforced unsharded run, and the lane stays in
    the gathered fallback mask from then on."""
    got = _same_on_every_rank(port["forced"])
    unsharded = port["unsharded"]["resident"]
    assert got["levels"] == unsharded.level_results
    assert got["result"] == unsharded.result()
    assert [c["xof_fallbacks"] for c in got["counters"]] == \
        [int(level >= FORCED_LEVEL) for level in range(BITS)]
    assert np.flatnonzero(_arrays(got["final"])["fallback"]).tolist() == \
        [FORCED]


def test_every_rank_launches_no_kernel_on_the_cpu(port):
    """The ranks ran on CPU tensors: the plain versions, no launch."""
    assert not any(any(launches.values()) for launches in port["launches"])


def test_spawned_ranks_import_no_jax(port):
    """A rank started by `parallel.launch.spawn` (from this session,
    which has jax loaded) holds neither jax nor mastic_tpu: the rank
    programs and the launcher import nothing of them."""
    assert port["modules3"] == [[], [], []]


@pytest.mark.parametrize("shards", [1, 2, 3, 8])
@pytest.mark.parametrize("chunk_size", [4, 2047, 4096])
def test_envelope_per_shard_fields_match_jax(shards, chunk_size):
    """memory_envelope(n_device_shards=) has JAX's keys and row
    arithmetic; its bytes are the port's per-report prices times the
    rows a rank holds."""
    bm = tbm.BatchedMastic(tbm.MasticCount(256))
    jbm = JBatchedMastic(jm.MasticCount(256))
    got = chunked.memory_envelope(bm, chunk_size, 64, 10_000,
                                  n_device_shards=shards)
    want = jchunked.memory_envelope(jbm, chunk_size, 64, 10_000,
                                    n_device_shards=shards)
    assert set(got) == set(want)
    for key in ("report_shards", "device_rows_per_chunk",
                "rows_per_shard"):
        assert got[key] == want[key], key
    per = got["per_report_bytes"]
    per_chunk = per["carry"] + per["roundkeys"] + per["store"]
    rows = got["rows_per_shard"]
    assert got["device_bytes_per_chunk_per_shard"] == rows * per_chunk
    assert got["device_peak_bytes_per_chunk_pipelined_per_shard"] == \
        2 * rows * per_chunk + rows * per["round_staging"]
    assert chunked.round_peak_bytes(
        bm, 64, 64, got["device_rows_per_chunk"],
        got["device_rows_per_chunk"] * per_chunk, 2, shards) == \
        got["device_peak_bytes_per_chunk_pipelined_per_shard"]


def test_envelope_refuses_per_chip(monkeypatch):
    """The device check bounds one rank's share: a budget that holds
    half a chunk passes over 2 ranks and is refused on one."""
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    env = chunked.memory_envelope(bm, 8, 8, 16)
    monkeypatch.setenv("MASTIC_DEVICE_BUDGET_BYTES",
                       str(env["device_bytes_per_chunk"] // 2))
    chunked.check_envelope(bm, 8, 8, 16, n_device_shards=2)
    with pytest.raises(ValueError, match="feasible chunk_size"):
        chunked.check_envelope(bm, 8, 8, 16)


def test_multichip_tool_exits_ok(capsys):
    """`python -m mastic_tpu_torch.tools.multichip --ranks 2 --backend
    gloo --device cpu`, called in this process: exit code 0 and one
    JSON line with "ok": true."""
    assert multichip.main(["--ranks", "2", "--backend", "gloo",
                           "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["ok"] and out["failures"] == []
    assert (out["backend"], out["device"]) == ("gloo", "cpu")
    assert (out["device_rows_per_chunk"], out["rows_per_shard"]) == (4, 2)


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """Left to its default, the multichip tool asks for the card and
    NCCL, and `make_mesh` for this rank's card under either backend:
    without a card both raise, and the CPU comes only from an explicit
    `device="cpu"`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multichip.main(["--ranks", "1"])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
        mesh = make_mesh(1, device="cpu")
        assert (mesh.backend, mesh.device, mesh.shape) == \
            ("gloo", torch.device("cpu"), {"reports": 1, "nodes": 1})
    finally:
        dist.destroy_process_group()


def test_refusals(cases):
    """A nodes_axis that does not divide the world raises, and so does a
    resident batch that does not divide over the ranks, each with the
    JAX package's message (`mastic_tpu/parallel/mesh.py::make_mesh` and
    `::shard_incremental_runner`), checked
    before any collective, so that a mesh object suffices here; a mesh
    on the from-root engine raises as in the JAX package, and a chunked
    runner takes its mesh at construction only."""
    with pytest.raises(ValueError, match="nodes_axis must divide n_devices"):
        make_mesh(4, nodes_axis=3)
    mesh = ReportMesh(2, 0, "gloo", torch.device("cpu"))
    reports = cases["resident"]["reports"][:9]
    msg = (r"report count 9 must be divisible by the mesh's reports axis "
           r"\(2\) to shard evenly")
    with pytest.raises(ValueError, match=msg):
        HeavyHittersRun(tbm.MasticCount(BITS), CTX, THRESHOLDS, VK,
                        device="cpu", reports=reports, mesh=mesh)
    run = HeavyHittersRun(tbm.MasticCount(BITS), CTX, THRESHOLDS,
                          VK, device="cpu", reports=reports)
    with pytest.raises(ValueError, match=msg):
        shard_incremental_runner(run.runner, mesh)
    chunked_run = HeavyHittersRun(tbm.MasticCount(BITS), CTX,
                                  THRESHOLDS, VK, device="cpu",
                                  reports=reports, chunk_size=CHUNK)
    with pytest.raises(ValueError, match="at construction"):
        shard_incremental_runner(chunked_run.runner, mesh)
    with pytest.raises(ValueError, match="incremental runner"):
        HeavyHittersRun(tbm.MasticCount(BITS), CTX, THRESHOLDS, VK,
                        device="cpu", reports=reports, incremental=False,
                        mesh=mesh)
