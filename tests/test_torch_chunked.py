"""The port's chunked runners against the JAX package's and against the
port's resident runner, compared exactly (tolerance 0).

MasticCount(5) over 37 scalar-layer reports in chunks of 8 (five
chunks, the tail padded with five dead lanes): every level's decoded
aggregates, the RoundMetrics counters and, after two levels, the
checkpoint arrays (every chunk's carries included) equal the JAX
package's chunked run; chunked checkpoints resume across the two
packages; the chunked run equals the resident one, pipelined equals
serial, and the width grows from 8 to 16 on the way.  A lane of the
tail chunk is forced through the XOF-rejection splice (its level-1
`ok` cleared, with `IncrementalMastic.agg_rounds` wrapped, as the
card's smoke forces it); it is the chunk's first lane, so the dead
lanes that copy it fall back too and must stay out of `fallback`.
MasticHistogram(4, 2, 1) (Field128, joint randomness) over 33 reports
in chunks of 16, from a JAX store converted into the port, equals the
resident runner.  The envelope is held against the
real allocations and refuses at tiny budgets.  The attribute round's
`chunk_size` (MasticSum(4, 7), 33 reports in chunks of 8, a tampered
report alone in the tail chunk) equals JAX's chunked round and the
port's unchunked one, from scalar reports, from a store and from a
batch; given a batch beside the reports it streams the batch and reads
the reports only for the splice of two forced lanes.

JAX runs with MASTIC_PIPELINE=0 (its serial executor: same results,
and no programs warmed for predicted rounds).
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.drivers import attribute_metrics as jam
from mastic_tpu.drivers import chunked as jchunked
from mastic_tpu.drivers.heavy_hitters import HeavyHittersRun as JRun
from mastic_tpu_torch import (ChunkedIncrementalRunner, HostReportStore,
                              aggregate_by_attribute, hash_attribute)
from mastic_tpu_torch.backend.incremental import IncrementalMastic
from mastic_tpu_torch.convert import store_from_arrays, store_to_arrays
from mastic_tpu_torch.drivers import chunked
from mastic_tpu_torch.drivers.heavy_hitters import (HeavyHittersRun,
                                                     IncrementalRunner)

CTX = b"torch port chunked test"
VK = bytes(range(40, 72))
BITS = 5
R = 37
CHUNK = 8
THRESHOLDS = {"default": 2}
SPLIT = 2            # levels before the checkpoint
FORCED = 32          # the tail chunk's first report
FORCED_LEVEL = 1


def _reports(name: str, args: tuple, meas: list, seed: int) -> tuple:
    """The same reports from the port's scalar layer and the JAX
    package's: (port reports, JAX reports)."""
    rng = np.random.default_rng(seed)
    port = getattr(tbm, name)(*args).scalar()
    ref = getattr(jm, name)(*args)
    (reports, jreports) = ([], [])
    for m in meas:
        (nonce, rand) = (rng.bytes(16), rng.bytes(port.RAND_SIZE))
        reports.append((nonce,) + port.shard(CTX, m, nonce, rand))
        jreports.append((nonce,) + ref.shard(CTX, m, nonce, rand))
    return (reports, jreports)


def _count_reports() -> tuple:
    values = np.random.default_rng(1).integers(0, 2 ** BITS, R)
    vid = tbm.MasticCount(BITS).scalar().vidpf
    return _reports("MasticCount", (BITS,),
                    [(vid.test_index_from_int(int(v), BITS), 1)
                     for v in values], 2)


def _port_run(reports, **kw) -> HeavyHittersRun:
    return HeavyHittersRun(tbm.MasticCount(BITS), CTX, THRESHOLDS, VK,
                           device="cpu", reports=reports, **kw)


def _steps(run, levels=None) -> list:
    """Step a run (the JAX or the port's) all the way, or `levels`
    levels: [(prefixes, decoded aggregates)] per level."""
    out = []
    while levels is None or len(out) < levels:
        handle = run.step_begin()
        if handle is None:
            break
        more = run.step_finish(handle)
        prefixes = list(handle["agg_param"][1])
        out.append((prefixes, handle["result"] if "result" in handle
                    else run.level_results[-1][1]))
        if not more:
            break
    return out


def _arrays(data: bytes) -> dict:
    arrays = np.load(io.BytesIO(data), allow_pickle=False)
    return {k: arrays[k] for k in arrays.files}


def _counters(m) -> dict:
    """A RoundMetrics record's counters (every field but `extra`)."""
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if f.name != "extra"}


def _forcing(monkeypatch, nonce: bytes, level: int) -> None:
    """Clear aggregator 0's `ok` at `level` on every lane whose round
    keys are those of `nonce` (IncrementalMastic.agg_rounds wrapped):
    the report, and in a chunk every dead lane that copies it."""
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    (target, _conv) = bm.vidpf.roundkeys(
        CTX, torch.tensor(list(nonce), dtype=torch.uint8)[None])
    real = IncrementalMastic.agg_rounds

    def agg_rounds(self, agg_ids, verify_key, ctx, carries, rnd, ext_rk,
                   *args):
        out = real(self, agg_ids, verify_key, ctx, carries, rnd, ext_rk,
                   *args)
        if rnd.level == level:
            (carry, proof, share, ok) = out[0]
            hit = (ext_rk == target).flatten(1).all(dim=1)
            out[0] = (carry, proof, share, ok & ~hit)
        return out

    monkeypatch.setattr(IncrementalMastic, "agg_rounds", agg_rounds)


@pytest.fixture(scope="module")
def count() -> dict:
    """The JAX package's chunked run (checkpointed after SPLIT levels
    and carried on), the port's chunked run likewise, the port's
    resident run, and the port's checkpoint resumed in JAX (on the
    first JAX run's compiled programs, which it shares by their shape
    keys)."""
    (reports, jreports) = _count_reports()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        jrun = JRun(jm.MasticCount(BITS), CTX, THRESHOLDS, jreports,
                    verify_key=VK, chunk_size=CHUNK)
        jlevels = _steps(jrun, SPLIT)
        jckpt = jrun.to_bytes()
        jlevels += _steps(jrun)
    trun = _port_run(reports, chunk_size=CHUNK)
    tlevels = _steps(trun, SPLIT)
    tckpt = trun.to_bytes()
    tlevels += _steps(trun)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        back = JRun.from_bytes(jm.MasticCount(BITS), CTX, THRESHOLDS,
                               jreports, VK, tckpt)
        back.runner.programs = jrun.runner.programs
        back_levels = _steps(back)
    resident = _port_run(reports)
    while resident.step():
        pass
    return {"reports": reports, "jreports": jreports, "jrun": jrun,
            "jlevels": jlevels, "jckpt": jckpt, "trun": trun,
            "tlevels": tlevels, "tckpt": tckpt, "back": back,
            "back_levels": back_levels, "resident": resident}


def test_levels_and_counters_match_jax(count):
    """Every level's decoded aggregates and RoundMetrics counters equal
    the JAX package's chunked run, and the heavy hitters too."""
    (trun, jrun) = (count["trun"], count["jrun"])
    assert count["tlevels"] == count["jlevels"]
    assert len(count["tlevels"]) == BITS
    assert trun.result() == jrun.result() and trun.result()
    assert [_counters(m) for m in trun.metrics] == \
        [_counters(m) for m in jrun.metrics]
    assert [m.accepted for m in trun.metrics] == [R] * BITS


def test_round_metrics_extra_has_the_jax_blocks(count):
    """`extra` carries the chunk timeline, the memory accounting and
    the pipeline block with the JAX package's keys (minus its AOT
    entry), for five chunks of which the last holds five reports."""
    (got, want) = (count["trun"].metrics[-1].extra,
                   count["jrun"].metrics[-1].extra)
    assert set(got["pipeline"]) - {"device_ms",
                                   "device_overlap_efficiency"} == \
        set(want["pipeline"]) - {"aot"}
    assert got["pipeline"]["host_syncs"] == 5
    assert (got["pipeline"]["mode"], got["pipeline"]["fallback"]) == \
        ("pipelined", None)
    assert got["memory"] == want["memory"]
    assert [c["reports"] for c in got["chunks"]] == [8, 8, 8, 8, 5]
    assert [set(c) for c in got["chunks"]] == \
        [set(c) - {"shard_wait_skew_ms"} for c in want["chunks"]]


def test_checkpoint_arrays_match_jax(count):
    """After two levels the port's chunked checkpoint equals the JAX
    package's array by array: meta (chunk_size 8), the fallback mask and
    every chunk's carries, dead lanes included."""
    (got, want) = (_arrays(count["tckpt"]), _arrays(count["jckpt"]))
    assert sorted(got) == sorted(want)
    assert "k4_c1_w" in got and int(got["meta"][6]) == CHUNK
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key


def test_jax_checkpoint_resumes_in_the_port(count):
    run = HeavyHittersRun.from_bytes(
        tbm.MasticCount(BITS), CTX, THRESHOLDS, VK, None, count["jckpt"],
        device="cpu", reports=count["reports"])
    assert run.store.chunk_size == CHUNK
    assert _steps(run) == count["tlevels"][SPLIT:]
    assert run.result() == count["trun"].result()


def test_port_checkpoint_resumes_in_jax(count):
    assert count["back_levels"] == count["tlevels"][SPLIT:]
    assert count["back"].result() == count["trun"].result()


def test_chunked_equals_resident(count):
    """The chunked run equals the resident runner over the same
    reports: every level, every counter, the widths (8, grown to 16)."""
    (trun, resident) = (count["trun"], count["resident"])
    assert trun.level_results == resident.level_results
    assert [_counters(m) for m in trun.metrics] == \
        [_counters(m) for m in resident.metrics]
    widths = [m.padded_width for m in trun.metrics]
    assert widths[0] == 8 and 16 in widths
    assert trun.runner.max_width == resident.runner.max_width


def test_width_growth_from_8_to_16(count):
    """A run cut at the level where the width first grows holds carries
    of the grown width in every chunk, equal to the JAX run's after the
    same levels (resumed from the JAX checkpoint)."""
    widths = [m.padded_width for m in count["trun"].metrics]
    grow = widths.index(16)
    run = HeavyHittersRun.from_bytes(
        tbm.MasticCount(BITS), CTX, THRESHOLDS, VK, None, count["jckpt"],
        device="cpu", reports=count["reports"])
    assert run.runner.width == 8
    _steps(run, grow + 1 - SPLIT)
    assert run.runner.width == 16
    for cs in run.runner.chunks:
        assert [c.w.shape[2] for c in cs.carries] == [16, 16]
    assert run.level_results == count["tlevels"][SPLIT:grow + 1]


def test_pipelined_equals_serial(monkeypatch, count):
    monkeypatch.setenv("MASTIC_PIPELINE", "0")
    run = _port_run(count["reports"], chunk_size=CHUNK)
    assert _steps(run) == count["tlevels"]
    assert [_counters(m) for m in run.metrics] == \
        [_counters(m) for m in count["trun"].metrics]
    assert {(m.extra["pipeline"]["mode"], m.extra["pipeline"]["fallback"])
            for m in run.metrics} == {("serial", "lever-off")}
    (got, want) = (_arrays(run.to_bytes()), _arrays(count["trun"].to_bytes()))
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_degrade_to_serial_is_named(monkeypatch, count):
    """A device budget that holds one chunk's round but not two runs the
    round serially and says why; one chunk is serial too."""
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    run = _port_run(count["reports"], chunk_size=CHUNK)
    resident = run.runner.memory_accounting()["device_bytes_per_chunk"]
    one = chunked.round_peak_bytes(bm, 8, 2, CHUNK, resident)
    two = chunked.round_peak_bytes(bm, 8, 2, CHUNK, resident, 2)
    monkeypatch.setenv("MASTIC_DEVICE_BUDGET_BYTES", str((one + two) // 2))
    assert _steps(run, 1) == count["tlevels"][:1]
    assert run.metrics[0].extra["pipeline"]["fallback"] == "device-budget"
    monkeypatch.delenv("MASTIC_DEVICE_BUDGET_BYTES")
    single = _port_run(count["reports"], chunk_size=R)
    assert _steps(single, 1) == count["tlevels"][:1]
    assert single.metrics[0].extra["pipeline"]["fallback"] == "single-chunk"


def test_forced_lane_in_the_tail_chunk_is_spliced(monkeypatch, count):
    """The tail chunk's first report forced to the fallback at level 1:
    every level still equals the unforced run, the lane stays in
    `fallback` (and is spliced) at every later level, and the dead
    lanes that copy it stay out of it."""
    _forcing(monkeypatch, count["reports"][FORCED][0], FORCED_LEVEL)
    run = _port_run(count["reports"], chunk_size=CHUNK)
    assert _steps(run) == count["tlevels"]
    assert np.flatnonzero(run.runner.fallback).tolist() == [FORCED]
    assert [m.xof_fallbacks for m in run.metrics] == \
        [int(level >= FORCED_LEVEL) for level in range(BITS)]
    assert [m.accepted for m in run.metrics] == [R] * BITS
    ckpt = _arrays(run.to_bytes())
    assert np.flatnonzero(ckpt["fallback"]).tolist() == [FORCED]


def test_checkpoint_refusals_match_jax(count):
    """A resident checkpoint with a store, a chunked one with no report
    source, and a store of another chunk size are refused with the JAX
    package's messages (both packages read the same checkpoint)."""
    reports = count["reports"]
    resident = _port_run(reports)
    resident.step()
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    jbm = JBatchedMastic(jm.MasticCount(BITS))

    def stores(chunk_size):
        return (HostReportStore.from_batch(bm.marshal_reports(reports, "cpu"),
                                           chunk_size),
                jchunked.HostReportStore.from_batch(
                    jbm.marshal_reports(count["jreports"]), chunk_size))

    cases = [(resident.to_bytes(), stores(CHUNK), "resident"),
             (count["tckpt"], (None, None), "report store"),
             (count["tckpt"], stores(4), "store has 4")]
    for (ckpt, (store, jstore), match) in cases:
        with pytest.raises(ValueError, match=match) as got:
            HeavyHittersRun.from_bytes(tbm.MasticCount(BITS), CTX,
                                       THRESHOLDS, VK, None, ckpt,
                                       device="cpu", store=store)
        with pytest.raises(ValueError) as want:
            JRun.from_bytes(jm.MasticCount(BITS), CTX, THRESHOLDS, None, VK,
                            ckpt, store=jstore)
        assert str(got.value) == str(want.value)


# -- Field128 with joint randomness --------------------------------------

HIST = (4, 2, 1)
HIST_R = 33
HIST_CHUNK = 16
HIST_LEVELS = 2


@pytest.fixture(scope="module")
def histogram() -> dict:
    """MasticHistogram(4, 2, 1) reports from both scalar layers, the JAX
    package's store of them, and the port's resident runner over the
    same reports for HIST_LEVELS levels (every prefix, the weight check
    and the joint-rand confirmation at level 0)."""
    rng = np.random.default_rng(5)
    mastic = tbm.MasticHistogram(*HIST)
    vid = mastic.scalar().vidpf
    meas = [(vid.test_index_from_int(int(rng.integers(0, 16)), 4),
             int(rng.integers(0, 2))) for _ in range(HIST_R)]
    (reports, jreports) = _reports("MasticHistogram", HIST, meas, 6)
    jbm = JBatchedMastic(jm.MasticHistogram(*HIST))
    jstore = jchunked.HostReportStore.from_batch(
        jbm.marshal_reports(jreports), HIST_CHUNK)
    bm = tbm.BatchedMastic(mastic)
    resident = IncrementalRunner(bm, VK, CTX,
                                 bm.marshal_reports(reports, "cpu"),
                                 reports=reports)
    (results, metrics) = ([], [])
    for level in range(HIST_LEVELS):
        handle = resident.round_stage(_hist_param(level))
        results.append(resident.round_collect(handle, metrics))
    return {"reports": reports, "jstore": jstore, "jbm": jbm,
            "resident": resident, "results": results, "metrics": metrics}


def _hist_param(level: int) -> tuple:
    prefixes = tuple(tuple(bool(v >> (level - i) & 1)
                           for i in range(level + 1))
                     for v in range(2 ** (level + 1)))
    return (level, prefixes, level == 0)


def _hist_runner(store, reports) -> ChunkedIncrementalRunner:
    return ChunkedIncrementalRunner(
        tbm.BatchedMastic(tbm.MasticHistogram(*HIST)), VK, CTX, store,
        "cpu", reports=reports)


def test_field128_store_converts_both_ways(histogram):
    """The JAX store's arrays become a port store and back, equal."""
    jstore = histogram["jstore"]
    store = store_from_arrays(jstore.arrays, HIST_CHUNK, "cpu")
    assert (store.num_reports, store.num_chunks, store.use_jr) == \
        (HIST_R, 3, True)
    back = store_to_arrays(store)
    assert sorted(back) == sorted(jstore.arrays)
    for (key, want) in jstore.arrays.items():
        got = back[key]
        for (g, w) in (zip(got, want) if key == "peer_parts"
                       else [(got, want)]):
            assert g.dtype == np.asarray(w).dtype, key
            assert np.array_equal(g, np.asarray(w)), key


def test_field128_joint_rand_runner_matches_resident(histogram):
    """The chunked runner over the converted JAX store (33 reports in
    chunks of 16, a padded tail): every level's histograms and counters
    equal the resident runner's over the same reports (itself held
    against the JAX package in test_torch_circuits.py), and its live
    lanes' carries equal the resident carries."""
    store = store_from_arrays(histogram["jstore"].arrays, HIST_CHUNK, "cpu")
    runner = _hist_runner(store, histogram["reports"])
    metrics = []
    results = [runner.round(_hist_param(level), metrics)
               for level in range(HIST_LEVELS)]
    assert results == histogram["results"]
    assert [_counters(m) for m in metrics] == \
        [_counters(m) for m in histogram["metrics"]]
    assert (metrics[0].accepted, metrics[0].rejected_joint_rand) == \
        (HIST_R, 0)
    for (a, want) in enumerate(histogram["resident"].carries):
        for (k, field) in enumerate(want):
            got = torch.cat([cs.carries[a][k] for cs in runner.chunks])
            assert torch.equal(got[:HIST_R], field), (a, k)


def test_envelope_prices_the_real_allocations(monkeypatch, histogram):
    """memory_envelope's per-chunk and host terms equal the runner's
    accounting of its tensors (the tail chunk padded, the store exact),
    and match JAX's carry and store terms; tiny budgets are refused with
    the remedy, at construction and at the round."""
    store = store_from_arrays(histogram["jstore"].arrays, HIST_CHUNK, "cpu")
    runner = _hist_runner(store, histogram["reports"])
    bm = runner.bm
    env = chunked.memory_envelope(bm, HIST_CHUNK, runner.width, HIST_R)
    mem = runner.memory_accounting()
    assert env["device_bytes_per_chunk"] == mem["device_bytes_per_chunk"]
    assert env["host_bytes_total"] == mem["host_bytes_total"]
    assert env["device_bytes_per_chunk_pipelined"] == \
        2 * mem["device_bytes_per_chunk"]
    carry = sum(x.nbytes for c in runner.chunks[0].carries for x in c)
    assert carry == HIST_CHUNK * env["per_report_bytes"]["carry"]
    assert store.host_bytes() == HIST_R * env["per_report_bytes"]["store"]
    jper = jchunked.per_report_bytes(histogram["jbm"], runner.width)
    for key in ("carry", "roundkeys", "store"):
        assert env["per_report_bytes"][key] == jper[key], key

    def build():
        return _hist_runner(store, histogram["reports"])

    monkeypatch.setenv("MASTIC_DEVICE_BUDGET_BYTES", "1000")
    with pytest.raises(ValueError, match="width itself is infeasible"):
        build()
    per = env["device_bytes_per_chunk"] // HIST_CHUNK
    monkeypatch.setenv("MASTIC_DEVICE_BUDGET_BYTES", str(per * 2))
    with pytest.raises(ValueError, match="feasible chunk_size at this "
                                         "width is 2"):
        build()
    monkeypatch.setenv("MASTIC_DEVICE_BUDGET_BYTES",
                       str(env["device_bytes_per_chunk"] + 1))
    with pytest.raises(ValueError, match="level 0: the round's transients"):
        build().round(_hist_param(0))
    monkeypatch.delenv("MASTIC_DEVICE_BUDGET_BYTES")
    monkeypatch.setenv("MASTIC_HOST_BUDGET_BYTES", "1000")
    with pytest.raises(ValueError, match="hosts"):
        build()


# -- the attribute round's chunk_size -------------------------------------

ATTR = (4, 7)
ASKED = ["Greece", "Mexico", "India"]
ATTR_R = 33
ATTR_CHUNK = 8
ATTR_TAMPERED = 32   # alone in the tail chunk
# JAX's chunked round compiles one program per chunk shape: three chunks
# of 11 take one program (its result does not depend on the chunking).
JAX_ATTR_CHUNK = 11


@pytest.fixture(scope="module")
def attributes() -> dict:
    """MasticSum(4, 7) votes over three attributes (and others), the
    tail report's correction word tampered; JAX's chunked round (in
    chunks of JAX_ATTR_CHUNK)."""
    rng = np.random.default_rng(9)
    port = tbm.MasticSum(*ATTR)
    names = ASKED + ["Chile", "Peru"]
    meas = [(hash_attribute(port, names[int(rng.integers(0, 5))]),
             int(rng.integers(0, 8))) for _ in range(ATTR_R)]
    (reports, jreports) = _reports("MasticSum", ATTR, meas, 10)
    for batch in (reports, jreports):
        (nonce, public, shares) = batch[ATTR_TAMPERED]
        (seed, ctrl, w, proof) = public[1]
        public = public[:1] + [(bytes([seed[0] ^ 0x33]) + seed[1:], ctrl,
                                w, proof)] + public[2:]
        batch[ATTR_TAMPERED] = (nonce, public, shares)
    jmetrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        jresult = jam.aggregate_by_attribute(
            jm.MasticSum(*ATTR), CTX, ASKED, jreports, verify_key=VK,
            metrics_out=jmetrics, chunk_size=JAX_ATTR_CHUNK)
    want = [(a, sum(w for (r, (p, w)) in enumerate(meas)
                    if p == hash_attribute(port, a) and r != ATTR_TAMPERED))
            for a in ASKED]
    return {"reports": reports, "jresult": jresult, "jmetrics": jmetrics,
            "want": want}


@pytest.mark.parametrize("source", ["reports", "store", "batch"])
def test_chunked_attribute_round_matches(attributes, source):
    """From the scalar reports, from a store and from a batch (a store
    built from it), the chunked round equals JAX's chunked round, the
    port's unchunked round and the plaintext sums; the tampered report
    in the tail chunk is the one rejection."""
    mastic = tbm.MasticSum(*ATTR)
    reports = attributes["reports"]
    batch = tbm.BatchedMastic(mastic).marshal_reports(reports, "cpu")
    kw = {"reports": reports, "chunk_size": ATTR_CHUNK}
    if source == "store":
        kw["store"] = HostReportStore.from_batch(batch, ATTR_CHUNK)
    elif source == "batch":
        kw = {"batch": batch, "chunk_size": ATTR_CHUNK}
    (metrics, plain) = ([], [])
    got = aggregate_by_attribute(mastic, CTX, ASKED, VK, device="cpu",
                                 metrics_out=metrics, **kw)
    unchunked = aggregate_by_attribute(mastic, CTX, ASKED, VK, batch,
                                       device="cpu", metrics_out=plain)
    assert got == attributes["jresult"] == unchunked == attributes["want"]
    assert _counters(metrics[0]) == _counters(attributes["jmetrics"][0]) \
        == _counters(plain[0])
    assert (metrics[0].accepted, metrics[0].rejected_eval_proof) == \
        (ATTR_R - 1, 1)
    extra = metrics[0].extra
    assert [c["reports"] for c in extra["chunks"]] == [8, 8, 8, 8, 1]
    assert extra["pipeline"]["mode"] == "pipelined"
    assert extra["pipeline"]["host_syncs"] == 5


def test_chunked_attribute_round_streams_the_batch(monkeypatch, attributes):
    """Given a batch, the scalar reports and `chunk_size` together, the
    round streams the batch (a store built from it; the reports are
    never marshalled) and reads the reports only for the splice: an
    honest lane and the tampered one, their `ok` cleared in every chunk
    by nonce (`BatchedMastic.prep_both` wrapped), are recomputed through
    the scalar layer, with the unforced result; the tampered one is
    rejected by the splice."""
    mastic = tbm.MasticSum(*ATTR)
    reports = attributes["reports"]
    batch = tbm.BatchedMastic(mastic).marshal_reports(reports, "cpu")
    forced = torch.tensor([list(reports[r][0]) for r in (10, ATTR_TAMPERED)],
                          dtype=torch.uint8)
    real = tbm.BatchedMastic.prep_both

    def prep_both(self, verify_key, ctx, agg_param, batch, *args):
        (p0, p1) = real(self, verify_key, ctx, agg_param, batch, *args)
        hit = (batch.nonces[:, None] == forced[None]).all(-1).any(-1)
        return (p0._replace(ok=p0.ok & ~hit), p1)

    def marshal_reports(*_args, **_kw):
        raise AssertionError("the chunked round marshalled the reports")

    monkeypatch.setattr(tbm.BatchedMastic, "prep_both", prep_both)
    monkeypatch.setattr(tbm.BatchedMastic, "marshal_reports", marshal_reports)
    metrics = []
    got = aggregate_by_attribute(mastic, CTX, ASKED, VK, batch, device="cpu",
                                 metrics_out=metrics, reports=reports,
                                 chunk_size=ATTR_CHUNK)
    m = metrics[0]
    assert got == attributes["want"]
    assert (m.accepted, m.xof_fallbacks, m.rejected_fallback) == \
        (ATTR_R - 1, 2, 1)
    assert [c["reports"] for c in m.extra["chunks"]] == [8, 8, 8, 8, 1]


def test_chunked_attribute_round_slices_valid(attributes):
    """`valid` is sliced per chunk: the reports it leaves out are left
    out of the chunked round as of the unchunked one."""
    mastic = tbm.MasticSum(*ATTR)
    batch = tbm.BatchedMastic(mastic).marshal_reports(attributes["reports"],
                                                      "cpu")
    valid = torch.ones(ATTR_R, dtype=torch.bool)
    valid[[3, 9, 30]] = False
    (metrics, plain) = ([], [])
    got = aggregate_by_attribute(mastic, CTX, ASKED, VK, batch, valid=valid,
                                 device="cpu", metrics_out=metrics,
                                 chunk_size=ATTR_CHUNK)
    want = aggregate_by_attribute(mastic, CTX, ASKED, VK, batch, valid=valid,
                                  device="cpu", metrics_out=plain)
    assert got == want
    assert _counters(metrics[0]) == _counters(plain[0])
    assert metrics[0].extra["excluded_invalid"] == 3
