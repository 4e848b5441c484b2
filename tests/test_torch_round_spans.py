"""The spans inside the port's chunked round from the root and its client
shard, on the CPU (no JAX program).

A chunked `AttributeMetricsRun` over a MasticHistogram(8, 4, 2) batch
(Field128, joint randomness) of 10 reports in chunks of 4 (three
chunks, the tail padded with dead lanes, one report with a tampered
correction word) leaves the tree

    round -> chunk.stage -> vidpf.eval_full, prep.eval_proof,
                            prep.weight_check (each aggregator), round.checks
          -> chunk.collect -> collect.wait
          -> round.finalize

with its attributes; every span lies on the wall clock between
`time.time_ns()` readings taken around it; and the run's aggregates and
verdicts are the same with the JSONL sink (`MASTIC_TRACE_FILE`) armed
as without it, and equal a plaintext count.  The client shard leaves
`shard.encode` and `shard.device`, whose beta shares are two depth-0
`vidpf.eval_full` walks.  `Tracer.wall_ns` is the tracer's epoch on the
wall clock plus the offset.
"""

import time

import numpy as np
import pytest
import torch

from mastic_tpu_torch import AttributeMetricsRun, hash_attribute
from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticHistogram
from mastic_tpu_torch.obs import trace as ttrace

CTX = b"torch port span test"
VK = bytes(range(7, 39))
BITS = 8
R = 10
CHUNK = 4
ATTRS = ["alpha", "beta", "gamma"]
TAMPERED = 5
PREP = ("vidpf.eval_full", "prep.eval_proof", "prep.weight_check")


def _shard():
    """The batch on the CPU, its plaintext measurements, and the lane
    whose correction word is tampered."""
    m = MasticHistogram(BITS, 4, 2)
    bm = BatchedMastic(m)
    rng = np.random.default_rng(18)
    meas = [(hash_attribute(m, ATTRS[r % 3]), int(r % 4)) for r in range(R)]
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    nonces = torch.as_tensor(rng.integers(0, 256, (R, 16), np.uint8))
    rand = torch.as_tensor(rng.integers(0, 256, (R, m.RAND_SIZE), np.uint8))
    (batch, ok) = bm.shard_device(CTX, alphas, betas, nonces, rand)
    assert bool(ok.all())
    batch.cws.seed[TAMPERED, 2, 0] ^= 1
    return (m, bm, batch, meas)


@pytest.fixture(scope="module")
def shard():
    return _shard()


def _run(m, batch) -> tuple:
    run = AttributeMetricsRun(m, CTX, ATTRS, VK, batch=batch, device="cpu",
                              chunk_size=CHUNK)
    handle = run.step_begin()
    run.step_finish(handle)
    return (run.result(), handle["accept"].copy(), run.metrics[-1])


def test_round_spans_tree_attrs_and_wall_clock(shard, tmp_path,
                                               monkeypatch):
    (m, _bm, batch, meas) = shard
    path = tmp_path / "spans.jsonl"
    ttrace.configure(trace_file="")
    try:
        (plain, plain_accept, _) = _run(m, batch)
        monkeypatch.setenv("MASTIC_TRACE_FILE", str(path))
        tracer = ttrace.configure()
        assert tracer.trace_file == str(path)
        before = time.time_ns()
        (result, accept, metrics) = _run(m, batch)
        after = time.time_ns()
    finally:
        ttrace.configure(trace_file="")

    # The sink changes nothing of the round, which counts the plaintext.
    assert result == plain
    assert np.array_equal(accept, plain_accept)
    want = {a: [0] * 4 for a in ATTRS}
    for (r, (_alpha, bucket)) in enumerate(meas):
        if r != TAMPERED:
            want[ATTRS[r % 3]][bucket] += 1
    assert result == [(a, want[a]) for a in ATTRS]
    assert accept.tolist() == [r != TAMPERED for r in range(R)]
    assert metrics.rejected_eval_proof == 1

    spans = ttrace.read_jsonl(str(path))
    assert [s["name"] for s in spans] == [s.name for s in tracer.spans()]
    tree = ttrace.build_tree(spans)
    (rnd,) = tree[None]
    assert rnd["name"] == "round"
    chunks = -(-R // CHUNK)
    assert len(spans) == 2 + 10 * chunks
    kids = tree[rnd["span_id"]]
    names = [s["name"] for s in kids]
    assert sorted(names) == sorted(["chunk.stage", "chunk.collect"] * chunks
                                   + ["round.finalize"])
    assert names[-1] == "round.finalize"
    assert kids[-1]["attrs"] == {}
    stages = [s for s in kids if s["name"] == "chunk.stage"]
    collects = [s for s in kids if s["name"] == "chunk.collect"]
    assert [s["attrs"] for s in stages] == [{"chunk": i}
                                            for i in range(chunks)]
    assert [s["attrs"] for s in collects] == [{"chunk": i}
                                              for i in range(chunks)]
    for stage in stages:
        inner = tree[stage["span_id"]]
        assert [s["name"] for s in inner] == list(PREP) * 2 + ["round.checks"]
        for (k, s) in enumerate(inner[:-1]):
            assert s["attrs"] == {"agg_id": k // 3}
            assert s["span_id"] not in tree
        assert inner[-1]["attrs"] == {}
    for (i, coll) in enumerate(collects):
        (wait,) = tree[coll["span_id"]]
        assert (wait["name"], wait["attrs"]) == ("collect.wait", {"chunk": i})

    # On the wall clock: inside the readings taken around the run.
    for s in spans:
        start = tracer.wall_ns(s["t_start_ms"])
        end = tracer.wall_ns(s["t_start_ms"] + s["duration_ms"])
        assert before <= start <= end <= after, s["name"]


def test_shard_spans():
    m = MasticHistogram(BITS, 4, 2)
    bm = BatchedMastic(m)
    rng = np.random.default_rng(5)
    meas = [(hash_attribute(m, ATTRS[r % 3]), 1) for r in range(6)]
    tracer = ttrace.configure()
    before = time.time_ns()
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    (_batch, ok) = bm.shard_device(
        CTX, alphas, betas,
        torch.as_tensor(rng.integers(0, 256, (6, 16), np.uint8)),
        torch.as_tensor(rng.integers(0, 256, (6, m.RAND_SIZE), np.uint8)))
    after = time.time_ns()
    assert bool(ok.all())
    tree = ttrace.build_tree([s.as_dict() for s in tracer.spans()])
    (encode, device) = tree[None]
    assert (encode["name"], encode["attrs"]) == ("shard.encode",
                                                 {"reports": 6})
    assert (device["name"], device["attrs"]) == ("shard.device",
                                                 {"reports": 6})
    assert [(s["name"], s["attrs"]) for s in tree[device["span_id"]]] == [
        ("vidpf.eval_full", {"agg_id": a}) for a in (0, 1)]
    assert before <= tracer.wall_ns(encode["t_start_ms"]) <= after


def test_wall_ns_is_the_wall_clock_epoch_plus_the_offset():
    before = time.time_ns()
    tracer = ttrace.configure()
    after = time.time_ns()
    assert before <= tracer.epoch_wall_ns <= after
    assert tracer.wall_ns(0.0) == tracer.epoch_wall_ns
    assert tracer.wall_ns(1.5) == tracer.epoch_wall_ns + 1_500_000
    with tracer.span("probe") as sp:
        pass
    assert tracer.wall_ns(sp.t_start_ms) <= time.time_ns()
    ttrace.configure()
