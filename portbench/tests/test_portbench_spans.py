"""The readers of the program's spans (`portbench/spans.py`) on the tiny
cells: each gives a number on the chunked cell, and nothing where its
spans are missing (a resident round has no chunks, a ring too small
drops them, a program whose tracer has no wall clock cannot place
them)."""

import pytest

from mastic_tpu_torch.obs import trace as ttrace
from portbench.tests.tiny import run_tiny

ROUND = ("attr.eval_full_ms", "attr.eval_proof_ms", "attr.weight_check_ms",
         "attr.collect_wait_pct")
SHARD = ("setup.encode_ms", "setup.shard_device_ms")


@pytest.fixture(scope="module")
def chunked():
    ttrace.configure()
    return run_tiny("hist", trace=True, seconds=0.01)


@pytest.mark.parametrize("metric", ROUND + SHARD)
def test_reader_reads_the_chunked_cell(chunked, metric):
    assert chunked["correct"]
    value = chunked["metrics"][metric]["value"]
    assert isinstance(value, float) and value >= 0.0
    if metric == "attr.collect_wait_pct":
        assert value <= 100.0
    else:
        assert value > 0.0


def test_enqueueing_spans_lie_inside_the_dispatch(chunked):
    """One job in the window: its preps' spans are parts of its chunks'
    `dispatch_ms`."""
    assert chunked["counts"]["jobs"] == 1
    metrics = {k: v["value"] for (k, v) in chunked["metrics"].items()}
    parts = sum(metrics[k] for k in ROUND[:3])
    assert 0.0 < parts <= metrics["attr.dispatch_ms"]


def _no_wall_clock(monkeypatch):
    monkeypatch.delattr(ttrace.Tracer, "wall_ns")


@pytest.mark.parametrize("case,missing", [
    ("resident", ROUND),
    ("ring_dropped", ROUND + SHARD),
    ("no_wall_clock", ROUND + SHARD),
])
def test_reader_reads_nothing_without_its_spans(monkeypatch, case, missing):
    which = "hist"
    if case == "resident":
        which = "attr"
        ttrace.configure()
    elif case == "ring_dropped":
        ttrace.configure(capacity=8)
    else:
        ttrace.configure()
        _no_wall_clock(monkeypatch)
    try:
        line = run_tiny(which, trace=True, seconds=0.05)
    finally:
        ttrace.configure()
    assert line["correct"]
    assert not set(missing) & set(line["metrics"])
    assert set(ROUND + SHARD) - set(missing) <= set(line["metrics"])
