"""The port's chunk-streaming executor (`mastic_tpu_torch/drivers/
pipeline.py`) against the JAX package's contract: the order of stages
and collects, the timeline records, the error path, the overlap
arithmetic, and the transfers' CPU path.  No JAX program runs here."""

import numpy as np
import pytest
import torch

from mastic_tpu.drivers import pipeline as jpipeline
from mastic_tpu_torch.drivers import pipeline
from mastic_tpu_torch.ops.field import FIELD64

RECORD_KEYS = {"chunk", "stage_start_ms", "stage_end_ms", "phases",
               "host_syncs", "collect_start_ms", "collect_end_ms"}


def _drive(num: int, pipelined: bool) -> tuple:
    events = []

    def stage(i):
        events.append(("stage", i))
        return (f"handle{i}", {"upload_ms": 1.0, "dispatch_ms": 2.0})

    def collect(i, handle):
        assert handle == f"handle{i}"
        events.append(("collect", i))
        return {"compute_wait_ms": 3.0}

    (timeline, wall_ms) = pipeline.run_chunks(num, stage, collect, pipelined)
    return (events, timeline, wall_ms)


@pytest.mark.parametrize("num", [1, 2, 5])
def test_serial_order_is_strict(num):
    (events, timeline, _wall) = _drive(num, pipelined=False)
    assert events == [(kind, i) for i in range(num)
                      for kind in ("stage", "collect")]
    assert [rec["chunk"] for rec in timeline] == list(range(num))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_pipelined_stages_the_next_chunk_first(num):
    """Chunk i+1 is staged before chunk i is collected, and every chunk
    is staged and collected once, in order."""
    (events, timeline, _wall) = _drive(num, pipelined=True)
    want = [("stage", 0)]
    for i in range(num):
        if i + 1 < num:
            want.append(("stage", i + 1))
        want.append(("collect", i))
    assert events == want
    for i in range(num - 1):
        assert timeline[i + 1]["stage_start_ms"] \
            <= timeline[i]["collect_start_ms"]


def test_one_chunk_pipelined_runs_serially():
    (events, _timeline, _wall) = _drive(1, pipelined=True)
    assert events == [("stage", 0), ("collect", 0)]


@pytest.mark.parametrize("pipelined", [False, True])
def test_timeline_records(pipelined):
    """Each record has the JAX package's keys, the merged phases and
    one host sync; timestamps are ordered."""
    (_events, timeline, wall_ms) = _drive(3, pipelined)
    for rec in timeline:
        assert set(rec) == RECORD_KEYS
        assert rec["phases"] == {"upload_ms": 1.0, "dispatch_ms": 2.0,
                                 "compute_wait_ms": 3.0}
        assert rec["host_syncs"] == 1
        assert rec["stage_start_ms"] <= rec["stage_end_ms"] \
            <= rec["collect_start_ms"] <= rec["collect_end_ms"] <= wall_ms


@pytest.mark.parametrize("pipelined", [False, True])
def test_exception_in_collect_propagates(pipelined):
    def stage(i):
        return (i, {})

    def collect(i, handle):
        if i == 1:
            raise RuntimeError("chunk 1 failed")
        return {}

    with pytest.raises(RuntimeError, match="chunk 1 failed"):
        pipeline.run_chunks(3, stage, collect, pipelined)


@pytest.mark.parametrize("wall_ms", [0.0, 5.0, 9.0, 12.0, 30.0])
def test_overlap_efficiency_equals_the_jax_function(wall_ms):
    timeline = [{"phases": {"upload_ms": 2.0, "dispatch_ms": 1.5}},
                {"phases": {"upload_ms": 3.25, "compute_wait_ms": 4.0}},
                {"phases": {"host_ms": 1.25}}]
    got = pipeline.overlap_efficiency(timeline, wall_ms)
    assert got == jpipeline.overlap_efficiency(timeline, wall_ms)
    assert 0.0 <= got < 1.0


def test_lever(monkeypatch):
    for (value, on) in (("1", True), ("on", True), ("0", False),
                        ("off", False), ("false", False), ("", False)):
        monkeypatch.setenv("MASTIC_PIPELINE", value)
        assert pipeline.pipeline_enabled() is on
        assert jpipeline.pipeline_enabled() is on
    monkeypatch.delenv("MASTIC_PIPELINE")
    assert pipeline.pipeline_enabled()


def test_transfers_on_the_cpu_use_the_tensors_themselves():
    """Without a card the upload is the tensor itself, a download into
    a buffer copies (or is a no-op when the buffer is the tensor), and
    there are no device times."""
    xfer = pipeline.ChunkTransfer(
        pipeline.CopyStreams(torch.device("cpu")))
    t = torch.arange(6)
    with xfer.upload():
        assert xfer.to_device(t) is t
        assert xfer.to_device(None) is None
    buf = torch.zeros(6, dtype=t.dtype)
    (a, b) = xfer.download([(buf, t + 1), (None, t)])
    assert a is buf and buf.tolist() == [1, 2, 3, 4, 5, 6]
    assert b is t
    assert xfer.download([(t, t)])[0] is t
    xfer.wait()
    assert xfer.device_ms() is None


@pytest.mark.parametrize(("lever", "num", "want"), [
    ("1", 3, ("pipelined", None)), ("1", 1, ("serial", "single-chunk")),
    ("0", 3, ("serial", "lever-off"))])
def test_pipeline_mode_names_the_degrade(monkeypatch, lever, num, want):
    monkeypatch.setenv("MASTIC_PIPELINE", lever)
    assert pipeline.pipeline_mode(num) == want


@pytest.mark.parametrize("pipelined", [True, False])
def test_chunked_round_folds_and_records(pipelined):
    """The shared round skeleton on the CPU: each collect reads its
    chunk's downloads after dropping its device tensors, the shares
    fold mod p, the masks reach `fold` cut to the chunk's live reports,
    every timeline record carries its report count and wall time, and
    the pipeline block has the keys of the JAX runner's (minus `aot`)
    plus the card's own two, None here."""
    spec = FIELD64
    bounds = [(0, 4), (4, 8), (8, 10)]
    cr = pipeline.ChunkedRound(pipeline.CopyStreams(torch.device("cpu")),
                               bounds, *(("pipelined", None) if pipelined
                                         else ("serial", "lever-off")),
                               rows=2, spec=spec)
    seen = []

    def stage(i):
        xfer = cr.transfer(i)
        share = torch.tensor(np.stack([
            np.stack([spec.int_to_limbs(v) for v in values])
            for values in ([spec.modulus - 1 - i, 90], [1, 2])]))
        masks = torch.arange(4)[:, None] % 2 == i % 2
        (shares, masks) = xfer.download([(None, share), (None, masks)])
        handle = {"shares": shares, "masks": masks, "device": (share,)}
        return (handle, {"upload_ms": 0.0})

    def collect(i, handle):
        def fold(masks):
            assert "device" not in handle
            (lo, hi) = bounds[i]
            assert masks.shape == (hi - lo, 1)
            seen.append(i)

        return cr.collect(i, handle, fold)

    timeline = cr.run(stage, collect)
    assert seen == [0, 1, 2]
    p = spec.modulus
    assert cr.agg_shares == [[(3 * p - 6) % p, 90 * 3], [3, 6]]
    assert [rec["reports"] for rec in timeline] == [4, 4, 2]
    assert all(rec["wall_ms"] >= 0.0 and "device_ms" not in rec
               for rec in timeline)
    block = cr.pipeline_block()
    assert set(block) == {"mode", "fallback", "round_wall_ms",
                          "overlap_efficiency", "compile_inline_ms",
                          "warm_ms", "host_syncs", "device_ms",
                          "device_overlap_efficiency"}
    assert (block["mode"], block["host_syncs"]) == \
        ("pipelined" if pipelined else "serial", 3)
    assert block["device_ms"] is None and \
        block["device_overlap_efficiency"] is None
