"""The XOF rejection-sampling fallback in the port (the counterpart of
tests/test_rejection.py).

The batched sampler is exact only when no sampled element falls outside
the field; lanes where one does (about 2^-32 per Field64 element) come
back with `ok` False and must be recomputed through the scalar layer,
whose sampler runs the true rejection loop.  A real rejection needs
about 2^32 trials to find, so these tests force the mask: `sample_vec`
is patched where the port imports it by name (`ops/level.py`,
`backend/vidpf.py`, `backend/mastic.py`) to flag chosen report lanes.
The device values of a flagged lane are still right here, and the
scalar fallback recomputes exactly those values, so agreement with the
unforced run, and with the JAX package over the same reports, shows the
splice is wired end to end.  The predicate itself is held against
out-of-range bytes in test_torch_ops.py, and on the card by
chip_smoke.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
import mastic_tpu_torch.backend.vidpf as tbv
import mastic_tpu_torch.ops.level as tlv
from mastic_tpu.vdaf import run_vdaf
from mastic_tpu_torch import aggregate_by_attribute, hash_attribute
from mastic_tpu_torch.backend.xof import sample_vec
from mastic_tpu_torch.drivers.heavy_hitters import (HeavyHittersRun,
                                                     compute_heavy_hitters,
                                                     run_round)

VK = bytes(range(32))
HH_CTX = b"rejection hh"
HH_VALUES = [0b1001, 0b0000, 0b0000, 0b1001, 0b1100, 0b0011]
HH_THRESHOLDS = {"default": 2}


def _force_reject(monkeypatch, lanes):
    """Patch sample_vec so the chosen report lanes always read as
    rejected (the leading axis is the report axis at every call site
    of the aggregation path)."""
    def fake(spec, stream, length, offset=0):
        (limbs, ok) = sample_vec(spec, stream, length, offset)
        bad = torch.zeros(ok.shape[0], dtype=torch.bool, device=ok.device)
        bad[list(lanes)] = True
        return (limbs, ok & ~bad.reshape((-1,) + (1,) * (ok.dim() - 1)))

    for mod in (tlv, tbv, tbm):
        monkeypatch.setattr(mod, "sample_vec", fake)


def _reports(name: str, args: tuple, ctx: bytes, meas: list,
             seed: int) -> tuple:
    """The same reports from the port's scalar layer and the JAX
    package's: (port reports, JAX reports, nonces)."""
    rng = np.random.default_rng(seed)
    port = getattr(tbm, name)(*args).scalar()
    ref = getattr(jm, name)(*args)
    (reports, jreports, nonces) = ([], [], [])
    for m in meas:
        (nonce, rand) = (rng.bytes(16), rng.bytes(port.RAND_SIZE))
        reports.append((nonce,) + port.shard(ctx, m, nonce, rand))
        jreports.append((nonce,) + ref.shard(ctx, m, nonce, rand))
        nonces.append(nonce)
    return (reports, jreports, nonces)


def _hh_reports() -> tuple:
    m = tbm.MasticCount(4)
    meas = [(m.scalar().vidpf.test_index_from_int(v, 4), 1)
            for v in HH_VALUES]
    return _reports("MasticCount", (4,), HH_CTX, meas, 1)


@pytest.fixture(scope="module")
def jax_heavy_hitters():
    """The JAX package's compute_heavy_hitters over the same reports
    (one JAX program per level of its incremental runner)."""
    from mastic_tpu.drivers.heavy_hitters import compute_heavy_hitters as jchh

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MASTIC_PIPELINE", "0")
        return jchh(jm.MasticCount(4), HH_CTX, HH_THRESHOLDS,
                    _hh_reports()[1], verify_key=VK)


def _run(reports, incremental: bool) -> HeavyHittersRun:
    run = HeavyHittersRun(tbm.MasticCount(4), HH_CTX, HH_THRESHOLDS, VK,
                          device="cpu", incremental=incremental,
                          reports=reports)
    while run.step():
        pass
    return run


def _counters(metrics) -> list:
    return [(m.xof_fallbacks, m.accepted, m.rejected_fallback)
            for m in metrics]


@pytest.mark.parametrize("incremental", [True, False])
def test_heavy_hitters_with_forced_rejections(monkeypatch, incremental,
                                              jax_heavy_hitters):
    """Lanes 0 and 3 forced on every level: the heavy hitters and every
    level's counts equal the unforced run's and the JAX package's; each
    record counts the two lanes as XOF fallbacks, all six accepted.
    Apart from those counters the records equal the unforced run's."""
    (reports, _jreports, _nonces) = _hh_reports()
    want = _run(reports, incremental)
    assert want.result() == jax_heavy_hitters
    assert want.result()  # a non-trivial example
    _force_reject(monkeypatch, [0, 3])
    got = _run(reports, incremental)
    assert got.result() == want.result()
    assert got.level_results == want.level_results
    assert _counters(got.metrics) == [(2, 6, 0)] * len(want.metrics)
    for (g, w) in zip(got.metrics, want.metrics):
        (g, w) = (dataclasses.asdict(g), dataclasses.asdict(w))
        for key in ("xof_fallbacks", "extra"):
            g.pop(key)
            w.pop(key)
        assert g == w
    assert not got.excluded().any()


def test_fallback_lane_stays_spliced_on_the_incremental_runner(monkeypatch):
    """A lane forced at level 0 only: its carry is garbage from then on,
    so the resident runner keeps it in `fallback` and splices it at
    every later level, and the counts stay the unforced run's."""
    (reports, _jreports, _nonces) = _hh_reports()
    want = _run(reports, True)
    run = HeavyHittersRun(tbm.MasticCount(4), HH_CTX, HH_THRESHOLDS, VK,
                          device="cpu", reports=reports)
    with monkeypatch.context() as mp:
        _force_reject(mp, [4])
        assert run.step()
    while run.step():
        pass
    assert run.level_results == want.level_results
    assert _counters(run.metrics) == [(1, 6, 0)] * 4
    assert run.runner.fallback.tolist() == [False] * 4 + [True, False]


def test_attribute_metrics_with_forced_rejection(monkeypatch):
    """The JAX package's smallest case: MasticSum(8, 3), four reports,
    lane 2 (Greece, 3) forced.  The port gives Greece 4, as the JAX
    package's scalar protocol does over the same reports, with the lane
    counted as an XOF fallback and accepted."""
    ctx = b"rejection attrs"
    votes = [("Greece", 1), ("United States", 2), ("Greece", 3),
             ("India", 1)]
    mastic = tbm.MasticSum(8, 3)
    meas = [(hash_attribute(mastic, a), v) for (a, v) in votes]
    (reports, _jreports, nonces) = _reports("MasticSum", (8, 3), ctx, meas,
                                            2)
    attributes = ["Greece", "Mexico", "United States"]
    paths = tuple(hash_attribute(mastic, a) for a in attributes)
    scalar = run_vdaf(jm.MasticSum(8, 3), VK, (7, paths, True), ctx,
                      nonces, meas)
    want = aggregate_by_attribute(mastic, ctx, attributes, VK,
                                  device="cpu", reports=reports)
    _force_reject(monkeypatch, [2])
    records = []
    got = aggregate_by_attribute(mastic, ctx, attributes, VK,
                                 metrics_out=records, device="cpu",
                                 reports=reports)
    assert got == want == list(zip(attributes, scalar)) == \
        [("Greece", 4), ("Mexico", 0), ("United States", 2)]
    assert _counters(records) == [(1, 4, 0)]


def test_fallback_requires_host_reports(monkeypatch):
    """A rejection with no scalar reports to recompute it from raises,
    on the from-root round and on the incremental runner."""
    (reports, _jreports, _nonces) = _hh_reports()
    bm = tbm.BatchedMastic(tbm.MasticCount(4))
    batch = bm.marshal_reports(reports, "cpu")
    _force_reject(monkeypatch, [0])
    with pytest.raises(ValueError, match="scalar fallback"):
        run_round(bm, VK, HH_CTX, (0, ((False,), (True,)), True), batch)
    with pytest.raises(ValueError, match="scalar fallback"):
        compute_heavy_hitters(tbm.MasticCount(4), HH_CTX, HH_THRESHOLDS, VK,
                              batch, device="cpu")


@pytest.mark.parametrize("incremental", [True, False])
def test_invalid_lanes_are_left_out_not_spliced(monkeypatch, incremental):
    """A lane whose `valid` is False (never sharded correctly) and whose
    sampling also fires is left out of the aggregates and not
    recomputed: no scalar reports are needed, it is no XOF fallback,
    and the records count it under extra["excluded_invalid"]."""
    (reports, _jreports, _nonces) = _hh_reports()
    bm = tbm.BatchedMastic(tbm.MasticCount(4))
    batch = bm.marshal_reports(reports, "cpu")
    valid = torch.tensor([True] * 5 + [False])
    want = HeavyHittersRun(tbm.MasticCount(4), HH_CTX, HH_THRESHOLDS, VK,
                           device="cpu", incremental=incremental,
                           reports=reports[:5])
    while want.step():
        pass
    _force_reject(monkeypatch, [5])
    run = HeavyHittersRun(tbm.MasticCount(4), HH_CTX, HH_THRESHOLDS, VK,
                          batch, valid, "cpu", incremental)
    while run.step():
        pass
    assert run.level_results == want.level_results
    assert run.excluded().tolist() == [False] * 5 + [True]
    assert _counters(run.metrics) == [(0, 5, 0)] * len(run.metrics)
    assert all(m.extra["excluded_invalid"] == 1 for m in run.metrics)
