"""Differential test of the port's whole slice: one heavy-hitters
collection, the port's HeavyHittersRun against the JAX package's, over
the same report batch, compared exactly (tolerance zero).

The port shards the reports (its sharding is held against the JAX
package's on the same inputs in test_torch_protocol.py) and `convert`
hands the batch to the JAX runner, so this file compiles no JAX
sharding program of its own."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from mastic_tpu.backend.mastic_jax import ReportBatch as JReportBatch
from mastic_tpu.backend.vidpf_jax import BatchedCorrectionWords as JCws
from mastic_tpu.drivers.heavy_hitters import HeavyHittersRun as JRun
from mastic_tpu.mastic import MasticCount as JMasticCount
from mastic_tpu_torch import convert
from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
from mastic_tpu_torch.drivers.heavy_hitters import (HeavyHittersRun,
                                                     compute_heavy_hitters)

CTX = b"torch port collection test"
VK = bytes(range(32, 64))
BITS = 4
REPORTS = 64


def _port_batch(seed: int = 0) -> tuple:
    """Four planted strings x 10 reports plus uniform ones, weights 0 or
    1, sharded by the port on the CPU: (batch, ok)."""
    rng = np.random.default_rng(seed)
    values = [int(v) for v in rng.integers(0, 2 ** BITS, 4)] * 10 + \
        [int(v) for v in rng.integers(0, 2 ** BITS, REPORTS - 40)]
    meas = [(tuple(bool((v >> (BITS - 1 - i)) & 1) for i in range(BITS)),
             int(rng.integers(0, 2)) if r % 7 == 0 else 1)
            for (r, v) in enumerate(values)]
    bm = BatchedMastic(MasticCount(BITS))
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    nonces = torch.from_numpy(rng.integers(0, 256, (REPORTS, 16),
                                           dtype=np.uint8))
    rand = torch.from_numpy(rng.integers(0, 256, (REPORTS, bm.m.RAND_SIZE),
                                         dtype=np.uint8))
    return bm.shard_device(CTX, alphas, betas, nonces, rand)


def _jax_batch(arrays: dict) -> JReportBatch:
    """The port's report batch (as numpy) as the JAX package's."""
    a = {k: jnp.asarray(v) for (k, v) in arrays.items()}
    return JReportBatch(
        nonces=a["nonces"],
        cws=JCws(seed=a["cws_seed"], ctrl=a["cws_ctrl"], w=a["cws_w"],
                 proof=a["cws_proof"]),
        keys=a["keys"], leader_proofs=a["leader_proofs"],
        helper_seeds=a["helper_seeds"], leader_seeds=None,
        peer_parts=(None, None))


# RoundMetrics.extra entries that are times (the "pipeline" block is the
# round's phase times), blocks whose values are each package's own (the
# artifact block: the JAX package's program tier, the port's kernel
# store) or that this run does not use (the mesh).
_UNSHARED_EXTRA = ("round_wall_ms", "splice_ms", "phases", "artifacts",
                   "pipeline", "mesh")


def _comparable(metrics) -> dict:
    record = dataclasses.asdict(metrics)
    record["extra"] = {k: v for (k, v) in record["extra"].items()
                       if k not in _UNSHARED_EXTRA}
    return record


def test_heavy_hitters_run_matches_jax(monkeypatch):
    """A whole collection: the heavy-hitter list, every level's
    aggregates and every level's RoundMetrics record (every field, and
    the `extra` entries both packages fill, times left out) equal
    HeavyHittersRun(..., batch=...)'s.  The JAX runner's next-level
    compile-ahead is switched off: it only costs compile time here."""
    monkeypatch.setenv("MASTIC_PIPELINE", "0")
    (pbatch, pok) = _port_batch()
    assert bool(pok.all())
    thresholds = {"default": 5}
    jrun = JRun(JMasticCount(BITS), CTX, thresholds, None, verify_key=VK,
                batch=_jax_batch(convert.report_batch_to_arrays(pbatch)))
    jlevels = []
    while True:
        handle = jrun.step_begin()
        if handle is None:
            break
        more = jrun.step_finish(handle)
        jlevels.append((list(handle["agg_param"][1]), handle["result"]))
        if not more:
            break
    trun = HeavyHittersRun(MasticCount(BITS), CTX, thresholds, VK, pbatch,
                           device="cpu")
    while trun.step():
        pass
    assert trun.level_results == jlevels
    assert trun.result() == jrun.result()
    assert len(trun.metrics) == len(jrun.metrics) == len(jlevels)
    for (got, want) in zip(trun.metrics, jrun.metrics):
        got = _comparable(got)
        extra = got.pop("extra")
        assert (extra.pop("excluded_invalid"),
                extra.pop("rejected_fallback_by")) == (0, {})
        want = _comparable(want)
        assert extra == want.pop("extra")
        assert got == want
    assert len(trun.result()) >= 3
    assert not trun.excluded().any()
    assert compute_heavy_hitters(MasticCount(BITS), CTX, thresholds, VK,
                                 pbatch, device="cpu") == jrun.result()
