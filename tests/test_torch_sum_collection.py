"""Differential tests of MasticSum's incremental rounds and of a whole
MasticSum collection, against the JAX package, compared exactly
(tolerance zero).

Every level of both aggregators' `agg_round` (Field64, VALUE_LEN 7,
the matrix truncate that recomposes the weight from its bits): carry,
eval proof, out share and ok.  Then `compute_heavy_hitters(MasticSum(4, 7),
...)` and every level's aggregates against the JAX package's
HeavyHittersRun over the same report batch; the JAX package's own tests
hold that result equal to a plaintext oracle.  The port shards the
reports (held against the JAX package in test_torch_circuit_shard.py)
and `convert` hands the batch to JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastic_tpu import mastic as jm
from mastic_tpu.backend.incremental import IncrementalMastic as JEngine
from mastic_tpu.backend.incremental import RoundPlan as JRoundPlan
from mastic_tpu.backend.incremental import carry_to_arrays as j_carry_to_arrays
from mastic_tpu.backend.incremental import round_inputs as j_round_inputs
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.backend.mastic_jax import ReportBatch as JReportBatch
from mastic_tpu.backend.vidpf_jax import BatchedCorrectionWords as JCws
from mastic_tpu.drivers.heavy_hitters import HeavyHittersRun as JRun
from mastic_tpu_torch import convert
from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.backend.incremental import (IncrementalMastic,
                                                  RoundPlan, round_inputs)
from mastic_tpu_torch.drivers.heavy_hitters import (HeavyHittersRun,
                                                     compute_heavy_hitters)

CTX = b"torch port sum collection"
VK = bytes(range(96, 128))
BITS = 4
REPORTS = 64
WIDTH = 8

FRONTIERS = [
    [(False,), (True,)],
    [(False, True), (True, False), (True, True)],
    [(False, True, True), (True, False, False), (True, False, True)],
    [(False, True, True, False), (True, False, False, True),
     (True, False, True, False), (True, False, True, True)],
]


@pytest.fixture(scope="module")
def port_batch() -> tuple:
    """Four planted strings x 10 reports plus uniform ones, weights in
    [0, 7], sharded by the port on the CPU once per module: (mastic,
    batch, ok)."""
    mastic = tm.MasticSum(BITS, 7)
    bm = tm.BatchedMastic(mastic)
    rng = np.random.default_rng(1)
    values = [int(v) for v in rng.integers(0, 2 ** BITS, 4)] * 10 + \
        [int(v) for v in rng.integers(0, 2 ** BITS, REPORTS - 40)]
    meas = [(tuple(bool((v >> (BITS - 1 - i)) & 1) for i in range(BITS)),
             int(rng.integers(0, 8))) for v in values]
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    nonces = torch.from_numpy(rng.integers(0, 256, (REPORTS, 16),
                                           dtype=np.uint8))
    rand = torch.from_numpy(rng.integers(0, 256, (REPORTS, mastic.RAND_SIZE),
                                         dtype=np.uint8))
    (batch, ok) = bm.shard_device(CTX, alphas, betas, nonces, rand)
    return (mastic, batch, ok)


def _jax_batch(arrays: dict) -> JReportBatch:
    """The port's report batch (as numpy) as the JAX package's."""
    a = {k: jnp.asarray(v) for (k, v) in arrays.items()}
    jr = "leader_seeds" in a
    return JReportBatch(
        nonces=a["nonces"],
        cws=JCws(seed=a["cws_seed"], ctrl=a["cws_ctrl"], w=a["cws_w"],
                 proof=a["cws_proof"]),
        keys=a["keys"], leader_proofs=a["leader_proofs"],
        helper_seeds=a["helper_seeds"],
        leader_seeds=a["leader_seeds"] if jr else None,
        peer_parts=(a["peer_part0"], a["peer_part1"]) if jr else (None, None))


def test_sum_agg_round_matches_jax_at_every_level(port_batch):
    """All BITS levels of both aggregators' rounds: carry, eval proof,
    out share (the truncated weight, recomposed from its bits by the
    Montgomery matrix) and ok equal after each.  MasticHistogram's
    rounds are held in test_torch_circuit_shard.py."""
    (mastic, pbatch, pok) = port_batch
    assert bool(pok.all())
    jbatch = _jax_batch(convert.report_batch_to_arrays(pbatch))
    jbm = JBatchedMastic(jm.MasticSum(BITS, 7))
    jengine = JEngine(jbm, width=WIDTH)
    (jext, jconv) = jbm.vidpf.roundkeys(CTX, jbatch.nonces)
    jcarries = [jengine.init_carry(REPORTS, jbatch.keys[:, a], a)
                for a in range(2)]
    tbm = tm.BatchedMastic(mastic)
    tengine = IncrementalMastic(tbm, WIDTH)
    (text, tconv) = tbm.vidpf.roundkeys(CTX, pbatch.nonces)
    tcarries = [tengine.init_carry(REPORTS, pbatch.keys[:, a], a)
                for a in range(2)]
    rounds = jax.jit(lambda c0, c1, r: tuple(
        jengine.agg_round(agg, VK, CTX, c, r, jext, jconv, jbatch.cws)
        for (agg, c) in ((0, c0), (1, c1))))
    layouts: list = []
    for (level, prefixes) in enumerate(FRONTIERS):
        jplan = JRoundPlan(tuple(prefixes), level, BITS, WIDTH, layouts)
        tplan = RoundPlan(tuple(prefixes), level, BITS, WIDTH, layouts)
        jouts = rounds(jcarries[0], jcarries[1], j_round_inputs(jplan))
        touts = tengine.agg_rounds((0, 1), VK, CTX, tuple(tcarries),
                                   round_inputs(tplan, "cpu"), text, tconv,
                                   pbatch.cws)
        for a in range(2):
            (jcarries[a], jproof, jout, jok) = jouts[a]
            (tcarries[a], tproof, tout, tok) = touts[a]
            want = j_carry_to_arrays(jcarries[a])
            got = convert.carry_to_arrays(tcarries[a])
            for key in ("w", "proof", "seed", "ctrl"):
                assert np.array_equal(got[key], want[key]), (level, a, key)
            assert np.array_equal(tproof.numpy(), np.asarray(jproof))
            assert np.array_equal(convert.to_numpy(tout, words=True),
                                  np.asarray(jout)), (level, a)
            assert bool(tok.all()) and np.array_equal(tok.numpy(),
                                                      np.asarray(jok))
        assert torch.equal(touts[0][1], touts[1][1])
        rows = len(prefixes) * (1 + mastic.valid.OUTPUT_LEN)
        assert touts[0][2].shape[1] >= rows
        layouts.append(jplan.layout_new)


def test_sum_heavy_hitters_match_jax(port_batch, monkeypatch):
    """compute_heavy_hitters(MasticSum(4, 7), ...) and every level's
    weighted counts equal the JAX package's HeavyHittersRun over the
    same batch (its next-level compile-ahead switched off: it only
    costs compile time here)."""
    monkeypatch.setenv("MASTIC_PIPELINE", "0")
    (mastic, pbatch, pok) = port_batch
    assert bool(pok.all())
    thresholds = {"default": 25}
    jrun = JRun(jm.MasticSum(BITS, 7), CTX, thresholds, None, verify_key=VK,
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
    trun = HeavyHittersRun(mastic, CTX, thresholds, VK, pbatch, device="cpu")
    while trun.step():
        pass
    assert trun.level_results == jlevels
    assert trun.result() == jrun.result()
    assert len(trun.result()) == 4
    assert not trun.excluded().any()
    assert compute_heavy_hitters(mastic, CTX, thresholds, VK, pbatch,
                                 device="cpu") == jrun.result()
