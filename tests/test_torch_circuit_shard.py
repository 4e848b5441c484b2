"""Differential tests of the port's batched client sharding for the four
circuits beyond Count, and of MasticHistogram's incremental rounds,
against the JAX package on the same numpy inputs, compared exactly
(tolerance zero).

Sharding: correction words, keys, leader proof shares, helper seeds,
and for the joint-rand circuits (SumVec, Histogram, MultihotCountVec
over Field128) the leader seeds and both aggregators' peer joint-rand
parts, which the client derives from the depth-0 beta shares
(`get_beta_share`, one level step from the root keys).  One JAX compile
per circuit.  Rounds: every level of both aggregators' `agg_round` on
Field128 carries with OUTPUT_LEN 4 (MasticSum's rounds are held in
test_torch_sum_collection.py)."""

from types import SimpleNamespace

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
from mastic_tpu_torch import convert
from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.backend.incremental import (IncrementalMastic,
                                                  RoundPlan, round_inputs)

CTX = b"torch port shard"
VK = bytes(range(128, 160))
BITS = 4
REPORTS = 64
WIDTH = 8

CIRCUITS = {
    "sum": (lambda: jm.MasticSum(BITS, 7), lambda: tm.MasticSum(BITS, 7),
            lambda rng: int(rng.integers(0, 8))),
    "sumvec": (lambda: jm.MasticSumVec(BITS, 3, 2, 2),
               lambda: tm.MasticSumVec(BITS, 3, 2, 2),
               lambda rng: [int(x) for x in rng.integers(0, 4, 3)]),
    "histogram": (lambda: jm.MasticHistogram(BITS, 4, 2),
                  lambda: tm.MasticHistogram(BITS, 4, 2),
                  lambda rng: int(rng.integers(0, 4))),
    "multihot": (lambda: jm.MasticMultihotCountVec(BITS, 4, 2, 2),
                 lambda: tm.MasticMultihotCountVec(BITS, 4, 2, 2),
                 lambda rng: [bool(x) for x in
                              rng.permutation(4) < int(rng.integers(0, 3))]),
}


@pytest.fixture(scope="module")
def circuits():
    """One JAX and one port instantiation of each circuit per module,
    its measurements and client randomness from a numpy seed, and the
    port's sharded batch of them, each built at first use."""
    built = {}

    def get(name: str) -> SimpleNamespace:
        if name not in built:
            (make_j, make_t, meas_of) = CIRCUITS[name]
            (jbm, tbm) = (JBatchedMastic(make_j()), tm.BatchedMastic(make_t()))
            rng = np.random.default_rng(len(name))
            meas = [(tuple(bool(b) for b in rng.integers(0, 2, BITS)),
                     meas_of(rng)) for _ in range(REPORTS)]
            nonces = rng.integers(0, 256, (REPORTS, 16), dtype=np.uint8)
            rand = rng.integers(0, 256, (REPORTS, tbm.m.RAND_SIZE),
                                dtype=np.uint8)
            (alphas, betas) = tbm.encode_measurements(meas, "cpu")
            (batch, ok) = tbm.shard_device(CTX, alphas, betas,
                                           torch.from_numpy(nonces),
                                           torch.from_numpy(rand))
            built[name] = SimpleNamespace(
                jbm=jbm, tbm=tbm, meas=meas, nonces=nonces, rand=rand,
                alphas=alphas, betas=betas, batch=batch, ok=ok)
        return built[name]
    return get


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_shard_device_matches_jax(circuits, name):
    c = circuits(name)
    (jbm, tbm) = (c.jbm, c.tbm)
    assert tbm.m.RAND_SIZE == jbm.m.RAND_SIZE
    assert tbm.m.value_len == jbm.m.vidpf.VALUE_LEN
    (alphas, betas) = jbm.encode_measurements(c.meas)
    assert np.array_equal(c.alphas.numpy(), alphas)
    assert np.array_equal(convert.to_numpy(c.betas, words=True), betas)
    (jb, jok) = jax.jit(lambda a, b, n, r: jbm.shard_device(CTX, a, b, n, r))(
        jnp.asarray(alphas), jnp.asarray(betas), jnp.asarray(c.nonces),
        jnp.asarray(c.rand))
    (tb, tok) = (c.batch, c.ok)
    want = {"nonces": jb.nonces, "cws_seed": jb.cws.seed,
            "cws_ctrl": jb.cws.ctrl, "cws_w": jb.cws.w,
            "cws_proof": jb.cws.proof, "keys": jb.keys,
            "leader_proofs": jb.leader_proofs,
            "helper_seeds": jb.helper_seeds}
    if jb.leader_seeds is not None:
        want.update(leader_seeds=jb.leader_seeds, peer_part0=jb.peer_parts[0],
                    peer_part1=jb.peer_parts[1])
    got = convert.report_batch_to_arrays(tb)
    assert set(got) == set(want)
    assert ("leader_seeds" in got) == (tbm.m.valid.JOINT_RAND_LEN > 0)
    for key in want:
        assert got[key].dtype == np.asarray(want[key]).dtype, key
        assert np.array_equal(got[key], np.asarray(want[key])), key
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert bool(tok.all())
    back = convert.report_batch_from_arrays(got, "cpu")
    for (key, value) in convert.report_batch_to_arrays(back).items():
        assert np.array_equal(value, got[key]), key


FRONTIERS = [
    [(False,), (True,)],
    [(False, True), (True, False), (True, True)],
    [(False, True, True), (True, False, False), (True, False, True)],
    [(False, True, True, False), (True, False, False, True),
     (True, False, True, False), (True, False, True, True)],
]


def test_histogram_agg_round_matches_jax_at_every_level(circuits):
    """All BITS levels of both aggregators' MasticHistogram rounds from
    the port's batch handed to JAX through `convert` (joint-rand fields
    included): carry (Field128 limbs), eval proof, out share (counter +
    4 buckets per prefix) and ok equal after each."""
    c = circuits("histogram")
    (jbm, tbm, pbatch) = (c.jbm, c.tbm, c.batch)
    assert bool(c.ok.all())
    a = {k: jnp.asarray(v)
         for (k, v) in convert.report_batch_to_arrays(pbatch).items()}
    jbatch = JReportBatch(
        nonces=a["nonces"],
        cws=JCws(seed=a["cws_seed"], ctrl=a["cws_ctrl"], w=a["cws_w"],
                 proof=a["cws_proof"]),
        keys=a["keys"], leader_proofs=a["leader_proofs"],
        helper_seeds=a["helper_seeds"], leader_seeds=a["leader_seeds"],
        peer_parts=(a["peer_part0"], a["peer_part1"]))
    jengine = JEngine(jbm, width=WIDTH)
    (jext, jconv) = jbm.vidpf.roundkeys(CTX, jbatch.nonces)
    jcarries = [jengine.init_carry(REPORTS, jbatch.keys[:, i], i)
                for i in range(2)]
    tengine = IncrementalMastic(tbm, WIDTH)
    (text, tconv) = tbm.vidpf.roundkeys(CTX, pbatch.nonces)
    tcarries = [tengine.init_carry(REPORTS, pbatch.keys[:, i], i)
                for i in range(2)]
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
        for i in range(2):
            (jcarries[i], jproof, jout, jok) = jouts[i]
            (tcarries[i], tproof, tout, tok) = touts[i]
            want = j_carry_to_arrays(jcarries[i])
            got = convert.carry_to_arrays(tcarries[i])
            for key in ("w", "proof", "seed", "ctrl"):
                assert np.array_equal(got[key], want[key]), (level, i, key)
            assert np.array_equal(tproof.numpy(), np.asarray(jproof))
            assert np.array_equal(convert.to_numpy(tout, words=True),
                                  np.asarray(jout)), (level, i)
            assert bool(tok.all()) and np.array_equal(tok.numpy(),
                                                      np.asarray(jok))
        assert torch.equal(touts[0][1], touts[1][1])
        layouts.append(jplan.layout_new)
