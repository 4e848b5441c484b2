"""Differential tests: the PyTorch port's protocol layers against the
JAX package on the same numpy inputs, compared exactly (tolerance
zero): the Count FLP, batched client sharding, the level step (the
plain version of kernel K3) and consecutive incremental rounds.  The
whole collection is in test_torch_collection.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastic_tpu.backend.incremental import IncrementalMastic as JEngine
from mastic_tpu.backend.incremental import RoundPlan as JRoundPlan
from mastic_tpu.backend.incremental import carry_to_arrays as j_carry_to_arrays
from mastic_tpu.backend.incremental import round_inputs as j_round_inputs
from mastic_tpu.backend.incremental import _prefix_len, _prefixed
from mastic_tpu.ops.field_jax import FIELD64 as JFIELD64
from mastic_tpu.ops.keccak_jax import turbo_shake128_dynamic as j_sponge
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.backend.vidpf_jax import BatchedVidpf as JBatchedVidpf
from mastic_tpu.backend.vidpf_jax import EvalState as JEvalState
from mastic_tpu.mastic import MasticCount as JMasticCount
from mastic_tpu_torch import convert
from mastic_tpu_torch.backend.incremental import IncrementalMastic
from mastic_tpu_torch.backend.incremental import RoundPlan, round_inputs
from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
from mastic_tpu_torch.backend.vidpf import BatchedVidpf, EvalState
from mastic_tpu_torch.ops.binder import binder_checks
from mastic_tpu_torch.ops import level
from mastic_tpu_torch.ops.level import level_step
from mastic_tpu_torch.backend.xof import ts_prefix
from mastic_tpu_torch.scalar.dst import (USAGE_NODE_PROOF,
                                         USAGE_ONEHOT_CHECK,
                                         USAGE_PAYLOAD_CHECK, dst, dst_alg)

CTX = b"torch port test"
VK = bytes(range(32))
BITS = 4
REPORTS = 64


def _measurements(seed: int = 0) -> list:
    """Planted strings with repeats (heavy hitters at threshold 5) plus
    uniform ones."""
    rng = np.random.default_rng(seed)
    planted = [int(x) for x in rng.integers(0, 2 ** BITS, 4)]
    values = [planted[i % 4] for i in range(40)] + \
        [int(x) for x in rng.integers(0, 2 ** BITS, REPORTS - 40)]
    return [(tuple(bool((v >> (BITS - 1 - i)) & 1) for i in range(BITS)),
             int(rng.integers(0, 2)) if i % 9 == 0 else 1)
            for (i, v) in enumerate(values)]


def _np_inputs(bm: JBatchedMastic, seed: int = 0) -> tuple:
    rng = np.random.default_rng(seed + 100)
    (alphas, betas) = bm.encode_measurements(_measurements(seed))
    nonces = rng.integers(0, 256, (REPORTS, 16), dtype=np.uint8)
    rand = rng.integers(0, 256, (REPORTS, bm.m.RAND_SIZE), dtype=np.uint8)
    return (alphas, betas, nonces, rand)


@pytest.fixture(scope="module")
def sharded():
    """Both packages shard the same inputs: (jax batch, jax ok, port
    batch, port ok)."""
    jbm = JBatchedMastic(JMasticCount(BITS))
    (alphas, betas, nonces, rand) = _np_inputs(jbm)
    (jbatch, jok) = jax.jit(
        lambda a, b, n, r: jbm.shard_device(CTX, a, b, n, r))(
        jnp.asarray(alphas), jnp.asarray(betas), jnp.asarray(nonces),
        jnp.asarray(rand))
    pbm = BatchedMastic(MasticCount(BITS))
    (palphas, pbetas) = pbm.encode_measurements(_measurements(), "cpu")
    assert np.array_equal(palphas.numpy(), alphas)
    assert np.array_equal(pbetas.numpy(), betas)
    (pbatch, pok) = pbm.shard_device(CTX, palphas, pbetas,
                                     torch.from_numpy(nonces),
                                     torch.from_numpy(rand))
    return (jbatch, jok, pbatch, pok)


# -- FLP --------------------------------------------------------------

def _limbs(rng, shape) -> np.ndarray:
    p = 2 ** 64 - 2 ** 32 + 1
    vals = [int(x) % p for x in rng.integers(0, 2 ** 63, int(np.prod(shape)))]
    out = np.array([[(v >> (16 * i)) & 0xFFFF for i in range(4)]
                    for v in vals], np.uint32)
    return out.reshape(shape + (4,))


def test_count_flp_prove_query_decide_match_jax():
    jflp = JBatchedMastic(JMasticCount(4)).bflp
    tflp = BatchedMastic(MasticCount(4)).bflp
    rng = np.random.default_rng(3)
    meas = np.zeros((8, 1, 4), np.uint32)
    meas[::2, 0, 0] = 1
    meas[3] = _limbs(rng, (1,))      # an invalid measurement
    prove_rand = _limbs(rng, (8, 2))
    query_rand = _limbs(rng, (8, 1))
    t = convert.to_tensor
    jproof = jax.jit(lambda m, r: jflp.prove(m, r, None))(
        jnp.asarray(meas), jnp.asarray(prove_rand))
    tproof = tflp.prove(t(meas, "cpu"), t(prove_rand, "cpu"), None)
    assert np.array_equal(tproof.numpy(), np.asarray(jproof))
    (jver, jok) = jax.jit(lambda m, p, q: jflp.query(m, p, q, None, 1))(
        jnp.asarray(meas), jproof, jnp.asarray(query_rand))
    (tver, tok) = tflp.query(t(meas, "cpu"), tproof, t(query_rand, "cpu"),
                             None, 1)
    assert np.array_equal(tver.numpy(), np.asarray(jver))
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    jdec = jax.jit(jflp.decide)(jver)
    tdec = tflp.decide(tver)
    assert np.array_equal(tdec.numpy(), np.asarray(jdec))
    assert tdec.numpy().tolist() == [i != 3 for i in range(8)]


# -- client sharding ---------------------------------------------------

@pytest.mark.parametrize("field", ["nonces", "cws_seed", "cws_ctrl",
                                   "cws_w", "cws_proof", "keys",
                                   "leader_proofs", "helper_seeds", "ok"])
def test_shard_device_matches_jax(sharded, field):
    (jbatch, jok, pbatch, pok) = sharded
    if field == "ok":
        assert np.array_equal(pok.numpy(), np.asarray(jok))
        return
    want = {"nonces": jbatch.nonces, "cws_seed": jbatch.cws.seed,
            "cws_ctrl": jbatch.cws.ctrl, "cws_w": jbatch.cws.w,
            "cws_proof": jbatch.cws.proof, "keys": jbatch.keys,
            "leader_proofs": jbatch.leader_proofs,
            "helper_seeds": jbatch.helper_seeds}[field]
    got = convert.report_batch_to_arrays(pbatch)[field]
    assert got.dtype == np.asarray(want).dtype
    assert np.array_equal(got, np.asarray(want))


def test_report_batch_round_trips_through_convert(sharded):
    (jbatch, _jok, pbatch, _pok) = sharded
    arrays = {"nonces": jbatch.nonces, "cws_seed": jbatch.cws.seed,
              "cws_ctrl": jbatch.cws.ctrl, "cws_w": jbatch.cws.w,
              "cws_proof": jbatch.cws.proof, "keys": jbatch.keys,
              "leader_proofs": jbatch.leader_proofs,
              "helper_seeds": jbatch.helper_seeds}
    back = convert.report_batch_from_arrays(
        {k: np.asarray(v) for (k, v) in arrays.items()}, "cpu")
    for (a, b) in zip(convert.report_batch_to_arrays(back).values(),
                      convert.report_batch_to_arrays(pbatch).values()):
        assert np.array_equal(a, b)


# -- K3: the level step ------------------------------------------------

def _level_inputs(num_reports: int, num_parents: int, seed: int) -> tuple:
    """Random parent state, correction-word slice and node binder for
    one level step (the pattern of tests/test_ops_level_pallas.py)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (num_reports, 16), np.uint8),
            rng.integers(0, 256, (num_reports, num_parents, 16), np.uint8),
            rng.integers(0, 2, (num_reports, num_parents)).astype(bool),
            (rng.integers(0, 256, (num_reports, 16), np.uint8),
             rng.integers(0, 2, (num_reports, 2)).astype(bool),
             rng.integers(0, 1 << 16, (num_reports, 2, 4), dtype=np.uint32),
             rng.integers(0, 256, (num_reports, 32), np.uint8)),
            rng.integers(0, 256, (2 * num_parents, 4 + (BITS + 7) // 8),
                         np.uint8))


@pytest.mark.parametrize("num_reports,num_parents", [(64, 4), (40, 3)])
def test_level_step_matches_eval_step(num_reports, num_parents):
    """The plain K3 against vidpf_jax.eval_step (the full binder row),
    also with a report count off the 32-packing."""
    (nonces, pseed, pctrl, cw, binder) = _level_inputs(
        num_reports, num_parents, num_reports)
    jvid = JBatchedVidpf(JMasticCount(BITS).field, BITS, 2)
    (jext, jconv) = jvid.roundkeys(CTX, jnp.asarray(nonces))
    parents = JEvalState(
        seed=jnp.asarray(pseed), ctrl=jnp.asarray(pctrl),
        w=jnp.zeros((num_reports, num_parents, 2, 4), jnp.uint32),
        proof=jnp.zeros((num_reports, num_parents, 32), jnp.uint8))
    (jchild, jok) = jax.jit(
        lambda e, c, par, cws: jvid.eval_step(e, c, par, cws, CTX, binder))(
        jext, jconv, parents, tuple(jnp.asarray(x) for x in cw))
    tvid = BatchedVidpf(BITS, 2)
    (text, tconv) = tvid.roundkeys(CTX, torch.from_numpy(nonces))
    assert np.array_equal(text.numpy(), np.asarray(jext))
    tcw = tuple(convert.to_tensor(x, "cpu") for x in cw)
    prefix = ts_prefix(dst(CTX, USAGE_NODE_PROOF), 16)
    (next_seed, ct, w, ok, proof) = level_step(
        tvid.spec, tvid.convert_blocks, tvid.VALUE_LEN, text, tconv,
        torch.from_numpy(pseed), torch.from_numpy(pctrl), tcw, prefix,
        torch.from_numpy(binder), binder.shape[-1])
    for (got, want) in zip((next_seed, ct, w, proof), jchild):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(torch.all(ok, dim=-1).numpy(), np.asarray(jok))


def test_level_step_matches_eval_step_dynamic():
    """The plain K3 with a runtime binder length against
    IncrementalMastic._eval_step_dynamic, live-parent lane mask
    included."""
    (nonces, pseed, pctrl, cw, binder) = _level_inputs(64, 4, 7)
    jbm = JBatchedMastic(JMasticCount(BITS))
    engine = JEngine(jbm, width=8)
    plan = JRoundPlan([(True, False), (True, True), (False, True),
                       (False, False)][:3], 1, BITS, 8, [[(False,), (True,)]])
    rnd = j_round_inputs(plan)
    (jext, jconv) = jbm.vidpf.roundkeys(CTX, jnp.asarray(nonces))
    parents = JEvalState(
        seed=jnp.asarray(pseed), ctrl=jnp.asarray(pctrl),
        w=jnp.zeros((64, 4, 2, 4), jnp.uint32),
        proof=jnp.zeros((64, 4, 32), jnp.uint8))
    (jchild, jok) = jax.jit(
        lambda e, c, par, cws, r: engine._eval_step_dynamic(
            e, c, par, cws, CTX, r))(
        jext, jconv, parents, tuple(jnp.asarray(x) for x in cw), rnd)

    tbm = BatchedMastic(MasticCount(BITS))
    tplan = RoundPlan([(True, False), (True, True), (False, True)], 1, BITS,
                      8, [[(False,), (True,)]])
    trnd = round_inputs(tplan, "cpu")
    assert np.array_equal(trnd.node_binder.numpy(), np.asarray(rnd.node_binder))
    (text, tconv) = tbm.vidpf.roundkeys(CTX, torch.from_numpy(nonces))
    tengine = IncrementalMastic(tbm, 8)
    (tchild, tok) = tengine._eval_step_dynamic(
        text, tconv, EvalState(torch.from_numpy(pseed),
                               torch.from_numpy(pctrl), None, None),
        tuple(convert.to_tensor(x, "cpu") for x in cw), CTX, trnd)
    for (got, want) in zip(tchild, jchild):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(tok.numpy(), np.asarray(jok))

    # The same level through level_step directly, with a binder row
    # longer than binder_len: bytes past binder_len are ignored.
    prefix = ts_prefix(dst(CTX, USAGE_NODE_PROOF), 16)
    wide = torch.cat([trnd.node_binder,
                      torch.full((8, 5), 0xAB, dtype=torch.uint8)], dim=1)
    out = level_step(tbm.spec, 2, 2, text, tconv, torch.from_numpy(pseed),
                     torch.from_numpy(pctrl),
                     tuple(convert.to_tensor(x, "cpu") for x in cw), prefix,
                     wide, trnd.binder_len)
    assert np.array_equal(out[4].numpy(), np.asarray(jchild.proof))


@pytest.mark.parametrize("ctx", [CTX, bytes(range(150))],
                         ids=["one_block", "two_blocks"])
def test_node_proof_template_is_the_padded_message(ctx):
    """The per-node lanes K3's node-proof kernel absorbs: with a seed in
    the 16-byte hole they are the message the plain sponge pads
    (prefix | seed | binder, domain byte 1, final 0x80)."""
    rng = np.random.default_rng(len(ctx))
    prefix = ts_prefix(dst(ctx, USAGE_NODE_PROOF), 16)
    binder = torch.from_numpy(rng.integers(0, 256, (6, 9), np.uint8))
    seed = rng.integers(0, 256, 16, np.uint8)
    (lanes, nb) = level.node_proof_template(prefix, binder, 7)
    assert lanes.shape == (6, nb * 21)
    msg = lanes.numpy().view(np.uint8).copy()
    msg[:, len(prefix):len(prefix) + 16] ^= seed
    length = len(prefix) + 16 + 7
    assert nb == length // 168 + 1 == (2 if len(ctx) > 100 else 1)
    want = np.zeros((6, nb * 168), np.uint8)
    want[:, :length] = np.concatenate(
        [np.broadcast_to(np.frombuffer(prefix, np.uint8), (6, len(prefix))),
         np.broadcast_to(seed, (6, 16)), binder.numpy()[:, :7]], axis=1)
    want[:, length] ^= 1
    want[:, -1] ^= 0x80
    assert np.array_equal(msg, want)


# -- incremental rounds ------------------------------------------------

FRONTIERS = [
    [(False,), (True,)],
    [(False, True), (True, False), (True, True)],
    [(False, True, True), (True, False, False), (True, False, True)],
]


def _rounds_against_jax(sharded, ctx: bytes, frontiers: list) -> None:
    """Consecutive rounds of both aggregators, the port's against the
    JAX package's: carry, eval proof, out share and ok equal after
    each."""
    (jbatch, _jok, pbatch, _pok) = sharded
    jbm = JBatchedMastic(JMasticCount(BITS))
    jengine = JEngine(jbm, width=8)
    (jext, jconv) = jbm.vidpf.roundkeys(ctx, jbatch.nonces)
    jcarries = [jengine.init_carry(REPORTS, jbatch.keys[:, a], a)
                for a in range(2)]
    tbm = BatchedMastic(MasticCount(BITS))
    tengine = IncrementalMastic(tbm, 8)
    (text, tconv) = tbm.vidpf.roundkeys(ctx, pbatch.nonces)
    tcarries = [tengine.init_carry(REPORTS, pbatch.keys[:, a], a)
                for a in range(2)]
    layouts: list = []
    for (level, prefixes) in enumerate(frontiers):
        jplan = JRoundPlan(tuple(prefixes), level, BITS, 8, layouts)
        tplan = RoundPlan(tuple(prefixes), level, BITS, 8, layouts)
        jrnd = j_round_inputs(jplan)
        trnd = round_inputs(tplan, "cpu")
        jouts = jax.jit(lambda c0, c1, r: tuple(
            jengine.agg_round(agg, VK, ctx, c, r, jext, jconv, jbatch.cws)
            for (agg, c) in ((0, c0), (1, c1))))(jcarries[0], jcarries[1],
                                                 jrnd)
        for a in range(2):
            (jcarries[a], jproof, jout, jok) = jouts[a]
            (tcarries[a], tproof, tout, tok) = tengine.agg_round(
                a, VK, ctx, tcarries[a], trnd, text, tconv, pbatch.cws)
            want = j_carry_to_arrays(jcarries[a])
            got = convert.carry_to_arrays(tcarries[a])
            for key in ("w", "proof", "seed", "ctrl"):
                assert np.array_equal(got[key], want[key]), (level, a, key)
            assert np.array_equal(tproof.numpy(), np.asarray(jproof))
            assert np.array_equal(tout.numpy(), np.asarray(jout))
            assert np.array_equal(tok.numpy(), np.asarray(jok))
        layouts.append(jplan.layout_new)
    back = convert.carry_from_arrays(j_carry_to_arrays(jcarries[1]),
                                     device="cpu")
    for (x, y) in zip(back, tcarries[1]):
        assert torch.equal(x, y)


def test_agg_round_matches_jax_over_rounds(sharded):
    """Three consecutive rounds of both aggregators."""
    _rounds_against_jax(sharded, CTX, FRONTIERS)


def test_agg_round_long_ctx_matches_jax(sharded):
    """A 150-byte ctx makes the node-proof message (11 + 150 bytes of
    prefix, 16 of seed, 5 of binder) longer than one rate block: the
    level step hashes it over two blocks, as the JAX package's XLA
    sponge does.  (The reports were sharded under CTX, so the
    aggregators disagree; both packages must still give the same
    bytes.)"""
    ctx = bytes(range(150))
    assert len(ts_prefix(dst(ctx, USAGE_NODE_PROOF), 16)) + 16 + 5 > 167
    _rounds_against_jax(sharded, ctx, FRONTIERS[:2])


# -- K1's binder sponge: the eval proof's onehot and payload checks ------

def _carried_tree(rng, width: int) -> tuple:
    """A carried tree of random payloads, a third of them 64-bit values
    at or above p (stored where the in-range mask failed), and random
    node proofs: (w (R, BITS, W, 2, 4) uint32 limbs, proof uint8)."""
    p = JFIELD64.modulus
    shape = (REPORTS, BITS, width, 2)
    vals = rng.integers(0, 2 ** 64, shape, dtype=np.uint64)
    edge = np.array([p, p + 1, 2 ** 64 - 1, p - 1, 0], dtype=np.uint64)
    high = rng.random(shape) < 0.3
    vals[high] = edge[rng.integers(0, len(edge), int(high.sum()))]
    w = np.stack([(vals >> np.uint64(16 * i)) & np.uint64(0xFFFF)
                  for i in range(4)], -1).astype(np.uint32)
    proof = rng.integers(0, 256, (REPORTS, BITS, width, 32), np.uint8)
    return (w, proof)


@pytest.mark.parametrize("ctx", [b"x" * 17, b"x" * 20],
                         ids=["prefix32", "prefix35"])
def test_binder_checks_match_jax_eval_proof(ctx):
    """The binder sponge's plain version against the JAX package's
    payload and onehot checks (mastic_tpu/backend/incremental.py
    _eval_proof) at level 3 of a real RoundPlan, over a carry holding
    values >= p; with a prefix length that is a multiple of 8 (32) and
    one that is not (35).  Then the whole eval proof of both
    aggregators, port against JAX."""
    width = 8
    plans = []
    layouts: list = []
    for (level, prefixes) in enumerate(FRONTIERS + [[
            (False, True, True, False), (True, False, False, True),
            (True, False, True, True)]]):
        plans.append((JRoundPlan(tuple(prefixes), level, BITS, width,
                                 layouts),
                      RoundPlan(tuple(prefixes), level, BITS, width,
                                layouts)))
        layouts.append(plans[-1][0].layout_new)
    (jplan, tplan) = plans[-1]
    jrnd = j_round_inputs(jplan)
    trnd = round_inputs(tplan, "cpu")
    rng = np.random.default_rng(len(ctx))
    trees = [_carried_tree(rng, width) for _ in range(2)]
    tbm = BatchedMastic(MasticCount(BITS))
    (onehot, payload) = binder_checks(
        tbm.spec, tuple(convert.to_tensor(w, "cpu") for (w, _p) in trees),
        tuple(torch.from_numpy(p) for (_w, p) in trees), trnd.onehot_idx,
        trnd.payload_parent, trnd.payload_left, trnd.payload_right,
        ts_prefix(dst_alg(ctx, USAGE_ONEHOT_CHECK, tbm.m.ID), 0),
        ts_prefix(dst_alg(ctx, USAGE_PAYLOAD_CHECK, tbm.m.ID), 0))
    assert len(ts_prefix(dst_alg(ctx, USAGE_ONEHOT_CHECK, tbm.m.ID), 0)) \
        == 15 + len(ctx)

    jbm = JBatchedMastic(JMasticCount(BITS))
    jengine = JEngine(jbm, width=width)
    tengine = IncrementalMastic(tbm, width)
    for (a, (w, proof)) in enumerate(trees):
        # The JAX package's two checks, as its _eval_proof computes them.
        w_flat = jnp.asarray(w).reshape(REPORTS, BITS * width, 2, 4)
        diff = JFIELD64.sub(w_flat[:, jrnd.payload_parent],
                            JFIELD64.add(w_flat[:, jrnd.payload_left],
                                         w_flat[:, jrnd.payload_right]))
        binder = JFIELD64.plain_to_le_bytes(diff).reshape(REPORTS, -1)
        want = j_sponge(
            _prefixed(binder, ctx, USAGE_PAYLOAD_CHECK, jbm.m.ID),
            _prefix_len(ctx, USAGE_PAYLOAD_CHECK, jbm.m.ID)
            + jplan.payload_rows * 16, 1, 32)
        assert np.array_equal(payload[a].numpy(), np.asarray(want))
        rows = jnp.asarray(proof).reshape(REPORTS, BITS * width, 32)
        binder = rows[:, jrnd.onehot_idx].reshape(REPORTS, -1)
        want = j_sponge(
            _prefixed(binder, ctx, USAGE_ONEHOT_CHECK, jbm.m.ID),
            _prefix_len(ctx, USAGE_ONEHOT_CHECK, jbm.m.ID)
            + jplan.onehot_rows * 32, 1, 32)
        assert np.array_equal(onehot[a].numpy(), np.asarray(want))

        want = jengine._eval_proof(a, VK, ctx, jnp.asarray(w),
                                   jnp.asarray(proof), jrnd)
        got = tengine._eval_proof(a, VK, ctx, convert.to_tensor(w, "cpu"),
                                  torch.from_numpy(proof), trnd)
        assert np.array_equal(got.numpy(), np.asarray(want))
