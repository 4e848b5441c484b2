"""Differential tests of the port's Field128 arithmetic and the five
FLP circuits against the JAX package, on the same numpy inputs,
compared exactly (tolerance zero): the Field128 limb ops and NTT,
`sample_vec` on 16-byte elements, batched prove / query / decide for
all five circuits, the level step (K3's plain version) on Field128 and
on more than 8 convert blocks, the binder sponge's plain version on a
Field128 carry, the depth-0 beta share and the FLP weight check with
its joint-rand confirmation.  Client sharding is held against the JAX
package in test_torch_circuit_shard.py, the incremental rounds and the
MasticSum collection in test_torch_sum_collection.py."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastic_tpu import mastic as jm
from mastic_tpu.backend.incremental import IncrementalMastic as JEngine
from mastic_tpu.backend.incremental import RoundPlan as JRoundPlan
from mastic_tpu.backend.incremental import round_inputs as j_round_inputs
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.backend.mastic_jax import ReportBatch as JReportBatch
from mastic_tpu.backend.vidpf_jax import BatchedCorrectionWords as JCws
from mastic_tpu.backend.vidpf_jax import BatchedVidpf as JBatchedVidpf
from mastic_tpu.backend.vidpf_jax import EvalState as JEvalState
from mastic_tpu.backend.xof_jax import sample_vec as j_sample_vec
from mastic_tpu.field import Field64 as JField64
from mastic_tpu.field import Field128 as JField128
from mastic_tpu.ops.field_jax import FIELD128 as JFIELD128
from mastic_tpu.ops.ntt_jax import ntt_plan as j_ntt_plan
from mastic_tpu_torch import convert
from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.backend.incremental import IncrementalMastic
from mastic_tpu_torch.backend.incremental import RoundPlan, round_inputs
from mastic_tpu_torch.backend.vidpf import BatchedVidpf
from mastic_tpu_torch.backend.xof import sample_vec, ts_prefix
from mastic_tpu_torch.scalar.dst import (USAGE_NODE_PROOF,
                                         USAGE_ONEHOT_CHECK,
                                         USAGE_PAYLOAD_CHECK, dst, dst_alg)
from mastic_tpu_torch.ops.binder import binder_checks
from mastic_tpu_torch.ops.field import FIELD64, FIELD128
from mastic_tpu_torch.ops.level import level_step
from mastic_tpu_torch.ops.ntt import ntt_plan

CTX = b"torch port circuits"
VK = bytes(range(64, 96))
BITS = 4
REPORTS = 64
P128 = FIELD128.modulus

# name: (JAX instantiation, port instantiation, measurement from a rng)
CIRCUITS = {
    "count": (lambda: jm.MasticCount(BITS), lambda: tm.MasticCount(BITS),
              lambda rng: int(rng.integers(0, 2))),
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
JR_CIRCUITS = ("sumvec", "histogram", "multihot")


@pytest.fixture(scope="module")
def circuits():
    """One JAX and one port instantiation of each circuit per module,
    and the port's sharded batch of it, each built at first use."""
    built = {}

    def get(name: str) -> SimpleNamespace:
        if name not in built:
            (make_j, make_t, meas_of) = CIRCUITS[name]
            mastic = make_t()
            built[name] = SimpleNamespace(
                jbm=JBatchedMastic(make_j()), mastic=mastic,
                tbm=tm.BatchedMastic(mastic), meas_of=meas_of, batch=None)
        return built[name]
    return get


def _to_limbs(spec, values) -> np.ndarray:
    """Ints -> (..., n) uint32 limbs."""
    values = np.asarray(values, object)
    out = np.zeros(values.shape + (spec.num_limbs,), np.uint32)
    for idx in np.ndindex(values.shape):
        out[idx] = spec.int_to_limbs(int(values[idx]))
    return out


def _rand_ints(rng, modulus: int, shape, above: bool = False) -> np.ndarray:
    """Uniform ints below `modulus`, or, with `above`, a third of them
    128-bit values at or above it."""
    bits = modulus.bit_length()
    count = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(bits // 8 + 1), "little") % modulus
            for _ in range(count)]
    if above:
        edge = [modulus, modulus + 1, 2 ** bits - 1, modulus - 1, 0]
        for i in range(0, count, 3):
            vals[i] = edge[(i // 3) % len(edge)]
    return np.array(vals, object).reshape(shape)


def _t(arr) -> torch.Tensor:
    return convert.to_tensor(arr, "cpu")


def _same(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = convert.to_numpy(got, words=want.dtype == np.uint32)
    return got.dtype == want.dtype and np.array_equal(got, want)


# -- Field128 limb arithmetic and NTT ----------------------------------

@pytest.mark.parametrize("op", ["add", "sub", "neg", "mul", "to_mont",
                                "from_mont", "le_bytes"])
def test_field128_ops_match_jax(op):
    """FieldSpec at n = 8 against the JAX package's, on random limbs of
    which a third are values >= p (and 2^128 - 1)."""
    rng = np.random.default_rng(len(op))
    a = _to_limbs(FIELD128, _rand_ints(rng, P128, (6, 40), above=True))
    b = _to_limbs(FIELD128, _rand_ints(rng, P128, (6, 40), above=True))
    if op == "le_bytes":
        data = rng.integers(0, 256, (200, 16), dtype=np.uint8)
        data[::5] = 0xFF                       # 2^128 - 1
        data[1::5] = np.frombuffer(P128.to_bytes(16, "little"), np.uint8)
        (want, wmask) = jax.jit(JFIELD128.limbs_from_le_bytes)(data)
        (got, mask) = FIELD128.limbs_from_le_bytes(torch.from_numpy(data))
        assert _same(got, want)
        assert np.array_equal(mask.numpy(), np.asarray(wmask))
        assert not mask.numpy()[::5].any() and not mask.numpy()[1::5].any()
        assert _same(FIELD128.plain_to_le_bytes(_t(a)),
                     jax.jit(JFIELD128.plain_to_le_bytes)(a))
        return
    jfn = {"add": JFIELD128.add, "sub": JFIELD128.sub, "mul": JFIELD128.mul,
           "neg": lambda x, _y: JFIELD128.neg(x),
           "to_mont": lambda x, _y: JFIELD128.to_mont(x),
           "from_mont": lambda x, _y: JFIELD128.from_mont(x)}[op]
    tfn = {"add": FIELD128.add, "sub": FIELD128.sub, "mul": FIELD128.mul,
           "neg": lambda x, _y: FIELD128.neg(x),
           "to_mont": lambda x, _y: FIELD128.to_mont(x),
           "from_mont": lambda x, _y: FIELD128.from_mont(x)}[op]
    want = jax.jit(jfn)(jnp.asarray(a), jnp.asarray(b))
    assert _same(tfn(_t(a), _t(b)), want)


@pytest.mark.parametrize("size", [2, 8, 128])
def test_field128_ntt_matches_jax(size):
    """The forward and inverse NTT at Field128 (the generator derived
    as the scalar field derives it) at the FLP's sizes: 2p = 8 for the
    chunked circuits of these tests, 2p = 128 for SumVec(1024) with
    32-element chunks."""
    rng = np.random.default_rng(size)
    x = FIELD128.to_mont(_t(_to_limbs(FIELD128, _rand_ints(rng, P128,
                                                            (3, size)))))
    xj = jnp.asarray(convert.to_numpy(x, words=True))
    plans = [ntt_plan(FIELD128, size, inverse) for inverse in (False, True)]
    want = jax.jit(lambda v: tuple(j_ntt_plan(JFIELD128, size, inverse)(v)
                                   for inverse in (False, True)))(xj)
    for (plan, w) in zip(plans, want):
        assert _same(plan(x), w)
    assert torch.equal(plans[1](plans[0](x)), x)


def test_sample_vec_field128_matches_jax():
    """Rejection-sampling reads of 16-byte elements, with streams that
    hold values >= p."""
    rng = np.random.default_rng(5)
    stream = rng.integers(0, 256, (32, 7 + 5 * 16), dtype=np.uint8)
    stream[::4, 7 + 16:7 + 32] = 0xFF
    (want, wok) = jax.jit(lambda s: j_sample_vec(JFIELD128, s, 5, 7))(stream)
    (got, ok) = sample_vec(FIELD128, torch.from_numpy(stream), 5, 7)
    assert _same(got, want)
    assert np.array_equal(ok.numpy(), np.asarray(wok))
    assert not ok.numpy()[::4].any()


# -- the batched FLP ---------------------------------------------------

@pytest.mark.parametrize("name", list(CIRCUITS))
def test_flp_prove_query_decide_match_jax(circuits, name):
    """prove, query (over the whole measurement: one share) and decide,
    port against JAX, on valid encodings and on one invalid
    measurement; decide accepts exactly the valid ones.  The two-share
    query is held against JAX in test_weight_check_matches_jax."""
    c = circuits(name)
    (jflp, tflp, mastic, meas_of) = (c.jbm.bflp, c.tbm.bflp, c.mastic,
                                     c.meas_of)
    valid = mastic.valid
    modulus = mastic.field.MODULUS
    spec = tflp.spec
    rng = np.random.default_rng(len(name))
    num = 6
    meas = [valid.encode(meas_of(rng)) for _ in range(num)]
    meas[3] = [int(x) for x in _rand_ints(rng, modulus, (valid.MEAS_LEN,))]
    (meas, prove_rand, query_rand, joint_rand) = (
        _to_limbs(spec, x) for x in (
            meas, _rand_ints(rng, modulus, (num, valid.PROVE_RAND_LEN)),
            _rand_ints(rng, modulus, (num, valid.QUERY_RAND_LEN)),
            _rand_ints(rng, modulus, (num, valid.JOINT_RAND_LEN))))
    jr = joint_rand if valid.JOINT_RAND_LEN else None

    def jax_flow(m, pr, qr, jr_):
        proof = jflp.prove(m, pr, jr_)
        (verifier, ok) = jflp.query(m, proof, qr, jr_, 1)
        return (proof, verifier, ok, jflp.decide(verifier))

    want = jax.jit(jax_flow)(*(None if x is None else jnp.asarray(x)
                               for x in (meas, prove_rand, query_rand, jr)))
    tjr = None if jr is None else _t(jr)
    proof = tflp.prove(_t(meas), _t(prove_rand), tjr)
    (verifier, ok) = tflp.query(_t(meas), proof, _t(query_rand), tjr, 1)
    decision = tflp.decide(verifier)
    assert proof.shape[-2] == valid.PROOF_LEN
    assert verifier.shape[-2] == valid.VERIFIER_LEN
    for (got, w) in zip((proof, verifier, ok, decision), want):
        assert _same(got, w)
    assert decision.numpy().tolist() == [i != 3 for i in range(num)]


# -- K3's plain version on Field128 and long payloads --------------------

def _level_inputs(spec, value_len: int, num_parents: int, seed: int) -> tuple:
    """Random parent state, correction-word slice (w_cw values >= p
    included) and node binder for one level step."""
    rng = np.random.default_rng(seed)
    w_cw = _to_limbs(spec, _rand_ints(rng, spec.modulus,
                                      (REPORTS, value_len), above=True))
    return (rng.integers(0, 256, (REPORTS, 16), np.uint8),
            rng.integers(0, 256, (REPORTS, num_parents, 16), np.uint8),
            rng.integers(0, 2, (REPORTS, num_parents)).astype(bool),
            (rng.integers(0, 256, (REPORTS, 16), np.uint8),
             rng.integers(0, 2, (REPORTS, 2)).astype(bool), w_cw,
             rng.integers(0, 256, (REPORTS, 32), np.uint8)),
            rng.integers(0, 256, (2 * num_parents, 4 + (BITS + 7) // 8),
                         np.uint8))


@pytest.mark.parametrize("field,value_len", [
    ("f128", 9), ("f64", 17)], ids=["field128_10_blocks",
                                    "field64_odd_10_blocks"])
def test_level_step_long_payload_matches_eval_step(field, value_len):
    """level_step's plain version against vidpf_jax.eval_step with 10
    convert blocks: Field128 (VALUE_LEN 9), and Field64 with an odd
    VALUE_LEN (17, MasticSum(255)'s: the last block half used)."""
    (jfield, spec) = {"f128": (JField128, FIELD128),
                      "f64": (JField64, FIELD64)}[field]
    (nonces, pseed, pctrl, cw, binder) = _level_inputs(spec, value_len, 3,
                                                       value_len)
    jvid = JBatchedVidpf(jfield, BITS, value_len)
    tvid = BatchedVidpf(BITS, value_len, spec)
    assert tvid.convert_blocks == jvid.convert_blocks == 10
    (jext, jconv) = jvid.roundkeys(CTX, jnp.asarray(nonces))
    n = spec.num_limbs
    parents = JEvalState(
        seed=jnp.asarray(pseed), ctrl=jnp.asarray(pctrl),
        w=jnp.zeros((REPORTS, 3, value_len, n), jnp.uint32),
        proof=jnp.zeros((REPORTS, 3, 32), jnp.uint8))
    (jchild, jok) = jax.jit(
        lambda e, c, par, cws: jvid.eval_step(e, c, par, cws, CTX, binder))(
        jext, jconv, parents, tuple(jnp.asarray(x) for x in cw))
    (text, tconv) = tvid.roundkeys(CTX, torch.from_numpy(nonces))
    prefix = ts_prefix(dst(CTX, USAGE_NODE_PROOF), 16)
    (next_seed, ct, w, ok, proof) = level_step(
        spec, tvid.convert_blocks, value_len, text, tconv,
        torch.from_numpy(pseed), torch.from_numpy(pctrl),
        tuple(_t(x) for x in cw), prefix, torch.from_numpy(binder),
        binder.shape[-1])
    for (got, want) in zip((next_seed, ct, w, proof), jchild):
        assert _same(got, want)
    assert np.array_equal(torch.all(ok, dim=-1).numpy(), np.asarray(jok))
    # Some children hold ctrl, so w_cw (values >= p among them) was added.
    assert ct.any() and not ct.all()


# -- K1's binder sponge, plain version, on a Field128 carry ---------------

def test_binder_checks_field128_match_jax_eval_proof(circuits):
    """The payload and onehot checks and the whole eval proof over two
    aggregators' Field128 carries (a third of the elements >= p, some
    2^128 - 1) at level 3 of a real RoundPlan, port against the JAX
    package's _eval_proof (MasticHistogram, VALUE_LEN 5)."""
    width = 8
    frontiers = [[(False,), (True,)],
                 [(False, True), (True, False), (True, True)],
                 [(False, True, True), (True, False, False),
                  (True, False, True)],
                 [(False, True, True, False), (True, False, False, True),
                  (True, False, True, True)]]
    layouts: list = []
    for (level, prefixes) in enumerate(frontiers):
        jplan = JRoundPlan(tuple(prefixes), level, BITS, width, layouts)
        tplan = RoundPlan(tuple(prefixes), level, BITS, width, layouts)
        layouts.append(jplan.layout_new)
    jrnd = j_round_inputs(jplan)
    trnd = round_inputs(tplan, "cpu")
    c = circuits("histogram")
    (jbm, tbm) = (c.jbm, c.tbm)
    vl = tbm.m.value_len
    rng = np.random.default_rng(11)
    trees = [(_to_limbs(FIELD128, _rand_ints(rng, P128,
                                             (REPORTS, BITS, width, vl),
                                             above=True)),
              rng.integers(0, 256, (REPORTS, BITS, width, 32), np.uint8))
             for _ in range(2)]
    (onehot, payload) = binder_checks(
        FIELD128, tuple(_t(w) for (w, _p) in trees),
        tuple(torch.from_numpy(p) for (_w, p) in trees), trnd.onehot_idx,
        trnd.payload_parent, trnd.payload_left, trnd.payload_right,
        ts_prefix(dst_alg(CTX, USAGE_ONEHOT_CHECK, tbm.m.ID), 0),
        ts_prefix(dst_alg(CTX, USAGE_PAYLOAD_CHECK, tbm.m.ID), 0))
    assert not torch.equal(onehot[0], onehot[1])
    assert not torch.equal(payload[0], payload[1])
    jengine = JEngine(jbm, width=width)
    tengine = IncrementalMastic(tbm, width)
    eval_proof = jax.jit(
        lambda a, w, p, r: jengine._eval_proof(a, VK, CTX, w, p, r),
        static_argnums=0)
    for (a, (w, proof)) in enumerate(trees):
        want = eval_proof(a, jnp.asarray(w), jnp.asarray(proof), jrnd)
        got = tengine._eval_proof(a, VK, CTX, _t(w), torch.from_numpy(proof),
                                  trnd)
        assert _same(got, want)


# -- the beta share and the weight check ---------------------------------

def _port_batch(c: SimpleNamespace) -> tuple:
    """REPORTS measurements of circuit `c`, sharded by the port on the
    CPU once per module: (batch, ok).  The port's sharding is held
    against the JAX package's in test_torch_circuit_shard.py."""
    if c.batch is None:
        rng = np.random.default_rng(7)
        meas = [(tuple(bool(b) for b in rng.integers(0, 2, BITS)),
                 c.meas_of(rng)) for _ in range(REPORTS)]
        (alphas, betas) = c.tbm.encode_measurements(meas, "cpu")
        nonces = torch.from_numpy(rng.integers(0, 256, (REPORTS, 16),
                                               dtype=np.uint8))
        rand = torch.from_numpy(rng.integers(
            0, 256, (REPORTS, c.mastic.RAND_SIZE), dtype=np.uint8))
        c.batch = c.tbm.shard_device(CTX, alphas, betas, nonces, rand)
    return c.batch


def jax_batch(arrays: dict) -> JReportBatch:
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


def test_get_beta_share_matches_jax(circuits):
    """Both parties' beta shares from the root keys (one depth-0 level
    step in the port) against vidpf_jax.get_beta_share, Field128; they
    sum to beta."""
    c = circuits("histogram")
    (batch, ok) = _port_batch(c)
    assert bool(ok.all())
    jbm = c.jbm
    jb = jax_batch(convert.report_batch_to_arrays(batch))
    shares = []
    for a in range(2):
        (want, wok) = jax.jit(
            lambda cws, k, n: jbm.vidpf.get_beta_share(a, cws, k, CTX, n))(
            jb.cws, jb.keys[:, a], jb.nonces)
        (got, gok) = c.tbm.vidpf.get_beta_share(
            a, batch.cws, batch.keys[:, a], CTX, batch.nonces)
        assert _same(got, want)
        assert np.array_equal(gok.numpy(), np.asarray(wok))
        shares.append(got)
    beta = FIELD128.add(shares[0], shares[1])
    assert torch.equal(beta[:, 0], _t(_to_limbs(FIELD128, [1] * REPORTS)))


@pytest.mark.parametrize("name", ["sum", "histogram"])
def test_weight_check_matches_jax(circuits, name):
    """Both aggregators' weight check from their depth-0 payloads (a
    depth-0 `eval_full`; the FLP query over two shares): the checks ("weight_check", and
    "joint_rand" for the joint-rand circuits) and ok, port against
    JAX.  Honest reports pass; for the joint-rand circuit a tampered
    peer part in half the reports must fail "joint_rand" in both
    packages."""
    c = circuits(name)
    (batch, ok) = _port_batch(c)
    assert bool(ok.all())
    (bm, jbm) = (c.tbm, c.jbm)
    root = bm.schedule((0, ((False,), (True,)), True), "cpu")
    pairs = [bm.vidpf.eval_full(a, batch.cws, batch.keys[:, a], root, CTX,
                                batch.nonces)[0] for a in range(2)]
    check = jax.jit(lambda b, w0, w1: jbm.weight_check_device(
        VK, CTX, 0, b, w0, w1))
    batches = [batch]
    if name in JR_CIRCUITS:
        tampered = batch.peer_parts[0].clone()
        tampered[::2, 5] ^= 0x40
        batches.append(batch._replace(
            peer_parts=(tampered, batch.peer_parts[1])))
    for (i, b) in enumerate(batches):
        (wchecks, wok) = check(jax_batch(convert.report_batch_to_arrays(b)),
                               *(jnp.asarray(convert.to_numpy(w, words=True))
                                 for w in pairs))
        (checks, got_ok) = bm.weight_check_device(VK, CTX, 0, b, *pairs)
        assert set(checks) == set(wchecks)
        for key in checks:
            assert np.array_equal(checks[key].numpy(),
                                  np.asarray(wchecks[key])), key
        assert np.array_equal(got_ok.numpy(), np.asarray(wok))
        if i == 0:
            assert all(bool(c.all()) for c in checks.values())
        else:
            assert checks["joint_rand"].numpy().tolist() == \
                [r % 2 == 1 for r in range(REPORTS)]
