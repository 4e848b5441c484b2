"""The port's scalar layer (`mastic_tpu_torch/scalar/`) against the JAX
package's (`mastic_tpu/mastic.py` and the modules under it), byte for
byte: for all five circuits at small bits and lengths, the same
measurement, nonce and rand through `shard`, both aggregators'
`prep_init`, `prep_shares_to_prep` and `prep_next`, on a weight-check
round at level 0 and a later round.  Then `Mastic.scalar()`'s
parameters, and `marshal_reports` of a report sharded by the port's
scalar layer against the same report from the JAX package's and
against the port's batched `shard_device` on the same inputs.

Pure Python on both sides: nothing here compiles a JAX program.
"""

import numpy as np
import pytest
import torch

import mastic_tpu.mastic as jm
from mastic_tpu_torch import convert
from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.scalar import mastic as sm

CTX = b"torch port scalar test"
BITS = 4
# name: (instantiation args, measurement weight)
CASES = {
    "count": ("MasticCount", (BITS,), 1),
    "sum": ("MasticSum", (BITS, 7), 5),
    "sumvec": ("MasticSumVec", (BITS, 3, 2, 2), [1, 2, 3]),
    "histogram": ("MasticHistogram", (BITS, 4, 2), 2),
    "multihot": ("MasticMultihotCountVec", (BITS, 4, 2, 2),
                 [True, False, True, False]),
}


def _norm(x):
    """Field elements as (field modulus, value); containers as lists."""
    if hasattr(x, "int") and hasattr(type(x), "MODULUS"):
        return (type(x).MODULUS, x.int())
    if isinstance(x, (list, tuple)):
        return [_norm(y) for y in x]
    return x


def _inputs(name: str, m) -> tuple:
    rng = np.random.default_rng(sorted(CASES).index(name))
    alpha = tuple(bool(b) for b in rng.integers(0, 2, BITS))
    return (alpha, rng.bytes(m.NONCE_SIZE), rng.bytes(m.RAND_SIZE),
            rng.bytes(m.VERIFY_KEY_SIZE))


def _pair(name: str) -> tuple:
    (cls, args, _weight) = CASES[name]
    return (getattr(sm, cls)(*args), getattr(jm, cls)(*args))


def _agg_params(alpha: tuple) -> list:
    """The weight-check round at level 0, and a level-2 round over the
    measurement's own prefix and two others."""
    level2 = sorted({alpha[:3], (False, True, True), (True, False, False)})
    return [(0, ((False,), (True,)), True), (2, tuple(level2), False)]


@pytest.mark.parametrize("name", list(CASES))
def test_scalar_protocol_matches_jax(name):
    """shard, prep_init of both aggregators, prep_shares_to_prep and
    prep_next agree with the JAX package's scalar layer on every field
    element and byte, and the public share encodes to the same bytes."""
    (port, ref) = _pair(name)
    weight = CASES[name][2]
    (alpha, nonce, rand, vk) = _inputs(name, port)
    (ps, shares) = port.shard(CTX, (alpha, weight), nonce, rand)
    (jps, jshares) = ref.shard(CTX, (alpha, weight), nonce, rand)
    assert _norm(ps) == _norm(jps)
    assert _norm(shares) == _norm(jshares)
    assert port.vidpf.encode_public_share(ps) == \
        ref.vidpf.encode_public_share(jps)
    for agg_param in _agg_params(alpha):
        (states, prep_shares, jstates, jprep_shares) = ([], [], [], [])
        for agg_id in range(2):
            (st, sh) = port.prep_init(vk, CTX, agg_id, agg_param, nonce, ps,
                                      shares[agg_id])
            (jst, jsh) = ref.prep_init(vk, CTX, agg_id, agg_param, nonce,
                                       jps, jshares[agg_id])
            assert _norm(st) == _norm(jst)
            assert _norm(sh) == _norm(jsh)
            states.append(st)
            prep_shares.append(sh)
            jstates.append(jst)
            jprep_shares.append(jsh)
        msg = port.prep_shares_to_prep(CTX, agg_param, prep_shares)
        assert msg == ref.prep_shares_to_prep(CTX, agg_param, jprep_shares)
        outs = [port.prep_next(CTX, st, msg) for st in states]
        assert _norm(outs) == _norm([ref.prep_next(CTX, st, msg)
                                     for st in jstates])
        # The out shares sum to the measurement on its own prefix.
        (level, prefixes, _wc) = agg_param
        p = port.field.MODULUS
        agg = [(a.int() + b.int()) % p for (a, b) in zip(*outs)]
        width = 1 + port.flp.OUTPUT_LEN
        own = prefixes.index(alpha[:level + 1]) * width
        assert agg[own] == 1


@pytest.mark.parametrize("name", list(CASES))
def test_scalar_twin_parameters(name):
    """Mastic.scalar() is the scalar instantiation with the same ID,
    bits, circuit lengths and RAND_SIZE, built once."""
    (cls, args, _weight) = CASES[name]
    m = getattr(tm, cls)(*args)
    s = m.scalar()
    ref = getattr(jm, cls)(*args)
    assert type(s) is getattr(sm, cls) and s is m.scalar()
    assert (s.ID, s.vidpf.BITS, s.vidpf.VALUE_LEN, s.RAND_SIZE) == \
        (m.ID, m.bits, m.value_len, m.RAND_SIZE) == \
        (ref.ID, ref.vidpf.BITS, ref.vidpf.VALUE_LEN, ref.RAND_SIZE)
    for attr in ("MEAS_LEN", "OUTPUT_LEN", "PROOF_LEN", "VERIFIER_LEN",
                 "JOINT_RAND_LEN", "PROVE_RAND_LEN", "QUERY_RAND_LEN"):
        assert getattr(s.flp, attr) == getattr(m.valid, attr) \
            == getattr(ref.flp, attr), attr
    assert s.field.MODULUS == m.field.MODULUS == ref.field.MODULUS


def test_base_mastic_has_no_scalar_twin():
    with pytest.raises(TypeError, match="no scalar twin"):
        tm.Mastic(BITS, tm.Count()).scalar()


@pytest.mark.parametrize("name", list(CASES))
def test_marshal_reports_of_scalar_reports(name):
    """Two reports sharded by the port's scalar layer marshal to the
    batch the JAX package's scalar reports marshal to, and to the port's
    batched shard on the same measurements, nonces and rand."""
    (port, ref) = _pair(name)
    (cls, args, weight) = CASES[name]
    m = getattr(tm, cls)(*args)
    bm = tm.BatchedMastic(m)
    meas = []
    (reports, jreports, nonces, rands) = ([], [], [], [])
    for k in range(2):
        (alpha, nonce, rand, _vk) = _inputs(name, port)
        alpha = alpha[:-1] + (bool(k),)
        meas.append((alpha, weight))
        reports.append((nonce,) + port.shard(CTX, meas[-1], nonce, rand))
        jreports.append((nonce,) + ref.shard(CTX, meas[-1], nonce, rand))
        nonces.append(np.frombuffer(nonce, np.uint8))
        rands.append(np.frombuffer(rand, np.uint8))
    got = convert.report_batch_to_arrays(bm.marshal_reports(reports, "cpu"))
    want = convert.report_batch_to_arrays(bm.marshal_reports(jreports,
                                                             "cpu"))
    (alphas, betas) = bm.encode_measurements(meas, "cpu")
    (batch, ok) = bm.shard_device(CTX, alphas, betas,
                                  torch.from_numpy(np.stack(nonces)),
                                  torch.from_numpy(np.stack(rands)))
    assert bool(ok.all())
    sharded = convert.report_batch_to_arrays(batch)
    assert sorted(got) == sorted(want) == sorted(sharded)
    for key in got:
        assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(got[key], sharded[key]), key
