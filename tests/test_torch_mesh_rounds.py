"""The port's report mesh (`mastic_tpu_torch.parallel`) against the JAX
package's (`mastic_tpu.parallel`), compared exactly (tolerance 0): the
client shard, the sharded round from the root and the attribute round.
test_torch_mesh.py holds the heavy-hitters runners; the two files split
the JAX package's compiles between two test workers.

The port's ranks run over gloo on the CPU, one process each
(`parallel.launch.spawn`, the rank programs of `parallel/jobs.py`): one
group of 2 ranks and one of 3.  The JAX package's mesh functions run on
the 8 virtual CPU devices of tests/conftest.py, each program compiled
once in this module; where a case is held against the port's unsharded
function instead, that function is held against JAX's by another test
file (named below), which keeps this module to three JAX compiles.  The
reports come from both packages' scalar layers with the same nonces and
randomness.

* `sharded_gen` at 2 ranks equals JAX's `sharded_gen_fn` on
  `make_mesh(2)` (tests/test_parallel.py's inputs), and at 3 ranks over
  9 reports the port's unsharded `gen`.
* `sharded_round` at 2 ranks equals the port's unsharded round
  (`round_device_checks` over the whole batch) for test_parallel.py's
  level-1 round and its level-0 weight-check round, and JAX's
  `sharded_round_fn` for the weight-check round.
* `sharded_prep` (the leader's, on the weight-check round) at 2 ranks
  equals the port's unsharded prep, every rank's rows gathered.
* `aggregate_by_attribute(mesh=)` at 2 ranks equals JAX's with
  `make_mesh(2)`: MasticSum(2, 3) over 9 reports (one chunk, padded to
  10 rows) and 3 attributes, one tampered report attributed alike; its
  observability blocks pass JAX's `validate_extra`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mastic_tpu.mastic as jm
import mastic_tpu_torch.backend.mastic as tbm
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.drivers import attribute_metrics as jam
from mastic_tpu.obs.schema import validate_extra
from mastic_tpu.parallel import (make_mesh as jmake_mesh, shard_batch,
                                 sharded_gen_fn, sharded_round_fn)
from mastic_tpu_torch import hash_attribute
from mastic_tpu_torch.parallel import jobs, spawn

CTX = b"mesh test"
VK = bytes(range(32))
BITS = 3
# Attributes whose 2-bit hashes differ (so a 2-bit tree keeps the JAX
# round's compile short), asked about; "Brazil" is not.
ATTR_MASTIC = ("MasticSum", (2, 3))
ATTRS = ["Greece", "Mexico", "Chile"]
ATTR_TAMPERED = 4


def _reports(spec: tuple, meas: list, seed: int,
             tampered=None) -> tuple:
    """The same reports from the port's scalar layer and the JAX
    package's: (port reports, JAX reports), `tampered`'s leader key
    with its first byte flipped."""
    rng = np.random.default_rng(seed)
    (port, ref) = (jobs.mastic_of(spec).scalar(), getattr(jm, spec[0])(
        *spec[1]))
    out = ([], [])
    for m in meas:
        (nonce, rand) = (rng.bytes(16), rng.bytes(port.RAND_SIZE))
        for (dst, mastic) in zip(out, (port, ref)):
            dst.append((nonce,) + mastic.shard(CTX, m, nonce, rand))
    if tampered is not None:
        for dst in out:
            (nonce, public_share, shares) = dst[tampered]
            (key, proof, seed_, part) = shares[0]
            dst[tampered] = (nonce, public_share, [
                (bytes([key[0] ^ 1]) + key[1:], proof, seed_, part),
                shares[1]])
    return out


def _count_meas(values: list) -> list:
    vid = tbm.MasticCount(BITS).scalar().vidpf
    return [(vid.test_index_from_int(v, BITS), 1) for v in values]


def _counters(m) -> dict:
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if f.name != "extra"}


def _gen_inputs(num: int, seed: int) -> dict:
    """tests/test_parallel.py's gen inputs (MasticCount(2), weight 1)."""
    rng = np.random.default_rng(seed)
    one = tbm.BatchedMastic(tbm.MasticCount(2)).spec.int_to_limbs(1)
    return {"alphas": rng.integers(0, 2, (num, 2)).astype(bool),
            "betas": np.stack([np.stack([one, one])] * num),
            "nonces": rng.integers(0, 256, (num, 16), dtype=np.uint8),
            "rand": rng.integers(0, 256, (num, 32), dtype=np.uint8)}


def _jax_gen(inputs: dict, mesh) -> list:
    """JAX's gen over the same inputs, sharded over `mesh` (or not):
    [cws seed, ctrl, w, proof, keys, ok] as numpy."""
    jbm = JBatchedMastic(jm.MasticCount(2))
    args = [jnp.asarray(inputs[k].astype(np.uint32) if k == "betas"
                        else inputs[k])
            for k in ("alphas", "betas", "nonces", "rand")]
    if mesh is None:
        out = jax.jit(lambda a, b, n, r: jbm.vidpf.gen(a, b, CTX, n, r))(
            *args)
    else:
        out = sharded_gen_fn(jbm, mesh, CTX)(
            *(shard_batch(mesh, a) for a in args))
    (cws, keys, ok) = out
    return [np.asarray(x) for x in list(cws) + [keys, ok]]


def _round_case(values: list, agg_param, seed: int) -> tuple:
    meas = _count_meas(values)
    (reports, jreports) = _reports(("MasticCount", (BITS,)), meas, seed)
    return ({"mastic": ("MasticCount", (BITS,)), "ctx": CTX,
             "verify_key": VK, "agg_param": agg_param, "reports": reports},
            jreports)


# test_parallel.py's two sharded rounds: level 1, and level 0 with the
# weight check (the one also run by JAX's sharded_round_fn here).
ROUND_VALUES = [0b101, 0b100, 0b101, 0b001, 0b101, 0b100, 0b110, 0b000]
ROUNDS = {
    "level1": ((1, tuple(tbm.MasticCount(2).scalar().vidpf
                         .test_index_from_int(v, 2) for v in range(4)),
                False), 0),
    "weight_check": ((0, ((False,), (True,)), True), 7),
}


def _attr_case() -> tuple:
    rng = np.random.default_rng(21)
    m = jobs.mastic_of(ATTR_MASTIC)
    names = ATTRS + ["Brazil"]
    meas = [(hash_attribute(m, names[int(rng.integers(0, len(names)))]),
             int(rng.integers(0, 4))) for _ in range(9)]
    (reports, jreports) = _reports(ATTR_MASTIC, meas, 22, ATTR_TAMPERED)
    return ({"mastic": ATTR_MASTIC, "ctx": CTX, "verify_key": VK,
             "attributes": ATTRS, "reports": reports}, jreports)


@pytest.fixture(scope="module")
def cases() -> dict:
    (attr, jattr) = _attr_case()
    rounds = {name: _round_case(ROUND_VALUES, agg_param, seed)
              for (name, (agg_param, seed)) in ROUNDS.items()}
    return {"attr": attr, "jattr": jattr, "rounds": rounds,
            "gen2": _gen_inputs(8, 5), "gen3": _gen_inputs(9, 6)}


@pytest.fixture(scope="module")
def jax_side(cases) -> dict:
    """Every JAX program of the module, each run once."""
    mesh = jmake_mesh(2, nodes_axis=1)
    out = {"gen2": _jax_gen(cases["gen2"], mesh)}
    (_case, jreports) = cases["rounds"]["weight_check"]
    jbm = JBatchedMastic(jm.MasticCount(BITS))
    (agg0, agg1, accept, ok) = sharded_round_fn(
        jbm, mesh, VK, CTX, ROUNDS["weight_check"][0])(
        jbm.marshal_reports(jreports))
    out["weight_check"] = ([[x.int() for x in jbm.agg_share_to_host(a)]
                            for a in (agg0, agg1)],
                           np.asarray(accept), np.asarray(ok))
    records: list = []
    result = jam.aggregate_by_attribute(
        jm.MasticSum(*ATTR_MASTIC[1]), CTX, ATTRS, cases["jattr"],
        verify_key=VK, metrics_out=records, mesh=mesh)
    out["attr"] = (result, records[0])
    return out


@pytest.fixture(scope="module")
def port(cases) -> dict:
    """The port's side: one group of 2 ranks and one of 3, each running
    all its cases."""
    two = [("gen", dict(mastic=("MasticCount", (2,)), ctx=CTX,
                        **cases["gen2"]))]
    two += [("round_from_root", case)
            for (case, _j) in cases["rounds"].values()]
    two += [("attribute", cases["attr"]),
            ("prep", cases["rounds"]["weight_check"][0])]
    three = [("gen", dict(mastic=("MasticCount", (2,)), ctx=CTX,
                          **cases["gen3"]))]
    got2 = spawn(jobs.run_all, 2, "gloo", "cpu", two)
    got3 = spawn(jobs.run_all, 3, "gloo", "cpu", three)
    out = {k: [r[0][i][0] for r in got2] for (i, k) in
           enumerate(["gen"] + list(cases["rounds"]) + ["attr", "prep"])}
    out["gen3"] = [r[0][0][0] for r in got3]
    out["launches"] = [r[1] for r in got2 + got3]
    return out


def _same_on_every_rank(results):
    """Rank 0's result, after checking that every rank returned the same
    (but for the arrival skews of a `mesh` block and the other
    observability records)."""
    def fixed(result) -> str:
        if isinstance(result, dict) and "mesh" in result:
            result = dict(result, mesh={k: v for (k, v) in
                                        result["mesh"].items()
                                        if "skew" not in k}, extra=None)
        return repr(result)

    for other in results[1:]:
        assert fixed(other) == fixed(results[0])
    return results[0]


def _port_gen(inputs: dict) -> list:
    """The port's unsharded gen over the same inputs (held against
    JAX's, inside shard_device, by test_torch_protocol.py): [cws seed,
    ctrl, w, proof, keys, ok] as numpy."""
    bm = tbm.BatchedMastic(tbm.MasticCount(2))
    (cws, keys, ok) = bm.vidpf.gen(
        *(torch.as_tensor(inputs[k]) for k in ("alphas", "betas")), CTX,
        *(torch.as_tensor(inputs[k]) for k in ("nonces", "rand")))
    return [t.numpy() for t in list(cws) + [keys, ok]]


def test_sharded_gen_matches_jax(port, jax_side, cases):
    """2 ranks against JAX's sharded_gen_fn on make_mesh(2); 3 ranks
    over 9 reports against the port's unsharded gen."""
    for (key, want) in (("gen", jax_side["gen2"]),
                        ("gen3", _port_gen(cases["gen3"]))):
        got = _same_on_every_rank(port[key])
        flat = got["cws"] + [got["keys"], got["ok"]]
        assert len(flat) == len(want)
        for (a, b) in zip(flat, want):
            assert np.array_equal(a.astype(np.int64), b.astype(np.int64))
        assert got["ok"].all()


@pytest.mark.parametrize("name", sorted(ROUNDS))
def test_sharded_round_matches_jax(port, jax_side, cases, name):
    """Both aggregates summed over the ranks and the accept and ok masks
    gathered equal the port's unsharded round over the whole batch (held
    against JAX's by test_torch_from_root.py) and, for the weight-check
    round, JAX's sharded_round_fn."""
    (agg0, agg1, accept, ok) = _same_on_every_rank(port[name])
    case = cases["rounds"][name][0]
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    (w0, w1, w_accept, w_ok, _checks) = bm.round_device_checks(
        VK, CTX, case["agg_param"], bm.marshal_reports(case["reports"],
                                                       "cpu"))
    got = [bm.agg_share_to_host(torch.from_numpy(a)) for a in (agg0, agg1)]
    assert got == [bm.agg_share_to_host(a) for a in (w0, w1)]
    assert np.array_equal(accept, w_accept.numpy()) and accept.all()
    assert np.array_equal(ok, w_ok.numpy())
    if name in jax_side:
        (want_aggs, want_accept, want_ok) = jax_side[name]
        assert got == want_aggs
        assert np.array_equal(accept, want_accept)
        assert np.array_equal(ok, want_ok)


def test_attribute_round_matches_jax(port, jax_side):
    """The attribute round at 2 ranks (9 reports: one chunk padded to
    10) equals JAX's with make_mesh(2): the result, the counters (the
    tampered report rejected at the eval proof) and the mesh block's
    shard count."""
    got = _same_on_every_rank(port["attr"])
    (jresult, jrecord) = jax_side["attr"]
    assert got["result"] == [(a, v) for (a, v) in jresult]
    assert got["counters"] == _counters(jrecord)
    assert got["counters"]["rejected_eval_proof"] == 1
    assert got["accept"].tolist() == [r != ATTR_TAMPERED for r in range(9)]
    assert set(jrecord.extra["mesh"]) <= set(got["mesh"])
    assert (got["mesh"]["report_shards"], got["mesh"]["rows_per_shard"]) \
        == (jrecord.extra["mesh"]["report_shards"], 5)
    assert validate_extra(got["extra"]) == []
    assert all({"download_ms", "gather_ms"} <= set(rec["phases"])
               for rec in got["extra"]["chunks"])


def test_sharded_prep_gathers_the_unsharded_prep(port, cases):
    """The leader's prep over 2 ranks, gathered, equals its prep over
    the whole batch in one process (held against JAX's by
    test_torch_from_root.py)."""
    case = cases["rounds"]["weight_check"][0]
    bm = tbm.BatchedMastic(jobs.mastic_of(case["mastic"]))
    batch = bm.marshal_reports(case["reports"], "cpu")
    want = bm.prep(0, VK, CTX, case["agg_param"], batch.nonces, batch.cws,
                   batch.keys[:, 0], proof_shares=batch.leader_proofs)
    got = _same_on_every_rank(port["prep"])
    for (a, b) in zip(got, (want.out_share, want.eval_proof, want.ok)):
        assert np.array_equal(a, b.numpy())
    assert got[2].all()


def test_ranks_launch_no_kernel_on_the_cpu(port):
    """The ranks ran on CPU tensors: the plain versions, no launch."""
    assert not any(any(launches.values()) for launches in port["launches"])


