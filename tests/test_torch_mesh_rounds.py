"""The port's report mesh (`mastic_tpu_torch.parallel`) against the JAX
package's (`mastic_tpu.parallel`), compared exactly (tolerance 0): the
client shard, the sharded round from the root and the attribute round.
test_torch_mesh.py holds the heavy-hitters runners; the two files split
the JAX package's compiles between two test workers.

The port's ranks run over gloo on the CPU, one process each
(`parallel.launch.spawn`, the rank programs of `parallel/jobs.py`): one
group of 2 ranks, one of 3 and one of 4.  The JAX package's mesh
functions run on the 8 virtual CPU devices of tests/conftest.py, each
program compiled once in this module; where a case is held against the
port's unsharded function instead, that function is held against JAX's
by another test file (named below), which keeps this module to three
JAX compiles (a fourth, JAX's node axis, under `-m slow`).  The
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

The node axis (`install_grid_sharding`), on the 2-rank group as reports
1 x nodes 2 and on the 4-rank group as reports 2 x nodes 2, is held to
the same results: the attribute round and the weight-check round to
JAX's (the attribute round's metric blocks through `validate_extra`),
and test_parallel.py's level-1 round, MasticCount(3) at level 2 over
all 8 prefixes, a round of one prefix (an empty node block), a round
with a tampered report, and `sharded_prep` to the port's unsplit
functions; a lane whose walk `ok` is cleared on node rank 1 only is
False on every rank, and the splice gives the unsplit result.  On the
4-rank group the incremental runners (resident and chunked), which the
split leaves alone, equal the port's unsharded run.  `-m slow` holds
the port at reports 4 x nodes 2 over 8 ranks to JAX's own node axis
(`install_grid_sharding` and `sharded_round_fn` on `make_mesh(8,
nodes_axis=2)`).
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
from mastic_tpu.parallel import (install_grid_sharding as jinstall,
                                 make_mesh as jmake_mesh, shard_batch,
                                 sharded_gen_fn, sharded_round_fn)
from mastic_tpu_torch import hash_attribute
from mastic_tpu_torch.backend.schedule import LevelSchedule, node_blocks
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun, run_round
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


def _round_case(values: list, agg_param, seed: int, tampered=None) -> tuple:
    meas = _count_meas(values)
    (reports, jreports) = _reports(("MasticCount", (BITS,)), meas, seed,
                                   tampered)
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
# The node axis's rounds beside those two: MasticCount(3) at level 2
# over all 8 prefixes (uneven blocks at 3 ranks, shared ancestors), one
# prefix (node rank 1's block empty), and level 2 over 5 prefixes with
# report 3's leader key tampered (rejected at the eval proof).
ALL3 = tuple(tbm.MasticCount(BITS).scalar().vidpf.test_index_from_int(v, 3)
             for v in range(8))
SPLIT_ROUNDS = {
    "level2_all": ((2, ALL3, False), 11, None),
    "one_prefix": ((2, (ALL3[5],), False), 12, None),
    "tampered": ((2, ALL3[1:6], False), 13, 3),
}
# The mesh shapes of the node axis: (ranks, nodes_axis).
SHAPES = {"1x2": (2, 2), "2x2": (4, 2)}
# The lane whose walk `ok` node rank 1 clears, in the level-2 round.
FORCED_LANE = 2
# Reports of the level-2 round given to a mesh whose report blocks then
# hold fewer reports than node ranks (1 a block at 1 x 2 and 2 x 2).
FEW = 2


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
    rounds.update({name: _round_case(ROUND_VALUES, agg_param, seed, tampered)
                   for (name, (agg_param, seed, tampered))
                   in SPLIT_ROUNDS.items()})
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


def _split_cases(cases: dict, nodes: int) -> list:
    """The node axis's cases on a mesh of `nodes` node ranks: [(key, job
    name, case)]."""
    split = {"nodes_axis": nodes}
    out = [(("round", name), "round_from_root", dict(case, **split))
           for (name, (case, _j)) in cases["rounds"].items()]
    out.append(("attr", "attribute", dict(cases["attr"], **split)))
    out.append(("prep", "prep",
                dict(cases["rounds"]["weight_check"][0], **split)))
    level2 = cases["rounds"]["level2_all"][0]
    nonce = level2["reports"][FORCED_LANE][0]
    out.append(("forced", "run_round", dict(level2, force=(nonce, None),
                                            force_node=1, **split)))
    out.append(("few", "round_from_root",
                dict(level2, reports=level2["reports"][:FEW], **split)))
    return out


def _hh_cases() -> list:
    """The incremental runners on the 2 x 2 mesh: test_torch_mesh.py's
    MasticCount(3) collection, resident and chunked (chunk_size 3: a
    chunk padded to the report axis), with the node ranks repeating
    their report block's work."""
    meas = _count_meas([0b101, 0b100, 0b101, 0b001, 0b101, 0b100, 0b110,
                        0b000])
    (reports, _j) = _reports(("MasticCount", (BITS,)), meas, 31)
    base = {"mastic": ("MasticCount", (BITS,)), "ctx": CTX,
            "verify_key": VK, "thresholds": {"default": 2},
            "reports": reports, "nodes_axis": 2}
    return [(("hh", "resident"), "heavy_hitters", base),
            (("hh", "chunked"), "heavy_hitters", dict(base, chunk_size=3))]


def _spawn_group(world: int, named: list) -> dict:
    """Run [(key, job name, case)] on one group of `world` ranks: {key:
    every rank's result}, and the ranks' launches under "launches"."""
    got = spawn(jobs.run_all, world, "gloo", "cpu",
                [(name, case) for (_key, name, case) in named])
    out = {key: [r[0][i][0] for r in got]
           for (i, (key, _n, _c)) in enumerate(named)}
    out["launches"] = [r[1] for r in got]
    return out


@pytest.fixture(scope="module")
def port(cases) -> dict:
    """The port's side: one group of 2 ranks (the report mesh, then the
    node axis's reports 1 x nodes 2 cases), one of 3 and one of 4 (the
    node axis's reports 2 x nodes 2 cases), each running all its
    cases."""
    two = [("gen", "gen", dict(mastic=("MasticCount", (2,)), ctx=CTX,
                               **cases["gen2"]))]
    two += [(name, "round_from_root", cases["rounds"][name][0])
            for name in ROUNDS]
    two += [("attr", "attribute", cases["attr"]),
            ("prep", "prep", cases["rounds"]["weight_check"][0])]
    two += [(("1x2",) + (k if isinstance(k, tuple) else (k,)), name, case)
            for (k, name, case) in _split_cases(cases, 2)]
    three = [("gen3", "gen", dict(mastic=("MasticCount", (2,)), ctx=CTX,
                                  **cases["gen3"]))]
    four = [(("2x2",) + (k if isinstance(k, tuple) else (k,)), name, case)
            for (k, name, case) in _split_cases(cases, 2) + _hh_cases()]
    out = _spawn_group(2, two)
    launches = out.pop("launches")
    for group in (_spawn_group(3, three), _spawn_group(4, four)):
        launches += group.pop("launches")
        out.update(group)
    out["launches"] = launches
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




# -- the node axis -------------------------------------------------------

@pytest.mark.parametrize("nodes", [2, 3, 5])
def test_node_blocks_partition_the_tree(nodes):
    """Each block's subtree is a contiguous run of every depth of the
    round's tree with the same binders, and the owned nodes of all
    blocks are every node once (5 ranks over 4 prefixes: an empty
    block)."""
    prefixes = [ALL3[i] for i in (0, 2, 3, 6)]
    sched = LevelSchedule(prefixes, 2, BITS)
    binders = [row for rows in sched.node_binder for row in rows]
    owned = np.zeros(sched.total_nodes, int)
    blocks = node_blocks(sched, nodes)
    assert len(blocks) == nodes
    for block in blocks:
        owned[block.index[block.owned]] += 1
        if block.sched is None:
            assert block.index.size == 0
            continue
        mine = [row for rows in block.sched.node_binder for row in rows]
        assert [binders[i].tolist() for i in block.index] \
            == [row.tolist() for row in mine]
    assert owned.tolist() == [1] * sched.total_nodes
    assert [len(b.sched.prefixes) if b.sched else 0 for b in blocks] \
        == [len(p) for p in np.array_split(np.arange(4), nodes)]


def _unsplit_round(case: dict) -> list:
    """The port's unsplit round over the whole batch (held against JAX's
    by test_torch_from_root.py): (agg0, agg1, accept, ok) as numpy."""
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    out = bm.round_device_checks(VK, CTX, case["agg_param"],
                                 bm.marshal_reports(case["reports"], "cpu"))
    return [t.numpy() for t in out[:4]]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("name", sorted(ROUNDS) + sorted(SPLIT_ROUNDS))
def test_split_round_matches_unsplit(port, cases, shape, name):
    """`sharded_round` with the node axis split equals the unsplit round
    bit for bit, on every rank; the tampered report is rejected alike."""
    got = _same_on_every_rank(port[(shape, "round", name)])
    want = _unsplit_round(cases["rounds"][name][0])
    for (a, b) in zip(got, want):
        assert np.array_equal(a, b)
    tampered = SPLIT_ROUNDS.get(name, (None, None, None))[2]
    assert got[2].tolist() == [r != tampered for r in range(8)]
    assert got[3].all()


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_weight_check_round_matches_jax(port, jax_side, shape):
    """The weight-check round split over the node axis equals JAX's
    sharded_round_fn on make_mesh(2)."""
    (agg0, agg1, accept, ok) = _same_on_every_rank(
        port[(shape, "round", "weight_check")])
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    (want_aggs, want_accept, want_ok) = jax_side["weight_check"]
    assert [bm.agg_share_to_host(torch.from_numpy(a))
            for a in (agg0, agg1)] == want_aggs
    assert np.array_equal(accept, want_accept) and accept.all()
    assert np.array_equal(ok, want_ok)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_attribute_round_matches_jax(port, jax_side, shape):
    """The attribute round split over the node axis equals JAX's with
    make_mesh(2): the result, the counters (the tampered report rejected
    at the eval proof), and a mesh block with JAX's keys whose report
    axis is the mesh's; its blocks pass `validate_extra`."""
    got = _same_on_every_rank(port[(shape, "attr")])
    (jresult, jrecord) = jax_side["attr"]
    assert got["result"] == [(a, v) for (a, v) in jresult]
    assert got["counters"] == _counters(jrecord)
    assert got["accept"].tolist() == [r != ATTR_TAMPERED for r in range(9)]
    assert set(jrecord.extra["mesh"]) <= set(got["mesh"])
    reports = SHAPES[shape][0] // SHAPES[shape][1]
    assert (got["mesh"]["report_shards"], got["mesh"]["rows_per_shard"]) \
        == (reports, -(-9 // reports))
    assert validate_extra(got["extra"]) == []


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_prep_gathers_the_unsplit_prep(port, cases, shape):
    """The leader's `sharded_prep` split over the node axis, every
    report rank's rows gathered, equals its unsplit prep."""
    case = cases["rounds"]["weight_check"][0]
    bm = tbm.BatchedMastic(jobs.mastic_of(case["mastic"]))
    batch = bm.marshal_reports(case["reports"], "cpu")
    want = bm.prep(0, VK, CTX, case["agg_param"], batch.nonces, batch.cws,
                   batch.keys[:, 0], proof_shares=batch.leader_proofs)
    got = _same_on_every_rank(port[(shape, "prep")])
    for (a, b) in zip(got, (want.out_share, want.eval_proof, want.ok)):
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_node_local_ok_failure(port, cases, shape):
    """A lane whose walk `ok` node rank 1 alone clears is False on every
    rank, and `run_round`'s splice gives the unsplit round's result."""
    case = cases["rounds"]["level2_all"][0]
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    records: list = []
    want = run_round(bm, VK, CTX, case["agg_param"],
                     bm.marshal_reports(case["reports"], "cpu"),
                     metrics_out=records, reports=case["reports"])
    for got in port[(shape, "forced")]:
        assert got["ok"].tolist() == [r != FORCED_LANE for r in range(8)]
        assert got["result"] == want
        assert got["accept"].all()
        assert got["counters"] == dict(_counters(records[0]),
                                       xof_fallbacks=1)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_round_of_fewer_reports_than_node_ranks(port, cases, shape):
    """A report block of fewer reports than node ranks (2 reports at
    reports 2 x nodes 2; at 1 x 2, the block of 2 splits) gives the
    unsplit round's result."""
    case = cases["rounds"]["level2_all"][0]
    got = _same_on_every_rank(port[(shape, "few")])
    want = _unsplit_round(dict(case, reports=case["reports"][:FEW]))
    for (a, b) in zip(got, want):
        assert np.array_equal(a, b)
    assert got[2].all() and got[3].all()


@pytest.mark.parametrize("mode", ["resident", "chunked"])
def test_incremental_runners_on_a_node_mesh(port, mode):
    """On the 2 x 2 mesh the incremental runners (not split: the node
    ranks repeat their report block's work) equal the port's unsharded
    run, on every rank."""
    (_key, _name, case) = dict((k[1], (k, n, c)) for (k, n, c)
                               in _hh_cases())[mode]
    run = HeavyHittersRun(tbm.MasticCount(BITS), CTX, case["thresholds"],
                          VK, device="cpu", reports=case["reports"])
    while run.step():
        pass
    for got in port[("2x2", "hh", mode)]:
        assert got["levels"] == run.level_results
        assert got["result"] == run.result()
        assert got["counters"] == [_counters(m) for m in run.metrics]
        assert all(b["report_shards"] == 2 for b in got["mesh"])


@pytest.mark.slow
def test_node_axis_matches_jax_grid_sharding(cases):
    """JAX's own node axis, `install_grid_sharding` and
    `sharded_round_fn` on make_mesh(8, nodes_axis=2), over
    test_parallel.py's level-1 round, equals the port's at reports 4 x
    nodes 2 over 8 ranks."""
    (case, jreports) = cases["rounds"]["level1"]
    jbm = JBatchedMastic(jm.MasticCount(BITS))
    mesh = jmake_mesh(8, nodes_axis=2)
    batch = jax.tree.map(lambda x: shard_batch(mesh, x),
                         jbm.marshal_reports(jreports))
    jinstall(jbm, mesh)
    try:
        want = sharded_round_fn(jbm, mesh, VK, CTX, case["agg_param"])(batch)
    finally:
        jbm.vidpf.constrain_state = None
    got = spawn(jobs.run_all, 8, "gloo", "cpu",
                [("round_from_root", dict(case, nodes_axis=2))])
    (agg0, agg1, accept, ok) = _same_on_every_rank([r[0][0][0] for r in got])
    bm = tbm.BatchedMastic(tbm.MasticCount(BITS))
    assert [bm.agg_share_to_host(torch.from_numpy(a)) for a in (agg0, agg1)] \
        == [[x.int() for x in jbm.agg_share_to_host(a)] for a in want[:2]]
    assert np.array_equal(accept, np.asarray(want[2])) and accept.all()
    assert np.array_equal(ok, np.asarray(want[3]))
