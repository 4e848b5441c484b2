"""Differential tests of the port's from-root round against the JAX
package, compared exactly (tolerance zero), at BITS 4-5 and R = 33
reports (not a multiple of 32): the schedule, `eval_full`'s tree,
both aggregators' `prep` (eval proof, out share, verifier, joint-rand
part and seed, ok), `round_device_checks`, `round_device` and
`accept_mask` for MasticCount (no weight check), MasticSum and
MasticHistogram (Field128, joint randomness), the check masks of
tampered reports, `marshal_reports` on scalar-layer
reports, and the wire sizes and op counts behind `RoundMetrics`.

The port shards the reports (held against the JAX package in
test_torch_protocol.py and test_torch_circuit_shard.py) and `convert`
hands the batch to JAX.  One JAX program per instantiation gives
everything compared: its `round_device_checks`, with the preps and both
aggregators' `eval_full` levels captured from inside the same trace."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mastic_tpu import mastic as jm
from mastic_tpu import metrics as jmetrics
from mastic_tpu import wire as jwire
from mastic_tpu.backend.mastic_jax import BatchedMastic as JBatchedMastic
from mastic_tpu.backend.mastic_jax import ReportBatch as JReportBatch
from mastic_tpu.backend.schedule import LevelSchedule as JLevelSchedule
from mastic_tpu.backend.vidpf_jax import BatchedCorrectionWords as JCws
from mastic_tpu_torch import convert, metrics, wire
from mastic_tpu_torch.backend import mastic as tm
from mastic_tpu_torch.backend.schedule import LevelSchedule

CTX = b"torch port from root"
VK = bytes(range(64, 96))
REPORTS = 33

# name: (JAX instance, port instance, weight of a report from rng, level
# of the round, its weight check)
CASES = {
    "count": (lambda: jm.MasticCount(5), lambda: tm.MasticCount(5),
              lambda rng: int(rng.integers(0, 2)), 2, False),
    "sum": (lambda: jm.MasticSum(4, 7), lambda: tm.MasticSum(4, 7),
            lambda rng: int(rng.integers(0, 8)), 3, True),
    "histogram": (lambda: jm.MasticHistogram(4, 2, 1),
                  lambda: tm.MasticHistogram(4, 2, 1),
                  lambda rng: int(rng.integers(0, 2)), 1, True),
}


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


def _jax_round(jbm: JBatchedMastic, agg_param):
    """The JAX package's round_device_checks, jitted, also returning the
    two preps and each aggregator's eval_full (its levels' (w, proof),
    out_w, ok) as the round computed them."""
    captured = {}
    (prep_both, eval_full) = (jbm.prep_both, jbm.vidpf.eval_full)

    def capture_preps(*args, **kwargs):
        captured["preps"] = prep_both(*args, **kwargs)
        return captured["preps"]

    def capture_levels(agg_id, *args, **kwargs):
        out = eval_full(agg_id, *args, **kwargs)
        (levels, out_w, ok) = out
        captured[agg_id] = ([(lvl.w, lvl.proof) for lvl in levels], out_w,
                            ok)
        return out

    jbm.prep_both = capture_preps
    jbm.vidpf.eval_full = capture_levels

    def body(vk, batch):
        out = jbm.round_device_checks(vk, CTX, agg_param, batch)
        return (out, captured["preps"], captured[0], captured[1])

    fn = jax.jit(body)
    vk = jnp.asarray(np.frombuffer(VK, np.uint8))
    return lambda batch: jax.device_get(fn(vk, batch))


class Case:
    """One instantiation: the port's batch, the round's parameter, and
    the JAX program."""

    def __init__(self, name: str):
        (jmake, tmake, weight, level, wc) = CASES[name]
        (self.jmastic, self.mastic) = (jmake(), tmake())
        bits = self.mastic.bits
        rng = np.random.default_rng(len(name))
        planted = [int(v) for v in rng.integers(0, 2 ** bits, 6)]
        values = [planted[i % 6] if i % 4 else int(rng.integers(0, 2 ** bits))
                  for i in range(REPORTS)]
        self.meas = [(tuple(bool((v >> (bits - 1 - i)) & 1)
                            for i in range(bits)), weight(rng))
                     for v in values]
        self.bm = tm.BatchedMastic(self.mastic)
        (alphas, betas) = self.bm.encode_measurements(self.meas, "cpu")
        nonces = torch.from_numpy(rng.integers(0, 256, (REPORTS, 16),
                                               dtype=np.uint8))
        rand = torch.from_numpy(rng.integers(
            0, 256, (REPORTS, self.mastic.RAND_SIZE), dtype=np.uint8))
        (self.batch, ok) = self.bm.shard_device(CTX, alphas, betas, nonces,
                                                rand)
        assert bool(ok.all())
        # The reports' own prefixes at the level and one that no report
        # has, in an order that is not sorted.
        present = sorted({m[0][:level + 1] for m in self.meas})
        absent = [p for p in (tuple(bool((v >> (level - i)) & 1)
                                    for i in range(level + 1))
                              for v in range(2 ** (level + 1)))
                  if p not in present]
        prefixes = present[3:] + absent[:1] + present[:3]
        self.agg_param = (level, tuple(prefixes), wc)
        self.jbm = JBatchedMastic(self.jmastic)
        self.jround = _jax_round(self.jbm, self.agg_param)
        self.jout = self.jround(self.jax_batch(self.batch))

    def jax_batch(self, batch):
        return _jax_batch(convert.report_batch_to_arrays(batch))


@pytest.fixture(scope="module")
def case():
    """Case by name, built once per module."""
    cache: dict = {}

    def get(name: str) -> Case:
        if name not in cache:
            cache[name] = Case(name)
        return cache[name]

    return get


# -- the schedule ------------------------------------------------------

@pytest.mark.parametrize("prefixes,level,bits", [
    (((False,), (True,)), 0, 4),
    (((True, False, True), (False, False, False), (True, True, True)), 2, 5),
    (tuple(tuple(bool((v >> (8 - i)) & 1) for i in range(9))
           for v in (3, 100, 511, 260, 7)), 8, 12),
])
def test_level_schedule_matches_jax(prefixes, level, bits):
    """Every field of LevelSchedule equals the JAX package's; the flat
    offsets and K1's index lists name the nodes of its check binders:
    every node's proof in BFS order, and each internal node with its
    two children."""
    (got, want) = (LevelSchedule(prefixes, level, bits),
                   JLevelSchedule(prefixes, level, bits))
    assert got.num_children == want.num_children
    assert got.total_nodes == want.total_nodes
    assert got.parent_index[0] is None and want.parent_index[0] is None
    for (a, b) in zip(got.parent_index[1:], want.parent_index[1:]):
        assert np.array_equal(a, b)
    for (a, b) in zip(got.node_binder, want.node_binder):
        assert np.array_equal(a, b)
    for (a, b) in zip(got.internal_index, want.internal_index):
        assert np.array_equal(a, b)
    assert np.array_equal(got.out_index, want.out_index)
    (onehot, par, left, right) = got.check_indices()
    # Label each flat node by (depth, position) and read the binder
    # order back.
    depth_pos = [(d, i) for d in range(level + 1)
                 for i in range(want.num_children[d])]
    assert [depth_pos[k] for k in onehot] == depth_pos
    want_rows = [((d, int(p)), (d + 1, 2 * k), (d + 1, 2 * k + 1))
                 for d in range(level)
                 for (k, p) in enumerate(want.internal_index[d])]
    assert [(depth_pos[a], depth_pos[b], depth_pos[c])
            for (a, b, c) in zip(par, left, right)] == want_rows


# -- the tree, the preps and the round ---------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_eval_full_matches_jax(case, name):
    """Both aggregators' flat tree (w, proof in BFS order), out_w and
    ok equal the JAX package's eval_full levels."""
    c = case(name)
    sched = c.bm.schedule(c.agg_param, "cpu")
    for agg_id in range(2):
        (w, proof, out_w, ok) = c.bm.vidpf.eval_full(
            agg_id, c.batch.cws, c.batch.keys[:, agg_id], sched, CTX,
            c.batch.nonces)
        (levels, want_out, want_ok) = c.jout[2 + agg_id]
        (want_w, want_proof) = convert.tree_from_levels(
            [lw for (lw, _p) in levels], [lp for (_w, lp) in levels], "cpu")
        assert w.shape[1] == sched.total_nodes
        assert torch.equal(w, want_w) and torch.equal(proof, want_proof)
        assert np.array_equal(convert.to_numpy(out_w, words=True), want_out)
        assert np.array_equal(ok.numpy(), want_ok) and bool(ok.all())


@pytest.mark.parametrize("name", list(CASES))
def test_prep_matches_jax(case, name):
    """Each aggregator's BatchedPrep, field by field."""
    c = case(name)
    got = c.bm.prep_both(VK, CTX, c.agg_param, c.batch)
    for agg_id in range(2):
        want = c.jout[1][agg_id]
        for field in tm.BatchedPrep._fields:
            (g, w) = (getattr(got[agg_id], field), getattr(want, field))
            if w is None:
                assert g is None, (agg_id, field)
                continue
            assert np.array_equal(convert.to_numpy(g, words=True),
                                  np.asarray(w)), (agg_id, field)
    assert (got[0].verifier is None) == (not c.agg_param[2])
    assert (got[0].joint_rand_part is None) == (name != "histogram")


@pytest.mark.parametrize("name", list(CASES))
def test_round_device_checks_matches_jax(case, name):
    """Aggregate shares, accept, ok and every check mask; the
    aggregates decode to the plaintext per-prefix sums."""
    c = case(name)
    (agg0, agg1, accept, ok, checks) = c.bm.round_device_checks(
        VK, CTX, c.agg_param, c.batch)
    (jagg0, jagg1, jaccept, jok, jchecks) = c.jout[0]
    for (g, w) in ((agg0, jagg0), (agg1, jagg1), (accept, jaccept),
                   (ok, jok)):
        assert np.array_equal(convert.to_numpy(g, words=True), np.asarray(w))
    assert sorted(checks) == sorted(jchecks)
    for name_ in checks:
        assert np.array_equal(checks[name_].numpy(), jchecks[name_])
    assert bool(accept.all())
    (level, prefixes, _wc) = c.agg_param
    got = c.mastic.unshard([c.bm.agg_share_to_host(a) for a in (agg0, agg1)])
    for (p, value) in zip(prefixes, got):
        weights = [w for (alpha, w) in c.meas if alpha[:level + 1] == p]
        if name == "histogram":
            assert value == np.bincount(weights, minlength=2).tolist()
        else:
            assert value == sum(weights)


def _tampered(batch: tm.ReportBatch, kind: str, rows: list,
              level: int) -> tm.ReportBatch:
    """The batch with a flipped correction-word seed byte at a depth <=
    level (kind "cw") or a changed leader proof limb ("proof") in each
    report of `rows`."""
    rng = np.random.default_rng(9)
    if kind == "cw":
        seed = batch.cws.seed.clone()
        for r in rows:
            seed[r, int(rng.integers(0, level + 1)),
                 int(rng.integers(0, 16))] ^= 0x5A
        return batch._replace(cws=batch.cws._replace(seed=seed))
    proofs = batch.leader_proofs.clone()
    for r in rows:
        proofs[r, int(rng.integers(0, proofs.shape[1])), 0] ^= 1
    return batch._replace(leader_proofs=proofs)


@pytest.mark.parametrize("kind", ["cw", "proof"])
def test_tampered_reports_give_jax_check_masks(case, kind):
    """MasticSum with a tampered correction word (on the reports' own
    path, so inside the grid) or leader proof share in three reports:
    the port's check masks equal the JAX package's, and exactly those
    reports fail, the eval proof for a correction word and the weight
    check for a proof share."""
    c = case("sum")
    (level, prefixes, _wc) = c.agg_param
    rows = [r for (r, m) in enumerate(c.meas)
            if m[0][:level + 1] in prefixes][1:10:4]
    batch = _tampered(c.batch, kind, rows, level)
    (_a0, _a1, accept, ok, checks) = c.bm.round_device_checks(
        VK, CTX, c.agg_param, batch)
    (_j0, _j1, jaccept, _jok, jchecks) = c.jround(c.jax_batch(batch))[0]
    assert sorted(checks) == sorted(jchecks)
    for name in checks:
        assert np.array_equal(checks[name].numpy(), jchecks[name])
    assert np.array_equal(accept.numpy(), jaccept)
    failing = "eval_proof" if kind == "cw" else "weight_check"
    assert np.flatnonzero(~checks[failing].numpy()).tolist() == rows
    assert np.flatnonzero(~accept.numpy()).tolist() == rows
    assert bool(ok.all())
    if kind == "proof":
        assert bool(checks["eval_proof"].all())


@pytest.mark.parametrize("name", list(CASES))
def test_accept_mask_and_round_device_match_jax(case, name):
    """With a tampered correction word in three reports: `accept_mask`
    over the port's two preps equals the JAX package's `accept_mask`
    over its own, and `round_device` equals the JAX round's first four
    outputs (the JAX package's `round_device`); exactly those reports
    are refused."""
    c = case(name)
    (level, prefixes, wc) = c.agg_param
    rows = [r for (r, m) in enumerate(c.meas)
            if m[0][:level + 1] in prefixes][:9:4]
    batch = _tampered(c.batch, "cw", rows, level)
    jout = c.jround(c.jax_batch(batch))
    (p0, p1) = c.bm.prep_both(VK, CTX, c.agg_param, batch)
    accept = c.bm.accept_mask(p0, p1, wc)
    assert np.array_equal(accept.numpy(),
                          np.asarray(c.jbm.accept_mask(*jout[1], wc)))
    assert np.flatnonzero(~accept.numpy()).tolist() == rows
    got = c.bm.round_device(VK, CTX, c.agg_param, batch)
    assert len(got) == 4
    for (g, w) in zip(got, jout[0][:4]):
        assert np.array_equal(convert.to_numpy(g, words=True), np.asarray(w))


def test_prep_round_trips_through_convert(case):
    c = case("histogram")
    (p0, _p1) = c.bm.prep_both(VK, CTX, c.agg_param, c.batch)
    back = convert.prep_from_arrays(convert.prep_to_arrays(p0, "p0_"), "p0_",
                                    "cpu")
    for field in tm.BatchedPrep._fields:
        assert torch.equal(getattr(back, field), getattr(p0, field)), field


# -- wire reports, sizes and op counts ---------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_marshal_reports_matches_jax(name):
    """Scalar-layer reports (the JAX package's `shard`) marshal to the
    same batch in both packages; the correction words go back to the
    scalar layer's own."""
    (jmake, tmake, weight, _level, _wc) = CASES[name]
    (jmastic, mastic) = (jmake(), tmake())
    rng = np.random.default_rng(5)
    reports = []
    for _ in range(3):
        alpha = tuple(bool(b) for b in rng.integers(0, 2, mastic.bits))
        nonce = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
        rand = rng.integers(0, 256, jmastic.RAND_SIZE,
                            dtype=np.uint8).tobytes()
        (public, shares) = jmastic.shard(CTX, (alpha, weight(rng)), nonce,
                                         rand)
        reports.append((nonce, public, shares))
    jb = JBatchedMastic(jmastic).marshal_reports(reports)
    bm = tm.BatchedMastic(mastic)
    got = convert.report_batch_to_arrays(bm.marshal_reports(reports, "cpu"))
    want = {"nonces": jb.nonces, "cws_seed": jb.cws.seed,
            "cws_ctrl": jb.cws.ctrl, "cws_w": jb.cws.w,
            "cws_proof": jb.cws.proof, "keys": jb.keys,
            "leader_proofs": jb.leader_proofs,
            "helper_seeds": jb.helper_seeds}
    if jb.leader_seeds is not None:
        want.update(leader_seeds=jb.leader_seeds,
                    peer_part0=jb.peer_parts[0], peer_part1=jb.peer_parts[1])
    assert sorted(got) == sorted(want)
    for (key, value) in want.items():
        assert got[key].dtype == np.asarray(value).dtype, key
        assert np.array_equal(got[key], np.asarray(value)), key
    cws = bm.vidpf.cws_from_host([public for (_n, public, _s) in reports],
                                 "cpu")
    assert bm.vidpf.cws_to_host(cws, 1, jmastic.field) == reports[1][1]


@pytest.mark.parametrize("name", list(CASES))
def test_wire_sizes_and_round_counts_match_jax(name):
    """The wire sizes and the RoundMetrics op and byte counts of a round
    equal the JAX package's."""
    (jmake, tmake, _weight, _level, _wc) = CASES[name]
    (jmastic, mastic) = (jmake(), tmake())
    for agg_id in range(2):
        assert wire.input_share_size(mastic, agg_id) == \
            jwire.input_share_size(jmastic, agg_id)
    for wc in (False, True):
        ap = (1, ((False, True), (True, True), (True, False)), wc)
        assert wire.prep_share_size(mastic, ap) == \
            jwire.prep_share_size(jmastic, ap)
        assert wire.agg_share_size(mastic, ap) == \
            jwire.agg_share_size(jmastic, ap)
        (got, want) = (metrics.RoundMetrics(1, 3, 8, REPORTS),
                       jmetrics.RoundMetrics(1, 3, 8, REPORTS))
        metrics.count_round_ops(got, mastic, REPORTS, 8, True)
        jmetrics.count_round_ops(want, jmastic, REPORTS, 8, True)
        metrics.count_round_bytes(got, mastic, ap, REPORTS)
        jmetrics.count_round_bytes(want, jmastic, ap, REPORTS)
        assert got.as_dict() == want.as_dict()
    assert metrics.upload_bytes(mastic) == jmetrics.upload_bytes(jmastic)
