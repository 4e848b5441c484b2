"""Weighted heavy hitters (a lean port of
`mastic_tpu/drivers/heavy_hitters.py`), on two round engines.

The resident incremental runner (the default): per level one
incremental round for both aggregators (kernel K3 for the level, K1
for the binders and the eval proof), the FLP weight check on level 0
(with the joint-rand confirmation for the circuits that use joint
randomness), the accept-mask combine and the masked aggregation, all
on the device; then one sync, the splice, the metrics record, the
unshard and decode, and the threshold pruning on the host.  The padded
node width grows on demand.

The from-root round (`run_round`, and `HeavyHittersRun(...,
incremental=False)`): each level re-evaluates the whole grid from the
root for both aggregators (`BatchedMastic.round_device_checks`: K3 a
depth, K1 over the flat tree), then one sync, the splice, the metrics
record and the unshard.  It is the differential reference for the
incremental runner, and the attribute-metrics round.

Both engines append one `RoundMetrics` record per level, with the
rejections attributed per check.

`HeavyHittersRun` prunes on `count >= threshold`, so it serves the
scalar circuits (MasticCount, MasticSum), as in the JAX package; the
resident runner (`IncrementalRunner`) and the from-root round serve
every circuit.

XOF rejection sampling: a lane whose batched sampling drew a value
outside the field (`ok` False, about 2^-32 per sampled Field64
element) holds garbage.  Both engines leave it out of the device
aggregates and recompute the report through the scalar layer
(`splice_rejected`, with `Mastic.scalar()`): the from-root round in
that round, the incremental runner in that round and every later one
(its `fallback` mask), since the lane's carry is garbage from then on.
The splice reads the scalar reports behind the batch (`reports=`, any
sequence indexable by lane); a rejection without them raises.  Lanes
whose `valid` is False (e.g. the shard's own sampling fired) were never
sharded correctly: they are left out of the aggregates, not recomputed,
and counted in `RoundMetrics.extra["excluded_invalid"]`.  As in the JAX
package, a recomputed report that fails counts in `rejected_fallback`;
`extra["rejected_fallback_by"]` names the checks it failed.

A run given `chunk_size` or a `HostReportStore` (`store=`) keeps the
reports and the carries in host memory and streams chunks through the
card each round (`drivers/chunked.py`'s `ChunkedIncrementalRunner`, on
the pipelined executor of `drivers/pipeline.py`), for collections
whose carries outgrow the card; its results equal the resident
runner's.

`HeavyHittersRun.to_bytes` / `from_bytes` checkpoint a run between
levels in the JAX package's v3 format (with the per-chunk carries of a
chunked run), so that a checkpoint taken by either package resumes in
the other.  The JAX package's AOT programs are not ported.

Under a report mesh (`mesh=`, `parallel/mesh.py`: one rank a process,
each handed the same arguments) both incremental runners keep only
this rank's rows on its card; each round's aggregate shares are summed
over the ranks and its verdict masks gathered, so every rank's
`RoundMetrics`, pruning and result are the global ones, equal to the
unsharded run's bit for bit.  The splice runs on every rank over the
whole gathered `fallback` set: it is the unsharded code path on the
same gathered data, so every rank reaches the same shares with no
collective beyond the round's and no branch of its own (the lanes fire
about 2^-32 per sampled element, so the repeated work is nil).  A
checkpoint gathers the carries: every rank writes the same bytes as
the unsharded run.  The from-root engine takes no mesh here (as in the
JAX package); the attribute round does.

Thresholds: a dict mapping prefix tuples to ints with a "default" key;
a prefix takes the threshold of its longest strict ancestor present in
the dict, else the default.
"""

import hashlib
import io
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..backend.incremental import (Carry, IncrementalMastic, RoundPlan,
                                   round_inputs)
from ..backend.mastic import (BatchedMastic, Mastic, ReportBatch,
                               all_checks)
from ..convert import carry_from_arrays, carry_to_arrays
from ..metrics import (RoundMetrics, attribute_rejections,
                       count_round_bytes, count_round_ops)
from ..obs import devtime
from ..obs import trace as obs_trace
from ..parallel.mesh import (gather_round, gather_rows, mesh_block,
                             place_reports, shard_incremental_runner,
                             tree_map)
from ..scalar.mastic import ReportRejected


def get_threshold(thresholds: dict, prefix: tuple) -> int:
    """Longest-strict-ancestor threshold lookup."""
    for level in reversed(range(len(prefix) - 1)):
        if prefix[:level + 1] in thresholds:
            return thresholds[prefix[:level + 1]]
    return thresholds["default"]


def _pad_nodes(x: torch.Tensor, dim: int, pad: int) -> torch.Tensor:
    """Zero-pad the node axis `dim` of a carry tensor by `pad`."""
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _ms(t0: float, t1: float) -> float:
    return (t1 - t0) * 1e3


# -- the rounds' telemetry ----------------------------------------------

def begin_round_obs(tenant: str, rnd: int, level: int, frontier_width: int,
                    reports: int, device) -> dict:
    """Open a round's telemetry: the detached "round" span, with the
    JAX package's attributes, and the one-shot profiler when
    `MASTIC_TORCH_PROFILE` is armed.  Returns the handle entries
    `end_round_obs` closes."""
    prof = devtime.round_profiler(device, tenant)
    span = obs_trace.get_tracer().start_detached_span(
        "round", tenant=tenant, round=rnd, level=level,
        frontier_width=frontier_width, reports=reports,
        profiled=prof is not None)
    return {"span": span, "prof": prof}


def end_round_obs(handle: dict, error: Optional[BaseException] = None
                  ) -> None:
    """Close the profiler bracket (writing its trace) and the round span
    exactly once; either half of a round may take the error path."""
    prof = handle.pop("prof", None)
    if prof is not None:
        handle["profile_trace"] = prof.stop()
    span = handle.pop("span", None)
    if span is not None:
        if error is not None:
            span.set_default("error", type(error).__name__)
        obs_trace.get_tracer().end_span(span)


def stamp_round(metrics: RoundMetrics, t0: float, tenant: str) -> None:
    """A finished round's record: its wall time, the schema check of its
    blocks, and its registry series."""
    metrics.extra["round_wall_ms"] = _ms(t0, time.perf_counter())
    metrics.validate_extra()
    devtime.observe_round(metrics, tenant=tenant)


# -- the scalar fallback -----------------------------------------------

# The check each scalar rejection names (the messages of
# scalar/mastic.py's ReportRejected), under RoundMetrics' names.
_REJECTED_BY = {"VIDPF verification failed": "eval_proof",
                "FLP verification failed": "weight_check",
                "joint rand confirmation failed": "joint_rand"}


def scalar_round_out_shares(m, verify_key: bytes, ctx: bytes, agg_param,
                            report,
                            rejected_by: Optional[dict] = None
                            ) -> Optional[list]:
    """One report through the scalar protocol round (both preps, the
    prep-share exchange, prep_next) of the scalar Mastic `m`.  Returns
    the two out shares, or None if the report is rejected by the
    checks, counting the failed check in `rejected_by`.  The scalar
    XOFs run the true rejection loop, so this is exact for the lanes
    the batched sampler flags."""
    (nonce, public_share, input_shares) = report
    states = []
    shares = []
    for agg_id in range(2):
        (state, share) = m.prep_init(verify_key, ctx, agg_id, agg_param,
                                     nonce, public_share,
                                     input_shares[agg_id])
        states.append(state)
        shares.append(share)
    try:
        prep_msg = m.prep_shares_to_prep(ctx, agg_param, shares)
        return [m.prep_next(ctx, state, prep_msg) for state in states]
    except ReportRejected as err:
        if rejected_by is not None:
            check = _REJECTED_BY[str(err)]
            rejected_by[check] = rejected_by.get(check, 0) + 1
        return None


def splice_rejected(mastic: Mastic, verify_key: bytes, ctx: bytes,
                    agg_param, reports: Optional[Sequence], ok: np.ndarray,
                    accept: np.ndarray, agg_shares: list) -> dict:
    """The XOF rejection-sampling fallback (vdaf-13 §6.2).

    Lanes where `ok` is False sampled a value outside the field: their
    device results are garbage, and the device aggregates already leave
    them out.  Recompute exactly those reports through the scalar layer
    and splice their out shares and accept bits into the round's host
    results (`accept` and `agg_shares`, lists of ints mod p, are
    updated in place).  Returns the recomputed reports' rejections per
    failed check ({"weight_check": 1, ...})."""
    rejected_by: dict = {}
    if ok.all():
        return rejected_by
    if reports is None:
        raise ValueError(
            "XOF rejection sampling fired but the host reports needed "
            "for the scalar fallback were not provided")
    m = mastic.scalar()
    p = mastic.field.MODULUS
    for r in np.flatnonzero(~ok):
        out_shares = scalar_round_out_shares(m, verify_key, ctx, agg_param,
                                             reports[int(r)], rejected_by)
        accept[r] = out_shares is not None
        if out_shares is not None:
            for a in range(2):
                agg_shares[a] = [(x + y.int()) % p for (x, y)
                                 in zip(agg_shares[a], out_shares[a])]
    return rejected_by


# -- the resident incremental runner -------------------------------------

class IncrementalRunner:
    """Drives backend/incremental.py across the collector loop: keeps
    both aggregators' carries on the device, grows the padded width on
    demand, and folds the level-0 FLP weight check into the accept
    mask.

    `fallback` (R,) bool, on the device: the lanes whose XOF rejection
    sampling fired in some round.  Their carry is garbage from that
    round on, so they stay out of every later device aggregate and go
    through the scalar splice every round (`reports`).  `valid` (R,)
    bool: lanes to leave out of every aggregate without recomputing
    them (e.g. the shard's `ok`).

    `parallel.mesh.shard_incremental_runner` keeps this rank's rows of
    the batch, `valid`, `fallback`, the round keys and the carries
    (`shard`); `num_reports` stays global."""

    def __init__(self, bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                 batch: ReportBatch, valid: Optional[torch.Tensor] = None,
                 width: int = 8, reports: Optional[Sequence] = None):
        self.bm = bm
        self.verify_key = verify_key
        self.ctx = ctx
        self.batch = batch
        self.reports = reports
        self.mesh = None
        self.device = batch.nonces.device
        self.num_reports = int(batch.nonces.shape[0])
        self.valid = (torch.ones(self.num_reports, dtype=torch.bool,
                                 device=self.device)
                      if valid is None else valid.to(torch.bool))
        self.fallback = torch.zeros(self.num_reports, dtype=torch.bool,
                                    device=self.device)
        self.width = max(4, width)
        self.engine = IncrementalMastic(bm, self.width)
        self.layouts: list = []
        (self.ext_rk, self.conv_rk) = bm.vidpf.roundkeys(ctx, batch.nonces)
        self.carries = [self.engine.init_carry(self.num_reports,
                                               batch.keys[:, a], a)
                        for a in range(2)]
        self.max_width = self.width

    def shard(self, mesh) -> None:
        """Keep this rank's rows of every per-report tensor."""
        (self.batch, self.valid, self.fallback, self.ext_rk, self.conv_rk,
         self.carries) = place_reports(mesh, (
             self.batch, self.valid, self.fallback, self.ext_rk,
             self.conv_rk, self.carries))
        self.mesh = mesh

    def _grow(self, width: int) -> None:
        """Pad both carries to `width`, one after the other, so that
        only one aggregator's old carry lives beside the new ones."""
        pad = width - self.width
        for (a, c) in enumerate(self.carries):
            self.carries[a] = Carry(
                w=_pad_nodes(c.w, 2, pad), proof=_pad_nodes(c.proof, 2, pad),
                seed=_pad_nodes(c.seed, 1, pad),
                ctrl=_pad_nodes(c.ctrl, 1, pad))
            del c
        self._set_width(width)

    def _set_width(self, width: int) -> None:
        self.width = width
        self.max_width = max(self.max_width, width)
        self.engine = IncrementalMastic(self.bm, width)

    def _plan(self, prefixes, level: int) -> RoundPlan:
        while True:
            try:
                return RoundPlan(prefixes, level, self.bm.m.bits,
                                 self.width, self.layouts)
            except ValueError as err:
                if "exceeds padded width" not in str(err):
                    raise
                self._grow(self.width * 2)

    def restore(self, width: int, fallback: np.ndarray, carries: list,
                layouts: list) -> None:
        """Adopt a checkpoint's state (every report's): its width,
        `fallback` mask (only lanes that are valid here), both carries
        (this rank's rows of them) and the per-depth creation
        layouts."""
        self._set_width(width)
        fallback = torch.as_tensor(np.asarray(fallback, bool),
                                   device=self.device)
        (fallback, carries) = place_reports(self.mesh,
                                            (fallback, list(carries)))
        self.fallback = fallback & self.valid
        self.carries = carries
        self.layouts = list(layouts)

    def memory_accounting(self) -> dict:
        """This rank's card for the whole run, under the JAX package's
        keys: both carries, the round keys and the report batch (the
        chunked runner's `memory_accounting` is the streaming twin)."""
        carry = 2 * sum(t.nbytes for t in self.carries[0])
        rk = self.ext_rk.nbytes + self.conv_rk.nbytes
        batch = sum(t.nbytes for t in self.batch.tensors())
        return {"chunk_size": 0, "num_chunks": 1,
                "device_bytes_total": carry + rk + batch,
                "device_carry_bytes": carry, "host_bytes_total": 0}

    def state(self) -> tuple:
        """(fallback (R,) bool, [carry of every report] x 2) in host
        memory, gathered over the ranks: what a checkpoint stores."""
        fallback = gather_rows(self.mesh, self.fallback).numpy()
        return (fallback, [tree_map(lambda t: gather_rows(self.mesh, t), c)
                           for c in self.carries])

    def round_stage(self, agg_param) -> dict:
        """Dispatch one round without blocking: both aggregators' tree
        step, the level-0 weight check, the accept combine and the
        masked aggregates.  Returns the handle `round_collect` reads."""
        t0 = time.perf_counter()
        (level, prefixes, do_weight_check) = agg_param
        plan = self._plan(prefixes, level)
        rnd = round_inputs(plan, self.device)
        t_plan = time.perf_counter()
        ((c0, proof0, out0, ok0), (c1, proof1, out1, ok1)) = \
            self.engine.agg_rounds((0, 1), self.verify_key, self.ctx,
                                   tuple(self.carries), rnd, self.ext_rk,
                                   self.conv_rk, self.batch.cws)
        self.carries = [c0, c1]
        checks = {"eval_proof": torch.all(proof0 == proof1, dim=-1)}
        ok = ok0 & ok1
        if do_weight_check:
            (wc_checks, wc_ok) = self.bm.weight_check_device(
                self.verify_key, self.ctx, level, self.batch,
                c0.w[:, 0, :2], c1.w[:, 0, :2])
            checks.update(wc_checks)
            ok = ok & wc_ok
        accept = all_checks(checks)
        keep = accept & ok & ~self.fallback & self.valid
        agg = (self.bm.aggregate(out0, keep), self.bm.aggregate(out1, keep))
        self.layouts.append(plan.layout_new)
        return {"agg_param": agg_param, "plan": plan, "agg": agg,
                "accept": accept, "ok": ok, "checks": checks,
                "t": (t0, t_plan, time.perf_counter())}

    def round_collect(self, handle: dict,
                      metrics_out: Optional[list] = None) -> list:
        """The blocking half: one sync (the downloads), the scalar
        splice of every fallback lane, the metrics record (appended to
        `metrics_out`), the unshard and decode.  Returns one decoded
        aggregate per prefix (a weighted count for the scalar circuits,
        a list for the vector ones)."""
        agg_param = handle["agg_param"]
        (level, prefixes, _wc) = agg_param
        plan = handle["plan"]
        (t0, t_plan, t_disp) = handle["t"]
        self.fallback |= ~handle["ok"] & self.valid
        rows = len(prefixes) * (1 + self.bm.m.valid.OUTPUT_LEN)
        names = sorted(handle["checks"])
        # The round's exchange over the mesh (with no mesh, the
        # downloads): shares summed over the ranks, masks gathered.
        g = gather_round(
            self.mesh, self.bm.spec, torch.stack(handle["agg"])[:, :rows],
            torch.stack([handle["accept"], self.fallback, self.valid]
                        + [handle["checks"][k] for k in names], dim=1))
        agg_shares = [self.bm.agg_share_to_host(s) for s in g.shares]
        (accept, fallback, valid, *per_check) = g.masks.numpy().T
        checks = dict(zip(names, per_check))
        accept = accept & ~fallback & valid
        t_wait = time.perf_counter()

        num = self.num_reports
        metrics = RoundMetrics(level=level, frontier_width=len(prefixes),
                               padded_width=plan.width, reports_total=num)
        attribute_rejections(metrics, checks["eval_proof"],
                             checks.get("weight_check"),
                             checks.get("joint_rand"),
                             device_ok=~fallback & valid)
        # The incremental round extends only the surviving parents.
        count_round_ops(metrics, self.bm.m, num, 2 * plan.parent_count,
                        include_key_setup=(level == 0))
        count_round_bytes(metrics, self.bm.m, agg_param, num)
        rejected_by = splice_rejected(self.bm.m, self.verify_key, self.ctx,
                                      agg_param, self.reports, ~fallback,
                                      accept, agg_shares)
        t_splice = time.perf_counter()
        metrics.accepted = int(accept.sum())
        metrics.xof_fallbacks = int(fallback.sum())
        metrics.rejected_fallback = int((fallback & ~accept).sum())
        metrics.extra["excluded_invalid"] = int((~valid).sum())
        metrics.extra["rejected_fallback_by"] = rejected_by
        metrics.extra["splice_ms"] = _ms(t_wait, t_splice)
        t_host = time.perf_counter()
        # The JAX package's resident block: one chunk, so nothing to
        # overlap within the round.  The downloads are the round's one
        # sync, so their time is inside compute_wait_ms; the port
        # compiles no program, so there is no compile_ms phase.
        metrics.extra["pipeline"] = {
            "mode": "resident-deferred", "fallback": None,
            "round_wall_ms": _ms(t0, t_host), "overlap_efficiency": 0.0,
            "compile_inline_ms": 0.0, "host_syncs": 1,
            "phases": {"upload_ms": _ms(t0, t_plan),
                       "dispatch_ms": _ms(t_plan, t_disp),
                       "compute_wait_ms": _ms(t_disp, t_wait),
                       "host_ms": _ms(t_wait, t_host)}}
        if self.mesh is not None:
            metrics.extra["mesh"] = mesh_block(self.mesh, num, g.share_bytes,
                                               [g.skew_ms])
        if metrics_out is not None:
            metrics_out.append(metrics)
        return self.bm.m.unshard(agg_shares)


# -- the from-root round ---------------------------------------------

def run_round_stage(bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                    agg_param, batch: ReportBatch,
                    valid: Optional[torch.Tensor] = None) -> dict:
    """Dispatch one from-root round without blocking: both preps, the
    checks and the masked aggregates, on the device.  Returns the
    handle `run_round_collect` reads."""
    sched = bm.schedule(agg_param, batch.nonces.device)
    return {"out": bm.round_device_checks(verify_key, ctx, agg_param, batch,
                                          valid, sched),
            "nodes": sched.total_nodes, "valid": valid,
            "verify_key": verify_key, "ctx": ctx}


def run_round_collect(bm: BatchedMastic, agg_param, handle: dict,
                      metrics_out: Optional[list] = None,
                      reports: Optional[Sequence] = None) -> list:
    """The blocking half of `run_round_stage`: one sync (the downloads),
    the scalar splice of the lanes whose XOF sampling fired (from
    `reports`), the metrics record and the unshard.  Returns the
    per-prefix aggregates; appends a RoundMetrics record to
    `metrics_out`; leaves the round's final accept mask (R,) bool, the
    spliced lanes' verdicts included, in handle["accept"]."""
    (agg0, agg1, accept, ok, checks) = handle["out"]
    accept = accept.cpu().numpy().copy()
    ok = ok.cpu().numpy()
    valid = handle["valid"]
    valid = (np.ones_like(ok) if valid is None
             else valid.cpu().numpy().astype(bool))
    checks = {k: v.cpu().numpy() for (k, v) in checks.items()}
    agg_shares = [bm.agg_share_to_host(a) for a in (agg0, agg1)]
    nodes = handle["nodes"]
    handle["accept"] = accept
    return finalize_round(bm, handle["verify_key"], handle["ctx"], agg_param,
                          reports, ok, accept, checks, agg_shares,
                          padded_width=nodes, nodes_evaluated=nodes,
                          metrics_out=metrics_out, valid=valid)


def run_round(bm: BatchedMastic, verify_key: bytes, ctx: bytes, agg_param,
              batch: ReportBatch, valid: Optional[torch.Tensor] = None,
              metrics_out: Optional[list] = None,
              reports: Optional[Sequence] = None) -> list:
    """One from-root aggregation round: `run_round_stage` then
    `run_round_collect`.  `reports` are the scalar reports behind
    `batch`, read only for the lanes whose XOF sampling fired."""
    handle = run_round_stage(bm, verify_key, ctx, agg_param, batch, valid)
    return run_round_collect(bm, agg_param, handle, metrics_out=metrics_out,
                             reports=reports)


def finalize_round(bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                   agg_param, reports: Optional[Sequence], ok: np.ndarray,
                   accept: np.ndarray, checks: dict, agg_shares: list,
                   padded_width: int, nodes_evaluated: int,
                   metrics_out: Optional[list], valid: np.ndarray) -> list:
    """The from-root round's host side: the metrics record with the
    rejections attributed per check, the XOF-rejection splice (lanes
    with `ok` False and `valid` True; `accept` and `agg_shares` are
    updated in place), then the unshard.  Lanes with `valid` False are
    left out of the aggregates and the verdicts."""
    (level, prefixes, _wc) = agg_param
    num_reports = accept.shape[0]
    metrics = RoundMetrics(level=level, frontier_width=len(prefixes),
                           padded_width=padded_width,
                           reports_total=num_reports)
    attribute_rejections(metrics, checks["eval_proof"],
                         checks.get("weight_check"),
                         checks.get("joint_rand"), device_ok=ok & valid)
    count_round_ops(metrics, bm.m, num_reports, nodes_evaluated,
                    include_key_setup=True)
    count_round_bytes(metrics, bm.m, agg_param, num_reports)
    fallback = ~ok & valid
    metrics.xof_fallbacks = int(fallback.sum())
    accept &= valid
    t0 = time.perf_counter()
    rejected_by = splice_rejected(bm.m, verify_key, ctx, agg_param, reports,
                                  ~fallback, accept, agg_shares)
    metrics.extra["splice_ms"] = _ms(t0, time.perf_counter())
    metrics.extra["excluded_invalid"] = int((~valid).sum())
    metrics.extra["rejected_fallback_by"] = rejected_by
    metrics.accepted = int(accept.sum())
    metrics.rejected_fallback = int((fallback & ~accept).sum())
    if metrics_out is not None:
        metrics_out.append(metrics)
    return bm.m.unshard(agg_shares)


# -- the collector loop and its checkpoints ---------------------------------

# The JAX package's checkpoint format: v3 stores the per-depth creation
# layouts (the carries are not compacted between rounds).
_CKPT_VERSION = 3


def _ckpt_binding(verify_key: bytes, ctx: bytes,
                  thresholds: dict) -> np.ndarray:
    """Digest binding a checkpoint to its (verify_key, ctx, thresholds):
    restoring under another key or context would reject every report
    (the carries were derived under the old key), and other thresholds
    would prune another frontier."""
    thresh_repr = repr(sorted(thresholds.items(), key=repr)).encode()
    digest = hashlib.sha256(
        len(verify_key).to_bytes(2, "little") + verify_key +
        len(ctx).to_bytes(2, "little") + ctx + thresh_repr).digest()
    return np.frombuffer(digest, np.uint8)


def _paths_to_array(paths) -> np.ndarray:
    if not paths:
        return np.zeros((0, 0), bool)
    return np.array([[bool(b) for b in p] for p in paths], bool)


def _paths_from_array(arr) -> list:
    return [tuple(bool(x) for x in row) for row in np.asarray(arr)]


class HeavyHittersRun:
    """A heavy-hitters collection over a device-resident report batch:
    one `step()` per tree level, on the incremental runner or, with
    `incremental=False`, one from-root round a level; either way one
    RoundMetrics record per level in `metrics`.

    `batch` is the report batch on the device; a run given only the
    scalar `reports` marshals them (`BatchedMastic.marshal_reports`).
    `reports` (any sequence indexable by lane) is read only for the
    lanes whose XOF sampling fires.  With `chunk_size` or `store` (a
    `HostReportStore`, built from the batch when not given) the run
    takes the chunked runner.  `to_bytes()` serialises the run between
    levels (the collector state, the carries and the `fallback` mask);
    `from_bytes()` restores a run, over the same reports, that
    continues bit-identically.  With `mesh` (a `parallel.ReportMesh`)
    every rank makes the same call and the incremental runner keeps
    this rank's rows; the from-root engine takes no mesh."""

    def __init__(self, mastic: Mastic, ctx: bytes, thresholds: dict,
                 verify_key: bytes, batch: Optional[ReportBatch] = None,
                 valid: Optional[torch.Tensor] = None, device="cuda",
                 incremental: bool = True,
                 reports: Optional[Sequence] = None,
                 chunk_size: Optional[int] = None, store=None, mesh=None):
        from .chunked import ChunkedIncrementalRunner, HostReportStore

        dev = resolve_device(device)
        self.bm = BatchedMastic(mastic)
        if store is None and batch is None:
            if reports is None:
                raise ValueError("a run needs the report batch or the "
                                 "scalar reports")
            batch = self.bm.marshal_reports(reports, dev)
        if batch is not None and batch.nonces.device.type != dev.type:
            raise ValueError(f"the report batch is not on {dev}")
        if store is not None and chunk_size is not None \
                and store.chunk_size != chunk_size:
            raise ValueError(f"chunk_size={chunk_size}, store has "
                             f"{store.chunk_size}")
        if mesh is not None and not incremental and chunk_size is None \
                and store is None:
            raise ValueError(
                "mesh sharding requires the incremental runner "
                "(incremental=True or a chunk_size/store)")
        self.mastic = mastic
        self.ctx = ctx
        self.thresholds = thresholds
        self.verify_key = verify_key
        self.valid = valid
        self.reports = reports
        if chunk_size is not None or store is not None:
            if store is None:
                store = HostReportStore.from_batch(batch, chunk_size)
            self.store = store
            self.batch = None
            self.num_reports = store.num_reports
            self.runner = ChunkedIncrementalRunner(
                self.bm, verify_key, ctx, store, dev, valid=valid,
                reports=reports, mesh=mesh)
        else:
            self.store = None
            self.batch = batch
            self.num_reports = int(batch.nonces.shape[0])
            self.runner = (IncrementalRunner(self.bm, verify_key, ctx,
                                             batch, valid, reports=reports)
                           if incremental else None)
            if mesh is not None:
                shard_incremental_runner(self.runner, mesh)
        self.metrics: list = []
        self.level = 0
        self.prefixes: list = [(False,), (True,)]
        self.prev_agg_params: list = []
        self.heavy_hitters: list = []
        # Per completed level: (prefixes, weighted counts).
        self.level_results: list = []
        self.device = dev
        self.obs_tenant = ""   # telemetry label (set by the service)
        self.done = False

    def step(self) -> bool:
        """Run one level's round.  Returns True while more remain.

        Each round runs inside a detached "round" trace span (tenant,
        round, level, frontier width, reports) and feeds the registry
        (`obs.devtime.observe_round`); with `MASTIC_TORCH_PROFILE=dir`
        armed, the first round stepped in the process runs under
        `torch.profiler` and leaves a Chrome trace in `dir`."""
        handle = self.step_begin()
        if handle is None:
            return False
        return self.step_finish(handle)

    def step_begin(self) -> Optional[dict]:
        """Dispatch one level's round without blocking; None when no
        rounds remain.  The handle's "atomic" flag is True when the
        round ran whole here instead (the chunked runner, whose
        executor makes one wait per chunk).  Every handle goes to
        `step_finish`: the frontier advances only there."""
        if self.done:
            return None
        if not self.prefixes:
            self.done = True
            return None
        agg_param = (self.level, tuple(self.prefixes), self.level == 0)
        if not self.mastic.is_valid(agg_param, self.prev_agg_params):
            raise ValueError("invalid aggregation parameter sequence")
        t0 = time.perf_counter()
        obs = begin_round_obs(self.obs_tenant, self.level, self.level,
                              len(self.prefixes), self.num_reports,
                              self.device)
        try:
            with obs_trace.get_tracer().use_parent(obs["span"]):
                if self.store is not None:
                    handle = {"counts": self.runner.round(
                        agg_param, metrics_out=self.metrics)}
                elif self.runner is not None:
                    handle = self.runner.round_stage(agg_param)
                else:
                    handle = run_round_stage(self.bm, self.verify_key,
                                             self.ctx, agg_param, self.batch,
                                             self.valid)
        except BaseException as exc:
            end_round_obs(obs, error=exc)
            raise
        handle.update(obs, agg_param=agg_param, t0=t0,
                      atomic=self.store is not None)
        return handle

    def step_finish(self, handle: dict) -> bool:
        """Collect the staged round, stamp its metrics record, prune at
        the threshold, and advance the frontier.  Returns True while
        more rounds remain."""
        (level, prefixes, _wc) = handle["agg_param"]
        try:
            with obs_trace.get_tracer().use_parent(handle["span"]):
                if self.store is not None:
                    counts = handle["counts"]
                elif self.runner is not None:
                    counts = self.runner.round_collect(
                        handle, metrics_out=self.metrics)
                else:
                    counts = run_round_collect(
                        self.bm, handle["agg_param"], handle,
                        metrics_out=self.metrics, reports=self.reports)
        except BaseException as exc:
            end_round_obs(handle, error=exc)
            raise
        end_round_obs(handle)
        stamp_round(self.metrics[-1], handle["t0"], self.obs_tenant)
        self.prev_agg_params.append(handle["agg_param"])
        self.level_results.append((list(prefixes), counts))
        survivors = [p for (p, c) in zip(prefixes, counts)
                     if c >= get_threshold(self.thresholds, p)]
        if level < self.mastic.bits - 1:
            self.prefixes = [p + (bit,) for p in survivors
                             for bit in (False, True)]
        else:
            self.heavy_hitters = survivors
        self.level += 1
        if self.level >= self.mastic.bits or not self.prefixes:
            self.done = True
        return not self.done

    def result(self) -> list:
        return self.heavy_hitters

    def frontier(self) -> list:
        """The output after the last COMPLETED level (what a collector
        service reports for an epoch cut short by its deadline): the
        heavy hitters once done; [] before any round; mid-tree the
        survivors of the last completed level, the unique parents of
        the expanded candidates.  Nothing is claimed about levels that
        never ran."""
        if self.done:
            return list(self.heavy_hitters)
        if self.level == 0:
            return []
        seen: dict = {}
        for p in self.prefixes:
            seen.setdefault(p[:-1], None)
        return list(seen)

    def rounds_completed(self) -> int:
        """Levels completed over the run's lifetime (a restored run
        counts the levels before its checkpoint; `metrics` covers only
        this process's)."""
        return self.level

    def excluded(self) -> np.ndarray:
        """Reports left out of the aggregates (bool (R,)): those whose
        `valid` is False.  Lanes whose XOF sampling fired are recomputed
        through the scalar layer, not left out."""
        if self.valid is None:
            return np.zeros(self.num_reports, bool)
        return ~self.valid.cpu().numpy().astype(bool)

    # -- checkpoint / resume ---------------------------------------

    def to_bytes(self) -> bytes:
        """Serialise the run between levels (the collector state, the
        carries and the fallback mask) in the JAX package's v3 npz
        format: a chunked run writes its chunk_size into `meta` and each
        chunk's carries as `k{i}_c{a}_*`.  Under a mesh every rank
        gathers the carries and returns the same bytes, those of the
        unsharded run (every rank must call it)."""
        num_layouts = (len(self.runner.layouts)
                       if self.runner is not None else 0)
        chunk_size = self.store.chunk_size if self.store is not None else 0
        data = {
            "meta": np.array(
                [_CKPT_VERSION, self.level, int(self.done),
                 0 if self.runner is None else 1, self.mastic.bits,
                 self.num_reports, chunk_size, num_layouts], np.int64),
            "binding": _ckpt_binding(self.verify_key, self.ctx,
                                     self.thresholds),
            "prefixes": _paths_to_array(self.prefixes),
            "heavy_hitters": _paths_to_array(self.heavy_hitters),
            "prev_levels": np.array([p[0] for p in self.prev_agg_params],
                                    np.int64),
            "prev_wc": np.array([p[2] for p in self.prev_agg_params], bool),
        }
        if self.prev_agg_params:
            data["last_prefixes"] = _paths_to_array(
                self.prev_agg_params[-1][1])
        for d in range(num_layouts):
            data[f"layout_{d}"] = _paths_to_array(self.runner.layouts[d])
        if self.store is not None:
            data["width"] = np.int64(self.runner.width)
            data["fallback"] = self.runner.fallback.copy()
            data.update(self.runner.state_arrays())
        elif self.runner is not None:
            (fallback, carries) = self.runner.state()
            data["width"] = np.int64(self.runner.width)
            data["fallback"] = fallback
            data.update(carry_to_arrays(carries[0], "c0_"))
            data.update(carry_to_arrays(carries[1], "c1_"))
        buf = io.BytesIO()
        np.savez(buf, **data)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, mastic: Mastic, ctx: bytes, thresholds: dict,
                   verify_key: bytes, batch: Optional[ReportBatch],
                   data: bytes, valid: Optional[torch.Tensor] = None,
                   device="cuda", reports: Optional[Sequence] = None,
                   store=None, mesh=None) -> "HeavyHittersRun":
        """Restore a checkpointed run over the same reports (the batch,
        or the scalar reports it was marshalled from; a chunked run may
        pass its `store` instead).  A chunked checkpoint restores a
        chunked run, with the envelope cleared again at its width.
        Under `mesh` each rank keeps its rows of the checkpoint's
        carries.  Refuses a checkpoint of another instantiation, report
        count, chunk size, verify key, ctx or thresholds, and a store
        for a resident checkpoint."""
        arrays = np.load(io.BytesIO(data), allow_pickle=False)
        meta = [int(x) for x in arrays["meta"]]
        if meta[0] != _CKPT_VERSION:
            raise ValueError(f"checkpoint version {meta[0]}: the port reads "
                             f"v{_CKPT_VERSION} only")
        (_, level, done, incremental, bits, num_reports, chunk_size,
         num_layouts) = meta
        if chunk_size == 0 and store is not None:
            raise ValueError(
                "checkpoint was taken by the resident (unchunked) "
                "runner; restore it with scalar reports, not a store")
        if chunk_size and store is None and reports is None \
                and batch is None:
            raise ValueError(
                "chunked checkpoint needs its report store (or the "
                "scalar reports to rebuild one)")
        if chunk_size == 0 and reports is None and batch is None:
            raise ValueError(
                "resident checkpoint needs the scalar reports (or the "
                "marshalled batch) it was taken over")
        restored_n = (store.num_reports if store is not None
                      else int(batch.nonces.shape[0]) if batch is not None
                      else len(reports))
        if bits != mastic.bits or num_reports != restored_n:
            raise ValueError("checkpoint does not match this instantiation "
                             "or report batch")
        if chunk_size and store is not None \
                and store.chunk_size != chunk_size:
            raise ValueError(
                f"checkpoint was taken with chunk_size={chunk_size}, "
                f"store has {store.chunk_size}")
        if not np.array_equal(np.asarray(arrays["binding"]),
                              _ckpt_binding(verify_key, ctx, thresholds)):
            raise ValueError("checkpoint was taken under a different "
                             "verify_key / ctx / thresholds")
        num_chunks = -(-num_reports // chunk_size) if chunk_size else 0
        if arrays["prev_levels"].size and any(
                f"k{i}_c{a}_w" not in arrays.files
                for i in range(num_chunks) for a in range(2)):
            raise ValueError(f"chunked checkpoint (chunk_size={chunk_size}) "
                             f"lacks the carries of its {num_chunks} chunks")
        run = cls(mastic, ctx, thresholds, verify_key, batch, valid, device,
                  bool(incremental), reports,
                  chunk_size=chunk_size or None, store=store, mesh=mesh)
        run.level = level
        run.done = bool(done)
        run.prefixes = _paths_from_array(arrays["prefixes"])
        run.heavy_hitters = _paths_from_array(arrays["heavy_hitters"])
        prev_levels = [int(x) for x in arrays["prev_levels"]]
        prev_wc = [bool(x) for x in arrays["prev_wc"]]
        last_prefixes = (tuple(_paths_from_array(arrays["last_prefixes"]))
                         if prev_levels else ())
        # is_valid reads only the weight-check flags and the last level.
        run.prev_agg_params = [
            (lvl, last_prefixes if i == len(prev_levels) - 1 else (), wc)
            for (i, (lvl, wc)) in enumerate(zip(prev_levels, prev_wc))]
        layouts = [_paths_from_array(arrays[f"layout_{d}"])
                   for d in range(num_layouts)]
        if run.store is not None and prev_levels:
            runner = run.runner
            width = int(arrays["width"])
            if width != runner.width:
                # A checkpoint at a grown width clears the envelope again
                # on the restoring host and card.
                runner._check_envelope(width)
                runner._set_width(width)
            runner.fallback = np.asarray(arrays["fallback"], bool) \
                & runner.valid
            runner.load_state(arrays, runner.store.num_chunks)
            runner.layouts = layouts
        elif run.runner is not None and prev_levels:
            dev = run.runner.device
            run.runner.restore(
                int(arrays["width"]), arrays["fallback"],
                [carry_from_arrays(arrays, f"c{a}_", dev) for a in range(2)],
                layouts)
        return run


def compute_heavy_hitters(mastic: Mastic, ctx: bytes, thresholds: dict,
                          verify_key: bytes,
                          batch: Optional[ReportBatch] = None,
                          valid: Optional[torch.Tensor] = None,
                          device="cuda", incremental: bool = True,
                          reports: Optional[Sequence] = None,
                          chunk_size: Optional[int] = None,
                          store=None, mesh=None) -> list:
    """The full collector loop over a sharded report batch (or the
    scalar `reports`, marshalled).  With `incremental=False` every level
    is one round from the root: the differential reference of the
    incremental runner.  With `chunk_size` or `store` the chunked
    runner streams the reports through the card.  With `mesh` every
    rank runs this call over its rows of the reports."""
    run = HeavyHittersRun(mastic, ctx, thresholds, verify_key, batch,
                          valid, device, incremental, reports,
                          chunk_size=chunk_size, store=store, mesh=mesh)
    while run.step():
        pass
    return run.result()
