"""Weighted heavy hitters (a lean port of
`mastic_tpu/drivers/heavy_hitters.py`), on two round engines.

The resident incremental runner (the default): per level one
incremental round for both aggregators (kernel K3 for the level, K1
for the binders and the eval proof), the FLP weight check on level 0
(with the joint-rand confirmation for the circuits that use joint
randomness), the accept-mask combine and the masked aggregation, all
on the device; then one sync, the unshard and decode, and the
threshold pruning on the host.  The padded node width grows on demand.

The from-root round (`run_round`, and `HeavyHittersRun(...,
incremental=False)`): each level re-evaluates the whole grid from the
root for both aggregators (`BatchedMastic.round_device_checks`: K3 a
depth, K1 over the flat tree), then one sync, a `RoundMetrics` record
per round with rejections attributed per check, and the unshard.  It
is the differential reference for the incremental runner, and the
attribute-metrics round.

`HeavyHittersRun` prunes on `count >= threshold`, so it serves the
scalar circuits (MasticCount, MasticSum), as in the JAX package; the
resident runner (`IncrementalRunner`) and the from-root round serve
every circuit.

Reports whose XOF rejection sampling fired (`ok` False, about 2^-32 per
sampled Field64 element) are excluded from both aggregates (the
incremental runner from the round where it fired on) and counted, in
`RoundMetrics.xof_fallbacks` and `rejected_fallback` on the from-root
round: the JAX package recomputes them through its scalar layer
(`splice_rejected`), which the port has not brought over yet.  The AOT
programs, the pipeline and checkpointing are left for later slices, and
so are the incremental rounds' metrics.

Thresholds: a dict mapping prefix tuples to ints with a "default" key;
a prefix takes the threshold of its longest strict ancestor present in
the dict, else the default.
"""

import time
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..backend.incremental import (Carry, IncrementalMastic, RoundPlan,
                                   round_inputs)
from ..backend.mastic import BatchedMastic, Mastic, ReportBatch
from ..metrics import (RoundMetrics, attribute_rejections,
                       count_round_bytes, count_round_ops)


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


class IncrementalRunner:
    """Drives backend/incremental.py across the collector loop: keeps
    both aggregators' carries on the device, grows the padded width on
    demand, and folds the level-0 FLP weight check into the accept
    mask."""

    def __init__(self, bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                 batch: ReportBatch, valid: Optional[torch.Tensor] = None,
                 width: int = 8):
        self.bm = bm
        self.verify_key = verify_key
        self.ctx = ctx
        self.batch = batch
        self.device = batch.nonces.device
        self.num_reports = int(batch.nonces.shape[0])
        # Reports excluded from every aggregate: rejected at shard time
        # (`valid` False) or at a round's rejection sampling.
        self.excluded = torch.zeros(self.num_reports, dtype=torch.bool,
                                    device=self.device)
        if valid is not None:
            self.excluded |= ~valid
        self.width = max(4, width)
        self.engine = IncrementalMastic(bm, self.width)
        self.layouts: list = []
        (self.ext_rk, self.conv_rk) = bm.vidpf.roundkeys(ctx, batch.nonces)
        self.carries = [self.engine.init_carry(self.num_reports,
                                               batch.keys[:, a], a)
                        for a in range(2)]
        self.max_width = self.width

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

    def round_stage(self, agg_param) -> dict:
        """Dispatch one round without blocking: both aggregators' tree
        step, the level-0 weight check, the accept combine and the
        masked aggregates.  Returns the handle `round_collect` reads."""
        (level, prefixes, do_weight_check) = agg_param
        plan = self._plan(prefixes, level)
        rnd = round_inputs(plan, self.device)
        ((c0, proof0, out0, ok0), (c1, proof1, out1, ok1)) = \
            self.engine.agg_rounds((0, 1), self.verify_key, self.ctx,
                                   tuple(self.carries), rnd, self.ext_rk,
                                   self.conv_rk, self.batch.cws)
        self.carries = [c0, c1]
        accept = torch.all(proof0 == proof1, dim=-1)
        ok = ok0 & ok1
        if do_weight_check:
            (checks, wc_ok) = self.bm.weight_check_device(
                self.verify_key, self.ctx, level, self.batch,
                c0.w[:, 0, :2], c1.w[:, 0, :2])
            accept = accept & checks["weight_check"]
            if "joint_rand" in checks:
                accept = accept & checks["joint_rand"]
            ok = ok & wc_ok
        self.excluded |= ~ok
        accept = accept & ~self.excluded
        agg = (self.bm.aggregate(out0, accept), self.bm.aggregate(out1, accept))
        self.layouts.append(plan.layout_new)
        return {"agg_param": agg_param, "agg": agg}

    def round_collect(self, handle: dict) -> list:
        """The blocking half: one sync, the unshard and decode.  Returns
        one decoded aggregate per prefix (a weighted count for the
        scalar circuits, a list for the vector ones)."""
        (_level, prefixes, _wc) = handle["agg_param"]
        rows = len(prefixes) * (1 + self.bm.m.valid.OUTPUT_LEN)
        shares = [self.bm.agg_share_to_host(a[:rows]) for a in handle["agg"]]
        return self.bm.m.unshard(shares)


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
            "nodes": sched.total_nodes}


def run_round_collect(bm: BatchedMastic, agg_param, handle: dict,
                      metrics_out: Optional[list] = None) -> list:
    """The blocking half of `run_round_stage`: one sync (the downloads),
    the metrics record and the unshard.  Returns the per-prefix
    aggregates; appends a RoundMetrics record to `metrics_out`."""
    (agg0, agg1, _accept, ok, checks) = handle["out"]
    ok = ok.cpu().numpy()
    checks = {k: v.cpu().numpy() for (k, v) in checks.items()}
    agg_shares = [bm.agg_share_to_host(a) for a in (agg0, agg1)]
    nodes = handle["nodes"]
    return finalize_round(bm, agg_param, ok, checks, agg_shares,
                          padded_width=nodes, nodes_evaluated=nodes,
                          metrics_out=metrics_out)


def run_round(bm: BatchedMastic, verify_key: bytes, ctx: bytes, agg_param,
              batch: ReportBatch, valid: Optional[torch.Tensor] = None,
              metrics_out: Optional[list] = None) -> list:
    """One from-root aggregation round: `run_round_stage` then
    `run_round_collect`."""
    handle = run_round_stage(bm, verify_key, ctx, agg_param, batch, valid)
    return run_round_collect(bm, agg_param, handle, metrics_out=metrics_out)


def finalize_round(bm: BatchedMastic, agg_param, ok: np.ndarray,
                   checks: dict, agg_shares: list, padded_width: int,
                   nodes_evaluated: int, metrics_out: Optional[list]) -> list:
    """The from-root round's host side: the metrics record with the
    rejections attributed per check, then the unshard.  Lanes with `ok`
    False are rejected (the device aggregates already leave them out)
    and counted in `xof_fallbacks` and `rejected_fallback`; the JAX
    package recomputes them through its scalar layer instead."""
    (level, prefixes, _wc) = agg_param
    num_reports = ok.shape[0]
    metrics = RoundMetrics(level=level, frontier_width=len(prefixes),
                           padded_width=padded_width,
                           reports_total=num_reports)
    attribute_rejections(metrics, checks["eval_proof"],
                         checks.get("weight_check"),
                         checks.get("joint_rand"), device_ok=ok)
    count_round_ops(metrics, bm.m, num_reports, nodes_evaluated,
                    include_key_setup=True)
    count_round_bytes(metrics, bm.m, agg_param, num_reports)
    metrics.xof_fallbacks = int((~ok).sum())
    metrics.rejected_fallback = metrics.xof_fallbacks
    if metrics_out is not None:
        metrics_out.append(metrics)
    return bm.m.unshard(agg_shares)


class HeavyHittersRun:
    """A heavy-hitters collection over a device-resident report batch:
    one `step()` per tree level, on the incremental runner or, with
    `incremental=False`, one from-root round a level (which appends a
    RoundMetrics record per level to `metrics`)."""

    def __init__(self, mastic: Mastic, ctx: bytes, thresholds: dict,
                 verify_key: bytes, batch: ReportBatch,
                 valid: Optional[torch.Tensor] = None, device="cuda",
                 incremental: bool = True):
        dev = resolve_device(device)
        if batch.nonces.device.type != dev.type:
            raise ValueError(f"the report batch is not on {dev}")
        self.mastic = mastic
        self.ctx = ctx
        self.thresholds = thresholds
        self.verify_key = verify_key
        self.bm = BatchedMastic(mastic)
        self.batch = batch
        self.valid = valid
        self.runner = (IncrementalRunner(self.bm, verify_key, ctx, batch,
                                         valid) if incremental else None)
        self.metrics: list = []
        # The from-root rounds' lanes left out of the last aggregates.
        self._excluded = np.zeros(int(batch.nonces.shape[0]), bool)
        self.level = 0
        self.prefixes: list = [(False,), (True,)]
        self.prev_agg_params: list = []
        self.heavy_hitters: list = []
        # Per completed level: (prefixes, weighted counts).
        self.level_results: list = []
        self.done = False

    def step(self) -> bool:
        """Run one level's round.  Returns True while more remain."""
        handle = self.step_begin()
        if handle is None:
            return False
        return self.step_finish(handle)

    def step_begin(self) -> Optional[dict]:
        """Dispatch one level's round without blocking; None when no
        rounds remain.  Every handle goes to `step_finish`."""
        if self.done:
            return None
        if not self.prefixes:
            self.done = True
            return None
        agg_param = (self.level, tuple(self.prefixes), self.level == 0)
        if not self.mastic.is_valid(agg_param, self.prev_agg_params):
            raise ValueError("invalid aggregation parameter sequence")
        if self.runner is not None:
            return self.runner.round_stage(agg_param)
        handle = run_round_stage(self.bm, self.verify_key, self.ctx,
                                 agg_param, self.batch, self.valid)
        handle.update(agg_param=agg_param, t0=time.perf_counter())
        return handle

    def step_finish(self, handle: dict) -> bool:
        """Collect the staged round, prune at the threshold, and
        advance the frontier.  Returns True while more rounds remain."""
        (level, prefixes, _wc) = handle["agg_param"]
        if self.runner is not None:
            counts = self.runner.round_collect(handle)
        else:
            counts = run_round_collect(self.bm, handle["agg_param"], handle,
                                       metrics_out=self.metrics)
            self._excluded = ~handle["out"][3].cpu().numpy()
            self.metrics[-1].extra["round_wall_ms"] = \
                (time.perf_counter() - handle["t0"]) * 1e3
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

    def excluded(self) -> np.ndarray:
        """Reports excluded from the aggregates (bool (R,)): so far on
        the incremental runner, in the last round from the root."""
        if self.runner is None:
            return self._excluded
        return self.runner.excluded.cpu().numpy()


def compute_heavy_hitters(mastic: Mastic, ctx: bytes, thresholds: dict,
                          verify_key: bytes, batch: ReportBatch,
                          valid: Optional[torch.Tensor] = None,
                          device="cuda", incremental: bool = True) -> list:
    """The full collector loop over a sharded report batch.  With
    `incremental=False` every level is one round from the root: the
    differential reference of the incremental runner."""
    run = HeavyHittersRun(mastic, ctx, thresholds, verify_key, batch,
                          valid, device, incremental)
    while run.step():
        pass
    return run.result()
