"""Attribute-based metrics: one aggregation at the last level with
hashed attributes as the index space (port of
`mastic_tpu/drivers/attribute_metrics.py`).

Each client's alpha is H(attribute) truncated to BITS; the collector
asks about its attributes of interest, and one weight-checked from-root
round at level BITS-1 (`heavy_hitters.run_round_stage` and
`run_round_collect`: kernel K3 at every depth of the grid, K1 over the
flat tree, on the device) gives each attribute's aggregate.  The
reports arrive as a device-resident `ReportBatch`, from the batched
client shard, or as the scalar reports (`reports=`), which a run given
no batch marshals (`BatchedMastic.marshal_reports`).  The scalar
reports are read for the lanes whose XOF sampling fires, which the
round recomputes through the scalar layer (`splice_rejected`).

With `chunk_size` (or a `HostReportStore`, `store=`) the round streams
the reports through the card in chunks on the pipelined executor of
`drivers/pipeline.py`, so that one chunk's from-root tree is on the
card at a time: from the store, else from a store built from the
batch, else from the scalar reports marshalled chunk by chunk (the JAX
package's source).  The result equals the unchunked round's bit for
bit.

With `mesh` (a `parallel.ReportMesh`; every rank makes the same call)
the round is chunked (without a `chunk_size`, one chunk of every
report, as in the JAX package): each chunk pads to the shard multiple
with dead lanes (its first report repeated), each rank runs the masked
round (`BatchedMastic.round_device_checks` with the `valid` mask that
leaves the dead lanes out: the JAX package's `_round_fn_masked`) over
its rows of it, and the chunk's shares are summed and its masks
gathered over the ranks, so every rank holds the global result and
`RoundMetrics` (with an `extra["mesh"]` block).
"""

import hashlib
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..backend.mastic import BatchedMastic, Mastic, ReportBatch
from ..backend.schedule import LevelSchedule
from . import artifacts
from .chunked import HostReportStore, _host, map_batch
from ..obs import trace as obs_trace
from .heavy_hitters import (_ms, begin_round_obs, end_round_obs,
                            finalize_round, run_round_collect,
                            run_round_stage, stamp_round)
from .pipeline import ChunkedRound, CopyStreams, pipeline_mode


def hash_attribute(mastic: Mastic, attribute: str) -> tuple:
    """SHA3-256 of the attribute, its first BITS bits as the path."""
    bits = mastic.bits
    digest = hashlib.sha3_256(attribute.encode()).digest()
    value = int.from_bytes(digest[:(bits + 7) // 8], "big")
    value >>= (8 - bits % 8) % 8
    return mastic.scalar().vidpf.test_index_from_int(value, bits)


def aggregate_by_attribute(mastic: Mastic, ctx: bytes,
                           attributes: Sequence[str], verify_key: bytes,
                           batch: Optional[ReportBatch] = None,
                           valid: Optional[torch.Tensor] = None,
                           metrics_out: Optional[list] = None,
                           device="cuda",
                           reports: Optional[Sequence] = None,
                           chunk_size: Optional[int] = None,
                           store: Optional[HostReportStore] = None,
                           mesh=None) -> list:
    """Aggregate the reports of `batch` (or the scalar `reports`,
    marshalled, or a `store`) grouped by the collector's attributes of
    interest.  Returns [(attribute, aggregate)]; appends the round's
    RoundMetrics record to `metrics_out`.  `valid` (R,) bool marks
    reports to leave out (e.g. the shard's `ok`); `reports` are the
    scalar reports behind the batch, read for the lanes whose XOF
    sampling fires.  With `chunk_size` or `store` the round streams the
    reports through the card chunk by chunk, with the same result; with
    `mesh` every rank runs it over its rows of each chunk."""
    run = AttributeMetricsRun(mastic, ctx, attributes, verify_key, batch,
                              valid, device, reports, chunk_size, store,
                              mesh)
    while run.step():
        pass
    if metrics_out is not None:
        metrics_out.extend(run.metrics)
    return run.result()


class AttributeMetricsRun:
    """The attribute-metrics mode as a one-step run, with the
    `step` / `step_begin` / `step_finish` interface of HeavyHittersRun.

    `to_bytes()` before the round records only that nothing ran (a
    resumed run runs the round again, one deterministic dispatch over
    the same reports); after the round it records the result, so a
    resumed finished run touches no device.

    With `chunk_size` or `store` the round is chunked
    (`_run_round_chunked`); a store sets the chunk size.  The chunks
    come from the store, else from the batch (a store built from it,
    as HeavyHittersRun builds its own), else from the scalar reports,
    marshalled chunk by chunk; `reports` beside a store or a batch are
    read only for the splice.  With `mesh` the round is chunked, in one
    chunk of every report when no chunk size is given.  A chunked
    round's handle holds the round's final accept and ok masks (R,)
    bool, over every report."""

    def __init__(self, mastic: Mastic, ctx: bytes, attributes: Sequence[str],
                 verify_key: bytes, batch: Optional[ReportBatch] = None,
                 valid: Optional[torch.Tensor] = None, device="cuda",
                 reports: Optional[Sequence] = None,
                 chunk_size: Optional[int] = None,
                 store: Optional[HostReportStore] = None, mesh=None):
        dev = resolve_device(device)
        prefixes = tuple(hash_attribute(mastic, a) for a in attributes)
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("attribute hash collision; increase BITS")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if store is not None and chunk_size not in (None, store.chunk_size):
            raise ValueError(f"chunk_size={chunk_size}, store has "
                             f"{store.chunk_size}")
        self.mastic = mastic
        self.bm = BatchedMastic(mastic)
        self.device = dev
        self.mesh = mesh
        self.chunk_size = (store.chunk_size if store is not None
                           else chunk_size)
        if mesh is not None and self.chunk_size is None:
            self.chunk_size = (int(batch.nonces.shape[0])
                               if batch is not None else len(reports))
        if batch is None and store is None:
            if reports is None:
                raise ValueError("a run needs the report batch or the "
                                 "scalar reports")
            if self.chunk_size is None:
                batch = self.bm.marshal_reports(reports, dev)
        if batch is not None and batch.nonces.device.type != dev.type:
            raise ValueError(f"the report batch is not on {dev}")
        if self.chunk_size is not None and store is None \
                and batch is not None:
            store = HostReportStore.from_batch(batch, self.chunk_size)
        self.store = store
        self.reports = reports
        self.ctx = ctx
        self.attributes = list(attributes)
        self.verify_key = verify_key
        self.batch = batch if self.chunk_size is None else None
        self.valid = valid
        self.prefixes = prefixes
        self.metrics: list = []
        self.obs_tenant = ""   # telemetry label (set by the service)
        self.done = False
        self._result: Optional[list] = None

    def step(self) -> bool:
        """Run the single aggregation round.  Returns False: no more
        rounds.  The round's telemetry is HeavyHittersRun.step's."""
        handle = self.step_begin()
        if handle is None:
            return False
        return self.step_finish(handle)

    def step_begin(self) -> Optional[dict]:
        """Dispatch the round without blocking; None when the run has
        finished.  A chunked round runs whole here (its executor makes
        one wait per chunk): its handle is "atomic"."""
        if self.done:
            return None
        level = self.mastic.bits - 1
        agg_param = (level, self.prefixes, True)
        if not self.mastic.is_valid(agg_param, []):
            raise ValueError("invalid aggregation parameter")
        t0 = time.perf_counter()
        num = (self.store.num_reports if self.store is not None
               else int(self.batch.nonces.shape[0]) if self.batch is not None
               else len(self.reports))
        obs = begin_round_obs(self.obs_tenant, 0, level, len(self.prefixes),
                              num, self.device)
        try:
            with obs_trace.get_tracer().use_parent(obs["span"]):
                if self.chunk_size is not None:
                    handle = _run_round_chunked(
                        self.bm, self.verify_key, self.ctx, agg_param,
                        self.device, self.chunk_size, self.valid,
                        self.metrics, reports=self.reports, store=self.store,
                        mesh=self.mesh)
                else:
                    handle = run_round_stage(self.bm, self.verify_key,
                                             self.ctx, agg_param, self.batch,
                                             self.valid)
        except BaseException as exc:
            end_round_obs(obs, error=exc)
            raise
        handle.update(obs, agg_param=agg_param, t0=t0,
                      atomic=self.chunk_size is not None)
        return handle

    def step_finish(self, handle: dict) -> bool:
        """Collect the round (its one blocking sync), stamp its metrics,
        keep the result.  Returns False: there is exactly one round."""
        result = handle.get("result")
        try:
            if result is None:
                with obs_trace.get_tracer().use_parent(handle["span"]):
                    result = run_round_collect(
                        self.bm, handle["agg_param"], handle,
                        metrics_out=self.metrics, reports=self.reports)
        except BaseException as exc:
            end_round_obs(handle, error=exc)
            raise
        end_round_obs(handle)
        stamp_round(self.metrics[-1], handle["t0"], self.obs_tenant)
        self._result = list(zip(self.attributes, result))
        self.done = True
        return False

    def result(self) -> Optional[list]:
        return self._result

    def frontier(self) -> list:
        """The whole result once the round ran, nothing before."""
        return list(self._result) if self.done else []

    def rounds_completed(self) -> int:
        return 1 if self.done else 0

    # -- checkpoint / resume ----------------------------------------

    def to_bytes(self) -> bytes:
        return json.dumps({
            "done": self.done,
            "result": (None if self._result is None
                       else [[a, v] for (a, v) in self._result]),
        }).encode()

    @classmethod
    def from_bytes(cls, mastic: Mastic, ctx: bytes,
                   attributes: Sequence[str], verify_key: bytes,
                   batch: Optional[ReportBatch], data: bytes,
                   valid: Optional[torch.Tensor] = None, device="cuda",
                   reports: Optional[Sequence] = None,
                   chunk_size: Optional[int] = None,
                   store: Optional[HostReportStore] = None, mesh=None
                   ) -> "AttributeMetricsRun":
        run = cls(mastic, ctx, attributes, verify_key, batch, valid, device,
                  reports, chunk_size, store, mesh)
        state = json.loads(data)
        if state["done"]:
            run.done = True
            run._result = [(a, v) for (a, v) in state["result"]]
        return run


def _run_round_chunked(bm: BatchedMastic, verify_key: bytes, ctx: bytes,
                       agg_param, device: torch.device, chunk_size: int,
                       valid: Optional[torch.Tensor],
                       metrics_out: Optional[list],
                       reports: Optional[Sequence] = None,
                       store: Optional[HostReportStore] = None,
                       mesh=None) -> dict:
    """One from-root round streamed chunk by chunk on the executor of
    `drivers/pipeline.py`, with the unchunked round's result.  A chunk
    comes from the store (padded to chunk_size with dead lanes, which
    the chunk's `valid` slice leaves out) or, with no store, from the
    scalar reports, marshalled on the host (the tail at its own size)
    while the previous chunk computes.  Under a mesh each chunk pads on
    to the shard multiple and each rank takes its rows of it (from the
    reports, it marshals only those).  The uploads run on the copy
    stream, then both preps, the checks and the masked aggregates on
    the card, then the downloads; the chunk's shares and masks cross
    the ranks in the collect.  The per-chunk verdicts and aggregate
    shares are folded on the host, and `finalize_round` (the metrics
    record and the splice; the span `round.finalize`) runs once over
    every report.  Returns the round's handle: the result, and its final
    accept and ok masks."""
    mark = artifacts.stats_mark()
    (level, prefixes, _wc) = agg_param
    num = store.num_reports if store is not None else len(reports)
    pin = device.type == "cuda"
    valid_all = (np.ones(num, bool) if valid is None
                 else valid.cpu().numpy().astype(bool))
    accept_all = np.zeros(num, bool)
    ok_all = np.ones(num, bool)
    checks_all: dict = {}
    bounds = [(lo, min(lo + chunk_size, num))
              for lo in range(0, num, chunk_size)]
    cr = ChunkedRound(CopyStreams(device), bounds, *pipeline_mode(
        len(bounds)), len(prefixes) * (1 + bm.m.valid.OUTPUT_LEN), bm.spec,
        mesh)
    sched = bm.schedule(agg_param, device)
    shards = mesh.shape["reports"] if mesh is not None else 1
    rank = mesh.report_rank if mesh is not None else 0

    def tile(i: int) -> tuple:
        """This rank's rows [a, b) of chunk i padded to the shard
        multiple (a store's chunk from chunk_size, the reports' from
        its own size)."""
        (lo, hi) = bounds[i]
        size = store.chunk_size if store is not None else hi - lo
        per = -(-size // shards)
        return (rank * per, (rank + 1) * per)

    def stage(i: int) -> tuple:
        (lo, hi) = bounds[i]
        (a, b) = tile(i)
        xfer = cr.transfer(i)
        t0 = time.perf_counter()
        live = max(0, min(b, hi - lo) - a)
        keep = np.zeros(b - a, bool)
        keep[:live] = valid_all[lo + a:lo + a + live]
        if store is None:
            lanes = [lo + a + j if j < live else lo for j in range(b - a)]
            host = map_batch(bm.marshal_reports([reports[r] for r in lanes],
                                                "cpu"),
                             lambda t: _host(t, pin))
        with xfer.upload():
            batch = (map_batch(host, xfer.to_device) if store is None
                     else store.device_chunk(i, device, (a, b))[0])
            keep_dev = xfer.to_device(_host(torch.from_numpy(keep), pin))
        t_up = time.perf_counter()
        (agg0, agg1, accept, ok, checks) = bm.round_device_checks(
            verify_key, ctx, agg_param, batch, keep_dev, sched)
        names = sorted(checks)
        shares = torch.stack([agg0, agg1])
        masks = torch.stack([accept, ok] + [checks[k] for k in names], dim=1)
        host_out = xfer.download([(None, shares), (None, masks)])
        # Every device tensor of the chunk stays referenced until
        # collect() has waited for the downloads.
        handle = {"shares": host_out[0], "masks": host_out[1],
                  "names": names,
                  "device": (batch, keep_dev, agg0, agg1, accept, ok,
                             checks, shares, masks)}
        return (handle, {"upload_ms": _ms(t0, t_up),
                         "dispatch_ms": _ms(t_up, time.perf_counter())})

    def collect(i: int, handle: dict) -> dict:
        (lo, hi) = bounds[i]

        def fold(masks: np.ndarray) -> None:
            (accept, ok, *per_check) = masks.T
            ok_all[lo:hi] = ok
            accept_all[lo:hi] = accept
            for (name, mask) in zip(handle["names"], per_check):
                checks_all.setdefault(name, np.zeros(num, bool))[lo:hi] = \
                    mask

        return cr.collect(i, handle, fold)

    timeline = cr.run(stage, collect)
    nodes = LevelSchedule(prefixes, level, bm.m.bits).total_nodes
    records: list = []
    with obs_trace.get_tracer().span("round.finalize"):
        result = finalize_round(bm, verify_key, ctx, agg_param, reports,
                                ok_all, accept_all, checks_all, cr.agg_shares,
                                padded_width=nodes, nodes_evaluated=nodes,
                                metrics_out=records, valid=valid_all,
                                mark=mark)
    records[0].extra.update({"chunk_size": chunk_size, "chunks": timeline,
                             "pipeline": cr.pipeline_block()})
    if mesh is not None:
        (a, b) = tile(0)
        records[0].extra["mesh"] = cr.mesh_block((b - a) * shards)
    if metrics_out is not None:
        metrics_out.extend(records)
    return {"result": result, "accept": accept_all, "ok": ok_all}
