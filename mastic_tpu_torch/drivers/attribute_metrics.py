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
round recomputes through the scalar layer (`splice_rejected`).  The
JAX package's chunked round (`chunk_size`) and mesh round (`mesh`) are
not ported yet.
"""

import hashlib
import json
import time
from typing import Optional, Sequence

import torch

from .. import resolve_device
from ..backend.mastic import BatchedMastic, Mastic, ReportBatch
from .heavy_hitters import run_round_collect, run_round_stage


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
                           reports: Optional[Sequence] = None) -> list:
    """Aggregate the reports of `batch` (or the scalar `reports`,
    marshalled) grouped by the collector's attributes of interest.
    Returns [(attribute, aggregate)]; appends the round's RoundMetrics
    record to `metrics_out`.  `valid` (R,) bool marks reports to leave
    out (e.g. the shard's `ok`); `reports` are the scalar reports behind
    the batch, read for the lanes whose XOF sampling fires."""
    run = AttributeMetricsRun(mastic, ctx, attributes, verify_key, batch,
                              valid, device, reports)
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
    resumed finished run touches no device."""

    def __init__(self, mastic: Mastic, ctx: bytes, attributes: Sequence[str],
                 verify_key: bytes, batch: Optional[ReportBatch] = None,
                 valid: Optional[torch.Tensor] = None, device="cuda",
                 reports: Optional[Sequence] = None):
        dev = resolve_device(device)
        prefixes = tuple(hash_attribute(mastic, a) for a in attributes)
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("attribute hash collision; increase BITS")
        self.mastic = mastic
        self.bm = BatchedMastic(mastic)
        if batch is None:
            if reports is None:
                raise ValueError("a run needs the report batch or the "
                                 "scalar reports")
            batch = self.bm.marshal_reports(reports, dev)
        if batch.nonces.device.type != dev.type:
            raise ValueError(f"the report batch is not on {dev}")
        self.reports = reports
        self.ctx = ctx
        self.attributes = list(attributes)
        self.verify_key = verify_key
        self.batch = batch
        self.valid = valid
        self.prefixes = prefixes
        self.metrics: list = []
        self.done = False
        self._result: Optional[list] = None

    def step(self) -> bool:
        """Run the single aggregation round.  Returns False: no more
        rounds."""
        handle = self.step_begin()
        if handle is None:
            return False
        return self.step_finish(handle)

    def step_begin(self) -> Optional[dict]:
        """Dispatch the round without blocking; None when the run has
        finished."""
        if self.done:
            return None
        agg_param = (self.mastic.bits - 1, self.prefixes, True)
        if not self.mastic.is_valid(agg_param, []):
            raise ValueError("invalid aggregation parameter")
        t0 = time.perf_counter()
        handle = run_round_stage(self.bm, self.verify_key, self.ctx,
                                 agg_param, self.batch, self.valid)
        handle.update(agg_param=agg_param, t0=t0)
        return handle

    def step_finish(self, handle: dict) -> bool:
        """Collect the round (its one blocking sync), stamp its metrics,
        keep the result.  Returns False: there is exactly one round."""
        result = run_round_collect(self.bm, handle["agg_param"], handle,
                                   metrics_out=self.metrics,
                                   reports=self.reports)
        self.metrics[-1].extra["round_wall_ms"] = \
            (time.perf_counter() - handle["t0"]) * 1e3
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
                   reports: Optional[Sequence] = None
                   ) -> "AttributeMetricsRun":
        run = cls(mastic, ctx, attributes, verify_key, batch, valid, device,
                  reports)
        state = json.loads(data)
        if state["done"]:
            run.done = True
            run._result = [(a, v) for (a, v) in state["result"]]
        return run
