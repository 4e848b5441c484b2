"""The attribute-metrics mode: aggregation jobs back to back, each one
`AttributeMetricsRun` (`drivers/attribute_metrics.py`): one
weight-checked round from the root at the last level over the hashed
attributes of interest.  Without a "chunk_size" in the cell's
parameters the batch is resident on the card; with one, the batch is
the aggregator's upload store in pinned host memory
(`HostReportStore`) and the round streams it through the card in
chunks of that size on the pipelined executor.

Set-up shards every batch of the traffic's pool on the card (each with
its tampered reports, in the batch and in the lazy scalar reports the
splice reads), moves it to its store where the cell is chunked, and
warms the kernels with one job on the first batch.
The window takes the batches in turn from the second, so that no job
repeats the inputs of the job before it, and closes at the end of the
first job that ends after `seconds`.  With `--trace 1` the device
trace covers one more job after those: once the profiler has run, the
process's launches stay slower (a job ~30% longer), so the host-clock
readers read the untraced jobs before it.  A job is
`step_begin` and `step_finish`, the two halves of `step()`, so that
the round's accept mask can be read from its handle.

What is compared (`check`) against the plain reference
(`reference/attributes.py`): each job's per-attribute aggregates (a
weight sum, or a histogram's bucket counts), every report's verdict,
and the rejections per check (those the device attributed and those of
the lanes the splice recomputed, together).
"""

import time

import numpy as np

from .. import bounds, system
from ..reference import attributes as ref


def setup(cell: dict, config: dict, traffic, device, trace) -> dict:
    import torch

    from mastic_tpu_torch.backend.mastic import BatchedMastic
    from mastic_tpu_torch.drivers.chunked import HostReportStore

    mastic = system.instantiate(config)
    bm = BatchedMastic(mastic)
    chunk = cell["params"].get("chunk_size")
    pool = []
    fired = []
    with trace.span("setup.shard"):
        for t in traffic.batches:
            reports = system.ScalarReports(mastic, t)
            (batch, lanes) = system.shard(bm, t, reports, device,
                                          cell["params"]["shard_chunk"])
            if chunk is not None:
                batch = HostReportStore.from_batch(batch, chunk)
            pool.append((batch, reports))
            fired += lanes
    state = {"mastic": mastic, "pool": pool, "traffic": traffic,
             "device": device, "shard_fired": fired,
             "source": "batch" if chunk is None else "store",
             "chunk_size": chunk, "buckets": config.get("buckets"),
             "value_len": config["value_len"],
             "limbs": bounds.LIMBS[config["field"]],
             "reports_n": len(traffic.batches[0].weights)}
    with trace.span("setup.warm"):
        job(state, 0, trace)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return state


def job(state: dict, b: int, trace) -> dict:
    from mastic_tpu_torch.drivers.attribute_metrics import \
        AttributeMetricsRun

    (source, reports) = state["pool"][b]
    t0 = time.perf_counter()
    with trace.span("attr.new_run"):
        run = AttributeMetricsRun(state["mastic"], system.CTX,
                                  state["traffic"].attributes,
                                  state["traffic"].verify_key,
                                  device=state["device"], reports=reports,
                                  **{state["source"]: source})
    with trace.span("attr.step_begin"):
        handle = run.step_begin()
    with trace.span("attr.step_finish"):
        run.step_finish(handle)
    m = run.metrics[-1]
    return {"batch": b, "sums": [(a, _plain(v)) for (a, v) in run.result()],
            "accept": np.asarray(handle["accept"], bool).copy(),
            "accepted": m.accepted,
            "rejected": {"eval_proof": m.rejected_eval_proof,
                         "weight_check": m.rejected_weight_check,
                         "joint_rand": m.rejected_joint_rand},
            "rejected_fallback_by": dict(m.extra["rejected_fallback_by"]),
            "xof_fallbacks": m.xof_fallbacks,
            "splice_ms": m.extra["splice_ms"],
            "dispatch_ms": (sum(c["phases"]["dispatch_ms"]
                                for c in m.extra["chunks"])
                            if "chunks" in m.extra else None),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


def _plain(value):
    """An attribute's aggregate as plain ints: a weight sum, or a
    histogram's list of bucket counts."""
    if isinstance(value, (list, tuple)):
        return [int(v) for v in value]
    return int(value)


def window(state: dict, seconds: float, trace) -> dict:
    import torch

    jobs = []
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        jobs.append(job(state, (len(jobs) + 1) % len(state["pool"]), trace))
    window_s = time.perf_counter() - t_start
    traced_from = len(jobs)
    on_card = state["device"].type == "cuda"
    if on_card:
        torch.cuda.synchronize(state["device"])
    trace.start()
    if trace.enabled:
        jobs.append(job(state, (len(jobs) + 1) % len(state["pool"]), trace))
        torch.cuda.synchronize(state["device"])
    trace.stop()
    return {"jobs": jobs, "traced_from": traced_from, "seconds": window_s}


def _reference(state: dict, b: int):
    refs = state.setdefault("reference", {})
    if b not in refs:
        t = state["traffic"].batches[b]
        paths = np.stack([_path(state, a)
                          for a in state["traffic"].attributes])
        refs[b] = ref.job(state["traffic"].attributes, paths, t.alphas,
                          t.weights, t.tamper_cw, t.tamper_proof,
                          state["buckets"])
    return refs[b]


def _path(state: dict, attribute: str) -> np.ndarray:
    from ..traffic import hash_path

    return hash_path(attribute, state["mastic"].bits)


def end_to_end(state: dict, result: dict) -> dict:
    return {"attr_reports_per_s": (
        state["reports_n"] * len(result["jobs"]) / result["seconds"],
        "reports/s")}


def check(state: dict, result: dict) -> dict:
    """The numbers compared with the reference, each with its limit;
    the jobs attempted, and those that failed."""
    (bad_sums, bad_verdicts, bad_rejections, failed) = (0, 0, 0, 0)
    for j in result["jobs"]:
        want = _reference(state, j["batch"])
        sums = j["sums"] != want.sums
        verdicts = int((j["accept"] != want.accept).sum()) \
            if j["accept"].shape == want.accept.shape else len(want.accept)
        fb = j["rejected_fallback_by"]
        got = {k: j["rejected"][k] + fb.get(k, 0) for k in j["rejected"]}
        rejections = (got != dict(want.rejected, joint_rand=0)
                      or j["accepted"] != int(want.accept.sum()))
        bad_sums += sums
        bad_verdicts += verdicts
        bad_rejections += rejections
        failed += bool(sums or verdicts or rejections)
    return {"compared": {"jobs_sums_mismatched": (bad_sums, 0),
                         "verdicts_mismatched": (bad_verdicts, 0),
                         "jobs_rejections_mismatched": (bad_rejections, 0)},
            "attempted": len(result["jobs"]), "failed": failed}


def counts(state: dict, result: dict) -> dict:
    walls = [j["wall_ms"] for j in result["jobs"]]
    return {"jobs": len(result["jobs"]), "reports": state["reports_n"],
            "job_ms_quartiles": [float(q) for q in
                                 np.percentile(walls, [25, 50, 75])],
            "shard_fired": len(state["shard_fired"]),
            "xof_fallbacks": sum(j["xof_fallbacks"] for j in result["jobs"]),
            "splice_s": sum(j["splice_ms"] for j in result["jobs"]) / 1e3}


def layer_context(state: dict, result: dict) -> dict:
    """The traced jobs, each with the bound ms of K1 and K3 for the
    round's shape (summed over its chunks where it is chunked), and the
    jobs after them (host-clock readings)."""
    paths = np.stack([_path(state, a) for a in state["traffic"].attributes])
    (R, chunk) = (state["reports_n"], state["chunk_size"] or
                  state["reports_n"])
    parts = [bounds.from_root_round(paths, min(chunk, R - lo),
                                    state["value_len"], len(system.CTX),
                                    state["limbs"])
             for lo in range(0, R, chunk)]
    bound = {k: sum(p[k] for p in parts) for k in parts[0]}
    traced = result["jobs"][result["traced_from"]:]
    for j in traced:
        j["bound_ms"] = bound
    rest = result["jobs"][:result["traced_from"]]
    return {"mode": "attribute_metrics", "rounds": rest or traced,
            "traced": traced}
