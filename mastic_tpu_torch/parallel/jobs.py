"""Rank programs for `parallel.launch.spawn`: what each rank of a report
mesh runs for the multichip tool (`tools/multichip.py`) and the CPU
tests.  Each takes the mesh and one `case` dict of picklable inputs
(scalar reports, bytes, numpy arrays; the instantiation as its class
name and arguments) and returns a picklable summary, the same on every
rank.

`run_all` runs several cases in one group, so that one spawn serves a
whole suite; `force` clears aggregator 0's `ok` for one report at one
level (`IncrementalMastic.agg_rounds` wrapped, matched by the report's
round keys, so it finds the lane on whichever rank holds it), to drive
the XOF-rejection splice as the CPU tests and the card's smoke do.
"""

import dataclasses
import sys
from contextlib import contextmanager
from typing import Optional

import torch

from ..backend import mastic as backend_mastic
from ..backend.incremental import IncrementalMastic
from ..drivers.attribute_metrics import AttributeMetricsRun
from ..drivers.heavy_hitters import HeavyHittersRun
from ..ops import kernels
from .mesh import gather_rows, sharded_gen, sharded_prep, sharded_round


def mastic_of(spec: tuple):
    """The port's instantiation from (class name, arguments)."""
    (name, args) = spec
    return getattr(backend_mastic, name)(*args)


def counters(m) -> dict:
    """A RoundMetrics record's counters (every field but `extra`)."""
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if f.name != "extra"}


@contextmanager
def force(bm, ctx: bytes, forced: Optional[tuple]):
    """With forced = (nonce, level): aggregator 0's `ok` is False at
    `level` on every lane whose round keys are those of `nonce` (the
    report, and any dead lane that copies it)."""
    if forced is None:
        yield
        return
    (nonce, level) = forced
    (target, _conv) = bm.vidpf.roundkeys(
        ctx, torch.tensor(list(nonce), dtype=torch.uint8)[None])
    real = IncrementalMastic.agg_rounds

    def agg_rounds(self, agg_ids, verify_key, ctx, carries, rnd, ext_rk,
                   *args):
        out = real(self, agg_ids, verify_key, ctx, carries, rnd, ext_rk,
                   *args)
        if rnd.level == level:
            (carry, proof, share, ok) = out[0]
            hit = (ext_rk == target.to(ext_rk.device)).flatten(1).all(dim=1)
            out[0] = (carry, proof, share, ok & ~hit)
        return out

    IncrementalMastic.agg_rounds = agg_rounds
    try:
        yield
    finally:
        IncrementalMastic.agg_rounds = real


def heavy_hitters(mesh, case: dict) -> dict:
    """A `HeavyHittersRun` over `case["reports"]` on the mesh: resident,
    or chunked with `chunk_size`; resumed from `resume` (checkpoint
    bytes) if given; checkpointed before level `split` if given; with
    the lane `force` names forced.  Returns every level's (prefixes,
    aggregates), the heavy hitters, each level's counters, `mesh` and
    `pipeline` blocks and whole `extra`, the checkpoint and the final
    state (`to_bytes` after the last level)."""
    m = mastic_of(case["mastic"])
    (ctx, vk, thresholds) = (case["ctx"], case["verify_key"],
                             case["thresholds"])
    kw = dict(device=mesh.device, reports=case["reports"], mesh=mesh)
    if case.get("resume") is not None:
        run = HeavyHittersRun.from_bytes(m, ctx, thresholds, vk, None,
                                         case["resume"], **kw)
    else:
        run = HeavyHittersRun(m, ctx, thresholds, vk,
                              chunk_size=case.get("chunk_size"), **kw)
    checkpoint = None
    with force(run.bm, ctx, case.get("force")):
        while not run.done:
            if run.level == case.get("split"):
                checkpoint = run.to_bytes()
            run.step()
    return {"levels": run.level_results, "result": run.result(),
            "counters": [counters(x) for x in run.metrics],
            "mesh": [x.extra.get("mesh") for x in run.metrics],
            "pipeline": [x.extra.get("pipeline") for x in run.metrics],
            "extras": [x.extra for x in run.metrics],
            "checkpoint": checkpoint, "final": run.to_bytes()}


def attribute(mesh, case: dict) -> dict:
    """`AttributeMetricsRun` (what `aggregate_by_attribute` steps) over
    `case["reports"]` on the mesh, chunked with `chunk_size` if given:
    the result, the counters, the final accept and ok masks, the `mesh`
    block and the whole `extra`."""
    m = mastic_of(case["mastic"])
    run = AttributeMetricsRun(m, case["ctx"], case["attributes"],
                              case["verify_key"], device=mesh.device,
                              reports=case["reports"],
                              chunk_size=case.get("chunk_size"), mesh=mesh)
    handle = run.step_begin()
    run.step_finish(handle)
    rec = run.metrics[0]
    return {"result": run.result(), "counters": counters(rec),
            "rejected_fallback_by": rec.extra["rejected_fallback_by"],
            "accept": handle["accept"], "ok": handle["ok"],
            "mesh": rec.extra["mesh"], "extra": rec.extra}


def gen(mesh, case: dict) -> dict:
    """`sharded_gen` over the case's numpy inputs (alphas, betas,
    nonces, rand): every rank's outputs gathered, as numpy."""
    bm = backend_mastic.BatchedMastic(mastic_of(case["mastic"]))
    inputs = [torch.as_tensor(case[k], device=mesh.device)
              for k in ("alphas", "betas", "nonces", "rand")]
    (cws, keys, ok) = sharded_gen(bm, mesh, case["ctx"])(*inputs)
    return {"cws": [gather_rows(mesh, t).numpy() for t in cws],
            "keys": gather_rows(mesh, keys).numpy(),
            "ok": gather_rows(mesh, ok).numpy()}


def prep(mesh, case: dict) -> list:
    """`sharded_prep` of the leader (aggregator 0) over the case's
    scalar reports: its out shares, eval proofs and ok mask, every
    rank's rows gathered, as numpy."""
    bm = backend_mastic.BatchedMastic(mastic_of(case["mastic"]))
    batch = bm.marshal_reports(case["reports"], mesh.device)
    out = sharded_prep(bm, mesh, 0, case["verify_key"], case["ctx"],
                       case["agg_param"])(
        batch.nonces, batch.cws, batch.keys[:, 0],
        proof_shares=batch.leader_proofs)
    return [gather_rows(mesh, t).numpy()
            for t in (out.out_share, out.eval_proof, out.ok)]


def round_from_root(mesh, case: dict) -> dict:
    """`sharded_round` over the case's scalar reports: (agg_share0,
    agg_share1, accept, ok) as numpy, the same on every rank."""
    bm = backend_mastic.BatchedMastic(mastic_of(case["mastic"]))
    batch = bm.marshal_reports(case["reports"], mesh.device)
    out = sharded_round(bm, mesh, case["verify_key"], case["ctx"],
                        case["agg_param"])(batch)
    return [t.numpy() for t in out]


def modules(mesh, case: Optional[dict] = None) -> list:
    """The modules of jax or of the JAX package loaded in this rank."""
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in ("jax", "mastic_tpu"))


def run_all(mesh, cases: list) -> list:
    """Each (job name, case) of `cases` in turn: [(result, the job's
    kernel launches)]."""
    out = []
    for (name, case) in cases:
        kernels.reset_launches()
        out.append((globals()[name](mesh, case), dict(kernels.launches)))
    return out
