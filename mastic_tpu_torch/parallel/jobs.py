"""Rank programs for `parallel.launch.spawn`: what each rank of a report
mesh runs for the multichip tool (`tools/multichip.py`), the north-star
and serve tools (`--mesh`) and the CPU tests.  Each takes the mesh and
one `case` dict of picklable inputs (scalar reports, bytes, numpy
arrays; the instantiation as its class name and arguments), or for
`northstar` and `serve` the tool's parsed command line, and returns a
picklable summary, the same on every rank (`serve`: rank 0's line is
the tool's).

`run_all` runs several cases in one group, so that one spawn serves a
whole suite; `force` clears aggregator 0's `ok` for one report at one
level (`IncrementalMastic.agg_rounds` wrapped, matched by the report's
round keys, so it finds the lane on whichever rank holds it), or in a
from-root walk on one node rank, to drive the XOF-rejection splice as
the CPU tests and the card's smoke do.

A case with `nodes_axis` k > 1 runs on a second mesh over the same
ranks, `make_mesh(nodes_axis=k)`, with `install_grid_sharding` on its
from-root rounds.
"""

import dataclasses
import sys
from contextlib import contextmanager
from typing import Optional

import torch

from ..backend import mastic as backend_mastic
from ..backend.incremental import IncrementalMastic
from ..drivers.attribute_metrics import AttributeMetricsRun
from ..drivers.heavy_hitters import (HeavyHittersRun, run_round_collect,
                                     run_round_stage)
from ..ops import kernels
from .grid import install_grid_sharding
from .mesh import (gather_rows, make_mesh, sharded_gen, sharded_prep,
                   sharded_round)


def mastic_of(spec: tuple):
    """The port's instantiation from (class name, arguments)."""
    (name, args) = spec
    return getattr(backend_mastic, name)(*args)


def counters(m) -> dict:
    """A RoundMetrics record's counters (every field but `extra`)."""
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if f.name != "extra"}


def node_mesh(mesh, case: dict):
    """The case's mesh: `mesh` itself, or with `nodes_axis` k > 1 a
    (world / k reports x k nodes) mesh over the same ranks."""
    nodes = case.get("nodes_axis", 1)
    if nodes == 1:
        return mesh
    return make_mesh(mesh.world, nodes_axis=nodes, device=mesh.device)


def split_engine(mesh, case: dict):
    """The case's BatchedMastic on `mesh`, its from-root rounds split
    over the node axis when the mesh has one."""
    bm = backend_mastic.BatchedMastic(mastic_of(case["mastic"]))
    install_grid_sharding(bm, mesh)
    return bm


def forced_here(mesh, case: dict) -> Optional[tuple]:
    """The case's `force`, on the node rank `force_node` only when the
    case names one."""
    node = case.get("force_node")
    if node is not None and node != mesh.node_rank:
        return None
    return case.get("force")


@contextmanager
def force(bm, ctx: bytes, forced: Optional[tuple]):
    """With forced = (nonce, level): aggregator 0's `ok` is False at
    `level` on every lane whose round keys are those of `nonce` (the
    report, and any dead lane that copies it).  With level None: the
    from-root walk's `ok` (`bm.vidpf.eval_full`) is False on those
    lanes, for both aggregators."""
    if forced is None:
        yield
        return
    (nonce, level) = forced
    if level is None:
        vidpf = bm.vidpf
        real_eval = vidpf.eval_full

        def eval_full(agg_id, cws, keys, sched, ctx, nonces):
            (w, proof, out_w, ok) = real_eval(agg_id, cws, keys, sched, ctx,
                                              nonces)
            hit = (nonces == torch.tensor(list(nonce), dtype=torch.uint8,
                                          device=nonces.device)).all(dim=1)
            return (w, proof, out_w, ok & ~hit)

        vidpf.eval_full = eval_full
        try:
            yield
        finally:
            del vidpf.eval_full
        return
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
    """A `HeavyHittersRun` over `case["reports"]` on the case's mesh
    (`node_mesh`: the node ranks repeat their report block's work; the
    incremental engine is not split): resident, or chunked with
    `chunk_size`; resumed from `resume` (checkpoint bytes) if given;
    checkpointed before level `split` if given; with the lane `force`
    names forced.  Returns every level's (prefixes,
    aggregates), the heavy hitters, each level's counters, `mesh` and
    `pipeline` blocks and whole `extra`, the checkpoint and the final
    state (`to_bytes` after the last level)."""
    m = mastic_of(case["mastic"])
    mesh = node_mesh(mesh, case)
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
    `case["reports"]` on the case's mesh (`node_mesh`, its round split
    over the node axis), chunked with `chunk_size` if given, with the
    lane `force` names forced: the result, the counters, the final
    accept and ok masks, the `mesh` block and the whole `extra`."""
    m = mastic_of(case["mastic"])
    mesh = node_mesh(mesh, case)
    run = AttributeMetricsRun(m, case["ctx"], case["attributes"],
                              case["verify_key"], device=mesh.device,
                              reports=case["reports"],
                              chunk_size=case.get("chunk_size"), mesh=mesh)
    install_grid_sharding(run.bm, mesh)
    with force(run.bm, case["ctx"], forced_here(mesh, case)):
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
    scalar reports on the case's mesh (`node_mesh`, split over the node
    axis): its out shares, eval proofs and ok mask, every report rank's
    rows gathered, as numpy."""
    mesh = node_mesh(mesh, case)
    bm = split_engine(mesh, case)
    batch = bm.marshal_reports(case["reports"], mesh.device)
    out = sharded_prep(bm, mesh, 0, case["verify_key"], case["ctx"],
                       case["agg_param"])(
        batch.nonces, batch.cws, batch.keys[:, 0],
        proof_shares=batch.leader_proofs)
    return [gather_rows(mesh, t).numpy()
            for t in (out.out_share, out.eval_proof, out.ok)]


def round_from_root(mesh, case: dict) -> dict:
    """`sharded_round` over the case's scalar reports on the case's mesh
    (`node_mesh`, split over the node axis): (agg_share0, agg_share1,
    accept, ok) as numpy, the same on every rank."""
    mesh = node_mesh(mesh, case)
    bm = split_engine(mesh, case)
    batch = bm.marshal_reports(case["reports"], mesh.device)
    out = sharded_round(bm, mesh, case["verify_key"], case["ctx"],
                        case["agg_param"])(batch)
    return [t.numpy() for t in out]


def run_round(mesh, case: dict) -> dict:
    """`heavy_hitters.run_round` (its stage and collect) over the case's
    scalar reports, its round split over the case's mesh's node axis
    (every report rank runs the whole batch), with the lane `force`
    names forced: the result, the counters and the round's accept and ok
    masks (ok as the device returned it, before the splice)."""
    mesh = node_mesh(mesh, case)
    bm = split_engine(mesh, case)
    batch = bm.marshal_reports(case["reports"], mesh.device)
    with force(bm, case["ctx"], forced_here(mesh, case)):
        handle = run_round_stage(bm, case["verify_key"], case["ctx"],
                                 case["agg_param"], batch)
    records: list = []
    result = run_round_collect(bm, case["agg_param"], handle,
                               metrics_out=records, reports=case["reports"])
    return {"result": result, "counters": counters(records[0]),
            "accept": handle["accept"], "ok": handle["out"][3].cpu().numpy()}


def northstar(mesh, args) -> dict:
    """The north-star tool's collection on this rank (`args` its parsed
    command line): each rank shards its rows of every chunk, and every
    rank returns the same line and heavy hitters."""
    from ..tools.northstar import collection

    return collection(args, mesh)


def serve(mesh, args) -> dict:
    """The serve tool's service on this rank (`args` its parsed command
    line, `tools.serve --mesh`): the rank's JSON line (rank 0's is the
    tool's)."""
    from ..tools.serve import run

    return run(args, mesh.device, mesh)


def service(mesh, case: dict) -> dict:
    """A `CollectorService` on the mesh (or, with `mesh` None, in this
    process on `case["device"]`): tenants `case["tenants"]` (TenantSpec
    fields) under `case["config"]` (ServiceConfig fields); each tenant's
    `case["uploads"]` (upload blobs) submitted and one epoch cut, on
    every rank, or on rank 0 alone with `lead_admits`; then stepped
    until drained.  With `split` (quanta) and `snapshot` (a path), rank 0
    writes `to_bytes` after that many quanta (every rank takes it: it
    gathers the carries) and every rank continues in a service restored
    from that one file.  With `expire` = (tenant, levels), rank 0 alone
    finds that tenant's epoch deadline expired once it has completed
    that many levels.  Returns each tenant's epoch records without their
    wall times, and the quanta stepped."""
    from ..drivers.service import CollectorService, ServiceConfig, TenantSpec
    from ..drivers.session import Deadline
    from ..tools.serve import strip_wall

    device = mesh.device if mesh is not None else case["device"]
    lead = mesh is None or mesh.rank == 0
    specs = [TenantSpec(**t) for t in case["tenants"]]
    svc = CollectorService(specs, config=ServiceConfig(**case["config"]),
                           mesh=mesh, device=device)
    if lead or not case.get("lead_admits"):
        for (name, blobs) in case["uploads"].items():
            for blob in blobs:
                svc.submit(name, blob)
            svc.begin_epoch(name)
    (quanta, more) = (0, True)
    while more:
        if quanta == case.get("split"):
            blob = svc.to_bytes()
            if lead:
                with open(case["snapshot"], "wb") as f:
                    f.write(blob)
            if mesh is not None:
                mesh.broadcast(None)   # the file is written
            with open(case["snapshot"], "rb") as f:
                svc = CollectorService.from_bytes(
                    f.read(), config=ServiceConfig(**case["config"]),
                    mesh=mesh, device=device)
        more = svc.step()
        quanta += 1
        if lead and case.get("expire") is not None:
            (name, levels) = case["expire"]
            epoch = svc.tenants[name].active
            if epoch is not None and epoch.run is not None \
                    and epoch.run.rounds_completed() >= levels:
                epoch.deadline = Deadline(0.0)
    return {"records": {name: strip_wall(t["epochs"]) for (name, t)
                        in svc.metrics()["tenants"].items()},
            "quanta": quanta}


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
