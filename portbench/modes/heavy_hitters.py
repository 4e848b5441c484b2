"""The heavy-hitters mode: whole collections back to back on the resident
runner, each a fresh `HeavyHittersRun` (`drivers/heavy_hitters.py`)
stepped level by level from level 0.

Set-up shards the traffic's one batch on the card (the pool), builds
the lazy scalar reports the splice reads, and warms up with one whole
collection that is then dropped, since a collection's first pass
through the deep levels grows the device and pinned host allocators'
pools (a first collection runs ~30% slower than the next).  The window
starts collection after collection over the same batch; it closes at
the end of the first collection that ends after `seconds`, or, when a
collection is still running at twice `seconds` (a lane whose XOF
sampling fired sends every later round of its collection through the
pure-Python splice), after the round then running.  The run's
construction (carry allocation, round keys) and every round's width
growth are inside the window: every collection pays them.  With
`--trace 1` the device trace covers the window's first collection.

What is compared (`check`) against the plain reference
(`reference/heavy_hitters.py`): every round's candidate prefixes, their
unsharded aggregates and the accept count; and each whole collection's
heavy hitters.  The node evaluations behind `hh_evals_per_s` are
counted from the reference's frontier.
"""

import time

import numpy as np

from .. import bounds, system
from ..reference import heavy_hitters as ref


def setup(cell: dict, config: dict, traffic, device, trace) -> dict:
    import torch

    from mastic_tpu_torch.backend.mastic import BatchedMastic

    mastic = system.instantiate(config)
    bm = BatchedMastic(mastic)
    (batch_traffic,) = traffic.batches
    reports = system.ScalarReports(mastic, batch_traffic)
    with trace.span("setup.shard"):
        (batch, fired) = system.shard(bm, batch_traffic, reports, device,
                                      cell["params"]["shard_chunk"])
    state = {"mastic": mastic, "batch": batch, "reports": reports,
             "traffic": traffic, "device": device, "shard_fired": fired,
             "thresholds": {"default": traffic.threshold},
             "value_len": config["value_len"],
             "limbs": bounds.LIMBS[config["field"]],
             "reports_n": len(batch_traffic.weights)}
    with trace.span("setup.warm"):
        run = new_run(state)
        while run.step():
            pass
        del run
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return state


def new_run(state: dict):
    from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun

    return HeavyHittersRun(state["mastic"], system.CTX, state["thresholds"],
                           state["traffic"].verify_key, state["batch"],
                           device=state["device"], reports=state["reports"])


def window(state: dict, seconds: float, trace) -> dict:
    import torch

    collections = []
    trace.start()
    t_start = time.perf_counter()
    cut = False
    while not cut:
        with trace.span("hh.new_run"):
            run = new_run(state)
        rounds = []
        more = True
        while more:
            t0 = time.perf_counter()
            with trace.span("hh.step"):
                more = run.step()
            wall_ms = (time.perf_counter() - t0) * 1e3
            m = run.metrics[-1]
            (prefixes, counts) = run.level_results[-1]
            phases = m.extra["pipeline"]["phases"]
            rounds.append({
                "level": m.level, "prefixes": prefixes,
                "counts": [int(c) for c in counts], "accepted": m.accepted,
                "wall_ms": wall_ms,
                "enqueue_ms": phases["upload_ms"] + phases["dispatch_ms"],
                "splice_ms": m.extra["splice_ms"],
                "xof_fallbacks": m.xof_fallbacks})
            if more and time.perf_counter() - t_start >= 2 * seconds:
                cut = True
                break
        collections.append({"rounds": rounds,
                            "hitters": run.result() if run.done else None})
        del run
        if len(collections) == 1:
            if state["device"].type == "cuda":
                torch.cuda.synchronize(state["device"])
            trace.stop()
        if time.perf_counter() - t_start >= seconds:
            cut = True
    if state["device"].type == "cuda":
        torch.cuda.synchronize(state["device"])
    return {"collections": collections,
            "seconds": time.perf_counter() - t_start}


def _reference(state: dict):
    if "reference" not in state:
        t = state["traffic"].batches[0]
        state["reference"] = ref.collection(t.alphas, t.weights,
                                            state["traffic"].threshold)
    return state["reference"]


def rounds(result: dict) -> list:
    return [r for c in result["collections"] for r in c["rounds"]]


def end_to_end(state: dict, result: dict) -> dict:
    reference = _reference(state)
    evals = ref.node_evals(reference.rounds, state["reports_n"])
    done = rounds(result)
    walls = [r["wall_ms"] for r in done]
    return {
        "hh_evals_per_s": (sum(evals[r["level"]] for r in done)
                           / result["seconds"], "evals/s"),
        "hh_round_p95_ms": (float(np.percentile(walls, 95)), "ms"),
    }


def check(state: dict, result: dict) -> dict:
    """The numbers compared with the reference, each with its limit;
    the rounds attempted, and those that failed."""
    reference = _reference(state)
    bad_rounds = 0
    for r in rounds(result):
        want = reference.rounds[r["level"]] \
            if r["level"] < len(reference.rounds) else None
        got = np.array(r["prefixes"], bool)
        if want is None or got.shape != want.prefixes.shape \
                or not np.array_equal(got, want.prefixes) \
                or r["counts"] != want.counts.tolist() \
                or r["accepted"] != want.accepted:
            bad_rounds += 1
    whole = [c for c in result["collections"] if c["hitters"] is not None]
    want_hh = {tuple(bool(b) for b in row)
               for row in reference.heavy_hitters}
    bad_coll = sum(set(c["hitters"]) != want_hh for c in whole)
    return {"compared": {"rounds_mismatched": (bad_rounds, 0),
                         "collections_mismatched": (bad_coll, 0)},
            "attempted": len(rounds(result)), "failed": bad_rounds}


def counts(state: dict, result: dict) -> dict:
    done = rounds(result)
    return {"collections": len(result["collections"]),
            "collection_s": [sum(r["wall_ms"] for r in c["rounds"]) / 1e3
                             for c in result["collections"]],
            "rounds": len(done), "reports": state["reports_n"],
            "shard_fired": len(state["shard_fired"]),
            "xof_fallbacks_max": max(r["xof_fallbacks"] for r in done),
            "splice_s": sum(r["splice_ms"] for r in done) / 1e3}


def layer_context(state: dict, result: dict) -> dict:
    """What the per-layer readers read: the traced part's rounds (the
    window's first collection), each with the bound ms of K1 and K3 for
    its shape, and the rounds after it (host-clock readings without the
    profiler's cost; the traced ones where the window held no more)."""
    reference = _reference(state)
    ctx_len = len(system.CTX)
    per_level = [bounds.incremental_round(r.prefixes, state["reports_n"],
                                          state["value_len"], ctx_len,
                                          state["limbs"])
                 for r in reference.rounds]
    traced = result["collections"][0]["rounds"]
    for r in traced:
        r["bound_ms"] = per_level[r["level"]]
    rest = [r for c in result["collections"][1:] for r in c["rounds"]]
    return {"mode": "heavy_hitters", "rounds": rest or traced,
            "traced": traced}
