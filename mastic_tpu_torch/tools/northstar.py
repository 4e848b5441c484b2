"""North-star-scale heavy hitters on the port (counterpart of the JAX
package's `tools/northstar.py`): a large synthetic report batch, sharded
on the device chunk by chunk, through the chunked incremental runner
(or, with `--resident`, the resident one) level by level to the heavy
hitters.

    python -m mastic_tpu_torch.tools.northstar --reports 32768 --bits 256
    python -m mastic_tpu_torch.tools.northstar --resident --reports 4096
    python -m mastic_tpu_torch.tools.northstar --mesh 1      # NCCL ranks
    python -m mastic_tpu_torch.tools.northstar --device cpu --reports 96 \\
        --bits 6 --chunk-size 64 --planted 2

The device defaults to "cuda" and the tool raises without a card;
`--device cpu` runs the plain versions on the host.

The reports are the JAX tool's, drawn from `np.random.default_rng(seed)`
in its order: the planted paths (`plant_paths`: when two or more are
planted, the second shares the first's prefix for 3/4 of the tree), the
heavy reports' choice of path (60% of the reports), the uniform tail's
paths, then per chunk the nonces and the client randomness.  A tail
chunk is padded to `--chunk-size` by repeating its first row and trimmed
after the shard.  So both tools shard the same batch, and a checkpoint
of one resumes in the other.  The heavy reports weigh `--max-weight`
and the tail `--tail-weight` under `--inst sum` (1 each under Count);
the threshold is half a planted path's weight.

Each chunk is sharded on the device (`BatchedMastic.encode_measurements`
and `shard_device`) into a pinned `HostReportStore` (chunked mode), or
kept on the device and concatenated (resident mode).  With `--mesh N`
the tool spawns N ranks (`parallel.spawn`, `--backend nccl|gloo`); each
shards its rows of every chunk, gathers the chunk, and runs
`HeavyHittersRun(mesh=)`; rank 0's line is printed.

Prints one JSON line with the JAX tool's keys:
  {"inst", "platform" (the torch device type), "mode", "mesh_devices",
   "reports", "bits", "chunk_size", "levels", "threshold",
   "shard_seconds", "wall_seconds", "node_evals_total",
   "node_evals_per_sec", "per_chunk_evals_per_sec_p50",
   "per_chunk_evals_per_sec_per_shard_p50", "memory" (the runner's
   accounting), "envelope" (`memory_envelope` at the final width),
   "heavy_hitters_found", "heavy_hitters_expected", "obs", "ok",
   and "pipeline", "mesh", "max_weight", "resumed_from_level" where
   they apply}
and exits 1 unless the heavy hitters are exactly the planted paths.
`compile_inline_ms_total` is 0.0: the port compiles no programs.  The
JAX tool's XLA compile cache and its `XLA_FLAGS` device count have no
counterpart.

`--checkpoint PATH` writes the verify key, the shard parameters and
`HeavyHittersRun.to_bytes()` every `--checkpoint-every` levels (atomic
rename); `--resume` restores from it, refusing a checkpoint of other
shard parameters before any report is built.
"""

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np

CTX = b"northstar"
# The share of the reports that carry a planted path.
SHARE_HEAVY = 0.6

# -- checkpoint container ---------------------------------------------
#
# The run state blob (HeavyHittersRun.to_bytes) binds the verify key,
# ctx, thresholds and tree shape; the reports are rebuilt from the
# command line, so the file stamps every parameter the rebuild depends
# on, and --resume checks them before any report is built.

SHARD_PARAM_KEYS = ("inst", "reports", "bits", "seed", "planted",
                    "max_weight", "tail_weight")


def shard_params(args) -> dict:
    """The parameters the synthetic report batch is a pure function of
    (plant_paths, the weights and the shard's random draws)."""
    return {k: getattr(args, k) for k in SHARD_PARAM_KEYS}


def write_checkpoint_bytes(vk: bytes, params: dict,
                           blob: bytes) -> bytes:
    """vk-length | vk | params-length | params-json | run blob."""
    header = json.dumps(params, sort_keys=True).encode()
    return (len(vk).to_bytes(2, "little") + vk
            + len(header).to_bytes(4, "little") + header + blob)


def read_checkpoint_bytes(raw: bytes) -> tuple:
    """Inverse of write_checkpoint_bytes -> (vk, params, blob)."""
    klen = int.from_bytes(raw[:2], "little")
    vk = raw[2:2 + klen]
    off = 2 + klen
    plen = int.from_bytes(raw[off:off + 4], "little")
    try:
        params = json.loads(raw[off + 4:off + 4 + plen])
    except ValueError:
        raise ValueError(
            "checkpoint has no shard-parameter header (written by an "
            "older north-star tool) — re-run without --resume")
    return (vk, params, raw[off + 4 + plen:])


def verify_shard_params(saved: dict, current: dict) -> list:
    """Mismatched parameter names (resume must refuse on any)."""
    return sorted(k for k in set(saved) | set(current)
                  if saved.get(k) != current.get(k))


def plant_paths(rng, planted: int, bits: int):
    """Full-width planted heavy-hitter paths, (planted, bits) bool.

    Rows are pairwise distinct; when >= 2 are planted, row 1 copies
    row 0's first 3/4 of the tree and diverges exactly there, so the
    two survivors ride one shared ancestor chain for 3/4 of the run.
    """
    if planted > 2 ** bits:
        raise ValueError(
            f"cannot plant {planted} distinct paths in a "
            f"{bits}-bit tree ({2 ** bits} exist)")
    paths = rng.integers(0, 2, (planted, bits)).astype(bool)
    if planted >= 2:
        split = max(1, (3 * bits) // 4)
        if split >= bits:
            split = bits - 1
        paths[1, :split] = paths[0, :split]
        paths[1, split] = ~paths[0, split]
        paths[1, split + 1:] = rng.integers(
            0, 2, bits - split - 1).astype(bool)
    for r in range(planted):
        while any(np.array_equal(paths[r], paths[s]) for s in range(r)):
            paths[r] = rng.integers(0, 2, bits).astype(bool)
    return paths


# -- the command line ---------------------------------------------------

def parse_args(argv=None) -> argparse.Namespace:
    """Parse and check the command line; a bad --checkpoint-every, a
    --mesh that the resident batch or the backend cannot take, and a
    --resume of a checkpoint written for other shard parameters exit 2
    here, before any report is built.  A resume's (vk, blob) lands in
    `args.ckpt` (None otherwise)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--inst", choices=("count", "sum"),
                        default="count")
    parser.add_argument("--reports", type=int, default=100_000)
    parser.add_argument("--bits", type=int, default=64)
    parser.add_argument("--chunk-size", type=int, default=4096)
    parser.add_argument("--planted", type=int, default=3,
                        help="number of heavy-hitter values planted")
    parser.add_argument("--max-weight", type=int, default=7,
                        help="MasticSum max_measurement; planted "
                             "reports carry this weight (sum mode)")
    parser.add_argument("--tail-weight", type=int, default=1,
                        help="weight of the uniform-tail reports "
                             "(sum mode)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resident", action="store_true",
                        help="keep the batch and the carries on the "
                             "device for the whole run instead of "
                             "streaming chunks from host memory (the "
                             "fast path whenever the carries fit the "
                             "card: a chunked round moves every carry "
                             "both ways)")
    parser.add_argument("--mesh", type=int, default=0,
                        help="shard the report axis over this many "
                             "ranks (processes of torch.distributed)")
    parser.add_argument("--backend", choices=("gloo", "nccl"),
                        default="nccl",
                        help="the ranks' collectives under --mesh")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a "
                             "card) or cpu (the plain versions)")
    parser.add_argument("--out", type=str, default=None,
                        help="also write the JSON line here")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="write the run state here every "
                             "--checkpoint-every levels (verify key, "
                             "shard parameters, HeavyHittersRun."
                             "to_bytes, atomic rename); with --resume, "
                             "restore from it and continue")
    parser.add_argument("--checkpoint-every", type=int, default=16)
    parser.add_argument("--resume", action="store_true",
                        help="resume from --checkpoint instead of "
                             "starting fresh (the reports are rebuilt "
                             "from --seed, so only the run state needs "
                             "the file)")
    args = parser.parse_args(argv)

    if args.checkpoint_every < 1:
        parser.error(f"--checkpoint-every must be >= 1 "
                     f"(got {args.checkpoint_every})")
    if args.mesh:
        if args.resident and args.reports % args.mesh:
            parser.error(
                f"--reports {args.reports} must be divisible by "
                f"--mesh {args.mesh} in --resident mode (the resident "
                f"batch shards without padding; chunked mode pads)")
        if args.backend == "nccl" and not args.device.startswith("cuda"):
            parser.error(f"--backend nccl needs a card (--device "
                         f"{args.device}): use --backend gloo")

    args.ckpt = None
    if args.resume:
        if not args.checkpoint:
            parser.error("--resume needs --checkpoint PATH")
        with open(args.checkpoint, "rb") as f:
            raw = f.read()
        (vk, saved_params, blob) = read_checkpoint_bytes(raw)
        mismatched = verify_shard_params(saved_params, shard_params(args))
        if mismatched:
            detail = ", ".join(
                f"{k}: checkpoint={saved_params.get(k)!r} "
                f"vs run={getattr(args, k, None)!r}"
                for k in mismatched)
            print(f"--resume refused: the checkpoint was written for "
                  f"different shard parameters ({detail}); the "
                  f"rebuilt reports would not match the carried "
                  f"state and the run would only fail at the end",
                  file=sys.stderr)
            sys.exit(2)
        args.ckpt = (vk, blob)
    return args


# -- the synthetic reports --------------------------------------------

class Reports(NamedTuple):
    """The collection's measurements: the planted paths, every report's
    path and weight, the threshold, and the generator whose next draws
    are the shard's nonces and randomness."""
    rng: np.random.Generator
    paths: np.ndarray       # (planted, bits) bool
    alphas: np.ndarray      # (R, bits) bool
    weights: np.ndarray     # (R,) int64
    threshold: int


def synthetic_reports(args) -> Reports:
    """The JAX tool's measurements, drawn in its order."""
    (R, bits) = (args.reports, args.bits)
    rng = np.random.default_rng(args.seed)
    paths = plant_paths(rng, args.planted, bits)
    heavy_rows = int(R * SHARE_HEAVY)
    choice = rng.integers(0, args.planted, heavy_rows)
    alphas = np.concatenate([
        paths[choice],
        rng.integers(0, 2, (R - heavy_rows, bits)).astype(bool)])
    if args.inst == "sum":
        (w_heavy, w_tail) = (args.max_weight, args.tail_weight)
    else:
        (w_heavy, w_tail) = (1, 1)
    weights = np.concatenate([
        np.full(heavy_rows, w_heavy, np.int64),
        np.full(R - heavy_rows, w_tail, np.int64)])
    threshold = int(heavy_rows / args.planted * w_heavy * 0.5)
    return Reports(rng, paths, alphas, weights, threshold)


def shard(args, bm, dev, reports: Reports, mesh=None, stamp=None) -> tuple:
    """Shard every chunk of `args.chunk_size` reports on `dev`: a chunk's
    rows [lo, hi), the tail padded by repeating row lo, its nonces and
    randomness drawn from `reports.rng`, then trimmed to hi - lo rows.
    Under a mesh each rank shards its rows of the chunk (padded to the
    shard multiple) and gathers the whole chunk.  Returns (the pinned
    HostReportStore, or with --resident the concatenated batch on
    `dev`; timings {"encode", "shard", "store"} in seconds)."""
    import torch

    from ..drivers.chunked import HostReportStore, cat_batches, map_batch

    (R, C) = (args.reports, args.chunk_size)
    m = bm.m
    rng = reports.rng
    pin = dev.type == "cuda"
    shards = mesh.shape["reports"] if mesh is not None else 1
    rows = -(-C // shards) * shards
    (a, b) = mesh.bounds(rows) if mesh is not None else (0, rows)
    timings = {"encode": 0.0, "shard": 0.0, "store": 0.0}
    host = None
    parts = []
    t_start = time.perf_counter()
    for i in range(-(-R // C)):
        (lo, hi) = (i * C, min((i + 1) * C, R))
        idx = np.concatenate([np.arange(lo, hi), np.full(rows - (hi - lo),
                                                         lo)])
        nonces = rng.integers(0, 256, (C, 16), dtype=np.uint8)
        rand = rng.integers(0, 256, (C, m.RAND_SIZE), dtype=np.uint8)
        # Rows past the chunk (the shard multiple's padding) repeat its
        # first row and are dropped after the gather.
        fill = np.full(rows - C, 0)
        nonces = np.concatenate([nonces, nonces[fill]])[a:b]
        rand = np.concatenate([rand, rand[fill]])[a:b]
        t0 = time.perf_counter()
        (alphas, betas) = bm.encode_measurements(
            [(reports.alphas[j], int(reports.weights[j]))
             for j in idx[a:b]], dev)
        t1 = time.perf_counter()
        (batch, ok) = bm.shard_device(
            CTX, alphas, betas, torch.as_tensor(nonces).to(dev),
            torch.as_tensor(rand).to(dev))
        if mesh is not None:
            from ..parallel.mesh import gather_rows, tree_map

            (batch, ok) = tree_map(lambda t: gather_rows(mesh, t, C),
                                   (batch, ok))
        if not bool(ok.all()):
            raise AssertionError("XOF rejection fired during the synthetic "
                                 "shard (p ~ 2^-32)")
        if pin:
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        if args.resident:
            parts.append(map_batch(batch, lambda t: t[:hi - lo].to(dev)))
        else:
            if host is None:
                host = map_batch(batch, lambda t: torch.empty(
                    (R,) + tuple(t.shape[1:]), dtype=t.dtype,
                    pin_memory=pin))
            for (dst, src) in zip(host.tensors(), batch.tensors()):
                dst[lo:hi].copy_(src[:hi - lo])
        del batch
        t3 = time.perf_counter()
        timings["encode"] += t1 - t0
        timings["shard"] += t2 - t1
        timings["store"] += t3 - t2
        if i == 0 and stamp is not None:
            stamp(f"shard: chunk 0 done ({t3 - t_start:.1f}s)")
    t0 = time.perf_counter()
    if args.resident:
        out = cat_batches(parts)
        parts.clear()  # don't hold the batch twice on the device
    else:
        out = HostReportStore.from_batch(host, C)
    timings["store"] += time.perf_counter() - t0
    return (out, timings)


# -- the collection -----------------------------------------------------

def collection(args, mesh=None) -> dict:
    """The whole collection in this process (a rank of `mesh`, if
    given): shard, run every level, check the heavy hitters.  Returns
    {"line": the JSON line's dict, "heavy_hitters": the run's}."""
    import torch

    from .. import resolve_device
    from ..backend.mastic import BatchedMastic, MasticCount, MasticSum
    from ..drivers.chunked import memory_envelope
    from ..drivers.heavy_hitters import HeavyHittersRun
    from ..obs import trace as obs_trace
    from ..scalar import common

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    t_start = time.time()

    def stamp(msg: str) -> None:
        if lead:
            print(f"[northstar {time.time() - t_start:8.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    (R, bits, C) = (args.reports, args.bits, args.chunk_size)
    m = (MasticSum(bits, args.max_weight) if args.inst == "sum"
         else MasticCount(bits))
    bm = BatchedMastic(m)
    stamp(f"device={dev} inst={args.inst} reports={R} bits={bits} "
          f"chunk={C}" + (f" ranks={mesh.shape['reports']}"
                          if mesh is not None else ""))
    reports = synthetic_reports(args)

    t0 = time.time()
    (data, timings) = shard(args, bm, dev, reports, mesh, stamp)
    shard_wall = time.time() - t0
    stamp(f"shard: {R} reports in {shard_wall:.1f}s "
          f"({R / shard_wall:.0f} reports/s; encode "
          f"{timings['encode']:.3f}s, shard {timings['shard']:.3f}s, "
          f"store {timings['store']:.3f}s)")

    # The verify key rides in the checkpoint: the blob's binding digest
    # pins it, and a fresh key would reject every carried report.
    if args.ckpt is not None:
        (vk, ckpt_blob) = args.ckpt
    else:
        (vk, ckpt_blob) = (common.gen_rand(m.VERIFY_KEY_SIZE), None)
    if mesh is not None:
        from ..parallel.mesh import gather_rows

        # One key for every rank: rank 0's.
        vk = bytes(gather_rows(mesh, torch.tensor(
            list(vk), dtype=torch.uint8)[None])[0].tolist())

    thresholds = {"default": reports.threshold}
    (batch, store) = (data, None) if args.resident else (None, data)
    del data
    if ckpt_blob is not None:
        run = HeavyHittersRun.from_bytes(m, CTX, thresholds, vk, batch,
                                         ckpt_blob, device=dev, store=store,
                                         mesh=mesh)
        stamp(f"resumed from checkpoint at level {run.level}")
    else:
        run = HeavyHittersRun(m, CTX, thresholds, vk, batch, device=dev,
                              store=store, mesh=mesh)
    del batch, store
    resumed_from = run.level if ckpt_blob is not None else None

    def save_checkpoint() -> None:
        blob = run.to_bytes()  # every rank gathers
        if not lead:
            return
        tmp = args.checkpoint + ".tmp"
        with open(tmp, "wb") as f:
            f.write(write_checkpoint_bytes(vk, shard_params(args), blob))
        os.replace(tmp, args.checkpoint)

    stamp(f"rounds: threshold={reports.threshold} planted={args.planted}")
    # The rounds' spans nest under one "collection" span, the schema of
    # the service's epochs (MASTIC_TRACE_FILE=path writes both).
    coll_span = obs_trace.get_tracer().start_detached_span(
        "collection", tool="northstar", inst=args.inst, reports=R,
        bits=bits, mode="resident" if args.resident else "chunked")
    agg_t0 = time.time()
    evals_total = 0
    chunk_rates: list = []
    level = 0
    more = True
    while more:
        # The deepest level's round runs inside the step() that returns
        # False: read the records appended since the last pass.
        with obs_trace.get_tracer().use_parent(coll_span):
            more = run.step()
        if args.checkpoint and more \
                and run.level % args.checkpoint_every == 0:
            save_checkpoint()
            stamp(f"checkpoint written at level {run.level}")
        for mx in run.metrics[level:]:
            evals_total += mx.node_evals
            if "chunks" in mx.extra:
                rates = [c["node_evals_per_sec"]
                         for c in mx.extra["chunks"]]
            else:  # resident: one device round, rate from its wall
                wall_ms = mx.extra.get("round_wall_ms", 0.0)
                rates = ([mx.node_evals / (wall_ms / 1e3)]
                         if wall_ms else [])
            chunk_rates += rates
            if level % 8 == 0 or level == bits - 1 or not more:
                p50 = (sorted(rates)[len(rates) // 2]
                       if rates else 0.0)
                stamp(f"level {mx.level}: frontier={mx.frontier_width}"
                      f" accepted={mx.accepted}/{mx.reports_total} "
                      f"evals/s p50={p50:.0f}")
            level += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    agg_wall = time.time() - agg_t0
    obs_trace.get_tracer().end_span(coll_span)

    hitters = run.result()
    expected = {tuple(bool(b) for b in row) for row in reports.paths}
    mem = run.runner.memory_accounting()
    pipe_rounds = [mx.extra["pipeline"] for mx in run.metrics
                   if "pipeline" in mx.extra]
    pipeline_out = None
    if pipe_rounds:
        effs = sorted(p["overlap_efficiency"] for p in pipe_rounds)
        pipeline_out = {
            "mode": pipe_rounds[-1]["mode"],
            "rounds_pipelined": sum(
                p["mode"] == "pipelined" for p in pipe_rounds),
            "rounds_total": len(pipe_rounds),
            "overlap_efficiency_p50": effs[len(effs) // 2],
            "compile_inline_ms_total": round(
                sum(p["compile_inline_ms"] for p in pipe_rounds), 1),
            "fallbacks": sorted({p["fallback"] for p in pipe_rounds
                                 if p["fallback"]}),
        }
    mesh_rounds = [mx.extra["mesh"] for mx in run.metrics
                   if "mesh" in mx.extra]
    mesh_out = None
    if mesh_rounds:
        skews = sorted(mr["shard_wait_skew_ms_max"] for mr in mesh_rounds)
        mesh_out = {
            "report_shards": mesh_rounds[-1]["report_shards"],
            "device_rows_per_chunk":
                mesh_rounds[-1]["device_rows_per_chunk"],
            "rows_per_shard": mesh_rounds[-1]["rows_per_shard"],
            "psum_bytes_total": sum(mr["psum_bytes_per_round"]
                                    for mr in mesh_rounds),
            "psum_bytes_per_round_last":
                mesh_rounds[-1]["psum_bytes_per_round"],
            "shard_wait_skew_ms_p50": skews[len(skews) // 2],
            "shard_wait_skew_ms_max": skews[-1],
        }
    # The envelope at the final width; resident mode's "chunk" is the
    # whole batch.
    envelope = memory_envelope(bm, R if args.resident else C,
                               run.runner.width, R, dev,
                               n_device_shards=args.mesh or 1)
    p50 = (sorted(chunk_rates)[len(chunk_rates) // 2]
           if chunk_rates else 0.0)
    out = {
        "inst": args.inst, "platform": dev.type,
        "mode": "resident" if args.resident else "chunked",
        "mesh_devices": args.mesh or 1,
        "reports": R, "bits": bits,
        "chunk_size": 0 if args.resident else C,
        "levels": len(run.metrics),
        "threshold": reports.threshold,
        "shard_seconds": round(shard_wall, 1),
        "wall_seconds": round(agg_wall, 1),
        "node_evals_total": evals_total,
        "node_evals_per_sec": round(evals_total / agg_wall, 1),
        "per_chunk_evals_per_sec_p50": round(p50, 1),
        "per_chunk_evals_per_sec_per_shard_p50": round(
            p50 / (args.mesh or 1), 1),
        "memory": mem,
        "envelope": envelope,
        "heavy_hitters_found": len(hitters),
        "heavy_hitters_expected": len(expected),
        "obs": obs_trace.get_tracer().snapshot(),
        "ok": set(hitters) == expected,
    }
    if pipeline_out is not None:
        out["pipeline"] = pipeline_out
    if mesh_out is not None:
        out["mesh"] = mesh_out
    if args.inst == "sum":
        out["max_weight"] = args.max_weight
    if resumed_from is not None:
        # wall/evals cover only this process's rounds.
        out["resumed_from_level"] = resumed_from
    return {"line": out, "heavy_hitters": hitters}


def collect(argv=None) -> tuple:
    """Parse `argv` and run the collection, in this process or, with
    --mesh N, on N spawned ranks.  Returns (args, rank 0's collection
    dict, [each rank's kernel launches] under --mesh, else [])."""
    args = parse_args(argv)
    if not args.mesh:
        return (args, collection(args), [])

    import torch

    from .. import resolve_device
    from ..parallel import jobs, spawn

    dev = resolve_device(args.device)
    if dev.type == "cuda" and args.backend == "nccl" \
            and args.mesh > torch.cuda.device_count():
        print(f"--mesh {args.mesh} over nccl exceeds the "
              f"{torch.cuda.device_count()} card(s)", file=sys.stderr)
        sys.exit(2)
    ranks = spawn(jobs.northstar, args.mesh, args.backend, args.device,
                  args)
    return (args, ranks[0][0], [r[1] for r in ranks])


def main(argv=None) -> int:
    (args, result, _launches) = collect(argv)
    line = json.dumps(result["line"])
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if result["line"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
