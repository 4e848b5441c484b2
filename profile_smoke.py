"""Where the round time of chip_smoke.py's collection goes, by phase.

    python3 profile_smoke.py [--seed N] [--levels L] [--path count|sum]

Runs chip_smoke.py's main path (MasticCount(256), 4096 reports, the same
measurements from --seed), or with `--path sum` its weighted
heavy-hitters path (MasticSum(256, 255) through compute_heavy_hitters,
all levels), with a synchronising host timer around each
phase of a round: the host RoundPlan, the index upload, kernel K3's
level step, the binder sponges (kernel K1's gathered sponge, both
aggregators in one launch), the eval proofs (binders, counter check,
eval-proof XOF), both aggregators' round, the truncation of the out
shares, the level-0 weight check, the masked aggregation and the collect
(sync and unshard). Each phase is
summed over all levels and over the deepest quarter. The timers
synchronise the card around every phase, so the rounds run somewhat
slower than in chip_smoke.py.

The client shard is split the same way, with timers that count only
inside it: `encode_measurements` (the host loop over the measurements
and the upload), and within `shard_device` the VIDPF key generation
(`gen`: the round keys, `fixed_key_blocks` for extend and for convert,
the node proofs and the rest of `gen`), `prove_rand` with
`helper_proof_share`, the FLP proof and the rest.  Both are timed
after a one-level pass of the same path, which loads every kernel.

Then it traces two of the deepest levels with torch.profiler and prints
their wall time and the top device operations (the card's busy share
is `python3 -m portbench.run --trace 1`'s, a union of intervals).
On the Count path it then times the two ways to launch K1's binder sponge over two
aggregators' level-255 carries: both in one launch (the main path's)
and one launch per aggregator.  Last it times K2 over growing grids
(4096 reports, 2 blocks, 1 to 64 seeds a report): the whole
`fixed_key_blocks` call by CUDA events, its kernel's device time, and
the planes entry's device time at the same columns (no round-key or
seed transposes), beside the bound.  Needs a CUDA card.
"""

import argparse
import collections
import sys
import time

import torch

import chip_smoke
from mastic_tpu_torch.backend import incremental, mastic, vidpf
from mastic_tpu_torch.drivers import heavy_hitters
from mastic_tpu_torch.flp import flp
from mastic_tpu_torch.ops import binder, kernels


def binder_launch_forms(seed: int) -> None:
    """K1's binder sponge at level 255: both aggregators in one launch
    against one launch per aggregator, same carries, CUDA events."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = chip_smoke.binder_inputs(dev, gen, chip_smoke.BITS,
                                    chip_smoke.CTX)
    (spec, ws, proofs, *rest) = args
    both = chip_smoke._time(lambda: binder.binder_checks(*args), 3)
    apart = chip_smoke._time(lambda: [binder.binder_checks(
        spec, ws[a:a + 1], proofs[a:a + 1], *rest) for a in (0, 1)], 3)
    print(f"K1 binder sponge at level {chip_smoke.BITS - 1}, 2 aggregators: "
          f"one launch {both:.4f} ms, one launch per aggregator "
          f"{apart:.4f} ms for the pair")


def fixed_key_grids(seed: int) -> None:
    """K2 at 4096 reports x S seeds x 2 blocks for growing S: where the
    one-thread latency floor gives way to throughput, and what the
    fixed-key entry's transposes cost over the planes entry."""
    from mastic_tpu_torch.backend.xof import fixed_key_blocks
    from mastic_tpu_torch.ops import aes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    reports = chip_smoke.R
    keys = torch.randint(0, 256, (reports, 16), dtype=torch.uint8,
                         device=dev, generator=gen)
    rk = aes.aes128_key_schedule(keys)
    kp = aes.bitslice_keys(rk).contiguous()
    for seeds in (1, 2, 8, 32, 64):
        rows = torch.randint(0, 256, (reports, seeds, 16), dtype=torch.uint8,
                             device=dev, generator=gen)
        planes = torch.randint(-2 ** 31, 2 ** 31,
                               (8, 16, seeds, 2, reports // 32),
                               dtype=torch.int32, device=dev, generator=gen)
        columns = reports // 32 * seeds * 2
        (bound, _by) = chip_smoke._bound(
            reports * (176.0 + 48 * seeds), columns * chip_smoke.AES_BLOCK_OPS)
        call = chip_smoke._time(lambda: fixed_key_blocks(rk, rows, 2), 20)
        kernel = chip_smoke._device_ms(lambda: fixed_key_blocks(rk, rows, 2),
                                       ("fixed_key_kernel",), 20)
        entry = chip_smoke._device_ms(
            lambda: aes.aes128_encrypt_bitsliced(kp, planes), ("aes_",), 20)
        print(f"K2 at {reports} x {seeds} seeds x 2 blocks ({columns} "
              f"columns, {4 * columns // 32} warps): fixed_key_blocks call "
              f"{call:.4f} ms, its kernel {kernel['fixed_key_kernel']:.4f} "
              f"ms; planes entry {entry['aes_']:.4f} ms; bound "
              f"{bound:.4f} ms")


def shard_timers() -> dict:
    """Rebind the client shard's phases to synchronising timers that
    count only inside `encode_measurements` and `shard_device`: returns
    the {phase: seconds} they fill."""
    secs = collections.defaultdict(float)
    state = {"shard": False, "xof": ""}

    def timed(name, fn, entry=False):
        def wrapper(*a, **k):
            if not (entry or state["shard"]):
                return fn(*a, **k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state["shard"] = True
            try:
                out = fn(*a, **k)
            finally:
                state["shard"] = not entry
            torch.cuda.synchronize()
            secs[name if isinstance(name, str) else name()] += \
                time.perf_counter() - t0
            return out
        return wrapper

    def labelled(usage, fn):
        def wrapper(*a, **k):
            state["xof"] = usage
            return fn(*a, **k)
        return wrapper

    bm = mastic.BatchedMastic
    bm.encode_measurements = timed("encode_measurements",
                                   bm.encode_measurements, entry=True)
    bm.shard_device = timed("shard_device", bm.shard_device, entry=True)
    bm.prove_rand = timed("prove_rand + helper_proof_share", bm.prove_rand)
    bm.helper_proof_share = timed("prove_rand + helper_proof_share",
                                  bm.helper_proof_share)
    flp.BatchedFlp.prove = timed("bflp.prove", flp.BatchedFlp.prove)
    bv = vidpf.BatchedVidpf
    bv.gen = timed("gen", bv.gen)
    bv.roundkeys = timed("gen: roundkeys", bv.roundkeys)
    bv._node_proof_dynamic = timed("gen: _node_proof_dynamic",
                                   bv._node_proof_dynamic)
    bv.extend = labelled("extend", bv.extend)
    bv.convert = labelled("convert", bv.convert)
    vidpf.fixed_key_blocks = timed(
        lambda: f"gen: fixed_key_blocks ({state['xof']})",
        vidpf.fixed_key_blocks)
    return secs


def print_shard(secs: dict, shard_s: float) -> None:
    gen_parts = [k for k in secs if k.startswith("gen: ")]
    rest_gen = secs["gen"] - sum(secs[k] for k in gen_parts)
    rest = secs["shard_device"] - secs["gen"] - sum(
        secs[k] for k in ("prove_rand + helper_proof_share", "bflp.prove"))
    print(f"shard by phase (synchronising timers; the shard took "
          f"{shard_s:.3f} s with them):")
    print(f"  encode_measurements: {secs['encode_measurements']:.4f} s")
    print(f"  shard_device: {secs['shard_device']:.4f} s, of which")
    print(f"    gen: {secs['gen']:.4f} s, of which")
    for name in sorted(gen_parts):
        print(f"      {name[5:]}: {secs[name]:.4f} s")
    print(f"      rest of gen: {rest_gen:.4f} s")
    for name in ("prove_rand + helper_proof_share", "bflp.prove"):
        print(f"    {name}: {secs[name]:.4f} s")
    print(f"    rest of shard_device: {rest:.4f} s")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--levels", type=int, default=chip_smoke.BITS)
    parser.add_argument("--path", choices=("count", "sum"), default="count")
    args = parser.parse_args()
    if args.path == "sum":
        args.levels = chip_smoke.BITS
    if not torch.cuda.is_available():
        print("profile_smoke: no CUDA card", file=sys.stderr)
        return 2
    deep_from = args.levels * 3 // 4
    traced = (args.levels - 4, args.levels - 2)
    total = collections.defaultdict(float)
    deep = collections.defaultdict(float)
    state = {"level": 0, "warm": False}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            total[name] += dt
            if state["level"] >= deep_from:
                deep[name] += dt
            return out
        return wrapper

    # The names the round code calls, rebound to timed versions.
    incremental.RoundPlan.__init__ = timed(
        "host RoundPlan", incremental.RoundPlan.__init__)
    heavy_hitters.round_inputs = timed("index upload",
                                       incremental.round_inputs)
    incremental.level_step = timed("K3 level step (wrapper + kernel)",
                                   incremental.level_step)
    mastic.binder_checks = timed("binder sponges (K1 gathered)",
                                 mastic.binder_checks)
    engine = incremental.IncrementalMastic
    engine._eval_proofs = timed("eval proofs (binders, counter, XOF)",
                                engine._eval_proofs)
    engine.agg_rounds = timed("agg_rounds (both aggregators)",
                              engine.agg_rounds)
    bm = mastic.BatchedMastic
    bm.weight_check_device = timed("weight check", bm.weight_check_device)
    bm.aggregate = timed("masked aggregation", bm.aggregate)
    bm.truncate = timed("truncate (out shares)", bm.truncate)
    runner = heavy_hitters.IncrementalRunner
    runner.round_collect = timed("collect (sync + unshard)",
                                 runner.round_collect)

    run_cls = heavy_hitters.HeavyHittersRun
    plain_step = run_cls.step
    trace = {}

    def step(self):
        state["level"] = self.level
        if state["warm"] and self.level == traced[0]:
            trace["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            trace["prof"].__enter__()
            trace["t0"] = time.perf_counter()
        out = timed("step", plain_step)(self)
        if state["warm"] and self.level == traced[1]:
            trace["wall"] = time.perf_counter() - trace["t0"]
            trace["prof"].__exit__(None, None, None)
        return out

    run_cls.step = step
    shard = shard_timers()
    kernels.build()
    # A first pass through the shard and one round: the first launch of
    # each PyTorch and hand-written kernel in a process loads it, which
    # took seconds in all and would land in the shard's phases.
    chip_smoke.main_path(torch.device("cuda"), args.seed, 1)
    for timings in (total, deep, shard):
        timings.clear()
    state["warm"] = True
    if args.path == "sum":
        result = chip_smoke.sum_path(torch.device("cuda"), args.seed)
    else:
        result = chip_smoke.main_path(torch.device("cuda"), args.seed,
                                      args.levels)
    print({k: v for (k, v) in result.items() if k != "shard_launches"})
    print_shard(shard, result["shard_s"])
    for (name, secs) in sorted(total.items(), key=lambda kv: -kv[1]):
        print(f"{name}: all levels {secs:.3f} s, levels {deep_from}-"
              f"{args.levels - 1} {deep[name]:.3f} s")
    averages = trace["prof"].key_averages()
    print(f"levels {traced[0]}-{traced[1] - 1}: wall {trace['wall']:.3f} s")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=15))
    del result, averages, trace
    torch.cuda.empty_cache()
    if args.path == "count":
        binder_launch_forms(args.seed)
        fixed_key_grids(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
