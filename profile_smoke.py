"""Where the round time of chip_smoke.py's collection goes, by phase.

    python3 profile_smoke.py [--seed N] [--levels L]

Runs chip_smoke.py's main path (MasticCount(256), 4096 reports, the same
measurements from --seed) with a synchronising host timer around each
phase of a round: the host RoundPlan, the index upload, kernel K3's
level step, the binder sponges (kernel K1's gathered sponge, both
aggregators in one launch), the eval proofs (binders, counter check,
eval-proof XOF), both aggregators' round, the level-0 weight check, the
masked aggregation and the collect (sync and unshard). Each phase is
summed over all levels and over the deepest quarter. The timers
synchronise the card around every phase, so the rounds run somewhat
slower than in chip_smoke.py.

Then it traces two of the deepest levels with torch.profiler and prints
the card's busy share of their wall time and the top device operations.
Last it times the two ways to launch K1's binder sponge over two
aggregators' level-255 carries: both in one launch (the main path's)
and one launch per aggregator.  Needs a CUDA card.
"""

import argparse
import collections
import sys
import time

import torch
from torch.autograd import DeviceType

import chip_smoke
from mastic_tpu_torch.backend import incremental, mastic
from mastic_tpu_torch.drivers import heavy_hitters
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--levels", type=int, default=chip_smoke.BITS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_smoke: no CUDA card", file=sys.stderr)
        return 2
    deep_from = args.levels * 3 // 4
    traced = (args.levels - 4, args.levels - 2)
    total = collections.defaultdict(float)
    deep = collections.defaultdict(float)
    state = {"level": 0}

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
    incremental.binder_checks = timed("binder sponges (K1 gathered)",
                                      incremental.binder_checks)
    engine = incremental.IncrementalMastic
    engine._eval_proofs = timed("eval proofs (binders, counter, XOF)",
                                engine._eval_proofs)
    engine.agg_rounds = timed("agg_rounds (both aggregators)",
                              engine.agg_rounds)
    bm = mastic.BatchedMastic
    bm.weight_check_device = timed("weight check", bm.weight_check_device)
    bm.aggregate = timed("masked aggregation", bm.aggregate)
    runner = heavy_hitters.IncrementalRunner
    runner.round_collect = timed("collect (sync + unshard)",
                                 runner.round_collect)

    run_cls = heavy_hitters.HeavyHittersRun
    plain_step = run_cls.step
    trace = {}

    def step(self):
        state["level"] = self.level
        if self.level == traced[0]:
            trace["prof"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            trace["prof"].__enter__()
            trace["t0"] = time.perf_counter()
        out = timed("step", plain_step)(self)
        if self.level == traced[1]:
            trace["wall"] = time.perf_counter() - trace["t0"]
            trace["prof"].__exit__(None, None, None)
        return out

    run_cls.step = step
    kernels.build()
    result = chip_smoke.main_path(torch.device("cuda"), args.seed,
                                  args.levels)
    print({k: v for (k, v) in result.items() if k != "shard_launches"})
    for (name, secs) in sorted(total.items(), key=lambda kv: -kv[1]):
        print(f"{name}: all levels {secs:.3f} s, levels {deep_from}-"
              f"{args.levels - 1} {deep[name]:.3f} s")
    averages = trace["prof"].key_averages()
    # Kernel rows only: an operator row repeats its kernels' device time.
    busy = sum(e.self_device_time_total for e in averages
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e6
    print(f"levels {traced[0]}-{traced[1] - 1}: wall {trace['wall']:.3f} s, "
          f"device busy {busy:.3f} s ({100 * busy / trace['wall']:.1f}%)")
    print(averages.table(sort_by="self_cuda_time_total", row_limit=15))
    del result, averages, trace
    torch.cuda.empty_cache()
    binder_launch_forms(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
