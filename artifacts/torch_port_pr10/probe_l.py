"""Phase l of chip_smoke.py alone, for a short call on the card: the
kernels, phase a (the Count path, all 256 levels) and phase e (the
attribute round), whose uploads phase l takes, then phase l.  With
`--sync-debug` the resident runner's `round_stage` runs under
`torch.cuda.set_sync_debug_mode("warn")` during phase l, and every
synchronizing call it makes is counted by its source line.  Run from the
repository's root:

    python3 artifacts/torch_port_pr10/probe_l.py [--sync-debug]
"""
import collections
import json
import subprocess
import sys
import time
import warnings

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mastic_tpu_torch.drivers import heavy_hitters  # noqa: E402
from mastic_tpu_torch.ops import kernels  # noqa: E402


def sync_debug() -> collections.Counter:
    """Wrap IncrementalRunner.round_stage: count the synchronizing CUDA
    calls each stage makes, by file:line."""
    seen = collections.Counter()
    orig = heavy_hitters.IncrementalRunner.round_stage

    def staged(self, agg_param):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return orig(self, agg_param)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                for w in caught:
                    seen[f"{w.filename}:{w.lineno}"] += 1
    heavy_hitters.IncrementalRunner.round_stage = staged
    seen["stages"] = 0
    return seen


if __name__ == "__main__":
    t_start = time.perf_counter()
    kernels.build()
    print("build", round(time.perf_counter() - t_start, 1), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    results = {"count": cs.main_path(dev, 0, cs.BITS)}
    print("phase a rounds", round(results["count"]["rounds_s"], 3),
          flush=True)
    kernels.reset_launches()
    results["attributes"] = cs.attributes_path(dev, 0)
    print("phase e round", round(results["attributes"]["round_s"], 3),
          flush=True)
    seen = sync_debug() if "--sync-debug" in sys.argv else None
    service = cs.service_phase(dev, results, 0.0)
    cs._print_service(service)
    if seen is not None:
        print("round_stage synchronizing calls by line: "
              + json.dumps(dict(seen.most_common(20))))
    print("probe", round(time.perf_counter() - t_start, 1), "s")
