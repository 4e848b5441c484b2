"""The control of each cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken, read
with the mode's own `check`.  It has to come out as not correct.

* heavy hitters: exact counts over every report.  The control counts a
  sample of half of the reports and doubles the counts (the shortcut
  that would halve the device's work), then prunes as the reference
  does.
* attribute metrics: robustness, every report that fails a check is
  left out.  The control skips the checks and accepts every report.

    python3 -m portbench.control --workload <cell> --seeds 11,12,13

prints one JSON line a seed with the numbers compared and their limits.
It reads only the instantiation's sizes from the program (the client's
random bytes and the proof's length, which the generator's draws
follow), so it needs no card; the benchmark's own runs never run it.
"""

import argparse
import json
import sys

import numpy as np

from . import catalog, system, traffic
from .reference import attributes as ref_attr
from .reference import heavy_hitters as ref_hh


def heavy_hitters_result(data, _config: dict) -> dict:
    """One collection as the window would hand it over, from counts of
    the even-numbered reports, doubled."""
    t = data.batches[0]
    half = np.zeros(len(t.weights), bool)
    half[::2] = True
    sample = ref_hh.collection(t.alphas, 2 * t.weights, data.threshold,
                               honest=half)
    rounds = [{"level": r.level,
               "prefixes": [tuple(bool(b) for b in p) for p in r.prefixes],
               "counts": r.counts.tolist(), "accepted": len(t.weights)}
              for r in sample.rounds]
    hitters = [tuple(bool(b) for b in p) for p in sample.heavy_hitters]
    return {"collections": [{"rounds": rounds, "hitters": hitters}],
            "seconds": 1.0}


def attributes_result(data, config: dict) -> dict:
    """Every job of the pool once, with every report accepted."""
    jobs = []
    for (b, t) in enumerate(data.batches):
        paths = np.stack([traffic.hash_path(a, t.alphas.shape[1])
                          for a in data.attributes])
        want = ref_attr.job(data.attributes, paths, t.alphas, t.weights,
                            {}, {}, config.get("buckets"))
        jobs.append({"batch": b, "sums": want.sums, "accept": want.accept,
                     "accepted": int(want.accept.sum()),
                     "rejected": {"eval_proof": 0, "weight_check": 0,
                                  "joint_rand": 0},
                     "rejected_fallback_by": {}})
    return {"jobs": jobs, "seconds": 1.0}


RESULTS = {"heavy_hitters": heavy_hitters_result,
           "attribute_metrics": attributes_result}


def control(cell: dict, config: dict, seed: int) -> dict:
    """The numbers the mode's `check` compares, for the control's
    output on the cell's inputs from `seed`."""
    mastic = system.instantiate(config)
    data = traffic.generate(cell["generator"], cell["params"], mastic.bits,
                            mastic.RAND_SIZE, mastic.valid.PROOF_LEN, seed)
    mode = catalog.mode(cell["mode"])
    state = {"traffic": data, "reports_n": len(data.batches[0].weights),
             "mastic": mastic, "buckets": config.get("buckets")}
    return mode.check(state, RESULTS[cell["mode"]](data, config))["compared"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    args = parser.parse_args(argv)
    cell = catalog.cell(args.workload)
    config = catalog.config(cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        compared = control(cell, config, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": all(v <= limit for (v, limit)
                                         in compared.values()),
                          "compared": compared}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
