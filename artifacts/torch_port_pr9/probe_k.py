"""Phase k of chip_smoke.py alone, for a short call on the card: the
kernels, phase a's first 16 levels and phase e (what phase k is held
to), then phase k.  Run from the repository's root:

    python3 artifacts/torch_port_pr9/probe_k.py
"""
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mastic_tpu_torch.ops import kernels  # noqa: E402

if __name__ == "__main__":
    t0 = time.perf_counter()
    kernels.build()
    print("build", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda", 0)
    results = {"count": cs.main_path(dev, 0, cs.MESH_NCCL_LEVELS)}
    print("phase a 16 levels", results["count"]["rounds_s"], flush=True)
    results["attributes"] = cs.attributes_path(dev, 0)
    print("phase e round", results["attributes"]["round_s"], flush=True)
    t0 = time.perf_counter()
    k = cs.party_phase(dev, 0, results)
    print("phase k", time.perf_counter() - t0, flush=True)
    cs._print_parties(k)
