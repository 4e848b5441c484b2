"""Phase j of chip_smoke.py alone, for a short call on the card: the
kernels, phase a's first 16 levels (what the NCCL run is held to), then
phase j.  Run from the repository's root:

    python3 artifacts/torch_port_pr8/probe_j.py
"""
import sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from mastic_tpu_torch.ops import kernels

if __name__ == "__main__":
    t0 = time.perf_counter()
    kernels.build()
    print("build", time.perf_counter() - t0, flush=True)
    dev = torch.device("cuda", 0)
    a = cs.main_path(dev, 0, cs.MESH_NCCL_LEVELS)
    print("phase a 16 levels", a["rounds_s"], flush=True)
    t0 = time.perf_counter()
    mesh = cs.mesh_phase(0.0, 0, a["first_levels"])
    print("phase j", time.perf_counter() - t0, flush=True)
    cs._print_mesh(mesh)
