"""Probe of the card's host for the chunked phases: versions, host
memory, pinned allocation and copy rates, then chip_smoke.py's chunked
Count (PROBE_LEVELS levels), chunked checkpoint and SumVec phases.

    python3 artifacts/torch_port_pr7/probe.py   (from the repository root)
"""
import os, pathlib, subprocess, sys, time
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
import torch
print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
for cmd in (["free", "-g"], ["sh", "-c", "ulimit -l"], ["sh", "-c", "cat /sys/fs/cgroup/memory.max 2>/dev/null; nproc"],
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]):
    print(subprocess.run(cmd, capture_output=True, text=True).stdout, flush=True)
print("empty_host_cache:", hasattr(getattr(torch, "accelerator", None), "empty_host_cache"),
      hasattr(torch._C, "_host_emptyCache"), flush=True)
dev = torch.device("cuda", 0)
t = time.perf_counter(); h = torch.empty(4 << 30, dtype=torch.uint8, pin_memory=True); print("pin 4 GiB", time.perf_counter() - t, flush=True)
d = torch.empty(4 << 30, dtype=torch.uint8, device=dev)
for _ in range(2):
    torch.cuda.synchronize(); t = time.perf_counter(); d.copy_(h, non_blocking=True); torch.cuda.synchronize(); up = time.perf_counter() - t
    t = time.perf_counter(); h.copy_(d, non_blocking=True); torch.cuda.synchronize(); down = time.perf_counter() - t
    print(f"H2D {4 / up:.2f} GiB/s, D2H {4 / down:.2f} GiB/s", flush=True)
s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
h2 = torch.empty(4 << 30, dtype=torch.uint8, pin_memory=True); d2 = torch.empty_like(d)
torch.cuda.synchronize(); t = time.perf_counter()
with torch.cuda.stream(s1): d.copy_(h, non_blocking=True)
with torch.cuda.stream(s2): h2.copy_(d2, non_blocking=True)
torch.cuda.synchronize(); print(f"both ways at once: {time.perf_counter() - t:.3f} s for 4 GiB each", flush=True)
del h, h2, d, d2
torch._C._host_emptyCache()
torch.cuda.empty_cache()
import chip_smoke as cs
from mastic_tpu_torch.ops import kernels
t = time.perf_counter(); kernels.build(); print("build", time.perf_counter() - t, flush=True)
kernels.reset_launches(); torch.cuda.reset_peak_memory_stats(dev)
t = time.perf_counter()
r = cs.count_chunked(dev, 0, int(os.environ.get("PROBE_LEVELS", "8")))
print("count_chunked", time.perf_counter() - t, dict(kernels.launches), flush=True)
for k, v in r.items():
    if k != "per_level":
        print(" ", k, v)
for lv in r["per_level"]:
    print(" ", lv, flush=True)
del r
import gc; gc.collect(); torch.cuda.empty_cache()
torch._C._host_emptyCache()
from mastic_tpu_torch.backend.mastic import BatchedMastic, MasticCount
from mastic_tpu_torch.drivers.heavy_hitters import HeavyHittersRun
(alphas, weights, planted) = cs.measurements(0, cs.CKPT_BITS)
mastic = MasticCount(cs.CKPT_BITS); bm = BatchedMastic(mastic)
(nonces, rand, vk) = cs._path_inputs(dev, 11, mastic.RAND_SIZE)
meas = [(tuple(bool(b) for b in alphas[r]), int(weights[r])) for r in range(cs.R)]
(batch, ok, _s) = cs._shard(dev, bm, meas, nonces, rand)
reports = cs.ScalarReports(mastic, meas, nonces, rand)
t = time.perf_counter()
want = HeavyHittersRun(mastic, cs.CTX, {"default": cs.THRESHOLD}, vk, batch, valid=ok, device=dev, reports=reports)
while want.step(): pass
print("resident count16", time.perf_counter() - t, flush=True)
kernels.reset_launches()
t = time.perf_counter()
i = cs.chunked_checkpoint(dev, (mastic, vk, batch, ok, reports, want.level_results, want.result()))
print("chunked_checkpoint", time.perf_counter() - t, i, dict(kernels.launches), flush=True)
del batch, want
torch.cuda.empty_cache()
if os.environ.get("PROBE_SUMVEC", "1") == "1":
    kernels.reset_launches(); torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    r = cs.sumvec_path(dev, 0)
    print("sumvec", time.perf_counter() - t, r, dict(kernels.launches), flush=True)
print("probe done", flush=True)
