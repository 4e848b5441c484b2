"""Time a 4 GiB pinned allocation, its release, and pin_memory() of a
4 GiB tensor (run once with and once without
PYTORCH_CUDA_ALLOC_CONF=pinned_use_cuda_host_register:True,pinned_num_register_threads:8)."""
import time, torch
for _ in range(2):
    t = time.perf_counter(); h = torch.empty(4 << 30, dtype=torch.uint8, pin_memory=True); a = time.perf_counter() - t
    t = time.perf_counter(); del h; torch._C._host_emptyCache(); print(f"pin 4 GiB {a:.3f} s, free {time.perf_counter() - t:.3f} s", flush=True)
t = time.perf_counter(); h = torch.empty(4 << 30, dtype=torch.uint8).pin_memory(); print(f"pin_memory() copy 4 GiB {time.perf_counter() - t:.3f} s")
