"""Device-time attribution (port of `mastic_tpu/obs/devtime.py`).

The executors measure a per-round phase timeline (upload / dispatch /
compute-wait / download / host; per chunk on the chunked runners,
`drivers/pipeline.py`, once a round on the resident runner).  This
module turns it into registry observations:

* `observe_round(metrics, tenant=...)`, called by the drivers'
  `step_finish` after each round: every phase lands in the
  `mastic_chunk_phase_ms{phase=...}` histogram, the round wall in
  `mastic_round_wall_ms{tenant=...}`, and the compile-vs-execute split
  in `mastic_device_time_ms_total{kind=compile|execute}`.  The port
  runs eagerly and compiles no program (a kernel is built once per
  process by `ops.kernels`, outside any round), so no phase is named
  `compile_ms` and `kind="compile"` stays 0;

* `MASTIC_TORCH_PROFILE=dir`, an opt-in, one-shot lever: the FIRST
  round stepped after import runs under `torch.profiler.profile` (the
  CUDA activity when the round's device is a card, else the CPU's) and
  writes a Chrome trace into `dir` when it is collected.  One round,
  not the whole run:
  profiler overhead and trace size make an always-on capture useless.
  `take_profile_dir()` consumes the lever; `HeavyHittersRun.step_begin`
  and `AttributeMetricsRun.step_begin` call it.
"""

import os
import threading
import time
from typing import Optional

from .registry import get_registry

# Phases whose wall time is attributed to program compilation rather
# than device execution (none in the port: see the module docstring).
_COMPILE_PHASES = ("compile_ms",)
_EXECUTE_PHASES = ("dispatch_ms", "compute_wait_ms")

_profile_lock = threading.Lock()
_profile_consumed = False


def take_profile_dir() -> Optional[str]:
    """The MASTIC_TORCH_PROFILE directory, once: the first caller gets
    it (and brackets its round in `round_profiler`), every later call
    gets None.  Re-arm by restarting the process: the lever is one-shot
    per process."""
    global _profile_consumed
    path = os.environ.get("MASTIC_TORCH_PROFILE")
    if not path:
        return None
    with _profile_lock:
        if _profile_consumed:
            return None
        _profile_consumed = True
    return path


def reset_profile_lever() -> None:
    """Tests only: re-arm the one-shot."""
    global _profile_consumed
    with _profile_lock:
        _profile_consumed = False


class RoundProfiler:
    """One round under `torch.profiler.profile`: `start()` in the
    round's `step_begin`, `stop()` once its results are on the host
    (the round's sync), which writes `<dir>/round-<tenant>-<ns>.json`
    (a Chrome trace: kernel launches and, on a card, their device
    times)."""

    def __init__(self, path: str, device, tenant: str = ""):
        self.path = path
        self.tenant = tenant or "run"
        self.on_card = getattr(device, "type", str(device)) == "cuda"
        self.prof = None
        self.trace_file: Optional[str] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        # On a card the device activity alone: the kernels and copies
        # with their device times (a host-side record of every operator
        # of a round is hundreds of MB).
        self.prof = profile(activities=[ProfilerActivity.CUDA
                                        if self.on_card
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()

    def stop(self) -> Optional[str]:
        if self.prof is None:
            return None
        if self.on_card:
            import torch

            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        os.makedirs(self.path, exist_ok=True)
        self.trace_file = os.path.join(
            self.path, f"round-{self.tenant}-{time.monotonic_ns()}.json")
        self.prof.export_chrome_trace(self.trace_file)
        self.prof = None
        return self.trace_file


def round_profiler(device, tenant: str = "") -> Optional[RoundProfiler]:
    """A started `RoundProfiler` when the one-shot lever is armed and
    not yet consumed, else None."""
    path = take_profile_dir()
    if not path:
        return None
    prof = RoundProfiler(path, device, tenant)
    prof.start()
    return prof


def observe_round(metrics, tenant: str = "") -> None:
    """Feed one RoundMetrics record into the registry: chunk-phase
    histograms, round wall, compile-vs-execute attribution, and the
    per-check accept/reject counters.  Cheap (a few dict walks), and
    tolerant of records stamped by any producer: missing blocks
    simply contribute nothing."""
    reg = get_registry()
    extra = metrics.extra
    wall = extra.get("round_wall_ms")
    if wall is None:
        pipeline = extra.get("pipeline") or {}
        wall = pipeline.get("round_wall_ms")
    if wall is not None:
        reg.histogram("mastic_round_wall_ms",
                      tenant=tenant).observe(float(wall))

    compile_ms = 0.0
    execute_ms = 0.0
    for rec in extra.get("chunks") or ():
        for (phase, ms) in rec.get("phases", {}).items():
            reg.histogram("mastic_chunk_phase_ms",
                          phase=phase[:-3] if phase.endswith("_ms")
                          else phase).observe(float(ms))
            if phase in _COMPILE_PHASES:
                compile_ms += float(ms)
            elif phase in _EXECUTE_PHASES:
                execute_ms += float(ms)
    pipeline = extra.get("pipeline") or {}
    phases = pipeline.get("phases")
    if phases:
        # The resident runner has one phase record per round instead
        # of per chunk; it feeds the same histograms.
        for (phase, ms) in phases.items():
            reg.histogram("mastic_chunk_phase_ms",
                          phase=phase[:-3] if phase.endswith("_ms")
                          else phase).observe(float(ms))
            if phase in _COMPILE_PHASES:
                compile_ms += float(ms)
            elif phase in _EXECUTE_PHASES:
                execute_ms += float(ms)
    if compile_ms:
        reg.counter("mastic_device_time_ms_total",
                    kind="compile").inc(compile_ms)
    if execute_ms:
        reg.counter("mastic_device_time_ms_total",
                    kind="execute").inc(execute_ms)

    reg.counter("mastic_rounds_total", tenant=tenant).inc()
    reg.counter("mastic_reports_accepted_total",
                tenant=tenant).inc(metrics.accepted)
    for (check, n) in (
            ("eval_proof", metrics.rejected_eval_proof),
            ("weight_check", metrics.rejected_weight_check),
            ("joint_rand", metrics.rejected_joint_rand),
            ("fallback", metrics.rejected_fallback)):
        if n:
            reg.counter("mastic_reports_rejected_total",
                        tenant=tenant, check=check).inc(n)
