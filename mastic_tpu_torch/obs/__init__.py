"""Telemetry of the port (copies of the JAX package's `mastic_tpu/obs/`):
structured span events, appendable as JSONL (`MASTIC_TRACE_FILE`,
`trace.py`); the process-wide metrics registry (`registry.py`); the one
versioned schema of `RoundMetrics.extra` (`schema.py`); device-time
attribution and the one-shot `MASTIC_TORCH_PROFILE` lever
(`devtime.py`); and the live status surface, /metrics, /statusz and
/varz (`statusz.py`).  The runs, the party, session, fault and
transport layers and the collector service report through them."""

from . import schema, trace  # noqa: F401  (re-exported submodules)
from .registry import get_registry  # noqa: F401
from .trace import get_tracer  # noqa: F401
