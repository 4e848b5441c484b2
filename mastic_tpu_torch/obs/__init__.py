"""Telemetry of the port (copies of the JAX package's `obs/trace.py`
and `obs/registry.py`): structured span events, appendable as JSONL
(`MASTIC_TRACE_FILE`), and the process-wide metrics registry.  The
party, session, fault and transport layers report through them."""

from .registry import get_registry  # noqa: F401
from .trace import get_tracer  # noqa: F401
