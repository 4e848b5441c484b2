"""attr.dispatch_ms: the host's milliseconds a job spends dispatching
its chunks' rounds from the root (the schedule, `eval_full` at every
depth, both preps, the FLP weight check and the masked aggregates are
enqueued there): the sum over the job's chunks of each chunk's
`dispatch_ms` (the round's `extra["chunks"]` phases), the median over
the window's jobs after the traced ones.  Nothing for a resident
round, which has no chunks."""

from portbench import layer


def read(ctx: dict):
    done = layer.rounds(ctx, "attribute_metrics")
    if done is None or any(j["dispatch_ms"] is None for j in done):
        return None
    return layer.median(ctx, "attribute_metrics", "dispatch_ms")
