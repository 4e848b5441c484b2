"""attr.splice_s: the seconds the scalar fallback (`splice_rejected`)
took over the window's jobs after its traced ones: the sum of each
round's `extra["splice_ms"]`."""

from portbench import layer


def read(ctx: dict):
    return layer.total_s(ctx, "attribute_metrics", "splice_ms")
