"""hh.splice_s: the seconds the scalar fallback (`splice_rejected`)
took over the window's rounds after its traced collection: the sum of
each round's `extra["splice_ms"]`.  The result line's "counts" carries
the lanes whose XOF sampling fired beside it."""

from portbench import layer


def read(ctx: dict):
    return layer.total_s(ctx, "heavy_hitters", "splice_ms")
