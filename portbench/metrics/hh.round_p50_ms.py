"""hh.round_p50_ms: the median of the harness's span around each
`HeavyHittersRun.step()` (the collector loop, `drivers/heavy_hitters.py`)
over the window's rounds after its traced collection (all of them where
the window held one collection)."""

from portbench import layer


def read(ctx: dict):
    return layer.median(ctx, "heavy_hitters", "wall_ms")
