"""hh.enqueue_ms: the host time the resident round spends before its
sync, per round: `upload_ms + dispatch_ms` of each round's
`extra["pipeline"]["phases"]` (the round engine,
`backend/incremental.py`, planned and launched by
`IncrementalRunner.round_stage`), averaged over the window's rounds
after its traced collection."""

from portbench import layer


def read(ctx: dict):
    return layer.mean(ctx, "heavy_hitters", "enqueue_ms")
