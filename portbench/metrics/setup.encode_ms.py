"""setup.encode_ms: the host's milliseconds of set-up spent encoding the
measurements (`BatchedMastic.encode_measurements`, its Python loop over
the reports), the program's span `shard.encode`, summed inside the
harness's `setup.shard`."""

from portbench import spans


def read(ctx: dict):
    return spans.setup_ms(ctx, "shard.encode")
