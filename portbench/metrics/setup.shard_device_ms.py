"""setup.shard_device_ms: the host's milliseconds of set-up spent in the
client shard on the card (`BatchedMastic.shard_device`: the VIDPF key
generation, the beta shares, the joint rand and the FLP proof), the
program's span `shard.device`, summed inside the harness's
`setup.shard`."""

from portbench import spans


def read(ctx: dict):
    return spans.setup_ms(ctx, "shard.device")
