"""hh.device_idle_pct: the share of the traced window in which no
kernel, copy or memset ran on the card (the union of their
intervals)."""

from portbench import layer


def read(ctx: dict):
    return layer.idle_pct(ctx, "heavy_hitters")
