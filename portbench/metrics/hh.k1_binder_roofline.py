"""hh.k1_binder_roofline: K1's binder sponge (`csrc/keccak.cu`) over
the traced window: the rounds' bound ms (`portbench/bounds.py`, from
each round's shape) over the device ms of these kernels."""

from portbench import layer

KERNELS = ("binder_sponge_kernel",)


def read(ctx: dict):
    return layer.roofline_pct(ctx, "heavy_hitters", "k1", KERNELS)
