"""attr.k1_binder_roofline: K1's binder sponge (`csrc/keccak.cu`) on
the from-root flat tree over the traced window: the jobs' bound ms
(`portbench/bounds.py`) over the device ms of these kernels."""

from portbench import layer

KERNELS = ("binder_sponge_kernel",)


def read(ctx: dict):
    return layer.roofline_pct(ctx, "attribute_metrics", "k1", KERNELS)
