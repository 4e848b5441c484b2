"""attr.k3_level_roofline: K3's level step (`csrc/level.cu`) at every
depth of the from-root grid over the traced window: the jobs' bound ms
(`portbench/bounds.py`) over the device ms of these kernels."""

from portbench import layer

KERNELS = ("level_kernel", "node_proof_kernel")


def read(ctx: dict):
    return layer.roofline_pct(ctx, "attribute_metrics", "k3", KERNELS)
