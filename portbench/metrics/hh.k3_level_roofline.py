"""hh.k3_level_roofline: K3's level step (`csrc/level.cu`) over the
traced window: the rounds' bound ms (`portbench/bounds.py`, from each
round's shape) over the device ms of these kernels."""

from portbench import layer

KERNELS = ("level_kernel", "node_proof_kernel")


def read(ctx: dict):
    return layer.roofline_pct(ctx, "heavy_hitters", "k3", KERNELS)
