"""warp_roofline[.<cell suffix>] (layer: kernels, K1 `csrc/warp.cu`): the
solo warp's share of its roofline for the cell's shapes, in %
(`harness/layers.warp_roofline`).  Moves the cell's rate."""

from harness import layers


def read(run):
    return layers.warp_roofline(run)
