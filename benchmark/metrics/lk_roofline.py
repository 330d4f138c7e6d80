"""lk_roofline[.<cell suffix>] (layer: kernels, K3 `csrc/lk.cu`): LK's share
of its roofline for the cell's shapes, in % (`harness/layers.lk_roofline`).
Moves the cell's rate."""

from harness import layers


def read(run):
    return layers.lk_roofline(run)
