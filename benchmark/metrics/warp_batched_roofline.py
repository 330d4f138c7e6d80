"""warp_batched_roofline (layer: kernels, K2 `csrc/warp.cu` over the stream
axis): the batched warp's share of its roofline for all streams of a tick,
in %.  Moves `frames_per_s.multi`."""

from harness import layers


def read(run):
    return layers.warp_roofline(run)
