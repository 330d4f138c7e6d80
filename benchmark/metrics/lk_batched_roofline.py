"""lk_batched_roofline (layer: kernels, K3 over the stream axis): LK's
share of its roofline for all streams of a tick, in %.  Moves
`frames_per_s.multi`."""

from harness import layers


def read(run):
    return layers.lk_roofline(run)
