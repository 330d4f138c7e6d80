"""kernels_per_step[.<cell suffix>] (layer: compiled step,
`utils/compiled.py`): kernels a graph replay runs (with several streams, a
tick of all of them), in the traced slice.  Moves the cell's rate."""

from harness import layers


def read(run):
    return layers.kernels_per_replay(run)
