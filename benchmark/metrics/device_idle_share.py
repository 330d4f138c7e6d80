"""device_idle_share[.<cell suffix>] (layer: device): the share of the
untraced window in which the card had nothing to run, in %
(`harness/layers.idle_share`), against the cell's rate (the mix's
`rate_metric`), which it moves."""

from harness import layers


def read(run):
    return layers.idle_share(run, run.cell.traffic["rate_metric"])
