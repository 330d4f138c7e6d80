"""warp_in_step_ms (layer: filters, `filters/stabilization.py` ->
`models/warp_field.py`): the `warp` stage (the correction to a map and the
warp kernel) inside the cell's own captured step, the median over the
traced slice's replays, ms.  Moves `frames_per_s`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "warp")
