"""cas_in_step_ms (layer: filters, `filters/sharpening.py`, `ops/cas.py`):
the `cas` stage inside the cell's own captured step, the median over the
traced slice's replays, ms.  Moves `frames_per_s.4k_chain`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "cas")
