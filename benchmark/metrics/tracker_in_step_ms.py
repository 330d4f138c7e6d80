"""tracker_in_step_ms (layer: tracker, `vision/frame_tracker.py`): the
`tracker` stage inside the cell's own captured step, between its two stage
marks, the median over the traced slice's replays, ms
(`harness/program_trace.stage_ms`).  Moves `frames_per_s`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "tracker")
