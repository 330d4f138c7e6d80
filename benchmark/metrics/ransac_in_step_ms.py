"""ransac_in_step_ms (layer: tracker, `vision/ransac.py`): the
`tracker.ransac` stage (the hypotheses, their scores and IRLS) inside the
cell's own captured step, the median over the traced slice's replays, ms.
Moves `frames_per_s`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "tracker.ransac")
