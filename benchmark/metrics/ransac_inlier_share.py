"""ransac_inlier_share (layer: tracker, `vision/ransac.py`): the chosen
models' inliers over the points RANSAC was given, summed over the traced
session's steps (the program's `ransac.inliers` and `ransac.tracked`
counters), in %.  Moves `frames_per_s`."""

from harness import program_trace


def read(run):
    return program_trace.counter_share(run, "ransac.inliers", "ransac.tracked")
