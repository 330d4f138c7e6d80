"""mesh_solve_in_step_ms (layer: tracker, `vision/mesh_motion.py`): the
`tracker.mesh` stage (the mesh solve) inside the cell's own captured step,
the median over the traced slice's replays, ms.  Moves
`frames_per_s.4k_chain`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "tracker.mesh")
