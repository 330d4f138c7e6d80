"""mesh_cg_in_step_ms (layer: tracker, `vision/mesh_motion.py`): the
`tracker.mesh.cg` stage of the mesh solve (each IRLS round's conjugate-
gradient iterations) inside the cell's own captured step, the median over
the traced slice's replays of its device busy time, ms.  Moves
`frames_per_s`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "tracker.mesh.cg")
