"""mesh_assemble_in_step_ms (layer: tracker, `vision/mesh_motion.py`): the
`tracker.mesh.assemble` stage of the mesh solve (the feature operator, the
rigidity matrix and each IRLS round's normal matrix and right-hand side)
inside the cell's own captured step, the median over the traced slice's
replays of its device busy time, ms.  Moves `frames_per_s`."""

from harness import program_trace


def read(run):
    return program_trace.stage_ms(run, "tracker.mesh.assemble")
