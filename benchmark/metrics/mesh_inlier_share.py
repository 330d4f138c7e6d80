"""mesh_inlier_share (layer: tracker, `vision/mesh_motion.py`): the mesh
solve's inliers over the matched points it was given, summed over the
traced session's steps (the program's `mesh.inliers` and `mesh.matched`
counters), in %.  Moves `frames_per_s`.  None where the driver hands
no traced session (`run.program["session"]`) or the program counts
neither."""


def read(run):
    sess = run.program.get("session")
    if sess is None or not sess.profiled or not sess.counters.get("mesh.matched"):
        return None
    return 100.0 * sess.counters.get("mesh.inliers", 0) / sess.counters["mesh.matched"]
