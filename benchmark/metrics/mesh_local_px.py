"""mesh_local_px (layer: tracker, `vision/mesh_motion.py`): how far the
mesh solve's field leaves its global (homography) anchor, the mean over
the traced session's solves of each solve's largest node offset from it,
in frame pixels (the program's `mesh.local_dev_cpx`, in hundredths of a
pixel, over `mesh.solves`).  A solve that collapses to its anchor reads
~0.  Moves `frames_per_s`.  None where the driver hands no traced
session (`run.program["session"]`) or the program counts no solve."""


def read(run):
    sess = run.program.get("session")
    if sess is None or not sess.profiled or not sess.counters.get("mesh.solves"):
        return None
    return sess.counters.get("mesh.local_dev_cpx", 0) / sess.counters["mesh.solves"] / 100.0
