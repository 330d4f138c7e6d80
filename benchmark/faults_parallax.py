"""`faults.py`'s runner with one more fault, for the mesh cells:

    python3 benchmark/faults_parallax.py --workload vs1080_mesh_clip --fault mesh_global_only --seeds 11 12 13

  mesh_global_only  the mesh solve returns its global (homography) anchor:
                    a mesh that cannot follow two planes at once

and every fault of `faults.py` (`none`, `still_tracker`, ...), each seed's
JSON line as `faults.py` prints it.  The benchmark's own runs never plant
a fault."""

from __future__ import annotations

import sys
from typing import Callable

import faults


def _mesh_global_only(patch: Callable) -> None:
    from livevisionkit_tpu_torch.vision import mesh_motion

    estimate = mesh_motion.estimate

    def anchored(src, dst, weights, global_fit, *args, **kw):
        _, inliers, mean_res = estimate(src, dst, weights, global_fit, *args, **kw)
        return global_fit, inliers, mean_res

    patch(mesh_motion, "estimate", anchored)


FAULTS: dict[str, Callable] = {**faults.FAULTS, "mesh_global_only": _mesh_global_only}


def main(argv=None) -> int:
    faults.FAULTS.update(FAULTS)
    return faults.main(argv)


if __name__ == "__main__":
    sys.exit(main())
