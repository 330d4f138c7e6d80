"""Distributed WarpField solve: feature-sharded CG (counterpart of
livevisionkit_tpu/parallel/distributed_solve.py).

The feature constraints split over the devices of a mesh axis.  Each
device builds its features' dense operator A_i and, each IRLS round, its
normal matrix A_i^T W_i A_i and right-hand side A_i^T W_i d_i; one sum of
each, gathered on the first device (the JAX package's `psum`, here in a
fixed order), assembles the system.  The mesh unknowns (2 x Hm x Wm
floats) are tiny: the CG runs on the first device, and only the reduced
(nodes, nodes) and (2, Hm, Wm) partials travel, never the features.
The solve is vision/mesh_motion.solve, the same code as the
single-device `estimate`; only the order of the feature sums differs.
"""

from __future__ import annotations

import torch

from livevisionkit_tpu_torch.config import MeshMotionSettings
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.parallel.streams import Mesh
from livevisionkit_tpu_torch.vision import mesh_motion


def estimate_sharded(
    src: torch.Tensor,  # (N, 2) previous-frame points
    dst: torch.Tensor,  # (N, 2)
    weights: torch.Tensor,  # (N,)
    global_fit: WarpField,
    size: tuple[int, int],
    settings: MeshMotionSettings,
    mesh: Mesh,
    axis: str = "tile",
    prev_local: WarpField | None = None,
    prev_weight_scale: torch.Tensor | float = 1.0,
) -> tuple[WarpField, torch.Tensor, torch.Tensor]:
    """vision.mesh_motion.estimate with the features split over the
    devices of the mesh's `axis`.  A feature count that does not divide the
    axis is padded with zero-weight features, which add nothing to any sum
    (the JAX package asserts divisibility instead).  The field, the (N,)
    inliers and the mean residual come back on the axis's first device."""
    devices = mesh.along(axis)
    n_dev, n = len(devices), src.shape[0]
    pad = -n % n_dev
    if pad:
        src = torch.cat([src, src.new_zeros((pad, 2))])
        dst = torch.cat([dst, dst.new_zeros((pad, 2))])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    shards = [tuple(t.to(d) for t in part)
              for d, *part in zip(devices, src.chunk(n_dev), dst.chunk(n_dev), weights.chunk(n_dev))]
    first = devices[0]
    field, inliers, mean_res = mesh_motion.solve(
        shards, WarpField(offsets=global_fit.offsets.to(first)), size, settings,
        None if prev_local is None else WarpField(offsets=prev_local.offsets.to(first)),
        prev_weight_scale)
    return field, torch.cat([i.to(first) for i in inliers])[:n], mean_res
