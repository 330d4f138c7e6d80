"""FrameTracker: per-frame motion estimation on the device (counterpart of
livevisionkit_tpu/vision/frame_tracker.py; reference
Vision/FrameTracker.cpp).

Downscale to detection resolution, pyramidal LK of the previous grid
features, distribution quality, RANSAC homography (or similarity on a
poorly spread set), then detection on the current frame with tracked
inliers re-seeded.  "No motion" is an `ok` flag plus identity motion, so
the step keeps fixed shapes and never reads a value back to the host.

`settings.motion_resolution` picks the motion model: (2, 2) is the global
(homography) mode; any other shape, e.g. (16, 16), is mesh mode
(estimate_local_motions, FrameTracker.cpp:200-321): the homography fit
anchors a mesh solve (vision/mesh_motion.py) warm-started from, and pulled
toward, the previous frame's local mesh residual.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.config import FrameTrackerSettings
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.ops import resample
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass
from livevisionkit_tpu_torch.vision import features as features_mod
from livevisionkit_tpu_torch.vision import mesh_motion, optical_flow, ransac
from livevisionkit_tpu_torch.vision.features import FeatureGrid
from livevisionkit_tpu_torch.vision.optical_flow import Pyramid


@dataclass(frozen=True)
class TrackResult:
    motion: WarpField  # motion field at settings.motion_resolution
    stability: torch.Tensor  # inlier ratio in [0, 1]
    uniformity: torch.Tensor  # spatial spread quality of tracked points
    ok: torch.Tensor  # 0-d bool: trustworthy estimate this frame
    points: torch.Tensor  # (G, 2) tracked point positions (detection coords)
    points_valid: torch.Tensor  # (G,) tracked mask


@pytree_dataclass(static=("generator",))
@dataclass(frozen=True)
class TrackerState:
    pyramid: Pyramid
    features: FeatureGrid
    thresholds: torch.Tensor
    has_prev: torch.Tensor  # 0-d bool
    # RANSAC sampler on the frame's device, in place of the JAX PRNG key.
    # It advances on every call (a generator cannot be reverted without a
    # host sync), where the JAX key stays put on invalid frames: the draws
    # differ, their distribution does not.
    generator: torch.Generator
    # Previous frame's LOCAL mesh residual (solved mesh minus its global
    # fit; zeros before the first successful solve, and always in global
    # mode): the mesh solve's warm start and temporal pull target.
    prev_mesh: torch.Tensor  # (2, hm, wm) normalized offsets
    has_prev_mesh: torch.Tensor  # 0-d bool


def init(settings: FrameTrackerSettings, device: torch.device | str = "cuda", seed: int = 0) -> TrackerState:
    h, w = settings.detection_size
    g = settings.detector.max_features
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return TrackerState(
        pyramid=Pyramid.build(torch.zeros((h, w), dtype=torch.float32, device=device),
                              settings.flow.pyramid_levels),
        features=FeatureGrid(
            points=torch.zeros((g, 2), dtype=torch.float32, device=device),
            scores=torch.zeros((g,), dtype=torch.float32, device=device),
            valid=torch.zeros((g,), dtype=torch.bool, device=device),
        ),
        thresholds=features_mod.initial_thresholds(settings.detector, device=device),
        has_prev=torch.zeros((), dtype=torch.bool, device=device),
        generator=gen,
        prev_mesh=torch.zeros((2, *settings.motion_resolution), dtype=torch.float32, device=device),
        has_prev_mesh=torch.zeros((), dtype=torch.bool, device=device),
    )


def track(
    state: TrackerState, gray: torch.Tensor, settings: FrameTrackerSettings
) -> tuple[TrackerState, TrackResult]:
    """Estimate the motion prev_frame -> `gray` and update tracking state.

    gray: (H, W) full-resolution luma in [0, 1].
    """
    det_size = tuple(settings.detection_size)
    res = tuple(settings.motion_resolution)
    det = resample.resize(gray, det_size, antialias=True)
    pyr = Pyramid.build(det, settings.flow.pyramid_levels)

    new_pts, tracked = optical_flow.track(
        state.pyramid, pyr, state.features.points,
        state.features.valid & state.has_prev, settings.flow,
    )

    uniformity = features_mod.distribution_quality(new_pts, tracked, det_size)
    use_h = uniformity > settings.motion.min_homography_uniformity
    est = ransac.estimate(
        state.features.points, new_pts, tracked, state.generator, settings.motion,
        use_homography=use_h, min_samples=settings.min_motion_samples,
    )

    ok = (
        est.ok
        & state.has_prev
        & (uniformity >= settings.min_uniformity)
        & (tracked.sum() >= settings.min_motion_samples)
    )
    motion = WarpField.from_homography(est.homography, res, det_size)
    if res == (2, 2):
        # Global mode: the local residual stays zero, as it starts.
        prev_mesh = state.prev_mesh
    else:
        # Mesh mode: the global fit anchors the solve; the CG warm-starts
        # from, and is pulled toward, the previous local mesh
        # (FrameTracker.cpp:274-276), zero-weighted until one exists.
        glob = motion
        motion, _, _ = mesh_motion.estimate(
            state.features.points, new_pts, tracked.to(torch.float32), glob, det_size,
            settings.mesh, prev_local=WarpField(offsets=state.prev_mesh),
            prev_weight_scale=state.has_prev_mesh.to(torch.float32),
        )
        # Gated on ok: after a tracking discontinuity the next solve
        # re-anchors on its global fit.
        prev_mesh = torch.where(ok, motion.offsets - glob.offsets, 0.0)
    motion = WarpField(offsets=torch.where(ok, motion.offsets, 0.0))
    result = TrackResult(
        motion=motion,
        stability=torch.where(ok, est.stability, 0.0),
        uniformity=uniformity,
        ok=ok,
        points=new_pts,
        points_valid=tracked,
    )

    # Detection on the current frame for the next call, with tracked inliers
    # re-seeded into their new cells with priority.
    propagated = features_mod.rebin(
        new_pts, state.features.scores, tracked & est.inliers & ok,
        settings.detector, det_size,
    )
    feats, thresholds = features_mod.detect(
        det, state.thresholds, settings.detector, prev_features=propagated
    )
    new_state = TrackerState(
        pyramid=pyr,
        features=feats,
        thresholds=thresholds,
        has_prev=torch.ones_like(state.has_prev),
        generator=state.generator,
        prev_mesh=prev_mesh,
        has_prev_mesh=ok,
    )
    return new_state, result
