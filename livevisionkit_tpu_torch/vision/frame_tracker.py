"""FrameTracker: per-frame global motion estimation on the device
(counterpart of livevisionkit_tpu/vision/frame_tracker.py; reference
Vision/FrameTracker.cpp).

Downscale to detection resolution, pyramidal LK of the previous grid
features, distribution quality, RANSAC homography (or similarity on a
poorly spread set), then detection on the current frame with tracked
inliers re-seeded.  "No motion" is an `ok` flag plus identity motion, so
the step keeps fixed shapes and never reads a value back to the host.

This slice ports the global (2x2, homography) mode; mesh mode waits for
ROADMAP slice 2.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.config import FrameTrackerSettings
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.ops import resample
from livevisionkit_tpu_torch.vision import features as features_mod
from livevisionkit_tpu_torch.vision import optical_flow, ransac
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


def _check_mode(settings: FrameTrackerSettings) -> None:
    if tuple(settings.motion_resolution) != (2, 2):
        raise NotImplementedError(
            f"motion_resolution {settings.motion_resolution} is mesh mode (ROADMAP slice 2)"
        )


def init(settings: FrameTrackerSettings, device: torch.device | str = "cpu", seed: int = 0) -> TrackerState:
    _check_mode(settings)
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
    )


def track(
    state: TrackerState, gray: torch.Tensor, settings: FrameTrackerSettings
) -> tuple[TrackerState, TrackResult]:
    """Estimate the motion prev_frame -> `gray` and update tracking state.

    gray: (H, W) full-resolution luma in [0, 1].
    """
    _check_mode(settings)
    det_size = tuple(settings.detection_size)
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
    motion = WarpField.from_homography(est.homography, settings.motion_resolution, det_size)
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
    )
    return new_state, result
