"""Preset bundles for the stabilizer (counterpart of
livevisionkit_tpu/presets.py; reference Modules/OBS-Plugin/Sources/
Stabilisation/VSFilter.cpp:255-293).

The motion-model presets "Homography" (2x2 mesh, acceptance threshold 3.0)
and the experimental "Vector Field" (16x16 mesh, threshold 10), plus the QA
presets "strict" / "default" / "relaxed" over the quality gates.
`stabilization_preset(model="field")` is how a user selects mesh mode:

    StabilizationFilter(settings=stabilization_preset(model="field"))
"""

from __future__ import annotations

from livevisionkit_tpu_torch.config import (
    FrameTrackerSettings,
    MeshMotionSettings,
    MotionEstimationSettings,
    PathSmootherSettings,
    StabilizationFilterSettings,
)


def homography_preset() -> FrameTrackerSettings:
    """Global-motion mode (VSFilter.cpp:255-268)."""
    return FrameTrackerSettings(
        motion_resolution=(2, 2),
        motion=MotionEstimationSettings(inlier_threshold_px=3.0),
    )


def vector_field_preset(mesh: tuple[int, int] = (16, 16)) -> FrameTrackerSettings:
    """Local mesh-motion mode (VSFilter.cpp:269-280)."""
    return FrameTrackerSettings(
        motion_resolution=mesh,
        motion=MotionEstimationSettings(inlier_threshold_px=10.0),
        mesh=MeshMotionSettings(inlier_threshold_px=10.0),
    )


_QA = {
    # (min_tracking_quality, min_scene_quality) (VSFilter.cpp:282-293)
    "strict": (0.5, 0.9),
    "default": (0.3, 0.8),
    "relaxed": (0.15, 0.6),
}


def stabilization_preset(
    model: str = "homography",
    qa: str = "default",
    smoothing: int = 10,
    crop: float = 0.10,
    crop_output: bool = False,
) -> StabilizationFilterSettings:
    """A full stabilizer configuration from preset names: `model`
    "homography" (or "h") or "field" ("vector_field", "mesh"); `qa`
    "strict", "default" or "relaxed"."""
    if model in ("homography", "h"):
        tracker = homography_preset()
    elif model in ("field", "vector_field", "mesh"):
        tracker = vector_field_preset()
    else:
        raise ValueError(f"unknown motion model preset {model!r}")
    if qa not in _QA:
        raise ValueError(f"unknown QA preset {qa!r} (strict/default/relaxed)")
    min_track, min_scene = _QA[qa]
    return StabilizationFilterSettings(
        tracker=tracker,
        smoother=PathSmootherSettings(predictive_samples=smoothing, corrective_limit=crop),
        min_tracking_quality=min_track,
        min_scene_quality=min_scene,
        crop_output=crop_output,
    )
