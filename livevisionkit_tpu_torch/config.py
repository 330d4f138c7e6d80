"""Typed settings tree for every tunable component.

The same frozen dataclasses, fields and defaults as
``livevisionkit_tpu/config.py`` (a test holds them equal field for field),
so one settings object describes a filter in either package.  Pixel-unit
defaults match the reference but are expressed on the [0, 1] intensity
scale where applicable (the reference is 8-bit).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class FeatureDetectorSettings:
    """Grid-based adaptive FAST corner detection settings (reference
    FeatureDetector.hpp:28-37)."""

    # Suppression-grid shape (rows, cols): one feature max per cell — this IS
    # the fixed feature capacity.  17x30 over 272x480 = 16 px cells, 510 slots.
    grid_shape: tuple[int, int] = (17, 30)
    # Threshold-servo regions (rows, cols).
    region_shape: tuple[int, int] = (2, 2)
    # FAST ring test: arc length 9 of 16, intensity threshold on [0,1] scale.
    fast_arc_length: int = 9
    fast_threshold_init: float = 40.0 / 255.0
    # Servo: threshold +/- step toward per-region target load, clamped.
    fast_threshold_min: float = 10.0 / 255.0
    fast_threshold_max: float = 250.0 / 255.0
    fast_threshold_step: float = 5.0 / 255.0
    # Target fraction of grid cells per region that should hold a feature.
    target_cell_load: float = 0.7

    @property
    def max_features(self) -> int:
        return self.grid_shape[0] * self.grid_shape[1]


@dataclass(frozen=True)
class OpticalFlowSettings:
    """Sparse pyramidal Lucas-Kanade settings (11x11 window, 3 levels, 5
    iterations)."""

    window_size: int = 11
    pyramid_levels: int = 3
    iterations: int = 5
    # OpenCV's minEigThreshold 1e-4 on 0-255 intensities, rescaled to [0, 1].
    min_eigen_threshold: float = 1.5e-9


@dataclass(frozen=True)
class MotionEstimationSettings:
    """Robust global motion-model fit (batched RANSAC + IRLS polish)."""

    hypotheses: int = 256
    inlier_threshold_px: float = 3.0
    refine_iterations: int = 4  # IRLS polish rounds on the winning model
    # Homography only when feature spread is good, else a similarity.
    min_homography_uniformity: float = 0.6


@dataclass(frozen=True)
class MeshMotionSettings:
    """Local (mesh) motion solve knobs (mesh mode, not yet ported)."""

    rigidity_weight: float = 1.0
    temporal_weight: float = 0.5
    temporal_support_scale: float = 0.25
    global_weight: float = 0.05
    cg_iterations: int = 24
    irls_rounds: int = 2
    inlier_threshold_px: float = 3.0


@dataclass(frozen=True)
class FrameTrackerSettings:
    """Inter-frame motion estimation (reference FrameTracker.hpp:31-44)."""

    # (h, w); 480x272 so the suppression grid tiles it in exact 16 px cells.
    detection_size: tuple[int, int] = (272, 480)
    motion_resolution: tuple[int, int] = (2, 2)  # WarpField grid; (16,16) mesh mode
    min_motion_samples: int = 75
    # Minimum spatial uniformity of tracked points to trust any estimate.
    min_uniformity: float = 0.2
    detector: FeatureDetectorSettings = dataclasses.field(
        default_factory=FeatureDetectorSettings
    )
    flow: OpticalFlowSettings = dataclasses.field(default_factory=OpticalFlowSettings)
    motion: MotionEstimationSettings = dataclasses.field(
        default_factory=MotionEstimationSettings
    )
    mesh: MeshMotionSettings = dataclasses.field(default_factory=MeshMotionSettings)


@dataclass(frozen=True)
class PathSmootherSettings:
    """Sliding-window trajectory smoothing (reference PathSmoother.hpp:29-39)."""

    predictive_samples: int = 10  # window = 2n+1, output delayed n frames
    corrective_limit: float = 0.10  # max correction, fraction of frame
    response_rate: float = 0.04  # EMA rate of the adaptive-sigma servo
    # Adaptive Gaussian sigma range, in window samples.
    min_sigma: float = 1.0
    max_sigma: float = 6.0
    # Drift-error hysteresis band driving sigma adaptation.
    drift_low: float = 0.5
    drift_high: float = 0.9

    @property
    def window(self) -> int:
        return 2 * self.predictive_samples + 1


@dataclass(frozen=True)
class StabilizationFilterSettings:
    """End-to-end stabilizer (reference StabilizationFilter.hpp:28-39)."""

    tracker: FrameTrackerSettings = dataclasses.field(
        default_factory=FrameTrackerSettings
    )
    smoother: PathSmootherSettings = dataclasses.field(
        default_factory=PathSmootherSettings
    )
    min_tracking_quality: float = 0.3
    min_scene_quality: float = 0.8
    # QA servo constants (reference StabilizationFilter.cpp:29-30).
    scene_quality_rate: float = 0.1
    trust_step: float = 0.05
    crop_output: bool = False  # zoom into the stable region on output
    # Storage dtype of the frame delay queue ("uint8" | "float32"); the
    # reference stores 8-bit frames.
    queue_dtype: str = "uint8"
    # Sampling filter of the corrective warp ("easu" | "bilinear").
    warp_filter: str = "easu"


@dataclass(frozen=True)
class DeblockingFilterSettings:
    """Adaptive macroblock deblocking (not yet ported)."""

    detection_levels: int = 3
    block_size: int = 16
    filter_size: int = 5
    filter_scaling: int = 4
    pool_form: str = "auto"  # auto | reshape | reduce_window


@dataclass(frozen=True)
class CASFilterSettings:
    """Contrast-adaptive sharpening (not yet ported)."""

    sharpness: float = 0.8


@dataclass(frozen=True)
class ScalingFilterSettings:
    """FSR upscale + RCAS sharpen (not yet ported)."""

    output_size: tuple[int, int] | None = (1080, 1920)
    sharpness: float = 0.8
