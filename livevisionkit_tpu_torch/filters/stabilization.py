"""StabilizationFilter: the end-to-end video stabilizer (counterpart of
livevisionkit_tpu/filters/stabilization.py; reference
Filters/StabilizationFilter.cpp).

One step `(state, frame) -> (state, frame)`: track the luma, run the
scene-quality/trust servo (motion scaled by trust, instant drop on a
tracking discontinuity), advance the path smoother, push the frame into the
u8 delay queue, pop the delayed one and warp it by the correction.  The
motion model is the tracker's `motion_resolution`: a 2x2 field (global
homography) or a mesh, e.g. presets.stabilization_preset(model="field")'s
16x16; the step is the same for both, and a mesh's correction warps by its
dense sample map through the same warp kernel.  The
step is branch-free on tensor values: every flag is a 0-d bool tensor and
every gate a `torch.where`, so nothing in it waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from livevisionkit_tpu_torch.config import (
    FeatureDetectorSettings,
    FrameTrackerSettings,
    MotionEstimationSettings,
    PathSmootherSettings,
    StabilizationFilterSettings,
)
from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.data.stream_buffer import StreamBuffer
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter, where_state
from livevisionkit_tpu_torch.models.homography import Homography
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.utils.batching import pytree_dataclass
from livevisionkit_tpu_torch.vision import frame_tracker, path_smoother


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> u8 for delay-queue storage: add 0.5 and truncate."""
    return torch.clamp(x * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def _dequantize_u8(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / 255.0)


@pytree_dataclass()
@dataclass(frozen=True)
class StabilizerState:
    tracker: frame_tracker.TrackerState
    smoother: path_smoother.SmootherState
    frames: StreamBuffer  # delay queue {"pixels", "timestamp", "valid"} (capacity N+1)
    scene_quality: torch.Tensor  # EMA of tracking stability
    trust: torch.Tensor  # motion trust factor in [0, 1]
    stability: torch.Tensor  # last-frame diagnostics
    uniformity: torch.Tensor
    correction: WarpField  # warp applied to the last output


@dataclass(frozen=True)
class StabilizationFilter(VideoFilter):
    settings: StabilizationFilterSettings = field(default_factory=StabilizationFilterSettings)
    enabled: bool = True  # bypass path: maintain delay/crop only

    def init(self, spec: FrameSpec, device: torch.device | str = "cuda", seed: int = 0) -> StabilizerState:
        """Initial state on `device`; `seed` seeds the RANSAC generator."""
        if spec.has_alpha:
            raise NotImplementedError("alpha planes are not ported yet (ROADMAP slice 5)")
        s = self.settings
        if s.queue_dtype not in ("uint8", "float32"):
            raise ValueError(f"unknown queue_dtype {s.queue_dtype!r}")
        qdtype = torch.uint8 if s.queue_dtype == "uint8" else torch.float32
        template = {
            "pixels": torch.zeros((spec.channels, spec.height, spec.width), dtype=qdtype, device=device),
            "timestamp": torch.zeros((), dtype=torch.float32, device=device),
            "valid": torch.zeros((), dtype=torch.bool, device=device),
        }
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return StabilizerState(
            tracker=frame_tracker.init(s.tracker, device=device, seed=seed),
            smoother=path_smoother.init(s.smoother, s.tracker.motion_resolution, device=device),
            frames=StreamBuffer.create(template, s.smoother.predictive_samples + 1),
            # Optimistic seed: a fresh stream assumes a trackable scene.
            scene_quality=torch.ones((), dtype=torch.float32, device=device),
            trust=zero,
            stability=zero,
            uniformity=zero,
            correction=WarpField.identity(s.tracker.motion_resolution, device=device),
        )

    @property
    def delay(self) -> int:
        return self.settings.smoother.predictive_samples

    def stable_region_margin(self) -> float:
        """Fraction of the frame on each side that corrections may consume."""
        return path_smoother.scene_margins(self.settings.smoother)

    def _crop_field(self, field_shape, size, device) -> WarpField:
        """Zoom-into-stable-region warp (output(u) = corrected(z(u)))."""
        m = self.stable_region_margin()
        h, w = size
        f32 = lambda v: torch.full((), v, dtype=torch.float32, device=device)  # noqa: E731
        z = Homography.from_similarity(f32(1.0 - 2.0 * m), f32(0.0), f32(m * (w - 1)), f32(m * (h - 1)))
        # from_homography builds o = H^-1(u) - u; we need o = z(u) - u.
        return WarpField.from_homography(z.inverse(), field_shape, size)

    def step(
        self, state: StabilizerState, frame: Frame, *, drain: bool | torch.Tensor = False
    ) -> tuple[StabilizerState, Frame]:
        s = self.settings
        dev = frame.device
        res = s.tracker.motion_resolution
        # The delay queue and the smoother's window advance on valid frames
        # and on drain bubbles; a non-drain invalid frame (a stall tick)
        # freezes both in lockstep, or queued frames pop while `ready` lags.
        advance = frame.valid | drain  # a bool or a 0-d bool tensor
        identity = WarpField.identity(res, device=dev)

        if self.enabled:
            tracker_state, result = frame_tracker.track(state.tracker, frame.luma(), s.tracker)
            tracker_state = where_state(frame.valid, tracker_state, state.tracker)

            # QA: scene-quality EMA + trust servo (StabilizationFilter.cpp:101-115).
            scene_quality = state.scene_quality + s.scene_quality_rate * (
                result.stability - state.scene_quality
            )
            scene_quality = torch.where(frame.valid, scene_quality, state.scene_quality)
            discontinuity = (~result.ok) | (result.stability < s.min_tracking_quality)
            trust = torch.where(
                scene_quality < s.min_scene_quality,
                torch.clamp(state.trust - s.trust_step, min=0.0),
                torch.clamp(state.trust + s.trust_step, max=1.0),
            )
            trust = torch.where(discontinuity, 0.0, trust)
            trust = torch.where(frame.valid, trust, state.trust)
            motion = result.motion * trust
            stability, uniformity = result.stability, result.uniformity
        else:
            tracker_state = state.tracker
            scene_quality = state.scene_quality
            trust = torch.zeros_like(state.trust)
            motion = identity
            stability, uniformity = state.stability, state.uniformity

        # Invalid frames carry identity motion; a frozen tick reverts below.
        motion = where_state(frame.valid, motion, identity)
        smoother_state, correction, ready = path_smoother.next_correction(
            state.smoother, motion, s.smoother
        )
        smoother_state = where_state(advance, smoother_state, state.smoother)

        # Delay queue: the push is advance-gated, so a stall bubble lands in
        # the dead slot and oldest() returns the bubble itself (an invalid
        # output tick) without losing a queued real frame.
        u8 = s.queue_dtype == "uint8"
        payload = _quantize_u8(frame.pixels) if u8 else frame.pixels
        frames = state.frames.push(
            {"pixels": payload, "timestamp": frame.timestamp, "valid": frame.valid},
            advance=advance,
        )
        delayed = frames.oldest()
        queue_full = frames.is_full()

        warp = correction
        if s.crop_output:
            warp = correction.compose(self._crop_field(warp.field_shape, frame.size, dev))
        if self.enabled or s.crop_output:
            # With the u8 queue the warp takes the raw u8 planes and returns
            # u8 (the reference warps 8-bit frames), dequantized after.
            warped = warp.apply(delayed["pixels"], fill=0.0, filter_mode=s.warp_filter, fmt=frame.format)
        else:
            warped = delayed["pixels"]
        out_pixels = _dequantize_u8(warped) if u8 else warped

        out = Frame(
            pixels=out_pixels,
            timestamp=delayed["timestamp"],
            valid=delayed["valid"] & queue_full & ready,
            format=frame.format,
        )
        new_state = StabilizerState(
            tracker=tracker_state,
            smoother=smoother_state,
            frames=frames,
            scene_quality=scene_quality,
            trust=trust,
            stability=stability,
            uniformity=uniformity,
            correction=correction,
        )
        return new_state, out


def flagship_filter(
    detection=(272, 480), grid=(17, 30), predictive=10, min_samples=75,
    hypotheses=256, warp_filter="easu",
) -> StabilizationFilter:
    """The flagship 1080p stabilizer's settings (the JAX package's
    ``__graft_entry__._flagship_filter``): 272x480 detection, a 17x30 grid,
    256 RANSAC hypotheses, a 10-frame predictive window and the EASU warp."""
    return StabilizationFilter(settings=StabilizationFilterSettings(
        tracker=FrameTrackerSettings(
            detection_size=detection,
            detector=FeatureDetectorSettings(grid_shape=grid),
            min_motion_samples=min_samples,
            motion=MotionEstimationSettings(hypotheses=hypotheses),
        ),
        smoother=PathSmootherSettings(predictive_samples=predictive),
        warp_filter=warp_filter,
    ))
