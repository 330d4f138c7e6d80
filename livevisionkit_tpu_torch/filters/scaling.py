"""ScalingFilter: FSR upscale + RCAS sharpen (counterpart of
livevisionkit_tpu/filters/scaling.py).

Reference parity: ``lvk::ScalingFilter`` (reference Filters/ScalingFilter
.cpp:52-59): `lvk::upscale` (EASU, Functions/Image.cpp:101-160) followed by
`lvk::sharpen` (RCAS, Functions/Image.cpp:164-233); no resize when the
frame is already at the output size.  Stateless, and free of host syncs:
it decides from static shapes only and never reads the frame's flags.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import torch

from livevisionkit_tpu_torch.config import ScalingFilterSettings
from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.ops import easu, rcas


@dataclass(frozen=True)
class ScalingFilter(VideoFilter):
    settings: ScalingFilterSettings = field(default_factory=ScalingFilterSettings)

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        s = self.settings
        # The kernels take contiguous f32 planes (no copy when they are).
        px = frame.pixels.to(torch.float32).contiguous()
        if s.output_size is not None and frame.size != tuple(s.output_size):
            px = easu.easu_scale(px, tuple(s.output_size), fmt=frame.format)
        if s.sharpness > 0.0:
            px = rcas.rcas(px, s.sharpness)
        return state, frame.with_pixels(px)

    def output_spec(self, spec: FrameSpec) -> FrameSpec:
        if self.settings.output_size is None:
            return spec
        oh, ow = self.settings.output_size
        return dataclasses.replace(spec, height=oh, width=ow)
