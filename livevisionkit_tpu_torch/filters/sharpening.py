"""CASFilter: contrast-adaptive sharpening as a chain filter (counterpart
of livevisionkit_tpu/filters/sharpening.py; reference OBS-Plugin
CASFilter.cpp + Effects/CASEffect.cpp:62-90: `CasSetup` with sharpness
only).  A sharpen-only filter, distinct from the FSR/RCAS pair of
ScalingFilter.  Stateless and free of host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from livevisionkit_tpu_torch.config import CASFilterSettings
from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import VideoFilter
from livevisionkit_tpu_torch.ops import cas as cas_ops
from livevisionkit_tpu_torch.utils.profiling import trace_scope


@dataclass(frozen=True)
class CASFilter(VideoFilter):
    settings: CASFilterSettings = field(default_factory=CASFilterSettings)

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        with trace_scope("cas"):
            return state, frame.with_pixels(cas_ops.cas(frame.pixels, self.settings.sharpness))
