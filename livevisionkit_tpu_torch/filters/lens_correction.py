"""LensCorrectionFilter: undistort frames from a calibration profile
(counterpart of livevisionkit_tpu/filters/lens_correction.py).

Reference parity: the OBS LCFilter (reference Modules/OBS-Plugin/Sources/
Enhancement/LCFilter.cpp): loads a calibration profile (:99-115), builds
getOptimalNewCameraMatrix + initUndistortRectifyMap as a WarpField with a
normalized view-region crop (:133-171), and applies it through the
standard warp path (:185-191).

The rectification field is computed ONCE at init (host numpy,
vision/calibration.py) and is the filter's state, a small WarpField on the
device; per frame it warps by the field's dense sample map through
`ops/remap.remap`, so on the card each step is one launch of the warp
kernel, in EASU mode or, with warp_filter="bilinear", in bilinear mode.
A frame's alpha plane rides the same launch as a fourth plane.  Free of
host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from livevisionkit_tpu_torch.data.frame import Frame
from livevisionkit_tpu_torch.filters.base import FrameSpec, VideoFilter
from livevisionkit_tpu_torch.models.warp_field import WarpField
from livevisionkit_tpu_torch.vision.calibration import CameraParameters, undistort_field


@dataclass(frozen=True)
class LensCorrectionFilter(VideoFilter):
    parameters: CameraParameters
    # alpha=0 crops to the valid region (LCFilter's view-region crop);
    # alpha=1 keeps all source pixels (with curved borders visible).
    alpha: float = 0.0
    field_shape: tuple[int, int] = (33, 33)
    # "easu" = reference parity (LCFilter applies through WarpMesh::apply,
    # LCFilter.cpp:185-191, which always EASU-filters); "bilinear" cheaper.
    warp_filter: str = "easu"

    def init(self, spec: FrameSpec, device: torch.device | str = "cuda", seed: int = 0) -> WarpField:
        return undistort_field(self.parameters, (spec.height, spec.width), self.field_shape,
                               self.alpha, device=device)

    def step(self, state: Any, frame: Frame, *, drain: bool | torch.Tensor = False) -> tuple[Any, Frame]:
        field: WarpField = state
        if frame.alpha is None:
            return state, frame.with_pixels(
                field.apply(frame.pixels, fill=0.0, filter_mode=self.warp_filter, fmt=frame.format)
            )
        # Alpha follows the colour geometry (data/frame.py contract): undistort
        # it in the same gather as the colour planes; EASU's luma comes from
        # the colour planes alone.
        warped = field.apply(
            torch.cat([frame.pixels, frame.alpha[None]]), fill=0.0,
            filter_mode=self.warp_filter, fmt=frame.format,
        )
        return state, frame.replace(pixels=warped[:-1], alpha=warped[-1])
