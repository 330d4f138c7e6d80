"""Frame: the device-resident video frame value type (counterpart of
livevisionkit_tpu/data/frame.py).

A planar ``(C, H, W)`` float32 tensor in [0, 1] with a timestamp, a 0-d bool
``valid`` flag (False during a filter's warm-up delay: the reference's
"empty frame", CompositeFilter.cpp:75-80) and a pixel-format tag.  All
tensors of a frame live on one device.  Alpha planes are not carried yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from livevisionkit_tpu_torch.ops import color as color_ops
from livevisionkit_tpu_torch.types import PixelFormat


@dataclass(frozen=True)
class Frame:
    pixels: torch.Tensor  # (C, H, W) float32 in [0, 1] (or the u8 queue payload)
    timestamp: torch.Tensor  # 0-d float32 seconds since stream start
    valid: torch.Tensor  # 0-d bool
    format: PixelFormat = PixelFormat.UNKNOWN

    @property
    def height(self) -> int:
        return self.pixels.shape[-2]

    @property
    def width(self) -> int:
        return self.pixels.shape[-1]

    @property
    def channels(self) -> int:
        return self.pixels.shape[-3]

    @property
    def size(self) -> tuple[int, int]:
        """(height, width)."""
        return (self.height, self.width)

    @property
    def device(self) -> torch.device:
        return self.pixels.device

    @classmethod
    def create(
        cls,
        pixels: torch.Tensor,
        timestamp: float | torch.Tensor = 0.0,
        fmt: PixelFormat = PixelFormat.RGB,
        valid: bool | torch.Tensor = True,
    ) -> "Frame":
        if pixels.ndim == 2:  # allow (H, W) shorthand for grayscale
            pixels = pixels[None]
            fmt = PixelFormat.GRAY
        dev = pixels.device
        return cls(
            pixels=pixels.to(torch.float32),
            timestamp=torch.as_tensor(timestamp, dtype=torch.float32, device=dev),
            valid=torch.as_tensor(valid, dtype=torch.bool, device=dev),
            format=fmt,
        )

    def replace(self, **changes) -> "Frame":
        return dataclasses.replace(self, **changes)

    def luma(self) -> torch.Tensor:
        """(H, W) luminance plane — the tracking input.  GRAY/YUV take plane
        0 directly (the reference's zero-copy viewAsFormat)."""
        return color_ops.luma(self.pixels, self.format)
